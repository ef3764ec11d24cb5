"""Both band-solve sweeps' share of their roofline: per launch, one
triangular sweep of the band columns of each matrix of the batch against
its ``k``-column panel, counted at element level."""
from perfbench import work
from perfbench.readers import roofline


def read(rec):
    cfg = rec["config"]
    return roofline(rec, ["band_forward_sweep", "band_backward_sweep"],
                    lambda b, k: (b * work.sweep_flops(cfg, k, "band"),
                                  b * work.solve_bytes(cfg, k)))

"""The band-Cholesky sweep's share of its roofline: per launch, the work of
the band columns of each matrix of its batch (their factor, arrow rows and
Schur sums into the corner), counted at element level."""
from perfbench import work
from perfbench.readers import roofline


def read(rec):
    cfg = rec["config"]
    return roofline(rec, ["band_cholesky_sweep"],
                    lambda b, k: (b * work.cholesky_flops(cfg, "band"), b * work.sweep_bytes(cfg)))

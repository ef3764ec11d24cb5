"""The selinv pre-pass and recurrence's share of their roofline: per
launch, the selected inversion of the band columns of each matrix of the
batch, counted at element level."""
from perfbench import work
from perfbench.readers import roofline


def read(rec):
    cfg = rec["config"]
    return roofline(rec, ["selinv_sweep"],
                    lambda b, k: (b * work.selinv_flops(cfg, "band"), b * work.selinv_bytes(cfg)))

"""Mean device time of a θ step's ``selinv_batched`` and the variances'
gather (CUDA events around the call)."""
from perfbench.readers import span_mean


def read(rec):
    return span_mean(rec, "selinv", "ms")

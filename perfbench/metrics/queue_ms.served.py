"""Mean time a request waited in the rung scheduler's queue before its
batch flushed: the program's ``serving.queue_wait`` histogram."""
from perfbench.readers import hist_mean


def read(rec):
    v = hist_mean(rec, "serving.queue_wait")
    return None if v is None else 1e3 * v

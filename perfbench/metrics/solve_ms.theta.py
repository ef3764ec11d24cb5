"""Mean device time of a θ step's ``solve_many_batched`` (CUDA events
around the call)."""
from perfbench.readers import span_mean


def read(rec):
    return span_mean(rec, "solve", "ms")

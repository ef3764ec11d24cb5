"""Mean device time of a θ step's ``factorize_window_batched`` + ``logdet``:
CUDA events the harness records around the two calls on their stream."""
from perfbench.readers import span_mean


def read(rec):
    return span_mean(rec, "factor", "ms")

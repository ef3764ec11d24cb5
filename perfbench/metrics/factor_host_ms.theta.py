"""Mean host time of a θ step's ``factorize_window_batched`` + ``logdet``,
from entry to return: what the host spends to enqueue the factorization."""
from perfbench.readers import span_mean


def read(rec):
    return span_mean(rec, "factor", "host_ms")

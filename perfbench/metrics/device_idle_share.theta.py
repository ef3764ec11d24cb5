"""The share of the window in which no kernel, copy or fill ran on the
card, from the profiler's device activity over every stream."""
from perfbench.readers import idle_share


def read(rec):
    return idle_share(rec)

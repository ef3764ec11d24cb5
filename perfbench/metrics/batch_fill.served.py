"""Mean batch size the scheduler flushed, over its ``max_batch``: the
program's ``serving.batch_size`` histogram."""
from perfbench.readers import hist_mean


def read(rec):
    v = hist_mean(rec, "serving.batch_size")
    return None if v is None else 100.0 * v / rec["mix"]["max_batch"]

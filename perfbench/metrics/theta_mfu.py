"""The whole θ step's share of the card's fp32 peak: the element-level
operations of each completed candidate's step (factor, log-determinant,
solve or selected inversion) over the window."""
from perfbench import work


def read(rec):
    peak = work.peaks(rec.get("device_name", ""))
    out, mix = rec["outcome"], rec["mix"]
    if peak is None or not out.get("completed"):
        return None
    flops = out["completed"] * work.step_flops(rec["config"], mix["readout"], mix.get("k", 1))
    return 100.0 * flops / out["window_s"] / peak["fp32_flops"]

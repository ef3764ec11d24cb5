"""The comparison that decides ``correct``: the program's answers for a
cell's sampled candidates against the plain reference's, number by number
against the cell's limits (``limits/<cell>.json``).

Numbers (each the worst over the candidates compared):

* ``logdet_rel``: ``|ld - ld_ref| / |ld_ref|``;
* ``x_rel``: ``max|x - x_ref| / max|x_ref|`` of a candidate's solutions;
* ``var_rel``: ``max_i |v_i - v_ref_i| / v_ref_i`` over its marginal variances;
* ``bad_status``: candidates of the whole window whose status word is not
  clean, or whose answer never came (the limit is 0).
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["compare", "judge", "format_checks"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        return math.inf
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def compare(answers, reference) -> dict:
    """The numbers of a list of answers against the reference's answers for
    the same candidates: dicts with ``logdet`` and ``x`` or ``var``."""
    nums = {"logdet_rel": 0.0}
    for got, want in zip(answers, reference):
        ld = got.get("logdet")
        err = (abs(ld - want["logdet"]) / abs(want["logdet"])
               if ld is not None and math.isfinite(ld) else math.inf)
        nums["logdet_rel"] = max(nums["logdet_rel"], err)
        if "x" in want:
            nums["x_rel"] = max(nums.get("x_rel", 0.0),
                                _rel(got["x"], want["x"]) if got.get("x") is not None
                                else math.inf)
        if "var" in want:
            v, w = got.get("var"), np.asarray(want["var"], np.float64)
            err = (float(np.max(np.abs(np.asarray(v, np.float64) - w) / w))
                   if v is not None and np.shape(v) == w.shape and np.all(np.isfinite(v))
                   else math.inf)
            nums["var_rel"] = max(nums.get("var_rel", 0.0), err)
    if len(answers) != len(reference) or not reference:
        nums["logdet_rel"] = math.inf
    return nums


def judge(nums: dict, limits: dict) -> bool:
    """Every number of the cell's limits present and within its limit."""
    return all(k in nums and nums[k] <= lim for k, lim in limits.items())


def format_checks(nums: dict, limits: dict) -> dict:
    """``{name: [number, limit]}`` in the limits' order."""
    return {k: [nums.get(k, math.inf), lim] for k, lim in limits.items()}

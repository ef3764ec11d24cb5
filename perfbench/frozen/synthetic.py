"""The serving stream's arrival process, frozen from
``repro_torch/data/synthetic.py::request_stream``: seeded Poisson arrivals,
or a two-state Markov-modulated Poisson process with bursts."""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["request_stream"]


def request_stream(seed: int, cases, num: int, rate: float = 1000.0, k: int = 4,
                   deadline_budget: Optional[float] = None, burst_factor: float = 1.0,
                   burst_len: float = 10e-3, normal_len: float = 50e-3):
    """``num`` request specs: dicts of ``arrival`` (exponential gaps at
    ``rate`` a second), ``case`` (one of ``cases``, uniformly), ``seed``,
    ``k`` and ``deadline``.  With ``burst_factor > 1`` the rate alternates
    between ``rate`` (sojourns of mean ``normal_len``) and ``rate *
    burst_factor`` (mean ``burst_len``); ``burst_factor = 1`` is the plain
    stream bit for bit."""
    cases = [tuple(int(v) for v in c) for c in cases]
    if not cases:
        raise ValueError("request_stream needs at least one case")
    if num < 0 or rate <= 0:
        raise ValueError(f"need num >= 0 and rate > 0, got {num}, {rate}")
    burst = burst_factor != 1.0
    if burst and (burst_factor <= 0 or burst_len <= 0 or normal_len <= 0):
        raise ValueError("burst mode needs burst_factor > 0 and positive sojourn means, "
                         f"got {burst_factor}, {burst_len}, {normal_len}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    if burst:
        mrng = np.random.default_rng(np.random.SeedSequence([seed, 17]))
        state = 0                                    # 0 = normal, 1 = burst
        flip_at = float(mrng.exponential(normal_len))
    out = []
    now = 0.0
    for _ in range(num):
        gap = float(rng.exponential(1.0 / rate))
        if not burst:
            now += gap
        else:
            # the unit-rate draw integrated through the modulated rate
            work = gap * rate
            while True:
                r = rate * (burst_factor if state else 1.0)
                dt = work / r
                if now + dt <= flip_at:
                    now += dt
                    break
                work -= (flip_at - now) * r
                now = flip_at
                state = 1 - state
                flip_at = now + float(mrng.exponential(burst_len if state else normal_len))
        out.append({"arrival": now, "case": cases[int(rng.integers(len(cases)))],
                    "seed": int(rng.integers(2 ** 31)), "k": int(k),
                    "deadline": now + deadline_budget if deadline_budget is not None else None})
    return out

"""Synthetic data, copies of the JAX package's ``data/synthetic.py``:
``block_separable_arrowhead``, the three pathological generators of the
breakdown-recovery tests, the serving harness's request stream and the
training token streams.  numpy and scipy only, with the reference's
seeding, so both packages corrupt the same entries, draw the same tokens
and replay the same arrivals.

* :func:`indefinite_arrowhead` — SPD arrowhead with a known negative shift
  applied to part of the diagonal (Cholesky breaks down at a predictable
  pivot);
* :func:`near_singular_arrowhead` — SPD with smallest eigenvalue driven to
  a requested tiny value (factorizable in exact arithmetic, pivots at the
  float32 cliff);
* :func:`nan_contaminated_arrowhead` — SPD with seeded NaN entries
  (symmetrically placed), the "silent NaN downstream" case detection must
  flag;
* :func:`request_stream` — seeded Poisson (or Markov-modulated burst)
  arrivals of mixed-grid request specs for the rung server
  (``launch/rung_server.py``);
* :func:`token_batch` — pure-hash tokens keyed by (seed, step): exactly
  reproducible on restart from any step, the replay-exact property the
  fault-tolerant training loop relies on;
* :class:`MarkovStream` — tokens from a fixed random first-order Markov
  chain, a learnable distribution for the training examples.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp

__all__ = ["indefinite_arrowhead", "near_singular_arrowhead", "nan_contaminated_arrowhead",
           "block_separable_arrowhead", "request_stream", "token_batch", "MarkovStream"]


def _base_arrowhead(n, bandwidth, arrow, rho, seed):
    from .gmrf import make_arrowhead
    return make_arrowhead(n, bandwidth, arrow, rho=rho, seed=seed)


def indefinite_arrowhead(n: int, bandwidth: int, arrow: int,
                         rho: float = 0.7, seed: int = 0,
                         shift: float = 10.0, frac: float = 0.1):
    """SPD arrowhead made indefinite by subtracting ``shift * mean_diag``
    from a seeded random ``frac`` of the diagonal.  The negative Cholesky
    pivot lands near the first corrupted index, so tests can assert the
    detector's ``first_bad`` tile.  Returns ``(csc_matrix, structure)``."""
    A, st = _base_arrowhead(n, bandwidth, arrow, rho, seed)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    k = max(1, int(frac * n))
    idx = np.sort(rng.choice(n, size=k, replace=False))
    A = sp.lil_matrix(A)
    d = A.diagonal()
    drop = shift * float(d.mean())
    for i in idx:
        A[i, i] = d[i] - drop
    return sp.csc_matrix(A), st


def near_singular_arrowhead(n: int, bandwidth: int, arrow: int,
                            rho: float = 0.7, seed: int = 0,
                            eig_min: float = 1e-6):
    """SPD arrowhead whose smallest eigenvalue is shifted down to
    ``eig_min`` (exact arithmetic keeps it factorizable; float32 pivots sit
    at the breakdown threshold — the case ``pivot_rtol`` exists for).
    Returns ``(csc_matrix, structure)``."""
    A, st = _base_arrowhead(n, bandwidth, arrow, rho, seed)
    lam_min = float(np.linalg.eigvalsh(A.toarray()).min())
    return sp.csc_matrix(A - sp.eye(n, format="csc") * (lam_min - eig_min)), st


def nan_contaminated_arrowhead(n: int, bandwidth: int, arrow: int,
                               rho: float = 0.7, seed: int = 0,
                               count: int = 1):
    """SPD arrowhead with ``count`` seeded NaN entries placed symmetrically
    on existing structural nonzeros — the silent-corruption case the
    sweep's ``nonfinite`` flag must catch.  Returns ``(csc_matrix,
    structure)``."""
    A, st = _base_arrowhead(n, bandwidth, arrow, rho, seed)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    A = sp.lil_matrix(A)
    rows, cols = A.nonzero()
    for pick in rng.choice(len(rows), size=min(count, len(rows)), replace=False):
        i, j = int(rows[pick]), int(cols[pick])
        A[i, j] = np.nan
        A[j, i] = np.nan
    return sp.csc_matrix(A), st


def block_separable_arrowhead(n: int, bandwidth: int, arrow: int,
                              t: int, n_parts: int = 2,
                              rho: float = 0.7, seed: int = 0):
    """SPD arrowhead whose band splits into ``n_parts`` independent
    partitions at tile-aligned cuts — the post-adaptive-ND shape
    (paper §III-A, Fig. 4) the partitioned sweep exists for.

    Starts from :func:`~repro_torch.data.gmrf.make_arrowhead` and zeroes
    every band entry coupling elements on opposite sides of the cuts at
    tiles ``round(ndt * p / n_parts)`` (cuts on the *tile* grid of size
    ``t``, so :func:`~repro_torch.core.ordering.detect_partition_plan`
    certifies them exactly).  Zeroing off-diagonals only *increases*
    diagonal dominance, so the result stays SPD.  The dense arrow block —
    the moved separator — still couples all partitions.

    Returns ``(csc_matrix, structure, boundaries)`` with ``boundaries``
    the tile-boundary tuple a
    :class:`~repro_torch.core.ordering.PartitionPlan` takes.
    """
    if t <= 0 or n_parts < 1:
        raise ValueError(f"need t > 0 and n_parts >= 1, got {t}, {n_parts}")
    A, st = _base_arrowhead(n, bandwidth, arrow, rho, seed)
    nd = st.n_diag
    ndt = -(-nd // t)
    cuts = sorted({min(ndt, max(1, round(ndt * p / n_parts)))
                   for p in range(1, n_parts)} - {ndt})
    A = A.tolil()
    for c in cuts:
        ce = c * t                     # element index of the cut
        lo = max(0, ce - bandwidth)
        hi = min(nd, ce + bandwidth)
        A[ce:hi, lo:ce] = 0
        A[lo:ce, ce:hi] = 0
    return sp.csc_matrix(A), st, tuple([0] + cuts + [ndt])


def request_stream(seed: int, cases, num: int, rate: float = 1000.0,
                   k: int = 4, deadline_budget: Optional[float] = None,
                   burst_factor: float = 1.0, burst_len: float = 10e-3,
                   normal_len: float = 50e-3):
    """Seeded Poisson mixed-grid arrival stream for the serving harness.

    Emits ``num`` host-side request *specs* (no arrays): dicts with
    ``arrival`` (absolute clock time; exponential inter-arrival gaps at
    ``rate`` requests per clock unit), ``case`` (one of ``cases``, each an
    ``(n, bandwidth, arrow)`` triple drawn uniformly), ``seed`` (the
    request's matrix and right-hand-side seed), ``k`` (the panel width) and
    ``deadline`` (``arrival + deadline_budget``, or None).  Everything
    comes from one ``SeedSequence([seed, ...])`` stream, so the same seed
    replays the same arrival process, and the reference's stream for the
    same arguments is equal to this one.

    **Burst mode** (``burst_factor > 1``): a two-state Markov-modulated
    Poisson process, exponential sojourns of mean ``normal_len`` at
    ``rate`` alternating with sojourns of mean ``burst_len`` at ``rate *
    burst_factor``.  It is a time change of the unit-rate process (each
    base draw is integrated through the piecewise-constant rate, the state
    flips drawn from an independent ``SeedSequence([seed, 17])`` stream),
    exact by memorylessness, and it leaves the base draws as they are:
    ``burst_factor=1`` is the plain stream bit for bit.
    """
    cases = [tuple(int(v) for v in c) for c in cases]
    if not cases:
        raise ValueError("request_stream needs at least one case")
    if num < 0 or rate <= 0:
        raise ValueError(f"need num >= 0 and rate > 0, got {num}, {rate}")
    burst = burst_factor != 1.0
    if burst and (burst_factor <= 0 or burst_len <= 0 or normal_len <= 0):
        raise ValueError(
            f"burst mode needs burst_factor > 0 and positive sojourn "
            f"means, got {burst_factor}, {burst_len}, {normal_len}")
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
            # integrate the unit-rate exponential through the
            # piecewise-constant modulated rate
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
                flip_at = now + float(mrng.exponential(
                    burst_len if state else normal_len))
        out.append({
            "arrival": now,
            "case": cases[int(rng.integers(len(cases)))],
            "seed": int(rng.integers(2 ** 31)),
            "k": int(k),
            "deadline": (now + deadline_budget
                         if deadline_budget is not None else None),
        })
    return out


def token_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                extras: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """Stateless batch: tokens = hash(seed, step); labels = next-token."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
    out = {"tokens": toks[:, :-1].astype(np.int32),
           "labels": toks[:, 1:].astype(np.int32)}
    if extras:
        out.update(extras)
    return out


class MarkovStream:
    """First-order Markov chain over ``vocab`` states, fixed by ``seed``.

    Perplexity floor ≈ exp(H(P_row)) — training should push loss towards it.
    """

    def __init__(self, vocab: int, seed: int = 0, concentration: float = 0.3):
        rng = np.random.default_rng(seed)
        logits = rng.standard_normal((vocab, vocab)) / concentration
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        self.P = p / p.sum(axis=1, keepdims=True)
        self.vocab = vocab
        self.seed = seed
        row_h = -(self.P * np.log(self.P + 1e-12)).sum(axis=1)
        self.entropy_floor = float(row_h.mean())

    def batch(self, step: int, batch: int, seq: int,
              extras: Optional[Dict] = None) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        toks = np.empty((batch, seq + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        # vectorized inverse-cdf sampling per step
        cdf = np.cumsum(self.P, axis=1)
        for t in range(seq):
            u = rng.random(batch)
            toks[:, t + 1] = (cdf[toks[:, t]] < u[:, None]).sum(axis=1)
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if extras:
            out.update(extras)
        return out

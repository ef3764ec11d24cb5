"""Numerical fault tolerance: breakdown recovery by escalating diagonal
jitter, with per-element graceful degradation for batched factorizations.

The detection half lives in the kernels: every route of
``factorize_window`` returns a status word ``[min_pivot, nonfinite,
first_bad]`` (one per batch element), so a bad pivot is visible without an
exception.  This module is the recovery half, the CHOLMOD-style
pivot-perturbation ladder of the JAX package's ``core/robustness.py``:

* on breakdown, refactorize the *original* matrix with ``tau_k * scale * I``
  added to the diagonal, ``tau_k`` escalating through
  :attr:`RegularizePolicy.taus`;
* a final Gershgorin rung (on by default) shifts failed elements into
  strict diagonal dominance, so any *finite* symmetric input is recovered.
  Only NaN/inf-contaminated inputs can exhaust the ladder, and those end as
  per-element ``STATUS_FAILED`` flags instead of exceptions;
* batched calls retry only the failed batch elements by masking: a retry
  re-runs the same call on the whole batch with only the failed elements'
  diagonals jittered, and healthy elements keep their first attempt's
  tensors bit for bit (one ``torch.where`` merge);
* the resulting :class:`FactorInfo` rides on ``CholeskyFactor`` so callers
  can read per-element status, and ``solve_many`` / ``solve_many_batched``
  use the retained original matrix for one residual-checked refinement
  step (:func:`ctsf_matvec`).

The ladder reads back one ``(B,)`` bool per attempt; the clean path pays
exactly one readback and returns.  Everything here is a plain function on
tensors; the reference's fused first-attempt evaluation is a few tensor
ops.  With telemetry enabled the ladder counts ``robustness.attempts`` and
``robustness.status{outcome=ok|recovered|failed}``, as the reference's
does: on the clean path off the readback it pays anyway, on the ladder
path off one more readback of the statuses.  A sharded batch
(``core/concurrent.py``'s ``mesh=``) passes ``gather``, so that every rank
decides, counts and retries on the whole batch's statuses.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime import telemetry
from .ctsf import BandedCTSF

__all__ = ["STATUS_OK", "STATUS_RECOVERED", "STATUS_FAILED", "STATUS_SHED",
           "RegularizePolicy", "FactorInfo", "diag_scale", "status_ok",
           "gershgorin_shift", "add_diagonal_jitter", "fold_corner_status",
           "run_ladder", "ctsf_matvec"]

STATUS_OK = 0          # factorized clean, no jitter
STATUS_RECOVERED = 1   # breakdown detected, recovered with diagonal jitter
STATUS_FAILED = 2      # ladder exhausted (non-finite input); factor unusable
# the serving layer's terminal status: a request that was never computed
# (shed by admission control, a deadline or shutdown); it completes the
# closed taxonomy OK / RECOVERED / FAILED / SHED
STATUS_SHED = 3


@dataclasses.dataclass(frozen=True)
class RegularizePolicy:
    """Escalating-jitter retry policy (CHOLMOD-style pivot perturbation).

    ``taus`` are *relative* jitter magnitudes: attempt k refactorizes with
    ``taus[k] * scale * I`` added to the diagonal, where ``scale`` is the
    per-element max |diagonal| of the input (:func:`diag_scale`).  The
    default ladder starts near float32 epsilon and escalates by about 100x
    a rung.

    ``gershgorin=True`` appends a final data-dependent rung: the smallest
    shift making the failed element strictly diagonally dominant (hence
    SPD), plus ``gershgorin_margin * scale``, so every finite symmetric
    input factorizes.

    ``pivot_rtol`` declares breakdown when ``min_pivot <= pivot_rtol *
    scale`` (pivots are diag(L)^2, in units of A's diagonal).

    ``keep_matrix=True`` retains the original (unjittered) input on the
    :class:`FactorInfo` whenever jitter was applied, for the refinement
    step of the solves.
    """
    taus: Tuple[float, ...] = (1e-6, 1e-4, 1e-2)
    pivot_rtol: float = 1e-10
    gershgorin: bool = True
    gershgorin_margin: float = 1e-3
    keep_matrix: bool = True

    @staticmethod
    def resolve(regularize) -> Optional["RegularizePolicy"]:
        """Normalize a ``regularize=`` argument: None/False -> None,
        True -> the default policy, a policy -> itself; anything else
        raises ValueError."""
        if regularize is None or regularize is False:
            return None
        if regularize is True:
            return RegularizePolicy()
        if isinstance(regularize, RegularizePolicy):
            return regularize
        raise ValueError(f"regularize= must be None, a bool or a RegularizePolicy, "
                         f"got {regularize!r}")


@dataclasses.dataclass
class FactorInfo:
    """Per-element numerical outcome of a (possibly batched) factorization.

    All tensor fields have the factorization's batch shape, ``()`` for a
    single matrix, ``(B,)`` for a batch, on the factor's device:

    * ``status`` — int32 ``STATUS_OK`` / ``STATUS_RECOVERED`` /
      ``STATUS_FAILED``;
    * ``attempts`` — int32 factorization attempts consumed (1 = clean);
    * ``tau`` — float32 *absolute* diagonal shift applied (``tau_k *
      scale``; 0 for clean elements, NaN where the last rung was NaN);
    * ``min_pivot`` — float32 smallest Cholesky pivot (diag(L)^2) of the
      final factor, ``status[..., 0]`` of its status word;
    * ``first_bad_tile`` — int32 first failing tile of the *clean* attempt
      (-1 if it succeeded; ``ndt`` means the arrow corner broke);
    * ``matrix`` — the original unjittered input (kept only when jitter
      was applied and the policy says so), for the refinement step.
    """
    status: torch.Tensor
    attempts: torch.Tensor
    tau: torch.Tensor
    min_pivot: torch.Tensor
    first_bad_tile: torch.Tensor
    matrix: Optional[BandedCTSF] = None

    def ok(self) -> np.ndarray:
        """Host bool array: which elements produced a usable factor."""
        return self.status.cpu().numpy() != STATUS_FAILED

    def element(self, i: int) -> dict:
        """Host-side scalar view of one batch element's outcome: plain
        Python numbers.  Works on unbatched info too, where ``i`` must be
        0.  Each call reads the five fields to the host; a reader of every
        element takes :meth:`elements`."""
        pick = lambda a, cast: cast(a.cpu().numpy().reshape(-1)[i])
        return {"status": pick(self.status, int),
                "attempts": pick(self.attempts, int),
                "tau": pick(self.tau, float),
                "min_pivot": pick(self.min_pivot, float),
                "first_bad_tile": pick(self.first_bad_tile, int)}

    def elements(self) -> list:
        """Every element's :meth:`element` view, from one read of the five
        fields to the host: they are stacked as float64 on the device (which
        holds every int32 and float32 value exactly) and copied once, so a
        batch of B costs one synchronization, not 5 B.  Unbatched info gives
        one element."""
        host = torch.stack([x.reshape(-1).to(torch.float64) for x in (
            self.status, self.attempts, self.tau, self.min_pivot,
            self.first_bad_tile)]).cpu().numpy()
        return [{"status": int(s), "attempts": int(a), "tau": float(t),
                 "min_pivot": float(p), "first_bad_tile": int(b)}
                for s, a, t, p, b in host.T]


def _diag(x: torch.Tensor) -> torch.Tensor:
    """The diagonals of a (..., t, t) stack of tiles: (..., t)."""
    return torch.diagonal(x, dim1=-2, dim2=-1)


def _corner_diag(C: torch.Tensor) -> torch.Tensor:
    """The diagonal of a (..., nat, nat, t, t) corner: (..., nat, t)."""
    ar = torch.arange(C.shape[-4], device=C.device)
    return _diag(C[..., ar, ar, :, :])


def diag_scale(Dr: torch.Tensor, C: torch.Tensor, grid) -> torch.Tensor:
    """Per-element diagonal scale: max |A_ii| over band and corner
    diagonals, 1.0 where that is not positive (an all-zero or NaN
    diagonal), so relative jitter stays meaningful.  Leading batch axes
    stay."""
    parts = []
    if grid.n_diag_tiles:
        parts.append(_diag(Dr[..., 0, :, :]).abs().amax(dim=(-2, -1)))
    if grid.n_arrow_tiles:
        parts.append(_corner_diag(C).abs().amax(dim=(-2, -1)))
    if not parts:
        return torch.tensor(1.0, dtype=torch.float32, device=Dr.device)
    s = parts[0] if len(parts) == 1 else torch.maximum(parts[0], parts[1])
    return torch.where(s > 0, s, torch.ones_like(s))


def status_ok(status_vec: torch.Tensor, scale: torch.Tensor,
              policy: RegularizePolicy) -> torch.Tensor:
    """Breakdown predicate on (..., 3) status words: finite everywhere and
    every pivot above ``pivot_rtol * scale`` (+inf, an empty sweep, is
    healthy)."""
    return (status_vec[..., 1] == 0.0) & (status_vec[..., 0] > policy.pivot_rtol * scale)


def add_diagonal_jitter(Dr: torch.Tensor, C: torch.Tensor, grid,
                        shift: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``A + shift * I`` in CTSF layout: ``shift`` (one value per batch
    element) added to every band and corner diagonal tile; new tensors,
    the inputs as they were."""
    eye = torch.eye(grid.t, dtype=Dr.dtype, device=Dr.device)
    sh = shift[..., None, None, None] * eye
    if grid.n_diag_tiles:
        Dr = Dr.clone()
        Dr[..., 0, :, :] += sh
    nat = grid.n_arrow_tiles
    if nat:
        ar = torch.arange(nat, device=C.device)
        C = C.clone()
        C[..., ar, ar, :, :] += sh
    return Dr, C


def gershgorin_shift(Dr: torch.Tensor, R: torch.Tensor, C: torch.Tensor,
                     grid) -> torch.Tensor:
    """Smallest diagonal shift making every Gershgorin disc positive:
    ``max_i (sum_{j != i} |A_ij| - A_ii)``, clipped at 0; adding it (plus
    any positive margin) makes the matrix strictly diagonally dominant and
    therefore SPD.  NaN inputs give a NaN shift.  Batch axes stay.

    The reference's arrow-row term transposes the corner's diagonal
    before subtracting it (``(..., t, nat)`` against ``(..., nat, t)``
    sums), which raises unless ``nat`` is 1 or ``t`` and mixes rows where
    it does not; here each arrow row is held to its own diagonal entry."""
    ndt, nat, bt = grid.n_diag_tiles, grid.n_arrow_tiles, grid.band_tiles
    b1 = bt + 1
    deltas = []
    if ndt:
        absDr = Dr.abs()
        # lower tiles: row (m, a) sums |Dr[m, d, a, :]| over d and columns
        low = absDr.sum(dim=(-3, -1))                                   # (..., ndt, t)
        # upper tiles: A[m, m+d] = Dr[m+d, d]^T, so row (m, a) reads |Dr[m+d, d, :, a]|
        pad = absDr.new_zeros(absDr.shape[:-4] + (bt, b1, grid.t, grid.t))
        Drp = torch.cat([absDr, pad], dim=-4)
        m_idx = torch.arange(ndt, device=Dr.device)[:, None] + torch.arange(b1, device=Dr.device)
        d_idx = torch.arange(b1, device=Dr.device).expand(ndt, b1)
        up = Drp[..., m_idx, d_idx, :, :][..., 1:, :, :].sum(dim=(-3, -2))
        rowsum = low + up
        if nat:
            # the arrow columns seen from band rows: |R[m, i, :, a]|
            rowsum = rowsum + R.abs().sum(dim=(-3, -2))
        dg = _diag(Dr[..., 0, :, :])
        # rowsum includes |A_ii|; dominance needs A_ii > rowsum - |A_ii|
        deltas.append((rowsum - dg.abs() - dg).amax(dim=(-2, -1)))
    if nat:
        absC = C.abs()
        rows_a = R.abs().sum(dim=(-4, -1)) if ndt else 0.0             # (..., nat, t)
        ii = torch.arange(nat, device=C.device)[:, None]
        jj = torch.arange(nat, device=C.device)[None, :]
        zero = torch.zeros((), dtype=C.dtype, device=C.device)
        lower = (ii >= jj)[:, :, None, None]                            # stored lower tiles
        rows_a = rows_a + torch.where(lower, absC, zero).sum(dim=(-3, -1))
        # upper corner tiles: A[i, j>i] = C[j, i]^T, so row (i, a) reads |C[j, i, :, a]|
        upper = (ii > jj)[:, :, None, None]
        rows_a = rows_a + torch.where(upper, absC, zero).sum(dim=(-4, -2))
        dcg = _corner_diag(C)                                           # (..., nat, t)
        deltas.append((rows_a - dcg.abs() - dcg).amax(dim=(-2, -1)))
    if not deltas:
        return torch.tensor(0.0, dtype=torch.float32, device=Dr.device)
    delta = deltas[0] if len(deltas) == 1 else torch.maximum(deltas[0], deltas[1])
    return torch.clamp_min(delta, 0.0)


def fold_corner_status(status: torch.Tensor, C_out: torch.Tensor,
                       ndt: int, nat: int) -> torch.Tensor:
    """Fold the dense-corner factor into a band status word: the same
    per-tile fold as ``ref.sweep_status`` over the corner's diagonal tiles,
    with a corner breakdown reported as ``first_bad = ndt`` (one past the
    last band tile) when the band itself was clean."""
    if nat == 0:
        return status
    ar = torch.arange(nat, device=C_out.device)
    dg = torch.diagonal(C_out[..., ar, ar, :, :], dim1=-2, dim2=-1)
    fin_d = torch.isfinite(dg).flatten(-2).all(dim=-1)
    inf = torch.full_like(status[..., 0], float("inf"))
    piv = torch.where(fin_d, (dg * dg).flatten(-2).amin(dim=-1), inf)
    fin = torch.isfinite(C_out).flatten(-4).all(dim=-1)
    bad = ~fin | (piv <= 0.0)
    first = torch.where((status[..., 2] < 0) & bad,
                        torch.full_like(status[..., 2], float(ndt)),
                        status[..., 2])
    return torch.stack([torch.minimum(status[..., 0], piv),
                        torch.maximum(status[..., 1], (~fin).to(status.dtype)),
                        first], dim=-1)


def _merge(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per-element select: ``new`` where ``mask`` (batch-shaped), else
    ``old``: the masking that limits retries to failed elements."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())), new, old)


def run_ladder(Dr: torch.Tensor, R: torch.Tensor, C: torch.Tensor, grid,
               call: Callable, policy: RegularizePolicy, gather: Optional[Callable] = None):
    """Drive ``call(Dr, R, C) -> (Dr_L, R_L, C_L, status_vec)`` through the
    escalating-jitter ladder.  ``call`` may be batched (a leading axis on
    the arrays and ``status_vec (B, 3)``): a retry runs the same call on
    the whole batch with only the failed elements' diagonals jittered, then
    merges, so healthy elements stay bit for bit their first attempt.
    Returns ``(Dr_L, R_L, C_L, FactorInfo)``.

    One readback of a ``(B,)`` bool per attempt; the clean path pays
    exactly that one and returns.  Never raises on a breakdown: exhausted
    elements come back ``STATUS_FAILED`` with their factor as it is.

    ``gather`` maps a per-element tensor of this call's elements to the
    whole batch's (a sharded batch's all-gather along its mesh axis): the
    ladder decides whether to go on, and counts, on what it gives, so
    every rank runs the same attempts.  The returned ``FactorInfo`` is of
    this call's elements."""
    gather = gather or (lambda x: x)
    dr, r, c, sv = call(Dr, R, C)
    scale = diag_scale(Dr, C, grid)
    ok = status_ok(sv, scale, policy)
    first_bad = sv[..., 2].to(torch.int32)
    # made before the readback, while the sweep still runs, so that the
    # clean path launches nothing after it
    attempts = torch.ones(ok.shape, dtype=torch.int32, device=ok.device)
    tau_app = torch.zeros(ok.shape, dtype=torch.float32, device=ok.device)
    clean = torch.zeros_like(attempts)
    if bool(gather(ok).all()):          # the clean path's one readback
        if telemetry.enabled():
            # counted off the readback the ladder pays anyway
            n = gather(ok).numel()
            telemetry.inc("robustness.attempts", n)
            telemetry.inc("robustness.status", n, outcome="ok")
        info = FactorInfo(status=clean, attempts=attempts, tau=tau_app, min_pivot=sv[..., 0],
                          first_bad_tile=first_bad, matrix=None)
        return dr, r, c, info
    shifts = [torch.tensor(tau, dtype=torch.float32, device=scale.device) * scale
              for tau in policy.taus]
    if policy.gershgorin:
        shifts.append(gershgorin_shift(Dr, R, C, grid)
                      + torch.tensor(policy.gershgorin_margin, dtype=torch.float32,
                                     device=scale.device) * scale)
    for shift in shifts:
        failed = ~ok
        sh = torch.where(failed, shift, torch.zeros_like(shift))
        DrJ, CJ = add_diagonal_jitter(Dr, C, grid, sh)
        n_dr, n_r, n_c, n_sv = call(DrJ, R, CJ)
        dr, r, c = _merge(failed, n_dr, dr), _merge(failed, n_r, r), _merge(failed, n_c, c)
        sv = _merge(failed, n_sv, sv)
        tau_app = torch.where(failed, sh, tau_app)
        attempts = attempts + failed.to(torch.int32)
        ok = ok | (failed & status_ok(n_sv, scale, policy))
        if bool(gather(ok).all()):
            break
    status = torch.where(ok, torch.where(tau_app > 0, STATUS_RECOVERED, STATUS_OK),
                         STATUS_FAILED).to(torch.int32)
    jittered = bool(gather(tau_app > 0).any())
    if telemetry.enabled():
        # the ladder path only: its readbacks are off the clean path
        st_host = gather(status).cpu()
        telemetry.inc("robustness.attempts", int(gather(attempts).sum()))
        for code, outcome in ((STATUS_OK, "ok"), (STATUS_RECOVERED, "recovered"),
                              (STATUS_FAILED, "failed")):
            n = int((st_host == code).sum())
            if n:
                telemetry.inc("robustness.status", n, outcome=outcome)
    matrix = BandedCTSF(grid, Dr, R, C) if (jittered and policy.keep_matrix) else None
    info = FactorInfo(status=status, attempts=attempts, tau=tau_app, min_pivot=sv[..., 0],
                      first_bad_tile=first_bad, matrix=matrix)
    return dr, r, c, info


def ctsf_matvec(Dr: torch.Tensor, R: torch.Tensor, C: torch.Tensor,
                xd: torch.Tensor, xa: torch.Tensor, grid):
    """``Y = A @ X`` on split tile panels for a *symmetric* banded-arrowhead
    CTSF (an original matrix, not a factor): ``xd (..., ndt, t, k)`` band
    panel, ``xa (..., nat, t, k)`` arrow panel -> ``(yd, ya)`` of the same
    shapes; leading batch axes on every input, one matrix an element.  The
    residual ``B - A X`` of the solves' refinement step.  Tile contractions
    by ``torch.einsum``, as the reference computes them outside any kernel."""
    t = grid.t
    ndt, nat, bt = grid.n_diag_tiles, grid.n_arrow_tiles, grid.band_tiles
    b1 = bt + 1
    lead, k = tuple(xd.shape[:-3]), xd.shape[-1]
    dev = xd.device
    if ndt:
        m_idx = torch.arange(ndt, device=dev)[:, None]
        d_idx = torch.arange(b1, device=dev)[None, :]
        # lower: y[m] += sum_d Dr[m, d] @ x[m-d]
        zeros = xd.new_zeros(lead + (bt, t, k))
        xp = torch.cat([zeros, xd], dim=-3)
        yd = torch.einsum("...mdab,...mdbk->...mak", Dr, xp[..., m_idx - d_idx + bt, :, :])
        if bt:
            # upper: A[m, m+d] = Dr[m+d, d]^T for d >= 1
            Drp = torch.cat([Dr, Dr.new_zeros(lead + (bt, b1, t, t))], dim=-4)
            Dup = Drp[..., m_idx + d_idx, d_idx.expand(ndt, b1), :, :]    # (..., ndt, b1, t, t)
            xq = torch.cat([xd, zeros], dim=-3)[..., m_idx + d_idx, :, :]
            yd = yd + torch.einsum("...mdba,...mdbk->...mak", Dup[..., 1:, :, :],
                                   xq[..., 1:, :, :])
        if nat:
            # the arrow columns seen from band rows: A[m, ndt+i] = R[m, i]^T
            yd = yd + torch.einsum("...miba,...ibk->...mak", R, xa)
    else:
        yd = xd
    if nat:
        ya = (torch.einsum("...miab,...mbk->...iak", R, xd) if ndt
              else xa.new_zeros(lead + (nat, t, k)))
        ii = torch.arange(nat, device=dev)[:, None]
        jj = torch.arange(nat, device=dev)[None, :]
        # the stored lower corner mirrored: Cfull[i, j>i] = C[j, i]^T
        Cfull = torch.where((ii >= jj)[:, :, None, None], C, C.transpose(-4, -3).mT)
        ya = ya + torch.einsum("...ijab,...jbk->...iak", Cfull, xa)
    else:
        ya = xa
    return yd, ya

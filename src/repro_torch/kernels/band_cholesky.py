"""CUDA kernels: the whole banded-arrowhead Cholesky in one launch, and
its partition-parallel form, ``csrc/band_cholesky.cu``.

:func:`band_cholesky_sweep_cuda` ports the TPU kernel
``repro/kernels/band_cholesky.py::band_cholesky_sweep_pallas``.  One block
walks the band columns in order; the last ``band_tiles`` finalized panels
are read back from the outputs (they stay in L2) instead of a VMEM ring.
Outputs and semantics match ``ref.band_cholesky_sweep_ref``: column
panels, factored arrow rows, per-chunk corner-Schur sums and the status
word ``[min_pivot, nonfinite, first_bad]`` folded in the kernel.

:func:`band_cholesky_partitioned_sweep_cuda` ports
``band_cholesky_partitioned_sweep_pallas``: the same kernel on one block
per independent partition of a block-separable band, each with its own
Schur leaf and status word (folded by ``ref.combine_sweep_status``), as
``ref.band_cholesky_partitioned_sweep_ref`` defines it.

Both take a leading batch axis in the same launch, a row of blocks per
element (the grid's second dimension): what ``factorize_window_batched``
runs for B hyperparameter candidates of one sparsity pattern.  Element i
is written bit for bit as an unbatched launch on its inputs writes it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .potrf import check_tiles
from .ref import check_boundaries, combine_sweep_status, empty_sweep_status
from .ring import chunk_layout

__all__ = ["band_cholesky_sweep_cuda", "band_cholesky_partitioned_sweep_cuda",
           "sweep_phase_cycles", "PHASES", "MAX_PARTITIONS", "MAX_BATCH"]

MAX_PARTITIONS = 512   # csrc/band_cholesky.cu::kMaxParts
MAX_BATCH = 65535      # the grid's height: one row of blocks a batch element

PHASES = ("diagonal products", "potrf", "band products", "arrow products",
          "substitution", "status fold", "Schur products", "column start")


def _check_sweep_inputs(name: str, Ac: torch.Tensor, R: torch.Tensor) -> int:
    """``Ac (..., ndt, bt+1, t, t)`` and ``R (..., ndt, nat, t, t)`` with at
    most one leading batch dim, the card's grid height at most; returns t."""
    t = check_tiles(name, Ac, R)
    if Ac.dim() not in (4, 5) or R.dim() != Ac.dim() or R.shape[:-3] != Ac.shape[:-3]:
        raise ValueError(f"{name}: want Ac ([B,] ndt, bt+1, t, t) and R ([B,] ndt, nat, t, t), "
                         f"got {tuple(Ac.shape)} and {tuple(R.shape)}")
    if Ac.dim() == 5 and not 1 <= Ac.shape[0] <= MAX_BATCH:
        raise ValueError(f"{name}: a batch of {Ac.shape[0]}, the kernel takes 1 to {MAX_BATCH}")
    return t


def band_cholesky_sweep_cuda(Ac: torch.Tensor, R: torch.Tensor,
                             nchunks: int = 1, start_tile: int = 0):
    """``Ac (ndt, bt+1, t, t)`` column-band tiles and ``R (ndt, nat, t, t)``
    arrow rows -> ``(panels, R_out, schur, status)`` on the card, with
    ``schur (nch, nat, nat, t, t)``, ``nch = chunk_layout(ndt, nchunks)[1]``.
    Columns ``k < start_tile`` are an identity-embedding prefix.  A leading
    batch axis ``(B, ...)`` on both inputs is one launch of B blocks, and
    every output gains it (``status (B, 3)``)."""
    t = _check_sweep_inputs("band_cholesky_sweep", Ac, R)
    lead = tuple(Ac.shape[:-4])
    ndt, b1 = Ac.shape[-4:-2]
    nat = R.shape[-3]
    csz, nch = chunk_layout(ndt, nchunks)
    if ndt == 0:
        return (torch.empty_like(Ac), torch.empty_like(R),
                torch.zeros(lead + (nch, nat, nat, t, t), dtype=Ac.dtype, device=Ac.device),
                empty_sweep_status(Ac.device).expand(lead + (3,)).clone())
    # the kernel writes every output element, so nothing is zeroed here
    panels = torch.empty_like(Ac)
    R_out = torch.empty_like(R)
    schur = torch.empty(lead + (nch, nat, nat, t, t), dtype=Ac.dtype, device=Ac.device)
    status = torch.empty(lead + (3,), dtype=torch.float32, device=Ac.device)
    lib = _build.load("band_cholesky")
    stream = torch.cuda.current_stream(Ac.device).cuda_stream
    code = lib.stiles_band_cholesky_sweep_f32(
        Ac.data_ptr(), R.data_ptr(), panels.data_ptr(), R_out.data_ptr(),
        schur.data_ptr(), status.data_ptr(), ndt, b1 - 1, nat, t, csz,
        int(start_tile), int(math.prod(lead)), stream)
    _build.check(lib, code, "band_cholesky_sweep")
    band_cholesky_sweep_cuda.launches += 1
    return panels, R_out, schur, status


band_cholesky_sweep_cuda.launches = 0


def band_cholesky_partitioned_sweep_cuda(Ac: torch.Tensor, R: torch.Tensor, boundaries,
                                         start_tile: int = 0):
    """The sweep of :func:`band_cholesky_sweep_cuda` over the partitions
    ``[boundaries[p], boundaries[p+1])`` of a block-separable band, one block
    each, in one launch -> ``(panels, R_out, schur, status)`` with
    ``schur (P, nat, nat, t, t)``, one corner-Schur leaf per partition, and
    the (3,) status word folded over the partitions (``first_bad`` global).
    Columns ``k < start_tile`` (global) are an identity-embedding prefix.
    A leading batch axis is taken as :func:`band_cholesky_sweep_cuda` takes
    it: B x P blocks in the one launch."""
    t = _check_sweep_inputs("band_cholesky_partitioned_sweep", Ac, R)
    lead = tuple(Ac.shape[:-4])
    ndt, b1 = Ac.shape[-4:-2]
    nat = R.shape[-3]
    bounds = check_boundaries(boundaries, ndt)
    nparts = len(bounds) - 1
    if nparts > MAX_PARTITIONS:
        raise ValueError(f"band_cholesky_partitioned_sweep: {nparts} partitions, the "
                         f"kernel takes at most {MAX_PARTITIONS}")
    # the kernel writes every output element, so nothing is zeroed here
    panels = torch.empty_like(Ac)
    R_out = torch.empty_like(R)
    schur = torch.empty(lead + (nparts, nat, nat, t, t), dtype=Ac.dtype, device=Ac.device)
    words = torch.empty(lead + (nparts, 3), dtype=torch.float32, device=Ac.device)
    host_bounds = (ctypes.c_int * (nparts + 1))(*bounds)
    lib = _build.load("band_cholesky")
    stream = torch.cuda.current_stream(Ac.device).cuda_stream
    code = lib.stiles_band_cholesky_partitioned_sweep_f32(
        Ac.data_ptr(), R.data_ptr(), panels.data_ptr(), R_out.data_ptr(), schur.data_ptr(),
        words.data_ptr(), ctypes.addressof(host_bounds), nparts, b1 - 1, nat, t,
        int(start_tile), int(math.prod(lead)), stream)
    _build.check(lib, code, "band_cholesky_partitioned_sweep")
    band_cholesky_partitioned_sweep_cuda.launches += 1
    return panels, R_out, schur, combine_sweep_status(words)


band_cholesky_partitioned_sweep_cuda.launches = 0


def sweep_phase_cycles(Ac: torch.Tensor, R: torch.Tensor, nchunks: int = 1):
    """Where one sweep's time goes: the SM cycles its block spent in each of
    :data:`PHASES`, summed over the columns, from a separate build of the
    kernel with a clock mark (and a block barrier) between phases.  For
    measurement only: the main path never loads that build, and this call
    does not count as a launch of the kernel."""
    t = check_tiles("sweep_phase_cycles", Ac, R)
    ndt, b1 = Ac.shape[:2]
    nat = R.shape[1]
    csz, nch = chunk_layout(ndt, nchunks)
    defines = ("STILES_SWEEP_PHASES",)
    lib = _build.load("band_cholesky", defines)
    lib.stiles_sweep_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.stiles_sweep_phase_cycles.restype = ctypes.c_int
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    _build.check(lib, lib.stiles_sweep_phase_cycles(None, 1), "sweep_phase_cycles")
    outs = (torch.empty_like(Ac), torch.empty_like(R),
            torch.empty((nch, nat, nat, t, t), dtype=Ac.dtype, device=Ac.device),
            torch.empty(3, dtype=torch.float32, device=Ac.device))
    code = lib.stiles_band_cholesky_sweep_f32(
        Ac.data_ptr(), R.data_ptr(), *(x.data_ptr() for x in outs), ndt, b1 - 1, nat,
        t, csz, 0, 1, torch.cuda.current_stream(Ac.device).cuda_stream)
    _build.check(lib, code, "sweep_phase_cycles")
    torch.cuda.synchronize(Ac.device)
    _build.check(lib, lib.stiles_sweep_phase_cycles(ctypes.addressof(cycles), 0),
                 "sweep_phase_cycles")
    return dict(zip(PHASES, (int(c) for c in cycles)))

"""The system under test: the port's entry points, as a cell's timed path
calls them.  The loops call them through this module's attributes, so a
test can put a broken entry point in their place and see ``correct``
come out false."""
from __future__ import annotations

from repro_torch.core import (BandedCTSF, TileGrid, factorize_window_batched, logdet,
                              selinv_batched, solve_many_batched)
from repro_torch.core.structure import ArrowheadStructure

__all__ = ["build_kernels", "base_matrix", "batch_matrix", "factorize", "logdet", "solve",
           "selinv", "server"]

factorize = factorize_window_batched
solve = solve_many_batched
selinv = selinv_batched


def build_kernels() -> None:
    """Build the CUDA kernels into ``src/repro_torch/_build/`` where they
    are missing, and load them: the first run of a checkout compiles."""
    from repro_torch.kernels import _build
    for name in _build.build_all():
        _build.load(name)


def base_matrix(A, cfg, device) -> BandedCTSF:
    """The port's tile form of the scipy matrix ``A``."""
    grid = TileGrid(ArrowheadStructure(n=cfg["n"], bandwidth=cfg["bandwidth"],
                                       arrow=cfg["arrow"]), t=cfg["t"])
    return BandedCTSF.from_sparse(A, grid, device=device)


def batch_matrix(base: BandedCTSF, Dr, R, C) -> BandedCTSF:
    """A batch of candidates on the base matrix's grid."""
    return BandedCTSF(base.grid, Dr, R, C)


def server(mix, device):
    """The rung server with the mix's batching, its other settings the
    server's own defaults (the jitter ladder on)."""
    from repro_torch.launch.rung_server import RungServer
    return RungServer(max_batch=mix["max_batch"], max_delay=mix["max_delay_s"], device=device)

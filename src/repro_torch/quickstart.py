"""Quickstart: factorize a block-arrowhead precision matrix with the port.

The twin of the JAX package's ``examples/quickstart.py``, step for step:
builds a Table-II-style GMRF precision matrix, runs the paper's
preprocessing (structure measurement, ordering with the fill-in acceptance
rule), factorizes it with both backends (the window sweep, timed, and the
paper's task list, whose agreement with it is printed), and uses the
factor for a solve, the log-determinant, a sample and marginal variances
— the INLA primitives.  On the card unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (BandedCTSF, TileGrid, TileMatrix, factorize_tasklist,
                              factorize_window, logdet, marginal_variances,
                              measure_arrowhead, sample_gmrf, solve, symbolic_factorize,
                              tile_pattern_from_coo)
from repro_torch.core.ctsf import resolve_device
from repro_torch.core.ordering import best_ordering
from repro_torch.data import make_arrowhead


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None, n: int = 2048, bandwidth: int = 48,
         arrow: int = 32, t: int = 32) -> dict:
    """Run the quickstart (``argv`` as on the command line) and return what
    it printed, as numbers: ``tasklist_agreement`` is ``max |L_tasklist -
    L_window|`` over the dense factor."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda:0)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # -- 1. build: a latent field with a band and a few fixed effects -------
    A, _ = make_arrowhead(n, bandwidth, arrow, rho=0.7, seed=0)
    print(f"matrix: n={n} bandwidth={bandwidth} arrow={arrow} "
          f"nnz={A.nnz} density={A.nnz / n / n:.2%}")

    # -- 2. preprocessing (paper §III-A): measure + order --------------------
    measured = measure_arrowhead(A, arrow_hint=arrow)
    print(f"measured structure: {measured}")
    ordering = best_ordering(A, measured, t=t)
    print(f"ordering: {ordering.name} accepted={ordering.accepted} "
          f"L-tiles {ordering.fill_before} -> {ordering.fill_after}")

    grid = TileGrid(measured, t=t)
    symb = symbolic_factorize(tile_pattern_from_coo(A, grid))
    print(f"symbolic: {len(symb.tasks)} tasks, fill={symb.fill_tiles} tiles, "
          f"critical path={symb.critical_path_length()}, "
          f"max parallelism={symb.max_parallelism()}")

    # -- 3. numerical factorization ------------------------------------------
    bm = BandedCTSF.from_sparse(A, grid, device=dev)
    factorize_window(bm, tree_chunks=8)            # first call: kernels load
    _sync(dev)
    t0 = time.perf_counter()
    factor = factorize_window(bm, tree_chunks=8)
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"window backend: {dt * 1e3:.1f} ms on {dev} "
          f"({symb.total_flops(t) / dt / 1e9:.1f} GFLOP/s)")

    tm = TileMatrix.from_sparse(A, grid, symbolic=symb, device=dev)
    tiles = factorize_tasklist(tm)
    err = float(np.abs(np.tril(tm.to_dense(tiles)) - factor.ctsf.to_dense()).max())
    print(f"tasklist backend agrees to {err:.2e}")

    # -- 4. INLA primitives ---------------------------------------------------
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(grid.padded_n).astype(np.float32)).to(dev)
    x = solve(factor, b)
    resid = float(np.abs(bm.to_dense(lower_only=False) @ x.cpu().numpy()
                         - b.cpu().numpy()).max())
    print(f"solve:   residual={resid:.2e}")
    ld = float(logdet(factor))
    print(f"logdet:  {ld:.2f}")
    s = sample_gmrf(factor, generator=torch.Generator(device=dev).manual_seed(1))
    print(f"sample:  GMRF draw, std={float(torch.std(s)):.3f}")
    mv = marginal_variances(factor, np.asarray([0, n // 2, n - 1]))
    print(f"posterior marginal variances (INLA): {np.round(mv.cpu().numpy(), 5).tolist()}")
    return dict(device=str(dev), window_ms=dt * 1e3, tasklist_agreement=err,
                solve_residual=resid, logdet=ld, sample_std=float(torch.std(s)),
                marginal_variances=mv.cpu().tolist())


if __name__ == "__main__":
    main()

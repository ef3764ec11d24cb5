"""Stable public facade for the port's solver stack.

Applications import from here — ``from repro_torch import api`` (or
``from repro_torch.api import ...``) — instead of reaching into
submodules.  ``__all__`` is the JAX package's ``repro.api.__all__``, name
for name and in its order, and every name is the port's own object.

The surface is one matrix type (:class:`BandedCTSF` on a
:class:`TileGrid`), one knob object (:class:`SolverOptions`, taken as
``options=`` by every entry point), and the entry points themselves:

* factorize: :func:`factorize_window` / :func:`factorize_window_batched`
  / :func:`concurrent_factorize`
* solve: :func:`solve` / :func:`solve_many` / :func:`solve_many_batched`
  (+ the triangular-sweep halves and GMRF sampling)
* selected inversion: :func:`selected_inverse` / :func:`selinv_batched`
  / :func:`marginal_variances`
* serving: :class:`RungServer` (+ :class:`SimClock` for deterministic
  replay)

The port's entry points take their options by keyword only; the rung
server keeps the reference's deprecated ``impl=`` / ``sweep=`` /
``regularize=`` keywords, each with one ``DeprecationWarning``.
"""
from __future__ import annotations

from repro_torch.core.cholesky import (CholeskyFactor, factorize_window,
                                       factorize_window_batched)
from repro_torch.core.concurrent import (concurrent_factorize, concurrent_logdet,
                                         concurrent_quadratic_forms, concurrent_selinv,
                                         concurrent_solve, stack_ctsf)
from repro_torch.core.ctsf import BandedCTSF
from repro_torch.core.gridpolicy import GridBucketPolicy
from repro_torch.core.options import SolverOptions
from repro_torch.core.ordering import (PartitionPlan, adaptive_nd_ordering,
                                       detect_partition_plan, partition_plan_from_ordering)
from repro_torch.core.robustness import (STATUS_FAILED, STATUS_OK, STATUS_RECOVERED,
                                         STATUS_SHED, FactorInfo, RegularizePolicy)
from repro_torch.core.selinv import SelectedInverse, selected_inverse, selinv_batched
from repro_torch.core.solve import (backward_solve, backward_solve_many, forward_solve,
                                    forward_solve_many, logdet, marginal_variances,
                                    sample_gmrf, sample_gmrf_many, solve, solve_many,
                                    solve_many_batched)
from repro_torch.core.structure import ArrowheadStructure, TileGrid, measure_arrowhead
from repro_torch.launch.rung_server import RungServer, SimClock

__all__ = [
    # matrix + grid types
    "ArrowheadStructure",
    "BandedCTSF",
    "TileGrid",
    "measure_arrowhead",
    # the one knob object + its ingredients
    "SolverOptions",
    "GridBucketPolicy",
    "PartitionPlan",
    "RegularizePolicy",
    # orderings / partition detection
    "adaptive_nd_ordering",
    "detect_partition_plan",
    "partition_plan_from_ordering",
    # factorization
    "CholeskyFactor",
    "FactorInfo",
    "factorize_window",
    "factorize_window_batched",
    "concurrent_factorize",
    "stack_ctsf",
    # solves
    "solve",
    "solve_many",
    "solve_many_batched",
    "forward_solve",
    "forward_solve_many",
    "backward_solve",
    "backward_solve_many",
    "concurrent_solve",
    "concurrent_quadratic_forms",
    "logdet",
    "concurrent_logdet",
    "sample_gmrf",
    "sample_gmrf_many",
    # selected inversion
    "SelectedInverse",
    "selected_inverse",
    "selinv_batched",
    "concurrent_selinv",
    "marginal_variances",
    # per-element status codes on FactorInfo
    "STATUS_OK",
    "STATUS_RECOVERED",
    "STATUS_FAILED",
    "STATUS_SHED",
    # serving
    "RungServer",
    "SimClock",
]

"""sTiles core on PyTorch: structure, tile storage, the task-list and window
factorizations of banded-arrowhead SPD matrices (with the Alg. 3 tree
reduction, the partition plan of the partitioned sweep, the legacy window
sweep, the batched θ-sweep factorization and breakdown recovery by
diagonal jitter), and the solves, sampling, marginal variances and
selected inverse read off the factor, one factor or a θ-batch of them;
canonical-grid bucketing of mixed problem sizes (``GridBucketPolicy``,
``SolverOptions(policy=)``) and the concurrent entry points of a stacked
batch, sharded over a mesh axis with ``mesh=``; ``core/distributed.py``
factorizes one block-separable matrix across the ranks of a mesh axis.

Every entry point takes its data positionally and its options by keyword
only (``factorize_window(m, options=...)``, ``sample_gmrf_many(f, num=8,
generator=g)``): a call written with the JAX package's positional ``impl``
or ``method`` raises ``TypeError``."""
from .structure import (ArrowheadStructure, TileGrid, measure_arrowhead,
                        tile_pattern_from_coo, banded_arrowhead_tile_pattern)
from .symbolic import SymbolicFactorization, Task, TaskType, symbolic_factorize
from .ordering import (OrderingResult, PartitionPlan, adaptive_nd_ordering,
                       detect_partition_plan, partition_plan_from_ordering)
from .ctsf import BandedCTSF, TileMatrix
from .robustness import (STATUS_FAILED, STATUS_OK, STATUS_RECOVERED, STATUS_SHED, FactorInfo,
                         RegularizePolicy)
from .options import SolverOptions, resolve_options
from .tree_reduction import chunked_tree_sum, should_use_tree, tree_combine
from .cholesky import (CholeskyFactor, factorize_tasklist, factorize_window,
                       factorize_window_batched)
from .solve import (backward_solve, backward_solve_many, forward_solve,
                    forward_solve_many, logdet, marginal_variances, sample_gmrf,
                    sample_gmrf_many, solve, solve_many, solve_many_batched)
from .selinv import SelectedInverse, selected_inverse, selinv_batched
from .concurrent import concurrent_factorize, concurrent_selinv
from .gridpolicy import (GridBucketPolicy, assemble_rung_batch, assemble_rung_rhs, embed_ctsf,
                         embed_rhs, padded_flop_overhead, restrict_factor, restrict_rhs,
                         restrict_selinv)

__all__ = [
    "ArrowheadStructure", "TileGrid", "measure_arrowhead",
    "tile_pattern_from_coo", "banded_arrowhead_tile_pattern",
    "SymbolicFactorization", "Task", "TaskType", "symbolic_factorize",
    "OrderingResult", "PartitionPlan", "adaptive_nd_ordering", "detect_partition_plan",
    "partition_plan_from_ordering",
    "BandedCTSF", "TileMatrix", "SolverOptions", "resolve_options",
    "STATUS_OK", "STATUS_RECOVERED", "STATUS_FAILED", "STATUS_SHED",
    "RegularizePolicy", "FactorInfo",
    "should_use_tree", "tree_combine", "chunked_tree_sum",
    "CholeskyFactor", "factorize_tasklist", "factorize_window", "factorize_window_batched",
    "logdet",
    "forward_solve", "forward_solve_many", "backward_solve", "backward_solve_many",
    "solve", "solve_many", "solve_many_batched", "sample_gmrf", "sample_gmrf_many",
    "marginal_variances", "SelectedInverse", "selected_inverse", "selinv_batched",
    "concurrent_factorize", "concurrent_selinv",
    "GridBucketPolicy", "assemble_rung_batch", "assemble_rung_rhs",
    "embed_ctsf", "embed_rhs", "padded_flop_overhead",
    "restrict_factor", "restrict_rhs", "restrict_selinv",
]

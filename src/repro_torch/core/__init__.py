"""sTiles core on PyTorch: structure, tile storage, the window
factorization of banded-arrowhead SPD matrices, and the solves, sampling,
marginal variances and selected inverse read off the factor."""
from .structure import (ArrowheadStructure, TileGrid, measure_arrowhead,
                        tile_pattern_from_coo, banded_arrowhead_tile_pattern)
from .symbolic import SymbolicFactorization, Task, TaskType, symbolic_factorize
from .ctsf import BandedCTSF
from .options import SolverOptions
from .cholesky import CholeskyFactor, factorize_window
from .solve import (backward_solve, backward_solve_many, forward_solve,
                    forward_solve_many, logdet, marginal_variances, sample_gmrf,
                    sample_gmrf_many, solve, solve_many)
from .selinv import SelectedInverse, selected_inverse

__all__ = [
    "ArrowheadStructure", "TileGrid", "measure_arrowhead",
    "tile_pattern_from_coo", "banded_arrowhead_tile_pattern",
    "SymbolicFactorization", "Task", "TaskType", "symbolic_factorize",
    "BandedCTSF", "SolverOptions",
    "CholeskyFactor", "factorize_window", "logdet",
    "forward_solve", "forward_solve_many", "backward_solve", "backward_solve_many",
    "solve", "solve_many", "sample_gmrf", "sample_gmrf_many", "marginal_variances",
    "SelectedInverse", "selected_inverse",
]

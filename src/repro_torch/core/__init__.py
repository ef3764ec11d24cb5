"""sTiles core on PyTorch: structure, tile storage and the window
factorization of banded-arrowhead SPD matrices."""
from .structure import (ArrowheadStructure, TileGrid, measure_arrowhead,
                        tile_pattern_from_coo, banded_arrowhead_tile_pattern)
from .symbolic import SymbolicFactorization, Task, TaskType, symbolic_factorize
from .ctsf import BandedCTSF
from .options import SolverOptions
from .cholesky import CholeskyFactor, factorize_window
from .solve import logdet

__all__ = [
    "ArrowheadStructure", "TileGrid", "measure_arrowhead",
    "tile_pattern_from_coo", "banded_arrowhead_tile_pattern",
    "SymbolicFactorization", "Task", "TaskType", "symbolic_factorize",
    "BandedCTSF", "SolverOptions",
    "CholeskyFactor", "factorize_window", "logdet",
]

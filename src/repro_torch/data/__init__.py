from .gmrf import (TABLE2, ar1_precision, kronecker_st_precision,
                   lattice_precision, make_arrowhead, table2_matrix)
from .synthetic import (block_separable_arrowhead, indefinite_arrowhead,
                        nan_contaminated_arrowhead, near_singular_arrowhead, request_stream,
                        token_batch, MarkovStream)

__all__ = ["TABLE2", "ar1_precision", "kronecker_st_precision",
           "lattice_precision", "make_arrowhead", "table2_matrix",
           "block_separable_arrowhead", "indefinite_arrowhead",
           "near_singular_arrowhead", "nan_contaminated_arrowhead",
           "request_stream", "token_batch", "MarkovStream"]

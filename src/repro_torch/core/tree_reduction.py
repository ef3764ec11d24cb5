"""Tree reduction of accumulation chains (paper §IV-A, Algorithm 3).

The left-looking factorization accumulates k GEMM/SYRK products into one
tile; summed one after another that chain is the critical path (paper
Table I: time grows linearly in k).  Algorithm 3 splits the products into
per-worker chunks, sums each chunk locally, and combines the partial tiles
with a binary GEADD tree (Figs. 6-7).  Here the chunk partials are one
batched sum and each level of the tree is one ``ops.geadd`` over all of its
pairs, so a tree over c partials is ``ceil(log2 c)`` geadd launches.

The paper's enablement heuristic is kept verbatim: use the tree only when
the number of accumulations is at least twice the number of workers.

Port of the JAX package's ``core/tree_reduction.py``; ``impl`` picks the
geadd backend, as every other kernel call of the port takes it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

__all__ = ["should_use_tree", "tree_combine", "chunked_tree_sum"]


def should_use_tree(n_accumulations: int, n_workers: int) -> bool:
    """Paper §IV-A: 'at least 2 cores, and ... accumulations at least double
    the number of cores being used'."""
    return n_workers >= 2 and n_accumulations >= 2 * n_workers


def tree_combine(partials: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
    """Binary-tree pairwise combine over the leading axis (log2 depth):
    ``partials (c, ...)`` -> their sum in the tree's association order, the
    paper's GEADD hierarchy, one ``ops.geadd`` on ``impl`` a level."""
    while partials.shape[0] > 1:
        c = partials.shape[0]
        half = c // 2
        combined = ops.geadd(partials[0:2 * half:2], partials[1:2 * half:2], impl=impl)
        if c % 2:
            combined = torch.cat([combined, partials[-1:]])
        partials = combined
    return partials[0]


def chunked_tree_sum(terms: torch.Tensor, n_chunks: int,
                     impl: Optional[str] = None) -> torch.Tensor:
    """Sum ``terms (K, ...)`` over its first axis by Algorithm 3: K products
    in ``n_chunks`` contiguous ranges (the paper's ``start_range/end_range``
    per worker), each summed in one go, and the partials combined by
    :func:`tree_combine`.  Equal to ``terms.sum(0)`` up to reassociation."""
    k = terms.shape[0]
    n_chunks = max(1, min(n_chunks, k))
    pad = (-k) % n_chunks
    if pad:
        terms = torch.cat([terms, terms.new_zeros((pad,) + tuple(terms.shape[1:]))])
    per = terms.shape[0] // n_chunks
    partials = terms.reshape((n_chunks, per) + tuple(terms.shape[1:])).sum(dim=1)
    return tree_combine(partials, impl=impl)

"""The launch plan of the tile-sum kernels, ``csrc/tile_sum.cuh``.

``selinv_step`` and ``band_update`` each compute a short sum of tile
products into a few target tiles, ``u[e] = sum_{q < n_e} A(e, q) op(B(e,
q))``.  Their kernels spread one launch over the card's SMs by a plan that
:func:`tile_sum_plan` works out here and the C entry points receive:

- each ``t x t`` target is split into ``sub x sub`` sub-tiles, ``sub =
  min(t, 32)``, each its own block;
- the pairs of one sub-tile go to a thread-block cluster of ``cluster =
  min(max_e n_e, max_cluster)`` blocks (at least 1); rank ``r`` takes the
  contiguous run ``q = r * per_rank .. min((r + 1) * per_rank, n_e) - 1``
  in order, ``per_rank = ceil(max_e n_e / cluster)``, which is empty for a
  rank past the target's pairs;
- rank 0 adds the ranks' partials in rank order and stores the tile.

:meth:`TileSumPlan.pairs` is the run the kernel computes for a rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

__all__ = ["TileSumPlan", "tile_sum_plan", "MAX_CLUSTER"]

MAX_CLUSTER = 4     # blocks a cluster; the card allows up to 8 portably
SUB = 32            # the largest sub-tile edge


@dataclass(frozen=True)
class TileSumPlan:
    t: int
    sub: int            # sub-tile edge
    cluster: int        # blocks a cluster, the ranks sharing a sub-tile's pairs
    per_rank: int       # pairs a rank
    grid: Tuple[int, ...]   # (cluster * sub-tiles, targets[, batch])

    @property
    def subtiles(self) -> int:
        """Sub-tiles of one target."""
        return (self.t // self.sub) ** 2

    @property
    def blocks(self) -> int:
        n = 1
        for g in self.grid:
            n *= g
        return n

    def pairs(self, rank: int, n: int) -> range:
        """The pairs rank ``rank`` of a cluster sums for a target with ``n``
        pairs, in order."""
        lo = min(rank * self.per_rank, n)
        return range(lo, min(lo + self.per_rank, n))


def tile_sum_plan(t: int, pairs: Sequence[int], batch: int = 0,
                  max_cluster: int = MAX_CLUSTER) -> TileSumPlan:
    """The plan for targets with ``pairs[e]`` products each, ``t x t``
    tiles, and a batch axis of ``batch`` elements where ``batch > 0``
    (``band_update``'s third grid axis).  ``max_cluster`` caps the cluster
    (1: no contraction split)."""
    if not pairs or min(pairs) < 0 or max_cluster < 1:
        raise ValueError(f"tile_sum_plan: want targets with pair counts >= 0 and a cluster "
                         f"of at least 1, got {list(pairs)} and {max_cluster}")
    sub = min(t, SUB)
    longest = max(pairs)
    cluster = max(1, min(longest, max_cluster))
    per_rank = max(1, -(-longest // cluster))
    grid = (cluster * (t // sub) ** 2, len(pairs)) + ((batch,) if batch else ())
    return TileSumPlan(t=t, sub=sub, cluster=cluster, per_rank=per_rank, grid=grid)

"""Symbolic factorization and static task-list generation (paper §II, §III-C).

Given a tile-level nonzero pattern, this module:

  1. computes the tile pattern of the Cholesky factor L (symbolic
     factorization — "identifies where the nonzero elements will be located,
     allowing for the allocation of storage for L");
  2. emits the exact task list of Algorithm 1 (left-looking sparse tile
     Cholesky) restricted to nonzero tiles — POTRF / SYRK / TRSM / GEMM
     with their {m, n, k} triples, in a valid left-looking order.

The task list plays the role of the paper's per-thread Task Assignment
Tables (Algorithm 2): it is fixed before any numerical work.  In the JAX
port the list is unrolled at trace time and XLA's static scheduler replaces
the progress table (DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Tuple

import numpy as np

__all__ = ["TaskType", "Task", "SymbolicFactorization", "symbolic_factorize"]


class TaskType(enum.IntEnum):
    POTRF = 1
    SYRK = 2
    TRSM = 3
    GEMM = 4


@dataclasses.dataclass(frozen=True)
class Task:
    """One tile task. Semantics (lower-triangular storage, Alg. 1):

      POTRF: A[k,k]  <- chol(A[k,k])
      SYRK:  A[k,k]  <- A[k,k] - A[k,n] A[k,n]^T          (n < k)
      TRSM:  A[m,k]  <- A[m,k] A[k,k]^{-T}                (m > k)
      GEMM:  A[m,k]  <- A[m,k] - A[m,n] A[k,n]^T          (n < k < m)
    """
    type: TaskType
    k: int
    m: int = -1
    n: int = -1


@dataclasses.dataclass
class SymbolicFactorization:
    n_tiles: int
    a_pattern: np.ndarray          # (nt, nt) bool, lower, input tiles
    l_pattern: np.ndarray          # (nt, nt) bool, lower, factor tiles (incl. fill)
    tasks: List[Task]
    fill_tiles: int

    # --- cost model (used by benchmarks + roofline) -------------------------
    def flops(self, t: int) -> dict:
        """FLOP count per kernel type for tile size t (dense tile kernels)."""
        c = {TaskType.POTRF: 0, TaskType.SYRK: 0, TaskType.TRSM: 0, TaskType.GEMM: 0}
        for task in self.tasks:
            c[task.type] += 1
        return {
            "POTRF": c[TaskType.POTRF] * t ** 3 / 3.0,
            "SYRK": c[TaskType.SYRK] * t ** 3,
            "TRSM": c[TaskType.TRSM] * t ** 3,
            "GEMM": c[TaskType.GEMM] * 2.0 * t ** 3,
        }

    def total_flops(self, t: int) -> float:
        return float(sum(self.flops(t).values()))

    def accumulation_counts(self) -> np.ndarray:
        """Number of GEMM/SYRK accumulations per destination tile.

        This is the quantity the paper's tree-reduction heuristic consumes
        ("number of accumulations at least double the number of cores").
        """
        acc = np.zeros((self.n_tiles, self.n_tiles), dtype=np.int64)
        for task in self.tasks:
            if task.type == TaskType.SYRK:
                acc[task.k, task.k] += 1
            elif task.type == TaskType.GEMM:
                acc[task.m, task.k] += 1
        return acc

    def critical_path_length(self) -> int:
        """Length of the longest dependency chain in the task DAG (Fig. 2).

        Dependencies follow Algorithm 2's progress-table semantics.
        """
        depth: dict = {}

        def tile_ready(t):
            return depth.get(t, 0)

        for task in self.tasks:
            if task.type == TaskType.POTRF:
                d = tile_ready((task.k, task.k)) + 1
                depth[(task.k, task.k)] = d
            elif task.type == TaskType.SYRK:
                d = max(tile_ready((task.k, task.k)), tile_ready((task.k, task.n))) + 1
                depth[(task.k, task.k)] = d
            elif task.type == TaskType.TRSM:
                d = max(tile_ready((task.m, task.k)), tile_ready((task.k, task.k))) + 1
                depth[(task.m, task.k)] = d
            else:  # GEMM
                d = max(tile_ready((task.m, task.k)), tile_ready((task.m, task.n)),
                        tile_ready((task.k, task.n))) + 1
                depth[(task.m, task.k)] = d
        return max(depth.values()) if depth else 0

    def max_parallelism(self) -> int:
        """Max number of tasks at equal DAG depth (width of Fig. 2's DAG)."""
        depth: dict = {}
        level_count: dict = {}

        def tile_ready(t):
            return depth.get(t, 0)

        for task in self.tasks:
            if task.type == TaskType.POTRF:
                d = tile_ready((task.k, task.k)) + 1
                depth[(task.k, task.k)] = d
            elif task.type == TaskType.SYRK:
                d = max(tile_ready((task.k, task.k)), tile_ready((task.k, task.n))) + 1
                depth[(task.k, task.k)] = d
            elif task.type == TaskType.TRSM:
                d = max(tile_ready((task.m, task.k)), tile_ready((task.k, task.k))) + 1
                depth[(task.m, task.k)] = d
            else:
                d = max(tile_ready((task.m, task.k)), tile_ready((task.m, task.n)),
                        tile_ready((task.k, task.n))) + 1
                depth[(task.m, task.k)] = d
            level_count[d] = level_count.get(d, 0) + 1
        return max(level_count.values()) if level_count else 0


def symbolic_factorize(a_pattern: np.ndarray) -> SymbolicFactorization:
    """Tile symbolic factorization + Algorithm 1 task list.

    ``a_pattern`` is the boolean lower-triangular tile map (from
    :func:`repro.core.structure.tile_pattern_from_coo`).
    """
    nt = a_pattern.shape[0]
    a_pattern = np.tril(a_pattern.astype(bool))

    # ----- symbolic elimination: column pattern propagation -----------------
    cols: List[set] = [set(np.nonzero(a_pattern[:, k])[0]) for k in range(nt)]
    for k in range(nt):
        cols[k].add(k)
        below = sorted(x for x in cols[k] if x > k)
        if below:
            parent = below[0]
            cols[parent].update(x for x in below if x > parent)

    l_pattern = np.zeros_like(a_pattern)
    for k in range(nt):
        for r in cols[k]:
            if r >= k:
                l_pattern[r, k] = True

    # neighbors(k): m such that L[m,k] nonzero, m > k (paper's definition on
    # the *filled* pattern — updates flow through fill tiles too).
    nbr_below = [sorted(np.nonzero(l_pattern[:, k])[0][np.nonzero(l_pattern[:, k])[0] > k])
                 for k in range(nt)]
    nbr_left = [sorted(np.nonzero(l_pattern[k, :])[0][np.nonzero(l_pattern[k, :])[0] < k])
                for k in range(nt)]

    # ----- Algorithm 1 (left-looking), restricted to nonzero tiles ----------
    tasks: List[Task] = []
    for k in range(nt):
        for n in nbr_left[k]:                       # SYRK accumulations
            tasks.append(Task(TaskType.SYRK, k=k, n=n))
        tasks.append(Task(TaskType.POTRF, k=k))
        for m in nbr_below[k]:
            # GEMM accumulations: n in neighbors(k) ∩ neighbors(m), n < k
            common = set(nbr_left[k]).intersection(nbr_left[m])
            for n in sorted(common):
                tasks.append(Task(TaskType.GEMM, k=k, m=m, n=n))
            tasks.append(Task(TaskType.TRSM, k=k, m=m))

    fill = int(l_pattern.sum() - a_pattern.sum())
    return SymbolicFactorization(nt, a_pattern, l_pattern, tasks, fill)

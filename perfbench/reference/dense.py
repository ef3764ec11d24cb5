"""The plain reference: each candidate ``τ A + δ I`` rebuilt as a dense
float64 matrix from the scipy base matrix ``A``, factored by
``torch.linalg.cholesky``; its log-determinant, solutions and marginal
variances (the diagonal of the inverse, through ``L^{-1}``) in float64.

``Control`` is the same computation put in the program's place one
precision lower than the configuration's float32: a blocked float32
Cholesky whose trailing updates are TF32 matrix products, the step that
would tempt a faster tile product.  It has to fail the comparison."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["DenseReference", "Control"]


class DenseReference:
    """``A`` (scipy, ``n x n``) dense on ``device`` in ``dtype``."""

    dtype = torch.float64

    def __init__(self, A, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.A = torch.as_tensor(A.toarray(), dtype=self.dtype, device=self.device)
        self.n = self.A.shape[0]

    def factor(self, tau: float, delta: float) -> torch.Tensor:
        """The lower Cholesky factor of ``tau A + delta I``."""
        M = self.A * float(tau)
        M.diagonal().add_(float(delta))
        return torch.linalg.cholesky(M)

    @staticmethod
    def logdet(L: torch.Tensor) -> float:
        return float(2.0 * torch.log(torch.diagonal(L)).sum())

    def solve(self, L: torch.Tensor, b) -> np.ndarray:
        """``(n, k)`` solutions of ``L L^T x = b``."""
        b = torch.as_tensor(np.asarray(b), dtype=L.dtype, device=L.device)
        y = torch.linalg.solve_triangular(L, b, upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True).double().cpu().numpy()

    def variances(self, L: torch.Tensor, block: int = 2048) -> np.ndarray:
        """``diag((L L^T)^{-1})``: column sums of squares of ``L^{-1}``,
        a block of its columns at a time."""
        out = torch.empty(self.n, dtype=torch.float64, device=L.device)
        for j0 in range(0, self.n, block):
            j1 = min(self.n, j0 + block)
            # columns j0:j1 of L^{-1} are zero above row j0
            e = torch.zeros((self.n - j0, j1 - j0), dtype=L.dtype, device=L.device)
            e[:j1 - j0] = torch.eye(j1 - j0, dtype=L.dtype, device=L.device)
            w = torch.linalg.solve_triangular(L[j0:, j0:], e, upper=False)
            out[j0:j1] = (w * w).sum(0)
        return out.cpu().numpy()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32, 10 bits of mantissa, to nearest with
    ties away from zero as the card's conversion does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Control(DenseReference):
    """The reference in float32 with the factorization's trailing updates
    as TF32 products: operands rounded to TF32, products summed in float32,
    the same on the card and on the CPU."""

    dtype = torch.float32
    block = 256

    def factor(self, tau: float, delta: float) -> torch.Tensor:
        M = self.A * float(tau)
        M.diagonal().add_(float(delta))
        n, nb = self.n, self.block
        for k0 in range(0, n, nb):
            k1 = min(n, k0 + nb)
            M[k0:k1, k0:k1] = torch.linalg.cholesky(M[k0:k1, k0:k1])
            if k1 < n:
                P = torch.linalg.solve_triangular(M[k0:k1, k0:k1], M[k1:, k0:k1].mT,
                                                  upper=False).mT
                M[k1:, k0:k1] = P
                Q = tf32(P)
                M[k1:, k1:] -= Q @ Q.mT
        return torch.tril(M)

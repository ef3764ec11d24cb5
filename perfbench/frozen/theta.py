"""The INLA θ-candidate arithmetic, frozen from ``chip_smoke.py``
(``theta_batch``, ``theta_rhs``): a candidate of the base precision ``A``
is ``τ A + δ I`` with τ in [0.5, 2) and δ in [0, 0.5) (the traffic file
gives the ranges), built on the card from the base matrix's tile arrays,
with the padding diagonal left at 1 so it stays decoupled; its right-hand
sides are seeded normal panels, zero on the padding rows.

``Layout`` is the padded row layout of a banded-arrowhead matrix of tile
size ``t``, worked out from ``n``, ``arrow`` and ``t`` alone: the band rows
``[0, n - arrow)`` first, padded to whole tiles, then the arrow rows,
padded the same way."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Layout", "Candidates", "theta_draws", "stream_seed"]


@dataclasses.dataclass(frozen=True)
class Layout:
    n: int
    arrow: int
    t: int

    @property
    def n_diag(self) -> int:
        return self.n - self.arrow

    @property
    def ndt(self) -> int:
        return -(-self.n_diag // self.t)

    @property
    def nat(self) -> int:
        return -(-self.arrow // self.t)

    @property
    def padded_n(self) -> int:
        return (self.ndt + self.nat) * self.t

    def rows(self) -> np.ndarray:
        """The padded row of each of the ``n`` rows of the matrix."""
        i = np.arange(self.n)
        return np.where(i < self.n_diag, i, self.ndt * self.t + (i - self.n_diag))

    def padding(self) -> np.ndarray:
        """The padded rows that hold no row of the matrix."""
        return np.setdiff1d(np.arange(self.padded_n), self.rows())


def stream_seed(*words: int) -> int:
    """A 63-bit seed from a run's seed and a stream's words."""
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def theta_draws(seed: int, step: int, batch: int, tau_range, delta_range):
    """``(tau, delta)``, ``batch`` draws each for step ``step`` of a run."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 11, int(step)]))
    return rng.uniform(*tau_range, batch), rng.uniform(*delta_range, batch)


class Candidates:
    """Builds candidates and right-hand sides of one base matrix on its
    device, the padding's indices and the tile identity made once."""

    def __init__(self, layout: Layout, device):
        self.layout, self.device = layout, torch.device(device)
        t, ndt_t = layout.t, layout.ndt * layout.t
        pad = torch.as_tensor(layout.padding(), device=self.device)
        band, arrow = pad[pad < ndt_t], pad[pad >= ndt_t] - ndt_t
        self.band = (band // t, band % t)
        self.arrow = (arrow // t, arrow % t)
        self.pad = pad
        self.eye = torch.eye(t, device=self.device)

    def make(self, Dr, R, C, tau, delta):
        """The tile arrays ``(Dr, R, C)`` of the candidates ``τ_i A + δ_i
        I``, with a leading batch axis, from the base matrix's arrays (``Dr
        (ndt, bt+1, t, t)`` band rows, the diagonal tile at ``[:, 0]``; ``R
        (ndt, nat, t, t)``; ``C (nat, nat, t, t)``)."""
        if len(tau) == 1:
            scale, di = float(tau[0]), (float(delta[0]) * self.eye)[None]
            Dr_b, R_b, C_b = (scale * x[None] for x in (Dr, R, C))
        else:
            td = torch.tensor(np.stack([tau, delta]), dtype=torch.float32).to(self.device)
            scale = td[0][:, None, None, None, None]
            di = td[1][:, None, None] * self.eye
            Dr_b, R_b, C_b = scale * Dr, scale * R, scale * C
        Dr_b[:, :, 0] += di[:, None]
        for i in range(self.layout.nat):
            C_b[:, i, i] += di
        # τ and δ scale the matrix, not its padding: its diagonal stays 1
        (bt, br), (at, ar) = self.band, self.arrow
        Dr_b[:, bt, 0, br, br] = 1.0
        C_b[:, at, at, ar, ar] = 1.0
        return Dr_b, R_b, C_b

    def rhs(self, batch: int, k: int, seed: int) -> torch.Tensor:
        """Seeded ``(batch, padded_n, k)`` right-hand sides, zero on the
        padding rows."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        B = torch.randn((batch, self.layout.padded_n, k), generator=gen, device=self.device)
        B[:, self.pad] = 0.0
        return B


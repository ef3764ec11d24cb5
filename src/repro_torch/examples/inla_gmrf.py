"""INLA-style Bayesian inference — the paper's driving application.

The twin of the JAX package's ``examples/inla_gmrf.py``.  Spatio-temporal
GMRF with fixed effects:

    y = X beta + u + eps,   u ~ N(0, K(theta)^{-1}),  K = Q_t(rho) (x) ... (x) Q_s

The joint latent precision Q(theta) is the paper's block-arrowhead pattern
(Fig. 1): banded latent block + dense fixed-effect arrow.  Each objective
evaluation needs a Cholesky factorization (logdet + solve), and the
central-difference gradient over the hyperparameters theta needs 2·dim
*independent* factorizations, run as one batched call:

* **Factorization** — all 2·dim+1 θ probes in one
  ``factorize_window_batched`` call (one fused band-Cholesky sweep for the
  batch on the card);
* **Quadratic forms** — ``y^T Q^{-1} y`` per probe as ‖L_i^{-1} y‖², one
  batched forward sweep (``concurrent_quadratic_forms``);
* **Posterior marginals** — variances and neighbour covariances at the
  fitted θ from one ``selected_inverse`` call;
* **Posterior sampling** — ``sample_gmrf_many`` draws a panel of GMRF
  realizations through one backward sweep.

On the card unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.inla_gmrf [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import scipy.sparse as sp
import torch

from repro_torch.api import (ArrowheadStructure, BandedCTSF, CholeskyFactor, TileGrid,
                             concurrent_logdet, concurrent_quadratic_forms,
                             factorize_window_batched, sample_gmrf_many, selected_inverse,
                             stack_ctsf)
from repro_torch.core.ctsf import resolve_device
from repro_torch.data.gmrf import ar1_precision, lattice_precision

NS = 48   # spatial lattice side — also the temporal-neighbour lag below
NT = 32


def build_precision(theta, nt=NT, ns=NS, n_fixed=16, seed=0):
    """Q(theta) for theta = (log tau_t, logit rho, log tau_s)."""
    ltau_t, lrho, ltau_s = theta
    rho = float(np.tanh(lrho))
    qt = ar1_precision(nt, rho=rho, tau=float(np.exp(ltau_t)))
    qs = lattice_precision(ns, coupling=0.4, tau=float(np.exp(ltau_s)))
    k = sp.kron(qt, sp.eye(ns)) + sp.kron(sp.eye(nt), qs)
    nd = nt * ns
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nd, n_fixed)) * (0.5 / np.sqrt(nd))
    c = float((x ** 2).sum() / 1e-3 + 1.0)
    q = sp.bmat([[k, sp.csc_matrix(x)],
                 [sp.csc_matrix(x.T), sp.csc_matrix(np.eye(n_fixed) * c)]],
                format="csc")
    struct = ArrowheadStructure(n=nd + n_fixed, bandwidth=ns, arrow=n_fixed)
    return sp.csc_matrix(q), struct


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def objective_terms(thetas, grid, y, nt=NT, ns=NS):
    """Batched objective: -logdet(Q)/2 + y^T Q^{-1} y / 2 for each theta.

    One batched factorization covers every probe and the quadratic forms
    ride one batched forward sweep, on the device of ``y``.  Returns
    ``(objective (numpy), factor, seconds)``, the seconds those two calls
    took (host clock, synchronized)."""
    mats = [BandedCTSF.from_sparse(build_precision(th, nt, ns)[0], grid, device=y.device)
            for th in thetas]
    batch = stack_ctsf(mats)
    t0 = time.perf_counter()
    factor = factorize_window_batched(batch)        # Appendix A workload
    lds = concurrent_logdet(factor)
    quads = concurrent_quadratic_forms(factor, y)
    _sync(y.device)
    dt = time.perf_counter() - t0
    obj = -0.5 * lds.cpu().numpy() + 0.5 * quads.cpu().numpy()
    return obj, factor, dt


def main(argv=None, nt: int = NT, ns: int = NS, iters: int = 5):
    """Fit θ by 5 central-difference steps, then the posterior summaries.
    Returns the objective at each iteration's θ (``objective``), the fitted
    θ, the marginal sd range, the temporal-neighbour correlations and the
    draws' shape."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda:0)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    theta = np.array([0.0, 0.5, 0.0])
    Q0, struct = build_precision(theta, nt, ns)
    grid = TileGrid(struct, t=16)
    rng = np.random.default_rng(1)
    y = torch.as_tensor(rng.standard_normal(grid.padded_n) * 0.1,
                        dtype=torch.float32).to(dev)

    print(f"latent dim {struct.n_diag} + {struct.arrow} fixed effects; "
          f"bandwidth {struct.bandwidth}")
    h, lr = 0.05, 0.1
    objective, seconds = [], []
    for it in range(iters):
        # central differences: 2*dim(theta) independent factorizations + f(x)
        probes = [theta]
        for d in range(3):
            for s in (+h, -h):
                tp = theta.copy()
                tp[d] += s
                probes.append(tp)
        vals, _, dt = objective_terms(probes, grid, y, nt, ns)
        grad = np.array([(vals[1 + 2 * d] - vals[2 + 2 * d]) / (2 * h)
                         for d in range(3)])
        theta = theta - lr * grad / max(1.0, np.abs(grad).max())
        objective.append(float(vals[0]))
        seconds.append(dt)
        print(f"iter {it}: f={vals[0]:.2f} |grad|={np.abs(grad).max():.3f} "
              f"theta={np.round(theta, 3).tolist()} "
              f"({len(probes)} factorizations in {dt*1e3:.0f} ms)")

    # --- posterior summaries at the fitted theta (one selinv sweep) --------
    Qf, _ = build_precision(theta, nt, ns)
    fb = factorize_window_batched([BandedCTSF.from_sparse(Qf, grid, device=dev)])
    ctsf = fb.ctsf
    fitted = CholeskyFactor(BandedCTSF(grid, ctsf.Dr[0], ctsf.R[0], ctsf.C[0]))
    t0 = time.perf_counter()
    sigma = selected_inverse(fitted)        # one backward Takahashi sweep
    samples = sample_gmrf_many(fitted, num=32,
                               generator=torch.Generator(device=dev).manual_seed(0))
    _sync(dev)
    dt = time.perf_counter() - t0

    var = sigma.diagonal().cpu().numpy()    # every latent + fixed effect
    sd = np.sqrt(var[:struct.n_diag])
    # temporal neighbour correlations (lag = ns): same Σ block, no extra work
    pairs = np.linspace(0, struct.n_diag - 1 - ns, 8).astype(np.int64)
    corr = np.array([float(sigma.covariance(int(i), int(i + ns)))
                     / np.sqrt(var[i] * var[i + ns]) for i in pairs])
    print(f"posterior marginal sd range [{sd.min():.4f}, {sd.max():.4f}] "
          f"over all {struct.n_diag} latents; temporal-neighbour corr range "
          f"[{corr.min():.3f}, {corr.max():.3f}]; {samples.shape[1]} "
          f"posterior samples — one selinv sweep + one blocked backward "
          f"sweep, {dt*1e3:.0f} ms total")
    print("done — hyperparameters fitted with batched sTiles factorizations")
    return dict(device=str(dev), objective=objective, seconds=seconds,
                theta=theta.tolist(), sd_min=float(sd.min()), sd_max=float(sd.max()),
                corr=corr.tolist(), samples_shape=list(samples.shape),
                samples_finite=bool(torch.isfinite(samples).all()), summary_seconds=dt)


if __name__ == "__main__":
    main()

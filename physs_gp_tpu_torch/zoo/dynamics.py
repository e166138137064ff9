"""Zoo: nonlinear dynamical-system GPs and the dynamic-correlation
volatility model (PyTorch counterpart of `physs_gp_tpu/zoo/dynamics.py`).

The state follows known (or parameterised) nonlinear dynamics, optionally
driven by a GP latent force, observed partially and noisily, and is
inferred by EKF / iterated parallel EKS (`models/ekf_gp.NonlinearSSGP`);
`dynamic_covariance_gp` is a CVI model over Q latent GPs driving a
time-varying correlation matrix. Each recipe builds on `device` (the card
unless the caller asks for the CPU) in `dtype` (float64 by default). The
rate parameters are tensors passed to the drift (not trainable Params, as
in the reference); keyword arguments such as `method="iterated_parallel"`,
`n_iters` and `chunk_size` go on to `NonlinearSSGP`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.markov import StackedMarkov
from ..kernels.matern import Matern32
from ..likelihoods.dynamic_covariance import DynamicCovarianceGaussian
from ..models.cvi_gp import CVIGP
from ..models.ekf_gp import NonlinearSSGP
from ..utils.params import Param, positive_param

__all__ = ["lotka_volterra_gp", "lorenz_gp", "latent_force_gp", "dynamic_covariance_gp"]


def _param(v, **kw):
    return v if isinstance(v, Param) else positive_param(v, **kw)


def _noise(noise, T, p, **kw):
    return (noise**2 * torch.eye(p, **kw)).expand(T, p, p)


def _series(t, y, p, **kw):
    t = torch.as_tensor(np.ravel(t), **kw)
    return t, torch.as_tensor(np.asarray(y), **kw).reshape(t.shape[0], p)


def _lotka_volterra_drift(params, x):
    a, b, d_, g = params
    prey, pred = x[0], x[1]
    return torch.stack([a * prey - b * prey * pred, d_ * prey * pred - g * pred])


def lotka_volterra_gp(t, y_obs, alpha=1.0, beta=0.1, delta=0.075, gamma=1.5, q=0.05,
                      noise=0.1, x0=(10.0, 5.0), dtype=torch.float64, observed="both",
                      n_substeps=4, device="cuda", **kw) -> NonlinearSSGP:
    """Lotka-Volterra predator-prey dynamics with process noise; y_obs [T, 2]
    (NaN = missing) with observed="both", else [T, 1], the prey only."""
    tk = dict(dtype=dtype, device=device)
    p = 2 if observed == "both" else 1
    t, Y = _series(t, y_obs, p, **tk)
    return NonlinearSSGP(
        t=t, Y=Y,
        params=tuple(torch.as_tensor(v, **tk) for v in (alpha, beta, delta, gamma)),
        L=torch.eye(2, **tk), Qc=q * torch.eye(2, **tk), m0=torch.as_tensor(x0, **tk),
        P0=0.5 * torch.eye(2, **tk), R=_noise(noise, t.shape[0], p, **tk),
        drift=_lotka_volterra_drift, obs_fn=lambda params, x: x[:p], n_substeps=n_substeps,
        **kw,
    )


def _lorenz_drift(params, x):
    s, r, b = params
    return torch.stack([s * (x[1] - x[0]), x[0] * (r - x[2]) - x[1], x[0] * x[1] - b * x[2]])


def lorenz_gp(t, y_obs, sigma=10.0, rho=28.0, beta=8.0 / 3.0, q=0.5, noise=1.0,
              x0=(1.0, 1.0, 1.0), dtype=torch.float64, n_substeps=8, device="cuda",
              **kw) -> NonlinearSSGP:
    """Lorenz-63 state estimation from its first coordinate, y_obs [T]."""
    tk = dict(dtype=dtype, device=device)
    t, Y = _series(t, y_obs, 1, **tk)
    return NonlinearSSGP(
        t=t, Y=Y, params=tuple(torch.as_tensor(v, **tk) for v in (sigma, rho, beta)),
        L=torch.eye(3, **tk), Qc=q * torch.eye(3, **tk), m0=torch.as_tensor(x0, **tk),
        P0=torch.eye(3, **tk), R=_noise(noise, t.shape[0], 1, **tk),
        drift=_lorenz_drift, obs_fn=lambda params, x: x[:1], n_substeps=n_substeps, **kw,
    )


def _latent_force_drift(params, x):
    damp, lam = params
    return torch.stack([-damp * x[0] + x[1], -lam * x[1]])


def latent_force_gp(t, y_obs, force_lengthscale=1.0, force_variance=1.0, damping=1.0,
                    noise=0.1, dtype=torch.float64, n_substeps=2, device="cuda",
                    **kw) -> NonlinearSSGP:
    """First-order latent force model x' = -damping x + u(t), u a Matérn-1/2
    GP in the joint state, inferred alongside x from y_obs [T]."""
    tk = dict(dtype=dtype, device=device)
    t, Y = _series(t, y_obs, 1, **tk)
    lam = 1.0 / force_lengthscale
    return NonlinearSSGP(
        t=t, Y=Y, params=(torch.as_tensor(damping, **tk), torch.as_tensor(lam, **tk)),
        L=torch.as_tensor([[0.0], [1.0]], **tk),
        Qc=torch.as_tensor([[2.0 * force_variance * lam]], **tk), m0=torch.zeros(2, **tk),
        P0=torch.diag(torch.as_tensor([1.0, force_variance], **tk)),
        R=_noise(noise, t.shape[0], 1, **tk), drift=_latent_force_drift,
        obs_fn=lambda params, x: x[:1], n_substeps=n_substeps, **kw,
    )


def dynamic_covariance_gp(t, Y, k_latent=None, variances=None, n_mc: int = 32,
                          dtype=torch.float64, parallel: bool = False, chunk_size=None,
                          device="cuda") -> CVIGP:
    """Dynamic-correlation multivariate volatility model: Y [T, P], y_t ~
    N(0, D C(t) D), C(t) driven by Q = P(P−1)/2 independent latent
    state-space GPs through the partial-correlation map; the variances (D²)
    are static trainable Params. `k_latent` is a kernel factory called once
    per latent, or a list of Q kernels (default Matérn-3/2, lengthscale 1,
    variance 0.5). Returns a CVIGP over the Q latent heads; read the fitted
    path with `model.likelihood.correlation_path(model.posterior().mean)`."""
    tk = dict(dtype=dtype, device=device)
    t = torch.as_tensor(np.ravel(t), **tk)
    Y = torch.as_tensor(np.asarray(Y), **tk)
    T, P = Y.shape
    Q = P * (P - 1) // 2
    if k_latent is None or callable(k_latent):
        parts = [k_latent() if callable(k_latent) else Matern32(lengthscale=1.0, variance=0.5, **tk)
                 for _ in range(Q)]
    else:
        parts = list(k_latent)
    lik = DynamicCovarianceGaussian(
        y=Y, variances=[_param(v, **tk) for v in (variances or [1.0] * P)], n_mc=n_mc,
    )
    return CVIGP.init(t=t, Y=torch.full((T, Q), float("nan"), **tk), kernel=StackedMarkov(parts),
                      likelihood=lik, parallel=parallel, chunk_size=chunk_size)

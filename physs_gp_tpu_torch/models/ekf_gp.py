"""Nonlinear state-space GP by extended Kalman filtering (PyTorch counterpart
of `physs_gp_tpu/models/ekf_gp.py`).

The prior is a nonlinear SDE dx = drift(x) dt + L dW (pendulum, Lorenz,
Lotka-Volterra, latent-force models), observed through a possibly nonlinear
measurement function. `method="ekf"` runs the sequential EKF and extended RTS
smoother, `method="iterated_parallel"` the iterated parallel EKS
(`ops/ekf.py`).

`params` are plain tensors handed to `drift(params, x)` and
`obs_fn(params, x)`, as in the reference, where they are plain arrays and so
not hyperparameter-trainable: `utils.training.trainable_parameters` finds
none here. A params tensor that requires grad gets the gradient of the lml
through the filter (`log_marginal_likelihood().backward()`).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..ops.ekf import NonlinearSSM, ekf_filter, ekf_smoother, iterated_parallel_ekf_smoother
from .ssgp import GaussianMoments

__all__ = ["NonlinearSSGP"]


class NonlinearSSGP(nn.Module):
    """EKF / EKS inference for y_t = obs_fn(x_t) + noise with R [T, p, p]."""

    def __init__(self, t, Y, params, L, Qc, m0, P0, R, drift: Callable, obs_fn: Callable,
                 n_substeps: int = 1, method: str = "ekf", n_iters: int = 5, chunk_size=None):
        super().__init__()
        if method not in ("ekf", "iterated_parallel"):
            raise ValueError(f"unknown method {method!r}")
        for name, value in (("t", t), ("Y", Y), ("L", L), ("Qc", Qc), ("m0", m0), ("P0", P0),
                            ("R", R)):
            self.register_buffer(name, value)
        self.params = tuple(params)
        self.drift = drift
        self.obs_fn = obs_fn
        self.n_substeps = n_substeps
        self.method = method
        self.n_iters = n_iters
        self.chunk_size = chunk_size

    def _ssm(self) -> NonlinearSSM:
        return NonlinearSSM(
            drift=lambda x: self.drift(self.params, x), L=self.L, Qc=self.Qc, m0=self.m0,
            P0=self.P0, obs_fn=lambda x: self.obs_fn(self.params, x),
        )

    def filter_smooth(self):
        ssm = self._ssm()
        if self.method == "iterated_parallel":
            return iterated_parallel_ekf_smoother(
                ssm, self.t, self.R, self.Y, n_iters=self.n_iters,
                n_substeps=self.n_substeps, chunk_size=self.chunk_size,
            )
        f = ekf_filter(ssm, self.t, self.R, self.Y, n_substeps=self.n_substeps)
        return f, ekf_smoother(ssm, self.t, f, n_substeps=self.n_substeps)

    def log_marginal_likelihood(self):
        return self.filter_smooth()[0].lml

    def get_objective(self):
        return -self.log_marginal_likelihood()

    def posterior_states(self):
        """The smoothed states (m [T, d], P [T, d, d])."""
        s = self.filter_smooth()[1]
        return s.ms, s.Ps

    def posterior(self) -> GaussianMoments:
        """Smoothed observation-space moments, linearised at the means."""
        s = self.filter_smooth()[1]

        def obs(m):
            return self.obs_fn(self.params, m)

        h = torch.func.vmap(obs)(s.ms)
        Hs = torch.func.vmap(torch.func.jacfwd(obs))(s.ms)
        return GaussianMoments(mean=h, var=torch.einsum("tpi,tij,tpj->tp", Hs, s.Ps, Hs))

"""Heteroscedastic Gaussian likelihood over two latent functions (PyTorch
counterpart of `physs_gp_tpu/likelihoods/het_gaussian.py`).

y ~ N(f1, exp(f2)²): head 0 is the mean, head 1 the log standard deviation.
The variational expectation is closed form under the log link:

    E_q[log N(y | f1, e^{2 f2})]
  = -0.5 log 2π - m2 - 0.5 ((y - m1 + 2 c12)² + v1) e^{-2 m2 + 2 v2}

(the Gaussian shift identity E[e^{su} g(u)] = e^{s² v/2} E[g(u + s v)] at
s = -2, c12 the head covariance). As in the reference, the block ELL takes
y [T] and returns one value per row; `CVIGP` passes Y [T, p] and expects a
sum, so the two do not compose.
"""
from __future__ import annotations

import math

import torch

from .gaussian import Likelihood

__all__ = ["HetGaussian"]

_LOG2PI = math.log(2.0 * math.pi)


class HetGaussian(Likelihood):
    """Heads: column 0 the mean latent f1, column 1 the log-std latent f2."""

    def log_prob(self, y, f):
        f1, f2 = f[..., 0], f[..., 1]
        return -0.5 * (_LOG2PI + 2.0 * f2 + (y - f1) ** 2 / torch.exp(2.0 * f2))

    def expected_log_lik_blocks(self, y, m, S, generator=None, draws=None):
        """y [T]; m [T, 2], S [T, 2, 2] joint head moments; [T] values, 0 on
        the NaN rows. Deterministic: the Monte-Carlo arguments are unused."""
        m1, m2 = m[..., 0], m[..., 1]
        Einv = torch.exp(-2.0 * m2 + 2.0 * S[..., 1, 1])
        resid = (torch.nan_to_num(y) - m1 + 2.0 * S[..., 0, 1]) ** 2 + S[..., 0, 0]
        val = -0.5 * (_LOG2PI + 2.0 * m2) - 0.5 * resid * Einv
        return torch.where(torch.isfinite(y), val, 0.0)

    def expected_log_lik(self, y, m, v):
        """Mean-field (diagonal) form: m, v [..., 2] head moments."""
        m1, m2 = m[..., 0], m[..., 1]
        Einv = torch.exp(-2.0 * m2 + 2.0 * v[..., 1])
        val = -0.5 * (_LOG2PI + 2.0 * m2) - 0.5 * ((torch.nan_to_num(y) - m1) ** 2 + v[..., 0]) * Einv
        return torch.where(torch.isfinite(y), val, 0.0)

    def conditional_mean(self, f):
        return f[..., 0]

    def conditional_variance(self, f):
        return torch.exp(2.0 * f[..., 1])

"""Non-Gaussian likelihoods (PyTorch counterpart of
`physs_gp_tpu/likelihoods/nongaussian.py`: `Poisson` and the
`expected_log_lik` dispatch; the other likelihoods are not ported yet).

Every likelihood exposes `log_prob(y, f)`, the elementwise
`expected_log_lik(y, m, v)` = E_{f ~ N(m, v)}[log p(y | f)], and
`conditional_mean(f)` / `conditional_variance(f)` for the moment-matched
`predict_y`. NaN observations contribute exactly 0.
"""
from __future__ import annotations

import math

import torch

from .gaussian import Gaussian, Likelihood

__all__ = ["Poisson", "expected_log_lik"]

_LOG2PI = math.log(2.0 * math.pi)


def _mask_nan(y, val):
    """Zero the contribution of missing (NaN) observations."""
    return torch.where(torch.isfinite(y), torch.nan_to_num(val), 0.0)


class Poisson(Likelihood):
    """y ~ Poisson(binsize * exp(f)). Under the log link the variational
    expectation is closed-form:
        E[log p] = y (m + log binsize) - binsize exp(m + v/2) - lgamma(y + 1)."""

    def __init__(self, binsize: float = 1.0):
        super().__init__()
        self.binsize = binsize

    def log_prob(self, y, f):
        rate = torch.exp(f) * self.binsize
        return y * torch.log(rate) - rate - torch.lgamma(y + 1.0)

    def expected_log_lik(self, y, m, v):
        y0 = torch.nan_to_num(y)
        val = (
            y0 * (m + math.log(self.binsize))
            - torch.exp(m + 0.5 * v) * self.binsize
            - torch.lgamma(y0 + 1.0)
        )
        return _mask_nan(y, val)

    def conditional_mean(self, f):
        return torch.exp(f) * self.binsize

    def conditional_variance(self, f):
        return torch.exp(f) * self.binsize


def expected_log_lik(lik, y, m, v):
    """Elementwise E_{f ~ N(m, v)}[log p(y | f)]; NaN y contribute 0. The
    scalar `Gaussian` is closed-form here, every other likelihood owns its
    expectation."""
    if isinstance(lik, Gaussian):
        nv = lik.variance.value
        y0 = torch.nan_to_num(y)
        val = -0.5 * (_LOG2PI + torch.log(nv) + ((y0 - m) ** 2 + v) / nv)
        return _mask_nan(y, val)
    return lik.expected_log_lik(y, m, v)

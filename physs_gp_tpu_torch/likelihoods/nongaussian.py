"""Non-Gaussian likelihoods (PyTorch counterpart of
`physs_gp_tpu/likelihoods/nongaussian.py`: `Poisson`, the probit-link
`Bernoulli` and the nu-scaled `Probit` of constraint heads, and the
`expected_log_lik` dispatch; the other likelihoods are not ported yet).

Every likelihood exposes `log_prob(y, f)`, the elementwise
`expected_log_lik(y, m, v)` = E_{f ~ N(m, v)}[log p(y | f)], and
`conditional_mean(f)` / `conditional_variance(f)` for the moment-matched
`predict_y`. NaN observations contribute exactly 0.
"""
from __future__ import annotations

import math

import torch

from ..ops.quadrature import expect_gh
from .gaussian import Gaussian, Likelihood

__all__ = ["Poisson", "Bernoulli", "Probit", "expected_log_lik"]

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


def _log_ndtr(z):
    return torch.special.log_ndtr(z)


class Bernoulli(Likelihood):
    """y in {0, 1} with the probit link P(y = 1 | f) = Phi(f); the
    expectation by Gauss-Hermite quadrature."""

    def __init__(self, gh_points: int = 20):
        super().__init__()
        self.gh_points = gh_points

    def log_prob(self, y, f):
        return _log_ndtr(torch.where(y > 0.5, f, -f))

    def expected_log_lik(self, y, m, v):
        y0 = torch.nan_to_num(y)
        val = expect_gh(lambda ff: _log_ndtr(torch.where(y0[..., None] > 0.5, ff, -ff)),
                        m, v, self.gh_points)
        return _mask_nan(y, val)

    def conditional_mean(self, f):
        return torch.special.ndtr(f)

    def conditional_variance(self, f):
        p = torch.special.ndtr(f)
        return p * (1 - p)


class Probit(Likelihood):
    """nu-scaled probit on pseudo-observations, p(y = 1 | f) = Phi(f / nu):
    inequality and monotonicity constraints (`zoo/physics.monotonic_cvi_gp`)."""

    def __init__(self, nu: float = 1e-2, gh_points: int = 20):
        super().__init__()
        self.nu = nu
        self.gh_points = gh_points

    def log_prob(self, y, f):
        return _log_ndtr(torch.where(y > 0.5, f, -f) / self.nu)

    def expected_log_lik(self, y, m, v):
        y0 = torch.nan_to_num(y)
        val = expect_gh(
            lambda ff: _log_ndtr(torch.where(y0[..., None] > 0.5, ff, -ff) / self.nu),
            m, v, self.gh_points,
        )
        return _mask_nan(y, val)

    def conditional_mean(self, f):
        return torch.special.ndtr(f / self.nu)

    def conditional_variance(self, f):
        p = torch.special.ndtr(f / self.nu)
        return p * (1 - p)


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

"""Non-Gaussian likelihoods (PyTorch counterpart of
`physs_gp_tpu/likelihoods/nongaussian.py`: `Poisson`, the probit-link
`Bernoulli`, the nu-scaled `Probit` of constraint heads, `Power`,
`LossLikelihood`, the per-output routing `PerOutputLikelihood`, the
`expected_log_lik` dispatch and the moment-matched `predictive_moments`).

Every likelihood exposes `log_prob(y, f)`, the elementwise
`expected_log_lik(y, m, v)` = E_{f ~ N(m, v)}[log p(y | f)], and
`conditional_mean(f)` / `conditional_variance(f)` for the moment-matched
`predict_y`. NaN observations contribute exactly 0.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.quadrature import expect_gh, expect_gh_log
from .gaussian import Gaussian, Likelihood

__all__ = ["Poisson", "Bernoulli", "Probit", "Power", "LossLikelihood", "PerOutputLikelihood",
           "expected_log_lik", "predictive_moments"]

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


def predictive_moments(lik, f_mean, f_var, gh_points: int = 20):
    """Moment-matched p(y*) under q(f) = N(f_mean, f_var): the likelihood's
    own `predict_y_moments` where it routes columns to heads, else
    E[y] = E_q[E[y | f]] and Var[y] = E_q[Var[y | f] + E[y | f]²] - E[y]²
    by Gauss-Hermite."""
    if hasattr(lik, "predict_y_moments"):
        return lik.predict_y_moments(f_mean, f_var, gh_points)
    ey = expect_gh(lik.conditional_mean, f_mean, f_var, gh_points)
    ey2 = expect_gh(lambda ff: lik.conditional_variance(ff) + lik.conditional_mean(ff) ** 2,
                    f_mean, f_var, gh_points)
    return ey, ey2 - ey * ey


class Power(Likelihood):
    """y = sign(f) |f|^power + unit Gaussian noise; expectations by
    Gauss-Hermite."""

    def __init__(self, power: float = 2.0, gh_points: int = 20):
        super().__init__()
        self.power = power
        self.gh_points = gh_points

    def log_prob(self, y, f):
        mu = torch.sign(f) * torch.abs(f) ** self.power
        return -0.5 * (_LOG2PI + (y - mu) ** 2)

    def expected_log_lik(self, y, m, v):
        y0 = torch.nan_to_num(y)
        val = expect_gh(lambda ff: self.log_prob(y0[..., None], ff), m, v, self.gh_points)
        return _mask_nan(y, val)

    def conditional_mean(self, f):
        return torch.sign(f) * torch.abs(f) ** self.power

    def conditional_variance(self, f):
        return torch.ones_like(f)


class LossLikelihood(Likelihood):
    """An elementwise loss as a pseudo-likelihood, log p(y | f) = -loss(y, f);
    expectations by Gauss-Hermite."""

    def __init__(self, loss, gh_points: int = 20):
        super().__init__()
        self.loss = loss
        self.gh_points = gh_points

    def log_prob(self, y, f):
        return -self.loss(y, f)

    def expected_log_lik(self, y, m, v):
        y0 = torch.nan_to_num(y)
        val = expect_gh(lambda ff: -self.loss(y0[..., None], ff), m, v, self.gh_points)
        return _mask_nan(y, val)

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return torch.ones_like(f)


class PerOutputLikelihood(Likelihood):
    """Column p of data-major multi-output arrays goes to `liks[p]` (a
    Gaussian data head beside Probit constraint heads, for example). The
    flat arrays are [N·P] (SVGP's layout); `predict_y_moments` and
    `predictive_log_density` take [N, P]."""

    def __init__(self, liks):
        super().__init__()
        self.liks = nn.ModuleList(liks)

    def _cols(self, *arrs):
        P = len(self.liks)
        return [a.reshape(-1, P) for a in arrs]

    def log_prob(self, y, f):
        y2, f2 = self._cols(y, f)
        out = torch.stack([lik.log_prob(y2[:, p], f2[:, p]) for p, lik in enumerate(self.liks)], -1)
        return out.reshape(y.shape)

    def expected_log_lik(self, y, m, v):
        y2, m2, v2 = self._cols(y, m, v)
        out = torch.stack([expected_log_lik(lik, y2[:, p], m2[:, p], v2[:, p])
                           for p, lik in enumerate(self.liks)], -1)
        return out.reshape(y.shape)

    def predict_y_moments(self, f_mean, f_var, gh_points: int = 20):
        cols = [predictive_moments(lik, f_mean[..., p], f_var[..., p], gh_points)
                for p, lik in enumerate(self.liks)]
        return torch.stack([c[0] for c in cols], -1), torch.stack([c[1] for c in cols], -1)

    def predictive_log_density(self, y, f_mean, f_var, gh_points: int = 20):
        cols = []
        for p, lik in enumerate(self.liks):
            y0 = torch.nan_to_num(y[..., p])
            cols.append(expect_gh_log(lambda ff, lik=lik, y0=y0: lik.log_prob(y0[..., None], ff),
                                      f_mean[..., p], f_var[..., p], gh_points))
        return torch.stack(cols, -1)

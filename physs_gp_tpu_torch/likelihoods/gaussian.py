"""Gaussian likelihoods (PyTorch counterpart of
`physs_gp_tpu/likelihoods/gaussian.py`: the scalar iid-noise `Gaussian`,
`IndependentGaussian` with its tied `SharedVariance` groups, and the CVI
pseudo-likelihood `BlockDiagonalGaussian`, the noise model of the surrogate
`StateSpaceGP`)."""
from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.params import Param, positive_param

__all__ = ["Likelihood", "Gaussian", "SharedVariance", "IndependentGaussian",
           "BlockDiagonalGaussian"]


class Likelihood(nn.Module):
    """Marker base class."""


class Gaussian(Likelihood):
    """y = f + eps, eps ~ N(0, variance) iid."""

    def __init__(self, variance: Param | None = None):
        super().__init__()
        self.variance = positive_param(1.0) if variance is None else variance

    def R(self, T: int, p: int = 1):
        """Per-step observation covariance blocks [T, p, p]."""
        v = self.variance.value
        return (v * torch.eye(p, dtype=v.dtype, device=v.device)).expand(T, p, p)

    def log_prob(self, y, f):
        v = self.variance.value
        return -0.5 * (torch.log(2 * math.pi * v) + (y - f) ** 2 / v)

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return self.variance.value.expand(f.shape)


class SharedVariance(nn.Module):
    """One scalar variance Param expanded across `n` heads: a TIED noise
    group for `IndependentGaussian`. Its single `nn.Parameter` is broadcast
    to the n heads, so training keeps them tied."""

    def __init__(self, p: Param, n: int = 1):
        super().__init__()
        self.p = p
        self.n = n

    @property
    def value(self):
        return torch.atleast_1d(self.p.value).expand(self.n)

    def fix(self) -> "SharedVariance":
        self.p.fix()
        return self


class IndependentGaussian(Likelihood):
    """Independent Gaussian noise with a variance per output head (data
    heads and collocation heads, each fixable on its own); an entry may be a
    `SharedVariance` group spanning several heads."""

    def __init__(self, variances):
        super().__init__()
        self.variances = nn.ModuleList(variances)

    @property
    def _v(self):
        return torch.cat([torch.atleast_1d(p.value) for p in self.variances])

    def R(self, T: int, p: int = 1):
        v = self._v
        return torch.diag(v).expand(T, v.shape[0], v.shape[0])

    def log_prob(self, y, f):
        v = self._v
        return -0.5 * (torch.log(2 * math.pi * v) + (y - f) ** 2 / v)

    def expected_log_lik(self, y, m, v):
        """Closed-form E_{N(m, v)}[log N(y | f, var_h)] per head column; NaN
        observations contribute 0."""
        nv = self._v
        y0 = torch.nan_to_num(y)
        val = -0.5 * (torch.log(2 * math.pi * nv) + ((y0 - m) ** 2 + v) / nv)
        return torch.where(torch.isfinite(y), val, torch.zeros_like(val))

    def conditional_mean(self, f):
        return f

    def conditional_variance(self, f):
        return self._v.expand(f.shape)


class BlockDiagonalGaussian(Likelihood):
    """N(Y_t | f_t, V_t) with a full [p, p] block V [T, p, p] per time step:
    the CVI sites as the observation noise of the surrogate model."""

    def __init__(self, V):
        super().__init__()
        self.register_buffer("V", V)

    def R(self, T: int, p: int = 1):
        return self.V

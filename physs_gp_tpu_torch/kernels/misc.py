"""More batch kernels: RQ, spectral mixture, arc-cosine, Gibbs, deep (PyTorch).

Counterpart of `physs_gp_tpu/kernels/misc.py`. Each gives the scalar form
(usable under derivative operators); RQ the stationary Gram path as well.
`SpectralMixture.init` and `DeepKernel.init` draw their starting values from
a `torch.Generator`; weights carried from the JAX package go through
`interop.load_numpy_params` (`.kernel.means.raw`,
`.kernel.layers[0][0].raw`).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from ..utils.params import Param, param, positive_param
from .base import Kernel, StationaryKernel, _as_2d

__all__ = ["RQ", "SpectralMixture", "ArcCosine", "Gibbs", "DeepKernel"]


def _pos(value, dtype, device):
    return value if isinstance(value, Param) else positive_param(value, dtype=dtype, device=device)


class RQ(StationaryKernel):
    """Rational quadratic: sigma^2 (1 + d2 / (2 alpha))^-alpha."""

    def __init__(self, lengthscales=1.0, variance=1.0, alpha=1.0, dtype=None, device=None):
        super().__init__()
        self.lengthscales = _pos(lengthscales, dtype, device)
        self.variance = _pos(variance, dtype, device)
        self.alpha = _pos(alpha, dtype, device)

    def k_from_sqdist(self, d2):
        a = self.alpha.value
        return (1.0 + d2 / (2.0 * a)) ** (-a)


class SpectralMixture(Kernel):
    """Sum of Q spectral-mixture components:
    k(tau) = sum_q w_q prod_d exp(-2 pi^2 tau_d^2 v_qd) cos(2 pi tau_d mu_qd)."""

    def __init__(self, weights: Param, means: Param, scales: Param):
        super().__init__()
        self.weights = weights  # [Q]
        self.means = means  # [Q, D] component frequencies
        self.scales = scales  # [Q, D] component variances

    @classmethod
    def init(cls, Q: int, D: int = 1, generator=None, dtype=None, device=None):
        """Equal weights, frequencies and variances uniform in [0.1, 1)
        from `generator` (a `torch.Generator` on `device`; None: seed 0)."""
        kw = dict(dtype=dtype or torch.get_default_dtype(), device=device)
        if generator is None:
            generator = torch.Generator(device=device or "cpu").manual_seed(0)
        u1 = torch.rand((Q, D), generator=generator, **kw)
        u2 = torch.rand((Q, D), generator=generator, **kw)
        return cls(weights=positive_param(torch.ones(Q, **kw) / Q),
                   means=Param(0.1 + 0.9 * u1), scales=positive_param(0.1 + 0.9 * u2))

    def k_scalar(self, x1, x2):
        tau = torch.atleast_1d(x1) - torch.atleast_1d(x2)  # [D]
        mu, v = self.means.value, self.scales.value
        comp = torch.exp(-2.0 * math.pi**2 * (tau[None, :] ** 2 * v)).prod(-1)
        comp = comp * torch.cos(2.0 * math.pi * (tau[None, :] * mu).sum(-1))
        return torch.sum(self.weights.value * comp)


class ArcCosine(Kernel):
    """The order-1 arc-cosine (infinite ReLU network) kernel."""

    def __init__(self, variance=1.0, weight_var=1.0, bias_var=1.0, dtype=None, device=None):
        super().__init__()
        self.variance = _pos(variance, dtype, device)
        self.weight_var = _pos(weight_var, dtype, device)
        self.bias_var = _pos(bias_var, dtype, device)

    def _dot(self, x1, x2):
        return self.weight_var.value * torch.dot(x1, x2) + self.bias_var.value

    def k_scalar(self, x1, x2):
        x1, x2 = torch.atleast_1d(x1), torch.atleast_1d(x2)
        s11, s22, s12 = self._dot(x1, x1), self._dot(x2, x2), self._dot(x1, x2)
        denom = torch.sqrt(s11 * s22)
        cos_t = torch.clamp(s12 / denom, -1.0, 1.0)
        theta = torch.arccos(cos_t)
        J = torch.sin(theta) + (math.pi - theta) * cos_t
        return self.variance.value / math.pi * denom * J


class Gibbs(Kernel):
    """The non-stationary Gibbs kernel with an input-dependent lengthscale
    l(x); `l_fn` maps [D] to a positive scalar."""

    def __init__(self, variance=1.0, l_fn: Callable | None = None, dtype=None, device=None):
        super().__init__()
        self.variance = _pos(variance, dtype, device)
        self.l_fn = l_fn

    def k_scalar(self, x1, x2):
        x1, x2 = torch.atleast_1d(x1), torch.atleast_1d(x2)
        l1, l2 = self.l_fn(x1), self.l_fn(x2)
        D = x1.shape[-1]
        pre = (2.0 * l1 * l2 / (l1**2 + l2**2)) ** (D / 2.0)
        d2 = torch.sum((x1 - x2) ** 2) / (l1**2 + l2**2)
        return self.variance.value * pre * torch.exp(-d2)


class DeepKernel(Kernel):
    """A base kernel over a learned feature map: k(x, x') = k_base(g(x),
    g(x')), g a small tanh MLP whose layers are [W Param, b Param] pairs."""

    def __init__(self, base, layers=()):
        super().__init__()
        self.base = base
        self.layers = nn.ModuleList(nn.ModuleList(layer) for layer in layers)

    @classmethod
    def init(cls, base, sizes, generator=None, dtype=None, device=None):
        """W ~ N(0, 1 / din) from `generator` (a `torch.Generator` on
        `device`; None: seed 0), b = 0."""
        kw = dict(dtype=dtype or torch.get_default_dtype(), device=device)
        if generator is None:
            generator = torch.Generator(device=device or "cpu").manual_seed(0)
        layers = []
        for din, dout in zip(sizes[:-1], sizes[1:]):
            W = torch.randn((din, dout), generator=generator, **kw) / math.sqrt(din)
            layers.append([param(W), param(torch.zeros(dout, **kw))])
        return cls(base, layers)

    def _features(self, x):
        h = torch.atleast_1d(x)
        for i, (W, b) in enumerate(self.layers):
            h = h @ W.value + b.value
            if i < len(self.layers) - 1:
                h = torch.tanh(h)
        return h

    def k_scalar(self, x1, x2):
        return self.base.k_scalar(self._features(x1), self._features(x2))

    def K(self, X1, X2):
        return self.base.K(torch.func.vmap(self._features)(_as_2d(X1)),
                           torch.func.vmap(self._features)(_as_2d(X2)))

    def K_diag(self, X):
        return self.base.K_diag(torch.func.vmap(self._features)(_as_2d(X)))

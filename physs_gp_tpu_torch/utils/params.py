"""Constrained trainable parameters (PyTorch).

Counterpart of `physs_gp_tpu/utils/params.py`. A `Param` is an `nn.Module`
holding the unconstrained value as an `nn.Parameter` named `raw`; `.value`
applies the bijector's forward transform. `.fix()` turns gradients off
(`requires_grad_(False)`), the counterpart of the JAX package's stop-gradient.
`NegParam` is a view of a `Param` as its negation. `fill_triangular` packs
lower triangles in `jnp.tril_indices`' row-major order, so packed leaves
(`SVGP.q_sqrt`) carry across from the JAX package unchanged.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Identity", "Positive", "Sigmoid", "identity", "positive", "Param", "param", "positive_param",
           "NegParam", "fill_triangular", "fill_triangular_inverse", "tril_param", "tril_value"]

_SOFTPLUS_SHIFT = 1e-6  # lower bound keeping positive params away from 0


class Identity:
    def forward(self, x):
        return x

    def inverse(self, y):
        return y


class Positive:
    """softplus with a small shift: y = softplus(x) + shift."""

    shift = _SOFTPLUS_SHIFT

    def forward(self, x):
        return torch.nn.functional.softplus(x) + self.shift

    def inverse(self, y):
        # softplus^-1(y) = log(expm1(y)) in its numerically stable form
        y = torch.as_tensor(y) - self.shift
        return y + torch.log(-torch.expm1(-y))


class Sigmoid:
    """y in (lo, hi)."""

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        self.lo, self.hi = lo, hi

    def forward(self, x):
        return self.lo + (self.hi - self.lo) * torch.sigmoid(x)

    def inverse(self, y):
        p = (torch.as_tensor(y) - self.lo) / (self.hi - self.lo)
        return torch.log(p) - torch.log1p(-p)


identity = Identity()
positive = Positive()


class Param(nn.Module):
    """A (possibly constrained, possibly fixed) trainable leaf."""

    def __init__(self, raw: torch.Tensor, bijector=identity, fixed: bool = False):
        super().__init__()
        self.raw = nn.Parameter(raw, requires_grad=not fixed)
        self.bijector = bijector

    @property
    def fixed(self) -> bool:
        return not self.raw.requires_grad

    @property
    def value(self) -> torch.Tensor:
        return self.bijector.forward(self.raw)

    def with_value(self, value) -> "Param":
        """Set the constrained value in place (raw = bijector⁻¹(value))."""
        with torch.no_grad():
            self.raw.copy_(self.bijector.inverse(torch.as_tensor(value, dtype=self.raw.dtype,
                                                                 device=self.raw.device)))
        return self

    def fix(self) -> "Param":
        self.raw.requires_grad_(False)
        return self

    def release(self) -> "Param":
        self.raw.requires_grad_(True)
        return self


def param(value, dtype=None, device=None) -> Param:
    return Param(torch.as_tensor(value, dtype=dtype, device=device))


def positive_param(value, dtype=None, device=None, fixed: bool = False) -> Param:
    v = torch.as_tensor(value, dtype=dtype, device=device)
    return Param(positive.inverse(v), bijector=positive, fixed=fixed)


def _tril_indices(n: int, device):
    return torch.tril_indices(n, n, device=device).unbind(0)


def fill_triangular(vec, n: int):
    """Pack a [..., n(n+1)/2] vector into a lower-triangular [..., n, n], row by row."""
    rows, cols = _tril_indices(n, vec.device)
    out = vec.new_zeros(vec.shape[:-1] + (n, n))
    out[..., rows, cols] = vec
    return out


def fill_triangular_inverse(mat):
    """The packed [..., n(n+1)/2] lower triangle of [..., n, n]."""
    rows, cols = _tril_indices(mat.shape[-1], mat.device)
    return mat[..., rows, cols]


def tril_param(mat) -> Param:
    """Parameterise a (batch of) lower-triangular matrices by their packed vec."""
    return Param(fill_triangular_inverse(torch.as_tensor(mat)))


def tril_value(p: Param, n: int):
    return fill_triangular(p.value, n)


class NegParam(nn.Module):
    """View of a (typically positive) Param as its negation: a strictly
    negative trainable coefficient (e.g. the -a Δf diffusion term) whose
    `base` trains in the positive bijector's space."""

    def __init__(self, base: Param):
        super().__init__()
        self.base = base

    @property
    def value(self) -> torch.Tensor:
        return -self.base.value

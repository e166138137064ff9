"""Constrained trainable parameters (PyTorch).

Counterpart of `physs_gp_tpu/utils/params.py`. A `Param` is an `nn.Module`
holding the unconstrained value as an `nn.Parameter` named `raw`; `.value`
applies the bijector's forward transform. `.fix()` turns gradients off
(`requires_grad_(False)`), the counterpart of the JAX package's stop-gradient.
`NegParam` is a view of a `Param` as its negation.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Identity", "Positive", "identity", "positive", "Param", "param", "positive_param",
           "NegParam"]

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

    def fix(self) -> "Param":
        self.raw.requires_grad_(False)
        return self


def param(value, dtype=None, device=None) -> Param:
    return Param(torch.as_tensor(value, dtype=dtype, device=device))


def positive_param(value, dtype=None, device=None, fixed: bool = False) -> Param:
    v = torch.as_tensor(value, dtype=dtype, device=device)
    return Param(positive.inverse(v), bijector=positive, fixed=fixed)


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

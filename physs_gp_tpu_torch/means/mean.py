"""Mean functions (PyTorch counterpart of `physs_gp_tpu/means/mean.py`).

A mean maps inputs [N, D] -> [N]; `BatchGP` subtracts it from the
observations before (zero-mean) inference and adds it back on prediction.
`deriv(X, order)` differentiates the mean with `torch.func.grad`, for
derivative heads. `head_mean_values` aligns a mean with a state-space
model's observation heads: `StateSpaceGP`, `CVIGP`, `StreamingGP` and
`StreamingCVI` run on the deviation from it.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..utils.params import Param, param
from ..utils.shapes import as_points

__all__ = ["Mean", "ZeroMean", "ConstantMean", "LinearMean", "FunctionMean", "head_mean_values",
           "mean_module"]


class Mean(nn.Module):
    def deriv(self, X, order: int = 1, dim: int = 0):
        """d^order mean / dx_dim^order at the rows of X, by autodiff."""
        f = self._scalar
        for _ in range(order):
            f = (lambda g: lambda x: torch.func.grad(g)(x)[dim])(f)
        return torch.func.vmap(f)(as_points(X))

    def _scalar(self, x):
        return self(x[None])[0]


class ZeroMean(Mean):
    def forward(self, X):
        X = as_points(X)
        return X.new_zeros(X.shape[0])


class ConstantMean(Mean):
    def __init__(self, c: Param | None = None, dtype=None, device=None):
        super().__init__()
        self.c = c if c is not None else param(0.0, dtype=dtype, device=device)

    def forward(self, X):
        X = as_points(X)
        return self.c.value.expand(X.shape[0])


class LinearMean(Mean):
    def __init__(self, w: Param, b: Param | None = None):
        super().__init__()
        self.w = w
        self.b = b if b is not None else param(0.0, dtype=w.raw.dtype, device=w.raw.device)

    def forward(self, X):
        return as_points(X) @ self.w.value + self.b.value


class FunctionMean(Mean):
    """A fixed function of one input row, vmapped over the rows."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, X):
        return torch.func.vmap(self.fn)(as_points(X))


def mean_module(mean):
    """A model's `mean` attribute: a list of means (one per head or output)
    as an `nn.ModuleList`, so their parameters register; one mean or None
    as given."""
    return nn.ModuleList(mean) if isinstance(mean, (list, tuple)) else mean


def _one_head_mean(mean, head, t):
    """[T] or [T, n_h] prior-mean values of one observation head: heads
    observe linear functionals L[f], whose mean is L[μ]. Physics-residual
    and spatial-operator heads get 0 (residual targets constrain the
    zero-mean deviation)."""
    from ..transforms.operators import (
        DerivativeHead, LinearOperatorHead, ScatteredSpatialHead, SpatialHead, ValueHead,
    )

    X_t = t[:, None]
    if isinstance(head, ValueHead):
        return mean(X_t)
    if isinstance(head, DerivativeHead):
        return mean.deriv(X_t, head.order)
    if isinstance(head, LinearOperatorHead):
        out = 0.0
        for k, c in enumerate(head.coeffs):
            cv = c.value if hasattr(c, "value") else c
            out = out + cv * mean.deriv(X_t, k)
        return out
    if isinstance(head, SpatialHead) and head.t_order == 0 and head.s_op is None:
        # mean over the (t, s_j) rows: [T, N_h]
        return torch.func.vmap(
            lambda s: mean(torch.cat([X_t, s.expand((X_t.shape[0],) + s.shape)], 1)),
            out_dims=1,
        )(head.points)
    if isinstance(head, ScatteredSpatialHead) and head.t_order == 0 and head.s_op is None:
        return torch.func.vmap(
            lambda tk, pts: mean(torch.cat([tk.expand(pts.shape[0], 1), pts], 1))
        )(t, head.points)  # [T, Ng]
    n = head.points.shape[-2] if hasattr(head, "points") else 1
    return t.new_zeros((t.shape[0], n) if n > 1 else (t.shape[0],))


def head_mean_values(mean, t, observation=None, p: int = 1):
    """Prior-mean matrix μ [T, p] aligned with the observation heads.

    `mean` is one Mean (shared by the heads) or a list of one per head /
    output column; with `observation=None` the model observes f on each of
    its p outputs."""
    t = t.reshape(-1)
    if observation is None:
        if isinstance(mean, (list, tuple, nn.ModuleList)):
            cols = [m(t[:, None]) for m in mean]
        else:
            cols = [mean(t[:, None])] * p
        return torch.stack(cols, 1)
    heads = observation.heads
    means = mean if isinstance(mean, (list, tuple, nn.ModuleList)) else [mean] * len(heads)
    cols = []
    for m, h in zip(means, heads):
        v = _one_head_mean(m, h, t)
        cols.append(v[:, None] if v.dim() == 1 else v)
    return torch.cat(cols, 1)

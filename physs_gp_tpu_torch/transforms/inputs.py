"""Uncertain inputs as a likelihood moment transform (PyTorch).

Counterpart of `physs_gp_tpu/transforms/inputs.py`: observations at noisy
input locations x + w, w ~ N(0, σ_x²), by the delta approximation through
the derivative process

    E[f(x+w)] ≈ f(x)  (+ ½ σ_x² f''(x) with `hessian=True`)
    V[f(x+w)] ≈ V[f] + σ_x² (f'(x)² + V[f'])

The Markov state already carries f' (and f''), so this is a block
likelihood over (f, f'[, f'']) heads, fitted through `CVIGP`'s block route.
"""
from __future__ import annotations

import torch
from torch import nn

from ..likelihoods.nongaussian import expected_log_lik
from ..utils.params import Param, positive_param

__all__ = ["UncertainInputLikelihood"]


class UncertainInputLikelihood(nn.Module):
    """An elementwise likelihood `base` of y observed at x + w,
    w ~ N(0, `input_var`). Use with observation heads
    [ValueHead(), DerivativeHead(1)] (+ DerivativeHead(2) with `hessian`);
    Y holds the data in column 0 and NaN in the derivative columns, which
    inform only through this transform, so their sites stay active
    (`site_active_mask`)."""

    def __init__(self, base, input_var: Param | None = None, hessian: bool = False):
        super().__init__()
        self.base = base
        self.input_var = input_var if input_var is not None else positive_param(0.1)
        self.hessian = hessian

    def site_active_mask(self, Y):
        return torch.ones_like(Y, dtype=torch.bool)

    def R(self, T: int, p: int = 1):
        v = self.input_var.raw
        return torch.eye(p, dtype=v.dtype, device=v.device).expand(T, p, p)

    def transformed_moments(self, m, S):
        """The delta-approximation moments ([T], [T]) of f(x + w)."""
        sx2 = self.input_var.value
        f, df = m[:, 0], m[:, 1]
        mean = f + 0.5 * sx2 * m[:, 2] if self.hessian else f
        return mean, S[:, 0, 0] + sx2 * (df * df + S[:, 1, 1])

    def expected_log_lik_blocks(self, Y, m, S, draws=None):
        """The data ELL (deterministic: `draws` is unused)."""
        mean, var = self.transformed_moments(m, S)
        return torch.sum(expected_log_lik(self.base, Y[:, 0], mean, var))

    def log_prob(self, y, f):
        return self.base.log_prob(y, f)

    def conditional_mean(self, f):
        return self.base.conditional_mean(f)

    def conditional_variance(self, f):
        return self.base.conditional_variance(f)

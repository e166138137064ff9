"""Gauss-Hermite quadrature and Monte-Carlo expectations (PyTorch
counterpart of `physs_gp_tpu/ops/quadrature.py`).

Nodes and weights are numpy constants (`numpy.polynomial.hermite.hermgauss`),
so each expectation is one batched evaluation of g over a trailing axis of
n nodes. `expect_mc` draws from the caller's `torch.Generator` where the
reference takes a PRNG key, or takes the draws themselves (`draws=`).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["gauss_hermite_points", "expect_gh", "expect_gh_log", "expect_mc"]


@lru_cache(maxsize=None)
def gauss_hermite_points(n: int):
    """Nodes and weights with E_{N(0,1)}[g(x)] ≈ sum_i w_i g(x_i)."""
    x, w = np.polynomial.hermite.hermgauss(n)
    return x * np.sqrt(2.0), w / np.sqrt(np.pi)


def _nodes(m, v, values, n):
    x, w = gauss_hermite_points(n)
    x = torch.as_tensor(x, dtype=m.dtype, device=m.device)
    f = m[..., None] + torch.sqrt(torch.clamp(v, min=0.0))[..., None] * x
    return f, torch.as_tensor(values(w), dtype=m.dtype, device=m.device)


def expect_gh(g, m, v, n: int = 20):
    """E_{f ~ N(m, v)}[g(f)] elementwise over matching-shape (m, v); g is
    applied to tensors of shape [..., n]."""
    f, w = _nodes(m, v, lambda w: w, n)
    return torch.sum(g(f) * w, -1)


def expect_gh_log(log_g, m, v, n: int = 20):
    """log E_{f ~ N(m, v)}[exp(log_g(f))] through logsumexp, so that
    predictive densities that underflow float32 keep a finite log."""
    f, logw = _nodes(m, v, np.log, n)
    return torch.logsumexp(log_g(f) + logw, -1)


def expect_mc(g, m, v, generator=None, n: int = 64, draws=None):
    """Monte-Carlo E_{f ~ N(m, v)}[g(f)] over n standard-normal draws
    [..., n] from `generator` (a `torch.Generator` on m's device), or over
    the given `draws` of that shape."""
    if draws is None:
        from .sampling import standard_normal

        draws = standard_normal(generator, m.shape + (n,), m)
    f = m[..., None] + torch.sqrt(torch.clamp(v, min=0.0))[..., None] * draws
    return torch.mean(g(f), -1)

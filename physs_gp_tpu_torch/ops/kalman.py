"""Kalman filter/smoother result types and the observation mask (PyTorch).

Counterpart of the shared parts of `physs_gp_tpu/ops/kalman.py`. The
sequential filter and smoother are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["FilterResult", "SmootherResult", "observation_mask"]


class FilterResult(NamedTuple):
    ms: torch.Tensor  # [T, d]   filtered means
    Ps: torch.Tensor  # [T, d, d] filtered covariances
    lml: torch.Tensor  # scalar   log marginal likelihood
    lmls: torch.Tensor  # [T]     per-step lml contributions
    # one-step-ahead predicted covariance P_{t|t-1}, a byproduct of the
    # parallel filter's lml pass that the parallel smoother reuses
    Pp: torch.Tensor | None = None


class SmootherResult(NamedTuple):
    ms: torch.Tensor  # [T, d]
    Ps: torch.Tensor  # [T, d, d]
    Gs: torch.Tensor  # [T, d, d] smoother gains (G_T = 0)
    Ls: torch.Tensor | None = None  # covariance factors (square-root runners)


def observation_mask(y, dtype=None):
    """{1, 0} mask from the NaN pattern of y [T, p]."""
    return torch.isfinite(y).to(dtype or y.dtype)

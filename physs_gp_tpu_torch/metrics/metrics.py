"""Evaluation metrics: RMSE, NLPD, confidence intervals (PyTorch counterpart
of `physs_gp_tpu/metrics/metrics.py`).

All are NaN-aware: missing targets contribute nothing. `response_curve`
and `sample_confidence_intervals` need posterior sampling and are not
ported yet.
"""
from __future__ import annotations

import math

import torch

from ..ops.quadrature import expect_gh_log

__all__ = ["rmse", "gaussian_nlpd", "nlpd_quadrature", "confidence_interval"]

_LOG2PI = math.log(2.0 * math.pi)


def rmse(y_true, y_pred):
    ok = torch.isfinite(y_true)
    se = torch.where(ok, torch.nan_to_num(y_true - y_pred) ** 2, 0.0)
    return torch.sqrt(torch.sum(se) / torch.sum(ok))


def gaussian_nlpd(y, mean, var):
    """Mean NLPD under Gaussian predictive moments (exact closed form)."""
    ok = torch.isfinite(y)
    val = 0.5 * (_LOG2PI + torch.log(var) + torch.nan_to_num(y - mean) ** 2 / var)
    return torch.sum(torch.where(ok, val, 0.0)) / torch.sum(ok)


def nlpd_quadrature(likelihood, y, f_mean, f_var, gh_points: int = 20):
    """Mean NLPD marginalising the latent with log-domain Gauss-Hermite
    quadrature (ref `metrics/nlpd.py:44` quadrature branch)."""
    val = -expect_gh_log(
        lambda ff: likelihood.log_prob(torch.nan_to_num(y)[..., None], ff),
        f_mean, f_var, gh_points,
    )
    ok = torch.isfinite(y)
    return torch.sum(torch.where(ok, val, 0.0)) / torch.sum(ok)


def confidence_interval(mean, var, level: float = 0.95):
    """Central Gaussian credible interval (ref confidence_intervals.py)."""
    z = torch.special.ndtri(torch.tensor(0.5 + level / 2.0, dtype=mean.dtype, device=mean.device))
    sd = torch.sqrt(var)
    return mean - z * sd, mean + z * sd

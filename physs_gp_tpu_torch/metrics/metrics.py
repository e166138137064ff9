"""Evaluation metrics: RMSE, NLPD, confidence intervals (PyTorch counterpart
of `physs_gp_tpu/metrics/metrics.py`).

All are NaN-aware: missing targets contribute nothing.
`sample_confidence_intervals` reads quantiles of joint posterior samples
(`sample_f`).
"""
from __future__ import annotations

import math

import torch

from ..ops.quadrature import expect_gh_log

__all__ = ["rmse", "gaussian_nlpd", "nlpd_quadrature", "confidence_interval",
           "response_curve", "sample_confidence_intervals"]

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


def response_curve(model, X_grid, feature: int = 0, X_ref=None, gh_points: int = 20):
    """1-D response curve: predictive mean and central interval sweeping one
    input feature, the others held at reference values (ref
    `metrics/response_curves.py`)."""
    X_grid = torch.as_tensor(X_grid).reshape(-1)
    if X_ref is None:
        Xs = X_grid[:, None]
    else:
        X_ref = torch.as_tensor(X_ref, dtype=X_grid.dtype, device=X_grid.device).reshape(-1)
        Xs = X_ref[None, :].repeat(X_grid.shape[0], 1)
        Xs[:, feature] = X_grid
    pred = model.predict_f(Xs)
    lo, hi = confidence_interval(pred.mean, pred.var)
    return pred.mean, lo, hi


def sample_confidence_intervals(model, generator, n_samples: int = 256, t_new=None,
                                Xs=None, level: float = 0.95, link=None):
    """Median and central credible interval from JOINT posterior samples
    (ref `VGP.confidence_intervals`, `models/vgp.py:306`): exact for
    non-Gaussian links, where the moment-based `confidence_interval` is an
    approximation.

    `model` needs `sample_f` (state-space models take `t_new=`, batch models
    `Xs=`); `generator` is the `torch.Generator` it draws from; `link`
    optionally maps the sampled f (e.g. `torch.exp`). Quantiles interpolate
    linearly, as `jnp.quantile` does. Returns (median, lo, hi), each shaped
    like one sample.
    """
    if Xs is not None:
        fs = model.sample_f(generator, Xs, n_samples)
    elif t_new is not None:
        fs = model.sample_f(generator, n_samples, t_new=t_new)
    else:
        fs = model.sample_f(generator, n_samples)
    if link is not None:
        fs = link(fs)
    a = (1.0 - level) / 2.0
    q = torch.tensor([a, 0.5, 1.0 - a], dtype=fs.dtype, device=fs.device)
    qs = torch.quantile(fs, q, dim=0, interpolation="linear")
    return qs[1], qs[0], qs[2]

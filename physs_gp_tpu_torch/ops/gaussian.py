"""Gaussian density algebra with missing-data masking (PyTorch).

Counterpart of `physs_gp_tpu/ops/gaussian.py` (`mvn_logpdf`,
`mask_covariance`, `masked_mvn_logpdf`, `gaussian_kl`,
`gaussian_expected_logpdf_diag`, `symmetrize_cov`). Missing observations
are masked inside fixed-shape algebra: masked rows/cols are zeroed and 1 is
put on the masked diagonal.
"""
from __future__ import annotations

import math

import torch

from .matrix import log_det_from_chol, psd_solve_logdet, safe_cholesky, solve_lower, symmetrize

__all__ = ["mvn_logpdf", "mask_covariance", "masked_mvn_logpdf", "gaussian_kl",
           "gaussian_expected_logpdf_diag", "symmetrize_cov"]

_LOG2PI = math.log(2.0 * math.pi)


def mvn_logpdf(y, mean, cov):
    """log N(y | mean, cov); y, mean [..., n], cov [..., n, n]."""
    n = y.shape[-1]
    L = safe_cholesky(cov)
    alpha = solve_lower(L, (y - mean)[..., None])[..., 0]
    maha = torch.sum(alpha * alpha, -1)
    return -0.5 * (maha + log_det_from_chol(L) + n * _LOG2PI)


def mask_covariance(cov, obs_mask):
    """Zero masked rows/cols of cov and put 1.0 on the masked diagonal;
    obs_mask [..., n] is 1.0 where observed, 0.0 where missing."""
    m = obs_mask[..., :, None] * obs_mask[..., None, :]
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    diag_fix = (1.0 - obs_mask)[..., :, None] * eye
    return cov * m + diag_fix


def masked_mvn_logpdf(y, mean, cov, obs_mask):
    """log N(y_obs | mean_obs, cov_obs) over the observed subset only;
    missing y entries may be NaN."""
    obs_mask = obs_mask.to(cov.dtype)
    y = torch.where(obs_mask > 0, torch.nan_to_num(y), 0.0)
    mean = mean * obs_mask
    cov_m = mask_covariance(cov, obs_mask)
    diff = y - mean
    alpha, logdet = psd_solve_logdet(cov_m, diff[..., None])
    maha = torch.sum(diff * alpha[..., 0], -1)
    n_obs = torch.sum(obs_mask, -1)
    return -0.5 * (maha + logdet + n_obs * _LOG2PI)


def gaussian_kl(m_q, L_q, m_p, L_p):
    """KL(N(m_q, L_q L_qᵀ) || N(m_p, L_p L_pᵀ)) from lower Cholesky factors."""
    n = m_q.shape[-1]
    M = solve_lower(L_p, L_q)
    trace = torch.sum(M * M, (-1, -2))
    diff = solve_lower(L_p, (m_p - m_q)[..., None])[..., 0]
    maha = torch.sum(diff * diff, -1)
    logdet = log_det_from_chol(L_p) - log_det_from_chol(L_q)
    return 0.5 * (trace + maha - n + logdet)


def gaussian_expected_logpdf_diag(y, m, v, noise_var):
    """E_{f ~ N(m, v)}[log N(y | f, noise_var)] elementwise, in closed form."""
    return -0.5 * (_LOG2PI + torch.log(noise_var) + ((y - m) ** 2 + v) / noise_var)


def symmetrize_cov(P):
    return symmetrize(P)

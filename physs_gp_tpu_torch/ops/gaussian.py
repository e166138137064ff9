"""Gaussian density algebra with missing-data masking (PyTorch).

Counterpart of `physs_gp_tpu/ops/gaussian.py` (`mask_covariance`,
`masked_mvn_logpdf`). Missing observations are masked inside fixed-shape
algebra: masked rows/cols are zeroed and 1 is put on the masked diagonal.
"""
from __future__ import annotations

import math

import torch

from .matrix import psd_solve_logdet

__all__ = ["mask_covariance", "masked_mvn_logpdf"]

_LOG2PI = math.log(2.0 * math.pi)


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

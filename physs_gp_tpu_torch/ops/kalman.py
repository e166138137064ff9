"""Sequential Kalman filtering / RTS smoothing over precomputed step tensors
(PyTorch), and the result types the parallel filters share.

Counterpart of `physs_gp_tpu/ops/kalman.py`. The filter and the smoother are
Python loops over T whose every step is PyTorch's own linear algebra at
batch 1 (`torch.linalg.cholesky`, triangular solves, `@`): they share no
kernel and no schedule with the parallel scans, which makes them the oracle
those are held to. Missing data: NaNs in y become a {0, 1} observation mask;
masked rows of H and an identity filler on the innovation covariance keep
every step fixed-shape (`ops/gaussian.mask_covariance`). Convention: A[0] /
Q[0] are identity / zero, so step 0 predicts the prior (m0, P0) itself.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .gaussian import mask_covariance
from .matrix import add_jitter, cholesky_solve, log_det_from_chol, symmetrize

__all__ = ["FilterResult", "SmootherResult", "observation_mask", "masked_update",
           "kalman_filter", "rts_smoother", "filter_smoother"]

_LOG2PI = math.log(2.0 * math.pi)


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


def _jittered_cholesky(A):
    """`safe_cholesky` through PyTorch's own factorisation, not the port's
    kernel: the oracle shares no kernel with what it checks."""
    return torch.linalg.cholesky(add_jitter(symmetrize(A)))


def masked_update(m_pred, P_pred, H, R, y, mask):
    """One masked Kalman update (Joseph-form covariance).

    m_pred [d], P_pred [d, d], H [p, d], R [p, p], y [p] (NaN allowed where
    mask == 0), mask [p] in {0., 1.}. Returns (m, P, step_lml).
    """
    d = m_pred.shape[-1]
    y0 = torch.where(mask > 0, torch.nan_to_num(y), 0.0)
    Hm = mask[:, None] * H
    v = y0 - Hm @ m_pred
    HP = Hm @ P_pred
    Ls = _jittered_cholesky(mask_covariance(HP @ Hm.T + R, mask))
    # K = P H^T S^-1 (columns of missing dims are exactly zero)
    K = cholesky_solve(Ls, HP).T
    m = m_pred + K @ v
    ImKH = torch.eye(d, dtype=P_pred.dtype, device=P_pred.device) - K @ Hm
    Rm = mask_covariance(R, mask)
    P = symmetrize(ImKH @ P_pred @ ImKH.T + K @ Rm @ K.T)
    alpha = torch.linalg.solve_triangular(Ls, v[:, None], upper=False)[:, 0]
    lml = -0.5 * (torch.sum(alpha * alpha) + log_det_from_chol(Ls) + torch.sum(mask) * _LOG2PI)
    return m, P, lml


def kalman_filter(A, Q, H, R, y, m0, P0, mask=None) -> FilterResult:
    """Sequential Kalman filter.

    A, Q: [T, d, d]; H: [p, d] or [T, p, d]; R: [T, p, p]; y: [T, p] (NaN =
    missing); m0: [d]; P0: [d, d].
    """
    T = y.shape[0]
    if mask is None:
        mask = observation_mask(y, P0.dtype)
    m, P = m0, P0
    ms, Ps, lmls = [], [], []
    for k in range(T):
        m_pred = A[k] @ m
        P_pred = symmetrize(A[k] @ P @ A[k].T + Q[k])
        m, P, lml_k = masked_update(
            m_pred, P_pred, H if H.dim() == 2 else H[k], R[k], y[k], mask[k]
        )
        ms.append(m)
        Ps.append(P)
        lmls.append(lml_k)
    lmls = torch.stack(lmls)
    return FilterResult(ms=torch.stack(ms), Ps=torch.stack(Ps), lml=torch.sum(lmls), lmls=lmls)


def rts_smoother(A, Q, filtered: FilterResult) -> SmootherResult:
    """Sequential RTS smoother; A[k] transitions k-1 -> k (A[0] unused)."""
    ms, Ps = filtered.ms, filtered.Ps
    T, d = ms.shape
    m_s, P_s = ms[-1], Ps[-1]
    out_m, out_P, out_G = [m_s], [P_s], [torch.zeros_like(P_s)]
    for k in range(T - 2, -1, -1):
        A_next = A[k + 1]
        m_pred = A_next @ ms[k]
        AP = A_next @ Ps[k]
        P_pred = symmetrize(AP @ A_next.T + Q[k + 1])
        # G = P_f A^T P_pred^-1
        G = cholesky_solve(_jittered_cholesky(P_pred), AP).T
        m_s = ms[k] + G @ (m_s - m_pred)
        P_s = symmetrize(Ps[k] + G @ (P_s - P_pred) @ G.T)
        out_m.append(m_s)
        out_P.append(P_s)
        out_G.append(G)
    return SmootherResult(
        ms=torch.stack(out_m[::-1]), Ps=torch.stack(out_P[::-1]), Gs=torch.stack(out_G[::-1])
    )


def filter_smoother(A, Q, H, R, y, m0, P0, mask=None):
    f = kalman_filter(A, Q, H, R, y, m0, P0, mask)
    return f, rts_smoother(A, Q, f)

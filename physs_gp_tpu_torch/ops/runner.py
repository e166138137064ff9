"""Filter/smoother dispatch (PyTorch).

Counterpart of `physs_gp_tpu/ops/runner.py`: {sequential (`parallel=False`),
parallel} x {covariance, square-root (`sqrt=True`)}. Square-root variants
take and return triangular factors inside; the runner converts at the
boundary, so models always see covariance Ps (and, from the square-root
smoothers, the factors in `Ls`). The time-sharded multi-device pass is not
ported yet and raises `NotImplementedError`.
"""
from __future__ import annotations

import torch

from . import kalman, parallel_kalman, parallel_sqrt_kalman, sqrt_kalman
from .gaussian import mask_covariance
from .kalman import FilterResult, SmootherResult, observation_mask
from .matrix import safe_cholesky_rel

__all__ = ["run_filter_smoother", "run_filter"]


def _pad_amount(T: int, chunk_size) -> int:
    """Steps to append so that T is a multiple of chunk_size (single device;
    the sharded variant of the reference is not ported)."""
    if chunk_size is None or T <= chunk_size:
        return 0
    return (-T) % chunk_size


def _pad_inputs(ssm, R, Y, pad: int):
    """Append `pad` dummy steps: identity dynamics (A = I, Q = 0) and fully
    missing observations (NaN Y, identity R; a time-varying [T, p, d] H
    repeats its last step); results there are discarded."""
    d = ssm.m0.shape[-1]
    p = R.shape[-1]
    kw = dict(dtype=R.dtype, device=R.device)
    A = torch.cat([ssm.A, torch.eye(d, **kw).expand(pad, d, d)])
    Q = torch.cat([ssm.Q, torch.zeros((pad, d, d), **kw)])
    Rp = torch.cat([R, torch.eye(p, **kw).expand(pad, p, p)])
    Yp = torch.cat([Y, torch.full((pad, p), float("nan"), dtype=Y.dtype, device=Y.device)])
    H = ssm.H
    if H.dim() == 3:
        H = torch.cat([H, H[-1:].expand((pad,) + tuple(H.shape[1:]))])
    return ssm._replace(A=A, Q=Q, H=H), Rp, Yp


def _unpad(res, T: int):
    return type(res)(
        *[x[:T] if x is not None and x.dim() > 0 else x for x in res]
    )


def _check_supported(mesh):
    if mesh is not None:
        raise NotImplementedError("time-axis sharding is not ported yet")


def _square(F: FilterResult) -> FilterResult:
    """Covariance-form result of a square-root filter. The predicted factors
    are dropped: in covariance form Pp must be a covariance."""
    return F._replace(Ps=F.Ps @ F.Ps.transpose(-1, -2), Pp=None)


def _square_s(S: SmootherResult) -> SmootherResult:
    """Covariance-form result of the sequential square-root smoother, with
    its factors kept in `Ls` for the PSD projections."""
    return S._replace(Ps=S.Ps @ S.Ps.transpose(-1, -2), Ls=S.Ps)


def _mask_decoupled_R(R, Y):
    """Decouple the missing rows and columns of R before factoring: the
    square-root filters mask the factor per step, which implies the masked
    covariance only when missing rows are already decoupled in R."""
    return mask_covariance(R, observation_mask(Y, R.dtype))


def _run_filter_raw(ssm, R, Y, *, parallel, sqrt, chunk_size):
    """(covariance-form result, (Q factor, raw result)) of one filter pass."""
    if sqrt:
        Q_sqrt = safe_cholesky_rel(ssm.Q)
        R_sqrt = safe_cholesky_rel(_mask_decoupled_R(R, Y))
        P0_sqrt = safe_cholesky_rel(ssm.P0)
        if parallel:
            f = parallel_sqrt_kalman.parallel_sqrt_kalman_filter(
                ssm.A, Q_sqrt, ssm.H, R_sqrt, Y, ssm.m0, P0_sqrt, chunk_size=chunk_size
            )
        else:
            f = sqrt_kalman.sqrt_kalman_filter(ssm.A, Q_sqrt, ssm.H, R_sqrt, Y, ssm.m0, P0_sqrt)
        return _square(f), (Q_sqrt, f)
    if parallel:
        f = parallel_kalman.parallel_kalman_filter(
            ssm.A, ssm.Q, ssm.H, R, Y, ssm.m0, ssm.P0, chunk_size=chunk_size
        )
    else:
        f = kalman.kalman_filter(ssm.A, ssm.Q, ssm.H, R, Y, ssm.m0, ssm.P0)
    return f, (None, f)


def run_filter(ssm, R, Y, *, parallel=False, sqrt=False, chunk_size=None):
    """One filtering pass; returns (FilterResult, aux) with covariance Ps."""
    T = Y.shape[0]
    pad = _pad_amount(T, chunk_size if parallel else None)
    if pad:
        ssm, R, Y = _pad_inputs(ssm, R, Y, pad)
    f, aux = _run_filter_raw(ssm, R, Y, parallel=parallel, sqrt=sqrt, chunk_size=chunk_size)
    return _unpad(f, T), aux


def run_filter_smoother(ssm, R, Y, *, parallel=False, sqrt=False,
                        chunk_size=None, mesh=None):
    """Filter + smoother; both results carry covariance Ps."""
    _check_supported(mesh)
    T = Y.shape[0]
    pad = _pad_amount(T, chunk_size if parallel else None)
    if pad:
        ssm, R, Y = _pad_inputs(ssm, R, Y, pad)
    f_cov, (Q_sqrt, f_raw) = _run_filter_raw(
        ssm, R, Y, parallel=parallel, sqrt=sqrt, chunk_size=chunk_size
    )
    if sqrt and parallel:
        # covariance Ps plus the factors Ls (Gram-form scan, one final Cholesky)
        s = parallel_sqrt_kalman.parallel_sqrt_rts_smoother(
            ssm.A, Q_sqrt, f_raw, chunk_size=chunk_size
        )
    elif sqrt:
        s = _square_s(sqrt_kalman.sqrt_rts_smoother(ssm.A, Q_sqrt, f_raw))
    elif parallel:
        s = parallel_kalman.parallel_rts_smoother(ssm.A, ssm.Q, f_raw, chunk_size=chunk_size)
    else:
        s = kalman.rts_smoother(ssm.A, ssm.Q, f_raw)
    return _unpad(f_cov, T), _unpad(s, T)

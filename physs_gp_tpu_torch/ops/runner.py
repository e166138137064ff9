"""Filter/smoother dispatch (PyTorch).

Counterpart of `physs_gp_tpu/ops/runner.py`, covariance form with the
parallel filters only. The sequential filters, the square-root filters and
the time-sharded multi-device pass are not ported yet and raise
`NotImplementedError`.
"""
from __future__ import annotations

import torch

from . import parallel_kalman

__all__ = ["run_filter_smoother", "run_filter"]


def _pad_amount(T: int, chunk_size) -> int:
    """Steps to append so that T is a multiple of chunk_size (single device;
    the sharded variant of the reference is not ported)."""
    if chunk_size is None or T <= chunk_size:
        return 0
    return (-T) % chunk_size


def _pad_inputs(ssm, R, Y, pad: int):
    """Append `pad` dummy steps: identity dynamics (A = I, Q = 0) and fully
    missing observations (NaN Y, identity R); results there are discarded."""
    d = ssm.m0.shape[-1]
    p = R.shape[-1]
    kw = dict(dtype=R.dtype, device=R.device)
    A = torch.cat([ssm.A, torch.eye(d, **kw).expand(pad, d, d)])
    Q = torch.cat([ssm.Q, torch.zeros((pad, d, d), **kw)])
    Rp = torch.cat([R, torch.eye(p, **kw).expand(pad, p, p)])
    Yp = torch.cat([Y, torch.full((pad, p), float("nan"), dtype=Y.dtype, device=Y.device)])
    return ssm._replace(A=A, Q=Q), Rp, Yp


def _unpad(res, T: int):
    return type(res)(
        *[x[:T] if x is not None and x.dim() > 0 else x for x in res]
    )


def _check_supported(parallel, sqrt, mesh):
    if mesh is not None:
        raise NotImplementedError("time-axis sharding is not ported yet")
    if sqrt:
        raise NotImplementedError("the square-root filters are not ported yet")
    if not parallel:
        raise NotImplementedError("the sequential filters are not ported yet")


def run_filter(ssm, R, Y, *, parallel=False, sqrt=False, chunk_size=None):
    """One filtering pass; returns (FilterResult, aux) with covariance Ps."""
    _check_supported(parallel, sqrt, None)
    T = Y.shape[0]
    pad = _pad_amount(T, chunk_size)
    if pad:
        ssm, R, Y = _pad_inputs(ssm, R, Y, pad)
    f = parallel_kalman.parallel_kalman_filter(
        ssm.A, ssm.Q, ssm.H, R, Y, ssm.m0, ssm.P0, chunk_size=chunk_size
    )
    return _unpad(f, T), (None, f)


def run_filter_smoother(ssm, R, Y, *, parallel=False, sqrt=False,
                        chunk_size=None, mesh=None):
    """Filter + smoother; both results carry covariance Ps."""
    _check_supported(parallel, sqrt, mesh)
    T = Y.shape[0]
    pad = _pad_amount(T, chunk_size)
    if pad:
        ssm, R, Y = _pad_inputs(ssm, R, Y, pad)
    f = parallel_kalman.parallel_kalman_filter(
        ssm.A, ssm.Q, ssm.H, R, Y, ssm.m0, ssm.P0, chunk_size=chunk_size
    )
    s = parallel_kalman.parallel_rts_smoother(ssm.A, ssm.Q, f, chunk_size=chunk_size)
    return _unpad(f, T), _unpad(s, T)

"""Filter/smoother dispatch (PyTorch).

Counterpart of `physs_gp_tpu/ops/runner.py`: {sequential (`parallel=False`),
parallel} x {covariance, square-root (`sqrt=True`)}. Square-root variants
take and return triangular factors inside; the runner converts at the
boundary, so models always see covariance Ps (and, from the square-root
smoothers, the factors in `Ls`). `mesh=` (a `torch.distributed`
`DeviceMesh`) sends the pass through the time-sharded multi-device scans of
`parallel/sharded.py`: each rank passes its segment of the T-step series
(`sharded.segment`) and gets its segment of the results, the last ranks'
segments padded to the mesh and chunk grid.
`run_filter(mesh=)` runs the sharded filter alone: the reference's lml
reads the filter's results of its sharded filter + smoother pass, and
`jax.jit` drops the smoother from that program; eager PyTorch would not.
"""
from __future__ import annotations

import torch

from . import kalman, parallel_kalman, parallel_sqrt_kalman, sqrt_kalman
from .gaussian import mask_covariance
from .kalman import FilterResult, SmootherResult, observation_mask
from .matrix import safe_cholesky_rel

__all__ = ["run_filter_smoother", "run_filter"]


def _pad_amount(T: int, chunk_size, n_shards: int = 1) -> int:
    """Steps to append so that T divides into n_shards equal segments, each
    a multiple of chunk_size (chunking applies within a segment)."""
    unit = n_shards * (chunk_size or 1)
    if n_shards == 1 and (chunk_size is None or T <= chunk_size):
        return 0
    if n_shards > 1 and chunk_size is not None:
        # judge the no-op on the padded segment length ceil(T / n): with
        # T = 1001, 8 shards, chunk 125 the floor test would pick unit = 8
        # and leave a 126-step segment that does not divide by the chunk
        if -(-T // n_shards) <= chunk_size:
            unit = n_shards  # chunking is a no-op within each segment
    return (-T) % unit


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


def run_filter(ssm, R, Y, *, parallel=False, sqrt=False, chunk_size=None, mesh=None,
               mesh_axis: str = "t", T=None):
    """One filtering pass; returns (FilterResult, aux) with covariance Ps.
    `mesh`: the time-sharded filter over the mesh dimension `mesh_axis` on
    the rank's segment of the T-step series (aux None; as
    `run_filter_smoother`)."""
    if mesh is not None:
        return _run_sharded(ssm, R, Y, sqrt=sqrt, chunk_size=chunk_size, mesh=mesh,
                            mesh_axis=mesh_axis, smooth=False, T=T)[0], None
    T = Y.shape[0]
    pad = _pad_amount(T, chunk_size if parallel else None)
    if pad:
        ssm, R, Y = _pad_inputs(ssm, R, Y, pad)
    f, aux = _run_filter_raw(ssm, R, Y, parallel=parallel, sqrt=sqrt, chunk_size=chunk_size)
    return _unpad(f, T), aux


def run_filter_smoother(ssm, R, Y, *, parallel=False, sqrt=False,
                        chunk_size=None, mesh=None, mesh_axis: str = "t", T=None):
    """Filter + smoother; both results carry covariance Ps.

    `mesh`: a `DeviceMesh` routes the pass through the time-sharded scans
    over its dimension `mesh_axis` (`parallel/sharded.py`); `parallel` is
    implied. The series has T steps (required with a mesh), and every
    time-indexed input (ssm.A, ssm.Q, a time-varying ssm.H, R, Y)
    holds the rank's rows of it, `sharded.segment(T, mesh, mesh_axis,
    chunk_size)`, or all T (then the rank's are taken); the results hold
    the rank's rows, and the filter's lml is their sum."""
    if mesh is not None:
        return _run_sharded(ssm, R, Y, sqrt=sqrt, chunk_size=chunk_size, mesh=mesh,
                            mesh_axis=mesh_axis, smooth=True, T=T)
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


def _run_sharded(ssm, R, Y, *, sqrt, chunk_size, mesh, mesh_axis, smooth, T):
    """The time-sharded pass (the filter alone unless `smooth`) on the
    rank's segment, padded to the segment's length on the mesh and chunk
    grid; the square-root form factors the segment's Q, mask-decoupled R
    and P0 as `_run_filter_raw` does."""
    from ..parallel import sharded

    if T is None:
        raise ValueError("a time-sharded pass needs T, the series' length over all ranks")
    seg = sharded.segment(T, mesh, mesh_axis, chunk_size)
    H = seg.rows(ssm.H) if ssm.H.dim() == 3 else ssm.H
    ssm, R, Y = ssm._replace(A=seg.rows(ssm.A), Q=seg.rows(ssm.Q), H=H), seg.rows(R), seg.rows(Y)
    rows = seg.hi - seg.lo
    if seg.length > rows:
        ssm, R, Y = _pad_inputs(ssm, R, Y, seg.length - rows)
    if sqrt:
        f, s = sharded.sharded_sqrt_filter_smoother(
            ssm.A, safe_cholesky_rel(ssm.Q), ssm.H, safe_cholesky_rel(_mask_decoupled_R(R, Y)), Y,
            ssm.m0, safe_cholesky_rel(ssm.P0), mesh=mesh, axis=mesh_axis, chunk_size=chunk_size,
            smooth=smooth)
    else:
        f, s = sharded.sharded_filter_smoother(ssm.A, ssm.Q, ssm.H, R, Y, ssm.m0, ssm.P0, mesh=mesh,
                                               axis=mesh_axis, chunk_size=chunk_size, smooth=smooth)
    return _unpad(f, rows), None if s is None else _unpad(s, rows)

"""Linear-Gaussian state-space model assembly from Markov kernels (PyTorch).

Counterpart of `physs_gp_tpu/ops/lgssm.py`: all T transitions are built in
one batched pass before the filter runs; under time-axis sharding, a
rank's rows of them (`build_lgssm(seg=)`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["LGSSM", "build_lgssm", "project_mean", "project_var", "project_cov",
           "project_cov_factor"]


class LGSSM(NamedTuple):
    A: torch.Tensor  # [T, d, d]
    Q: torch.Tensor  # [T, d, d]
    H: torch.Tensor  # [p, d]
    m0: torch.Tensor  # [d]
    P0: torch.Tensor  # [d, d]


def build_lgssm(kernel, t, seg=None) -> LGSSM:
    """Discretise a Markov kernel over sorted time points t [T]; dt_0 = 0,
    so A[0] = I, Q[0] = 0 and the first prediction is the stationary prior.

    `seg` (a `parallel.sharded.Segment`): rows [seg.lo, seg.hi) of A and Q
    alone, built over t[lo - 1 : hi] with the first row dropped (its
    predecessor's step gives row lo's dt), so they equal those rows of the
    whole build."""
    from ..kernels.markov import noise_matrix, to_ss, transition_matrix

    if seg is not None:
        t = t.reshape(-1)
        ssm = build_lgssm(kernel, t[max(seg.lo - 1, 0):seg.hi])
        return ssm if seg.lo == 0 else ssm._replace(A=ssm.A[1:], Q=ssm.Q[1:])
    if hasattr(kernel, "to_lgssm"):
        # composite kernels (e.g. SpatioTemporalKernel) own their lifting
        return kernel.to_lgssm(t)
    t = t.reshape(-1)
    ss = to_ss(kernel)
    dt = torch.cat([torch.zeros(1, dtype=t.dtype, device=t.device), torch.diff(t)])
    return LGSSM(
        A=transition_matrix(kernel, dt),
        Q=noise_matrix(kernel, dt),
        H=ss.H,
        m0=ss.minf,
        P0=ss.Pinf,
    )


def project_mean(H, ms):
    """[T, p] head means from smoothed state means ms [T, d]."""
    if H.dim() == 2:
        return ms @ H.T
    return torch.einsum("tpd,td->tp", H, ms)


def _Ps_Ht(H, Ps):
    """Y[t, i, q] = sum_j Ps[t, i, j] H[q, j] as one [T*d, d] @ [d, p] product."""
    T, d, _ = Ps.shape
    return (Ps.reshape(T * d, d) @ H.T).reshape(T, d, H.shape[0])


def project_var(H, Ps):
    """[T, p] head variances (the diagonal of H Ps Hᵀ) from state
    covariances Ps [T, d, d]."""
    if H.dim() == 2:
        return torch.sum(_Ps_Ht(H, Ps) * H.T[None], 1)
    return torch.einsum("tpi,tij,tpj->tp", H, Ps, H)


def project_cov_factor(H, Ls):
    """[T, p, p] head covariances (H L)(H L)ᵀ from covariance factors Ls
    [T, d, d]: PSD by construction, with float32 rounding relative to the
    projected scale rather than the state scale."""
    if H.dim() == 2:
        T, d, _ = Ls.shape
        p = H.shape[0]
        # M[t] = H @ Ls[t] as one [p, d] @ [d, T*d] product
        M = (H @ Ls.movedim(0, 1).reshape(d, T * d)).reshape(p, T, d).movedim(0, 1)
    else:
        M = torch.einsum("tpi,tij->tpj", H, Ls)
    return M @ M.transpose(-1, -2)


def project_cov(H, Ps):
    """[T, p, p] head covariances H Ps H^T from state covariances Ps [T, d, d]."""
    if H.dim() == 2:
        T, d, _ = Ps.shape
        p = H.shape[0]
        Y = _Ps_Ht(H, Ps)  # [T, d, p]
        # out[t, p, q] = sum_i H[p, i] Y[t, i, q]: one [p, d] @ [d, T*p] product
        out = (H @ Y.movedim(0, 1).reshape(d, T * p)).reshape(p, T, p)
        return out.movedim(0, 1)
    return torch.einsum("tpi,tij,tqj->tpq", H, Ps, H)

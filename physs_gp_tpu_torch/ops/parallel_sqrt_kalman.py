"""Parallel square-root Kalman filter and smoother (PyTorch).

Counterpart of `physs_gp_tpu/ops/parallel_sqrt_kalman.py` (Yaghoobi,
Corenflos, Hassan & Särkkä): filtering elements carry triangular factors
(A, b, U, eta, Z) with C = U Uᵀ and J = Z Zᵀ, and the associative combine
works in QR/Woodbury form, so no PSD matrix is ever subtracted. It is the
float32-robust form for long series with tight observation noise, where the
covariance combine goes indefinite.

    A = A2 (I + C1 J2)^-1 A1,
    (I + C1 J2)^-1      = I - U1 M^-1 G Z2ᵀ,      G = U1ᵀ Z2, M = I + G Gᵀ
    (I + C1 J2)^-1 C1   = (U1 Xi^-T)(U1 Xi^-T)ᵀ,  Xi  = tria([G, I])
    (I + J2 C1)^-1 J2   = (Z2 Lam^-T)(Z2 Lam^-T)ᵀ, Lam = tria([Gᵀ, I]).

The scans run the blocked schedule of `parallel_kalman.blocked_inclusive_scan`
with the square-root identity element (A = I, the rest 0); chunks carry the
filtered (m, U). The smoother scans in covariance (Gram) form with the
covariance smoother's unfused combine (the fused-combine knob acts on the
covariance-form scans only), then factors once. Triangular solves run the
batched Gauss-Jordan kernel (`gen_solve`), factors the LQ and Gram +
Cholesky kernels (`tria`, `tria_sum`), the final factor the pivot-floored
Cholesky kernel. Where the reference multiplies through `bmm` the port does
too (the batched kernel); where it writes `einsum` the port uses PyTorch's
own products.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .kalman import FilterResult, SmootherResult, observation_mask
from .matrix import _cholesky_any, bmm, gen_solve, symmetrize
from .parallel_kalman import (
    _SmootherElems,
    _chunks,
    _ident_smoother_elem,
    _map,
    _mtv,
    _mv,
    _smoothing_final,
    _smoothing_operator_unfused,
    blocked_inclusive_scan,
)
from .sqrt_kalman import tria, tria_sum

__all__ = [
    "parallel_sqrt_kalman_filter",
    "parallel_sqrt_rts_smoother",
    "sqrt_smoother_elements",
]

_LOG2PI = math.log(2.0 * math.pi)


class _SqrtFilterElems(NamedTuple):
    A: torch.Tensor  # [T, d, d]
    b: torch.Tensor  # [T, d]
    U: torch.Tensor  # [T, d, d]  C = U Uᵀ
    eta: torch.Tensor  # [T, d]
    Z: torch.Tensor  # [T, d, d]  J = Z Zᵀ


def _solve_tri(L, B):
    """Batched triangular solve L X = B through the Gauss-Jordan kernel: on a
    triangular system it pivots on the diagonal and matches a triangular
    solve to rounding."""
    return gen_solve(L, B)


def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _masked_noise_factor(R_sqrt, mask):
    """mask · R^1/2 · mask with an identity filler on missing rows."""
    return mask[..., :, None] * R_sqrt * mask[..., None, :] + torch.diag_embed(1.0 - mask)


def _build_sqrt_elements(A, Q_sqrt, H, R_sqrt, y, mask, m0, U0):
    """Square-root filtering elements for all T steps; the prior folds into
    element 0.

      S^1/2   = tria([H Up, R^1/2])          LQ (information side)
      K S^1/2 = Up (S^-1/2 H Up)ᵀ           one solve against S^1/2
      U'      = tria_sum((I-KH) Up, K R^1/2) Joseph form, a PSD sum
      Z       = tria(Aᵀ (S^-1/2 H)ᵀ)         LQ (information side)
    """
    T, d = y.shape[0], m0.shape[-1]
    y0 = torch.where(mask > 0, torch.nan_to_num(y), 0.0)
    Hm = mask[..., :, None] * H  # [T, p, d]
    Rs_m = _masked_noise_factor(R_sqrt, mask)

    # local prior factor: Qs_k, and tria([A0 U0, Qs_0]) at the first step
    Up_loc = Q_sqrt.clone()
    Up_loc[0] = tria(torch.cat([A[0] @ U0, Q_sqrt[0]], -1))
    m_first = (A[0] @ m0)[None]
    # out of place: under `vmap` the first row may be batched where zeros are not
    m_loc = torch.cat([m_first, m_first.new_zeros((T - 1, d))])

    HU = Hm @ Up_loc  # [T, p, d]
    # [HU, Rs] has full row rank (Rs diag > 0, identity filler included)
    L_S = tria(torch.cat([HU, Rs_m], -1), assume_full_rank=True)

    v = y0 - _mv(Hm, m_loc)
    # one solve against L_S for all four right-hand sides
    sol = _solve_tri(L_S, torch.cat([v[..., None], HU, Hm, Rs_m], -1))
    Sv = sol[..., 0]  # S^-1/2 v
    N = sol[..., 1:1 + d]  # S^-1/2 H Up
    M = sol[..., 1 + d:1 + 2 * d]  # S^-1/2 H
    Rtil = sol[..., 1 + 2 * d:]  # S^-1/2 R^1/2
    KS = bmm(Up_loc, N, tb=True)  # K S^1/2
    b_out = m_loc + _mv(KS, Sv)
    KH = bmm(KS, M)
    A_out = A - KH @ A

    # Joseph form: U' U'ᵀ = (I-KH) P (I-KH)ᵀ + K R Kᵀ
    U_out = tria_sum(Up_loc - bmm(KH, Up_loc), bmm(KS, Rtil))

    eta = _mtv(A, _mtv(M, Sv))  # Aᵀ Hᵀ S^-1 v
    Z = tria(bmm(A, M, ta=True, tb=True))

    # first element: A = 0, eta = 0, Z = 0 (the prior is in b, U)
    A_out[0] = 0.0
    eta[0] = 0.0
    Z[0] = 0.0
    return _SqrtFilterElems(A=A_out, b=b_out, U=U_out, eta=eta, Z=Z)


def _broadcast_batch(e1, e2):
    """Expand two elements to a common batch shape (the concatenations of
    the square-root algebra need matching shapes)."""
    b1, b2 = e1.A.shape[:-2], e2.A.shape[:-2]
    if b1 == b2:
        return e1, e2
    batch = torch.broadcast_shapes(b1, b2)

    def fix(e, nb):
        return _map(lambda x: x.expand(batch + tuple(x.shape[nb:])), e)

    return fix(e1, len(b1)), fix(e2, len(b2))


def _sqrt_filtering_moments(e1, e2, G=None, W1=None, XiG=None):
    """Moment outputs (b, U) of the combine and the A2 W1 product the full
    operator builds on. `W1`/`XiG` come from the full operator, which solves
    them together with the Lam side; without them (the distribute pass) the
    solve against Xi runs with d + 1 right-hand sides."""
    d = e1.A.shape[-1]
    if G is None:
        G = bmm(e1.U, e2.Z, ta=True)  # U1ᵀ Z2
    u = e1.b + _mv(e1.U, _mtv(e1.U, e2.eta))  # b1 + U1 U1ᵀ eta2
    Z2tu = _mtv(e2.Z, u)
    if W1 is None:
        eye = _eye(d, G).expand(G.shape)
        # information side stays on the LQ; [G, I] has full row rank
        Xi = tria(torch.cat([G, eye], -1), assume_full_rank=True)
        vec = _mv(G, Z2tu)
        sol = _solve_tri(Xi, torch.cat([e1.U.transpose(-1, -2), vec[..., None]], -1))
        W1 = sol[..., :d].transpose(-1, -2)
        Gz = sol[..., d]  # Xi^-1 G Z2ᵀ u
    else:
        Gz = _mv(XiG, Z2tu)
    A2W1 = bmm(e2.A, W1)
    b = e2.b + _mv(e2.A, u - _mv(W1, Gz))
    U = tria_sum(A2W1, e2.U)
    return A2W1, b, U


def _sqrt_filtering_operator(e1, e2):
    """Associative combine in square-root form (e1 earlier, e2 later).

    Xi = tria([G, I]) and Lam = tria([Gᵀ, I]) run as one LQ launch on the
    batch-stacked pre-arrays, and all their solves as one Gauss-Jordan
    launch; the Lam right-hand side is zero-padded from d + 1 to 2d
    columns to stack."""
    e1, e2 = _broadcast_batch(e1, e2)
    d = e1.A.shape[-1]
    nb = e1.A.shape[-3]
    eye = _eye(d, e1.A).expand(e1.A.shape)
    G = bmm(e1.U, e2.Z, ta=True)  # U1ᵀ Z2
    Gt = G.transpose(-1, -2)
    w = e2.eta - _mv(e2.Z, _mtv(e2.Z, e1.b))  # eta2 - Z2 Z2ᵀ b1
    GtU1tw = _mtv(G, _mtv(e1.U, w))  # Gᵀ U1ᵀ w
    rhs_xi = torch.cat([e1.U.transpose(-1, -2), G], -1)
    rhs_lam = torch.cat([e2.Z.transpose(-1, -2), GtU1tw[..., None]], -1)
    pre = torch.cat([torch.cat([G, eye], -1), torch.cat([Gt, eye], -1)], -3)
    XiLam = tria(pre, assume_full_rank=True)
    pad = rhs_lam.new_zeros(rhs_lam.shape[:-1] + (d - 1,))
    sol = _solve_tri(XiLam, torch.cat([rhs_xi, torch.cat([rhs_lam, pad], -1)], -3))
    sol_xi, sol_lam = sol[..., :nb, :, :], sol[..., nb:, :, :]
    W1 = sol_xi[..., :d].transpose(-1, -2)  # U1 Xi^-T
    XiG = sol_xi[..., d:]  # Xi^-1 G
    V2t = sol_lam[..., :d]  # Lam^-1 Z2ᵀ
    lg = sol_lam[..., d]  # Lam^-1 Gᵀ U1ᵀ w
    A2W1, b, U = _sqrt_filtering_moments(e1, e2, G=G, W1=W1, XiG=XiG)

    # A = A2 A1 - (A2 W1) (Xi^-1 G) (Z2ᵀ A1)
    Z2tA1 = bmm(e2.Z, e1.A, ta=True)
    A = bmm(e2.A, e1.A) - bmm(bmm(A2W1, XiG), Z2tA1)
    eta = e1.eta + _mtv(e1.A, w - _mtv(V2t, lg))
    # information side on the LQ; zeroed inputs take tria's bypass
    Z = tria(torch.cat([bmm(e1.A, V2t, ta=True, tb=True), e1.Z], -1))
    return _SqrtFilterElems(A=A, b=b, U=U, eta=eta, Z=Z)


def _sqrt_filtering_final(e1, e2):
    """Distribute-pass combine emitting only the filtered moments (b, U)."""
    e1, e2 = _broadcast_batch(e1, e2)
    _, b, U = _sqrt_filtering_moments(e1, e2)
    return b, U


def _ident_sqrt_elem(d, like):
    kw = dict(dtype=like.dtype, device=like.device)
    return _SqrtFilterElems(
        A=torch.eye(d, **kw), b=torch.zeros(d, **kw), U=torch.zeros(d, d, **kw),
        eta=torch.zeros(d, **kw), Z=torch.zeros(d, d, **kw),
    )


def _per_step_lml_sqrt(A, Q_sqrt, H, R_sqrt, y, mask, ms, m0, U0, Us):
    """Per-step lml from the square-root predictive factors; also returns
    the predicted factors Up[t] = P_{t|t-1}^1/2 for the smoother."""
    m_prev = torch.cat([m0[None], ms[:-1]])
    U_prev = torch.cat([U0[None], Us[:-1]])
    m_pred = _mv(A, m_prev)
    Up = tria_sum(bmm(A, U_prev), Q_sqrt)
    Hm = mask[..., :, None] * H
    Rs_m = _masked_noise_factor(R_sqrt, mask)
    S_sqrt = tria(torch.cat([bmm(Hm, Up), Rs_m], -1), assume_full_rank=True)
    y0 = torch.where(mask > 0, torch.nan_to_num(y), 0.0)
    v = y0 - _mv(Hm, m_pred)
    alpha = _solve_tri(S_sqrt, v[..., None])[..., 0]
    logdet = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(S_sqrt, dim1=-2, dim2=-1))), -1)
    n_obs = torch.sum(mask, -1)
    lmls = -0.5 * (torch.sum(alpha * alpha, -1) + logdet + n_obs * _LOG2PI)
    return lmls, Up


def parallel_sqrt_kalman_filter(A, Q_sqrt, H, R_sqrt, y, m0, P0_sqrt, mask=None,
                                chunk_size: int | None = None) -> FilterResult:
    """Parallel-scan square-root filter; Ps and Pp of the result are lower
    factors of the filtered and predicted covariances."""
    T = y.shape[0]
    d = m0.shape[-1]
    if mask is None:
        mask = observation_mask(y, P0_sqrt.dtype)
    H_steps = H.expand((T,) + tuple(H.shape[-2:])) if H.dim() == 2 else H
    ident = _ident_sqrt_elem(d, P0_sqrt)

    m_prev, U_prev = m0, P0_sqrt
    ms, Us = [], []
    for s, e in _chunks(T, chunk_size):
        elems = _build_sqrt_elements(
            A[s:e], Q_sqrt[s:e], H_steps[s:e], R_sqrt[s:e], y[s:e], mask[s:e],
            m_prev, U_prev,
        )
        (ms_c, Us_c), _ = blocked_inclusive_scan(
            _sqrt_filtering_operator, elems, ident, final_op=_sqrt_filtering_final
        )
        m_prev, U_prev = ms_c[-1], Us_c[-1]
        ms.append(ms_c)
        Us.append(Us_c)
    ms = torch.cat(ms)
    Us = torch.cat(Us)
    lmls, Up = _per_step_lml_sqrt(A, Q_sqrt, H_steps, R_sqrt, y, mask, ms, m0, P0_sqrt, Us)
    return FilterResult(ms=ms, Ps=Us, lml=torch.sum(lmls), lmls=lmls, Pp=Up)


def _factor_psd(L):
    """Factor a PSD covariance for the PSD projections downstream: the
    pivot-floored Cholesky kernel with no added jitter (the reference's TPU
    branch), on both devices."""
    return _cholesky_any(symmetrize(L), assume_psd=True)


def sqrt_smoother_elements(A_next, Qs_next, ms, Us, Pp_sqrt=None):
    """Smoothing elements (G, g, L22) in Gram-Joseph form:

      Pp^1/2 = tria_sum(A U, Qs)             (or the filter's Pp, rolled)
      G      = P Aᵀ Pp^-1                   Linv = Pp^-1/2 in one solve
      L22    = (I-GA) P (I-GA)ᵀ + G Q Gᵀ    as a Gram, no subtraction

    Inputs are the k -> k+1 rolled (A, Qs); entry [-1] is overwritten by the
    caller."""
    AU = bmm(A_next, Us)
    if Pp_sqrt is None:
        Pp_sqrt = tria_sum(AU, Qs_next)
    AP = bmm(AU, Us, tb=True)  # A P
    eye = _eye(Pp_sqrt.shape[-1], Pp_sqrt).expand(Pp_sqrt.shape)
    Linv = _solve_tri(Pp_sqrt, eye)
    Gt = bmm(Linv, bmm(Linv, AP), ta=True)  # Pp^-1 A P
    G = Gt.transpose(-1, -2)
    WU = Us - bmm(G, AU)  # (I - G A) U
    GQ = bmm(G, Qs_next)
    L22 = symmetrize(bmm(WU, WU, tb=True) + bmm(GQ, GQ, tb=True))
    g = ms - _mv(G, _mv(A_next, ms))
    return G, g, L22


def parallel_sqrt_rts_smoother(A, Q_sqrt, filtered: FilterResult,
                               chunk_size: int | None = None) -> SmootherResult:
    """Parallel-scan smoother for the square-root pipeline; filtered.Ps are
    factors. Returns covariance Ps and their factors in Ls: the scan runs in
    covariance form with the covariance combine (a PSD sum), then one
    T-wide Cholesky factors the result."""
    ms, Us = filtered.ms, filtered.Ps
    T, d = ms.shape
    A_next = torch.roll(A, -1, 0)
    Qs_next = torch.roll(Q_sqrt, -1, 0)
    # the filter's lml pass built Up[t] = P_{t|t-1}^1/2; Pp_sqrt[t] = Up[t+1]
    Pp_sqrt = torch.roll(filtered.Pp, -1, 0) if filtered.Pp is not None else None
    G, g, L22 = sqrt_smoother_elements(A_next, Qs_next, ms, Us, Pp_sqrt)

    E = G.contiguous()
    E[-1] = 0.0
    g[-1] = ms[-1]
    L22[-1] = Us[-1] @ Us[-1].T
    flipped = _SmootherElems(E=E.flip(0), g=g.flip(0), L=L22.flip(0))

    carry = _ident_smoother_elem(d, Us)
    gs, Ls = [], []
    for s, e in _chunks(T, chunk_size):
        (g_c, L_c), carry = blocked_inclusive_scan(
            _smoothing_operator_unfused, _map(lambda x: x[s:e], flipped),
            _ident_smoother_elem(d, Us), final_op=_smoothing_final, init=carry,
        )
        gs.append(g_c)
        Ls.append(L_c)
    gs = torch.cat(gs).flip(0)
    Ls_cov = torch.cat(Ls).flip(0)
    return SmootherResult(ms=gs, Ps=Ls_cov, Gs=E, Ls=_factor_psd(Ls_cov))

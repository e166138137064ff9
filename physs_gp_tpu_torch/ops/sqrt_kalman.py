"""Square-root Kalman filtering (PyTorch): `tria`, `tria_sum`, `psd_sqrt` and
the sequential square-root filter and smoother.

Counterpart of `physs_gp_tpu/ops/sqrt_kalman.py`. Covariances are carried as
lower-triangular factors; `tria(B)` is the L with L Lᵀ = B Bᵀ (canonical
diag >= 0), `tria_sum(X, Y)` the L with L Lᵀ = X Xᵀ + Y Yᵀ (+ I).

Forward passes run the batched kernels: `tria` the Householder LQ
(`ops/cuda/batched_qr.batch_tria`), `tria_sum` the fused Gram + Cholesky
(`ops/cuda/batched_chol.batch_chol_gram`), on every shape they hold, on
both devices (the TPU package gates them to its TPU backend). Backward
passes recompute through the library QR (`torch.geqrf`, with QR's backward
in batched products), as the reference's custom VJPs recompute through
XLA's QR: the TPU kernels have no backward kernel.

`sqrt_kalman_filter` and `sqrt_rts_smoother` are Python loops over T: every
step is one `tria` of a joint pre-array (the LQ kernel at batch 1) and
PyTorch's own triangular solves. They share no schedule with the parallel
square-root scans, which makes them those scans' oracle, as `ops/kalman` is
the covariance scans'.
"""
from __future__ import annotations

import math

import torch

from .cuda.batched_chol import batch_chol_gram
from .cuda.batched_qr import batch_tria, lq_fits
from .cuda.build import D_MAX, count_route
from .gaussian import mask_covariance
from .kalman import FilterResult, SmootherResult, observation_mask
from .matrix import apply_function, recompute_vjp, symmetrize, unit_last

__all__ = ["tria", "tria_sum", "psd_sqrt", "sqrt_kalman_filter", "sqrt_rts_smoother"]

_LOG2PI = math.log(2.0 * math.pi)


def _floor(dtype) -> float:
    # the in-sqrt floor must not underflow in the working dtype
    return 1e-24 if dtype.itemsize < 8 else 1e-60


def tria(B, assume_full_rank: bool = False):
    """Lower-triangular L [.., d, d] with L Lᵀ = B Bᵀ, B [.., d, m].

    Exactly-zero pre-arrays (the zeroed first elements of each chunk, the
    scan's identity element) bypass the factorisation and return 0 with a
    zero gradient; the backward of the others runs through a pre-array with
    a tiny relative identity block appended, so rank-deficient inputs keep
    bounded gradients. `assume_full_rank=True` skips both, for pre-arrays
    with a full-row-rank block ([G, I], [H U, R^1/2])."""
    return _tria(B, assume_full_rank, _kernel_core)


def _kernel_core(B, ref):
    """The factorisation by the LQ kernel (`_TriaCore`), its backward
    through `ref`."""
    return apply_function(_TriaCore, B, ref)


def _reference_core(B, ref):
    """`_TriaCore`'s gradient without the kernel: `ref` itself."""
    return ref(B)


def _tria(B, assume_full_rank: bool, core):
    """`tria` with `core(B, ref)` for the factorisation whose backward runs
    through `ref`: `_kernel_core`, or `_reference_core`."""
    if assume_full_rank:
        return core(B, _tria_canonical_ref)
    d, m = B.shape[-2], B.shape[-1]
    if m < d:  # zero columns leave B Bᵀ unchanged; the LQ needs m >= d
        B = torch.cat([B, B.new_zeros(B.shape[:-1] + (d - m,))], -1)
        m = d
    floor = _floor(B.dtype)
    scale = torch.sqrt(torch.sum(B * B, dim=(-1, -2), keepdim=True) / d + floor)
    is_zero = scale <= 2.0 * floor ** 0.5
    eye = torch.eye(d, m, dtype=B.dtype, device=B.device)
    B_safe = torch.where(is_zero, eye, B)
    return torch.where(is_zero, 0.0, core(B_safe, _tria_reg))


class _QrR(torch.autograd.Function):
    """R of the reduced QR of A [.., m, n], m >= n, by `torch.geqrf`. The
    backward is QR's: A_bar = Q copyltu(R R_barᵀ) R⁻ᵀ, with copyltu(M) the
    symmetric matrix of M's lower triangle, and Q accumulated from the
    Householder reflectors in batched products. (`torch.linalg.qr`'s own
    backward forms Q through `orgqr`, which the CUDA build runs one matrix
    at a time.) The forward also returns the factorisation (a, tau), which
    the backward reads; `_qr_r` gives R alone."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A):
        a, tau = torch.geqrf(A)
        return a[..., : A.shape[-1], :].triu(), a, tau

    @staticmethod
    def setup_context(ctx, inputs, output):
        R, a, tau = output
        ctx.mark_non_differentiable(a, tau)
        ctx.save_for_backward(a, tau, R)

    @staticmethod
    def backward(ctx, gR, _ga, _gtau):
        a, tau, R = ctx.saved_tensors
        m, n = a.shape[-2:]
        eye = torch.eye(m, n, dtype=a.dtype, device=a.device)
        V = a.tril(-1) + eye  # column i: the reflector v_i, v_i[i] = 1
        Q = eye.expand(a.shape)
        for i in reversed(range(n)):  # Q = H_0 ... H_{n-1} [I; 0]
            v = V[..., i : i + 1]
            Q = Q - (tau[..., i, None, None] * v) @ (v.transpose(-1, -2) @ Q)
        M = R @ gR.triu().transpose(-1, -2)
        Y = M.tril() + M.tril(-1).transpose(-1, -2)
        return torch.linalg.solve_triangular(R.transpose(-1, -2), Q @ Y, upper=False, left=False)


def _qr_r(A):
    """R of the reduced QR of A [.., m, n], m >= n (`_QrR`)."""
    return apply_function(_QrR, A)[0]


def _tria_canonical_ref(B):
    """Canonical (diag >= 0) factor through the library QR (backward)."""
    r = _qr_r(B.transpose(-1, -2))
    L = r.transpose(-1, -2)
    sign = torch.sign(torch.diagonal(L, dim1=-2, dim2=-1))
    sign = torch.where(sign == 0, 1.0, sign)
    return L * sign[..., None, :]


def _tria_reg(B):
    """`_tria_canonical_ref` of [B, eps * scale(B) * I]: bounded gradients
    for (near) rank-deficient B, O(eps^2) away from the plain factor."""
    d = B.shape[-2]
    eps = 1e-6 if B.dtype.itemsize < 8 else 1e-9
    scale = torch.sqrt(torch.sum(B * B, dim=(-1, -2), keepdim=True) / d + _floor(B.dtype))
    reg = eps * scale * torch.eye(d, dtype=B.dtype, device=B.device)
    return _tria_canonical_ref(torch.cat([B, reg.expand(B.shape[:-1] + (d,))], -1))


class _TriaCore(torch.autograd.Function):
    """Forward: the LQ kernel on B (above its shapes, `lq_fits`, the library
    QR, `_tria_canonical_ref`, on B's own device, counted as the "lq"
    wrapper's "library" route on the card); backward: through
    `ref` (the QR of B, `_tria_canonical_ref`, or of the regularised
    pre-array, `_tria_reg`)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(B, ref):
        d, m = B.shape[-2:]
        if not lq_fits(d, m):
            if B.is_cuda:
                count_route("lq", "library")
            return _tria_canonical_ref(B)
        L = batch_tria(unit_last(B.reshape(-1, d, m)))
        return L.reshape(B.shape[:-1] + (d,))

    @staticmethod
    def setup_context(ctx, inputs, output):
        B, ctx.ref = inputs
        ctx.save_for_backward(B)

    @staticmethod
    def backward(ctx, ct):
        return *recompute_vjp(ctx.ref, ct, *ctx.saved_tensors), None


def _eye_like(X):
    d = X.shape[-2]
    return torch.eye(d, dtype=X.dtype, device=X.device).expand(X.shape[:-1] + (d,))


def _tria_sum_ref(X, Y, plus_eye: bool, core=_kernel_core):
    """Reference composition: `tria` of the concatenated pre-array."""
    parts = [X] + ([] if Y is None else [Y]) + ([_eye_like(X)] if plus_eye else [])
    return _tria(torch.cat(parts, -1), False, core)


class _CholGramCore(torch.autograd.Function):
    """Forward: the fused Gram + Cholesky kernel; backward: through
    `_tria_sum_ref`, whose QR stays finite for rank-deficient inputs."""

    generate_vmap_rule = True

    @staticmethod
    def forward(X, Y, plus_eye):
        return batch_chol_gram(unit_last(X), None if Y is None else unit_last(Y),
                               plus_eye=plus_eye)

    @staticmethod
    def setup_context(ctx, inputs, output):
        X, Y, ctx.plus_eye = inputs
        ctx.save_for_backward(X, Y)

    @staticmethod
    def backward(ctx, ct):
        X, Y = ctx.saved_tensors
        # differentiates `tria`'s backward reference directly: the LQ
        # kernel's forward value would go unread
        gx, gy = recompute_vjp(lambda x, y: _tria_sum_ref(x, y, ctx.plus_eye, _reference_core),
                               ct, X, Y)
        return gx, gy, None


def tria_sum(X, Y=None, plus_eye: bool = False):
    """Lower-triangular L with L Lᵀ = X Xᵀ (+ Y Yᵀ) (+ I when plus_eye).

    Semantically `tria(cat([X, Y, I]))`; every term is a PSD sum, so it runs
    the fused Gram + Cholesky kernel wherever the shapes fit ([N, d, m],
    d, m <= 80). Exactly-zero inputs bypass it as in `tria`."""
    fits = (
        X.dim() == 3
        and (Y is None or Y.shape[:-1] == X.shape[:-1])
        and max(X.shape[-2:]) <= D_MAX
        and (Y is None or Y.shape[-1] <= D_MAX)
    )
    if not fits:
        return _tria_sum_ref(X, Y, plus_eye)
    if plus_eye:  # Gram + I: spectrum >= 1, never degenerate
        return apply_function(_CholGramCore, X, Y, True)
    floor = _floor(X.dtype)
    s2 = torch.sum(X * X, dim=(-1, -2), keepdim=True)
    if Y is not None:
        s2 = s2 + torch.sum(Y * Y, dim=(-1, -2), keepdim=True)
    is_zero = s2 / X.shape[-2] + floor <= 2.0 * floor
    Xs = torch.where(is_zero, torch.eye(*X.shape[-2:], dtype=X.dtype, device=X.device), X)
    Ys = None if Y is None else torch.where(is_zero, 0.0, Y)
    return torch.where(is_zero, 0.0, apply_function(_CholGramCore, Xs, Ys, False))


def psd_sqrt(A):
    """Eigenvalue-clipped symmetric square root (exactly singular matrices,
    such as Q(dt = 0) = 0, included)."""
    w, V = torch.linalg.eigh(symmetrize(A))
    return V * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]


def _solve_tri(L, B, lower=True):
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def _masked_parts(H, R, y, mask):
    """Masked H rows, the masked noise (or noise factor) with a unit filler
    on missing rows, and y with missing entries zeroed."""
    Hm = mask[..., :, None] * H
    Rm = mask_covariance(R, mask)
    y0 = torch.where(mask > 0, torch.nan_to_num(y), 0.0)
    return Hm, Rm, y0


def _sqrt_update(m_pred, Up, Hm, Rm_sqrt, y0, mask):
    """Square-root measurement update through one `tria`:
    [[Hm Up, Rm^1/2], [Up, 0]] -> [[S^1/2, 0], [K S^1/2, U]]."""
    d, p = m_pred.shape[-1], y0.shape[-1]
    HU = Hm @ Up
    pre = torch.cat([
        torch.cat([HU, Rm_sqrt], -1),
        torch.cat([Up, Up.new_zeros(d, p)], -1),
    ], -2)
    T = tria(pre)
    S_sqrt, KS, U = T[:p, :p], T[p:, :p], T[p:, p:]
    v = y0 - Hm @ m_pred
    alpha = _solve_tri(S_sqrt, v[:, None])[:, 0]
    m = m_pred + KS @ alpha
    logdet = 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(S_sqrt))))
    lml = -0.5 * (torch.sum(alpha * alpha) + logdet + torch.sum(mask) * _LOG2PI)
    return m, U, lml


def sqrt_kalman_filter(A, Q_sqrt, H, R_sqrt, y, m0, P0_sqrt, mask=None) -> FilterResult:
    """Sequential square-root filter.

    A [T, d, d]; Q_sqrt [T, d, d]; H [p, d] or [T, p, d]; R_sqrt [T, p, p]
    (a factor of R); y [T, p] (NaN = missing). The Ps of the result are
    lower-triangular factors of the filtered covariances.
    """
    T = y.shape[0]
    if mask is None:
        mask = observation_mask(y, P0_sqrt.dtype)
    m, U = m0, P0_sqrt
    ms, Us, lmls = [], [], []
    for k in range(T):
        m_pred = A[k] @ m
        Up = tria(torch.cat([A[k] @ U, Q_sqrt[k]], -1))
        Hm, Rs_m, y0 = _masked_parts(H if H.dim() == 2 else H[k], R_sqrt[k], y[k], mask[k])
        m, U, lml_k = _sqrt_update(m_pred, Up, Hm, Rs_m, y0, mask[k])
        ms.append(m)
        Us.append(U)
        lmls.append(lml_k)
    lmls = torch.stack(lmls)
    return FilterResult(ms=torch.stack(ms), Ps=torch.stack(Us), lml=torch.sum(lmls), lmls=lmls)


def sqrt_rts_smoother(A, Q_sqrt, filtered: FilterResult) -> SmootherResult:
    """Sequential square-root RTS smoother on the factors of `filtered`; the
    Ps of the result are factors of the smoothed covariances. Each step is
    one `tria` of [[A U_f, Qs], [U_f, 0]] -> [[Pp^1/2, 0], [G Pp^1/2, Y22]]
    and one of [Y22, G D_next]."""
    ms, Us = filtered.ms, filtered.Ps
    T, d = ms.shape
    m_s, D = ms[-1], Us[-1]
    out_m, out_D, out_G = [m_s], [D], [torch.zeros_like(D)]
    for k in range(T - 2, -1, -1):
        A_next, Qs_next, U_f = A[k + 1], Q_sqrt[k + 1], Us[k]
        pre = torch.cat([
            torch.cat([A_next @ U_f, Qs_next], -1),
            torch.cat([U_f, U_f.new_zeros(d, d)], -1),
        ], -2)
        Tm = tria(pre)
        Pp_sqrt, GP, Y22 = Tm[:d, :d], Tm[d:, :d], Tm[d:, d:]
        # G Pp^1/2 = GP: the right solve through the transposed system
        G = torch.linalg.solve_triangular(Pp_sqrt.T, GP.T, upper=True).T
        m_s = ms[k] + G @ (m_s - A_next @ ms[k])
        D = tria(torch.cat([Y22, G @ D], -1))
        out_m.append(m_s)
        out_D.append(D)
        out_G.append(G)
    return SmootherResult(ms=torch.stack(out_m[::-1]), Ps=torch.stack(out_D[::-1]),
                          Gs=torch.stack(out_G[::-1]))

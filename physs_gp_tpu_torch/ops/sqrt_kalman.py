"""Square-root primitives (PyTorch): `tria` and `tria_sum`.

Counterpart of the parts of `physs_gp_tpu/ops/sqrt_kalman.py` that the
parallel square-root filter and smoother use. Covariances are carried as
lower-triangular factors; `tria(B)` is the L with L Lᵀ = B Bᵀ (canonical
diag >= 0), `tria_sum(X, Y)` the L with L Lᵀ = X Xᵀ + Y Yᵀ (+ I).

Forward passes run the batched kernels: `tria` the Householder LQ
(`ops/cuda/batched_qr.batch_tria`), `tria_sum` the fused Gram + Cholesky
(`ops/cuda/batched_chol.batch_chol_gram`), on every shape they hold, on
both devices (the TPU package gates them to its TPU backend). Backward
passes recompute through `torch.linalg.qr`, as the reference's custom VJPs
recompute through XLA's QR: the TPU kernels have no backward kernel.

The sequential square-root filter and smoother are not ported yet.
"""
from __future__ import annotations

import torch

from .cuda.batched_chol import batch_chol_gram
from .cuda.batched_qr import batch_tria
from .cuda.build import D_MAX
from .matrix import unit_last

__all__ = ["tria", "tria_sum"]


def _floor(dtype) -> float:
    # the in-sqrt floor must not underflow in the working dtype
    return 1e-24 if dtype.itemsize < 8 else 1e-60


def _vjp(fn, ct, *xs):
    """Cotangents of fn at xs (None entries pass through as None)."""
    with torch.enable_grad():
        ins = [None if x is None else x.detach().requires_grad_(True) for x in xs]
        out = fn(*ins)
        live = [x for x in ins if x is not None]
        grads = iter(torch.autograd.grad(out, live, ct))
    return tuple(None if x is None else next(grads) for x in ins)


def tria(B, assume_full_rank: bool = False):
    """Lower-triangular L [.., d, d] with L Lᵀ = B Bᵀ, B [.., d, m].

    Exactly-zero pre-arrays (the zeroed first elements of each chunk, the
    scan's identity element) bypass the factorisation and return 0 with a
    zero gradient; the backward of the others runs through a pre-array with
    a tiny relative identity block appended, so rank-deficient inputs keep
    bounded gradients. `assume_full_rank=True` skips both, for pre-arrays
    with a full-row-rank block ([G, I], [H U, R^1/2])."""
    if assume_full_rank:
        return _TriaCore.apply(B, _tria_canonical_ref)
    d, m = B.shape[-2], B.shape[-1]
    if m < d:  # zero columns leave B Bᵀ unchanged; the LQ needs m >= d
        B = torch.cat([B, B.new_zeros(B.shape[:-1] + (d - m,))], -1)
        m = d
    floor = _floor(B.dtype)
    scale = torch.sqrt(torch.sum(B * B, dim=(-1, -2), keepdim=True) / d + floor)
    is_zero = scale <= 2.0 * floor ** 0.5
    eye = torch.eye(d, m, dtype=B.dtype, device=B.device)
    B_safe = torch.where(is_zero, eye, B)
    return torch.where(is_zero, 0.0, _TriaCore.apply(B_safe, _tria_reg))


def _tria_canonical_ref(B):
    """Canonical (diag >= 0) factor through `torch.linalg.qr` (backward)."""
    _, r = torch.linalg.qr(B.transpose(-1, -2), mode="reduced")
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
    """Forward: the LQ kernel on B; backward: through `ref` (the QR of B,
    `_tria_canonical_ref`, or of the regularised pre-array, `_tria_reg`)."""

    @staticmethod
    def forward(ctx, B, ref):
        ctx.save_for_backward(B)
        ctx.ref = ref
        d, m = B.shape[-2:]
        L = batch_tria(unit_last(B.reshape(-1, d, m)))
        return L.reshape(B.shape[:-1] + (d,))

    @staticmethod
    def backward(ctx, ct):
        return *_vjp(ctx.ref, ct, *ctx.saved_tensors), None


def _eye_like(X):
    d = X.shape[-2]
    return torch.eye(d, dtype=X.dtype, device=X.device).expand(X.shape[:-1] + (d,))


def _tria_sum_ref(X, Y, plus_eye: bool):
    """Reference composition: `tria` of the concatenated pre-array."""
    parts = [X] + ([] if Y is None else [Y]) + ([_eye_like(X)] if plus_eye else [])
    return tria(torch.cat(parts, -1))


class _CholGramCore(torch.autograd.Function):
    """Forward: the fused Gram + Cholesky kernel; backward: through
    `_tria_sum_ref`, whose QR stays finite for rank-deficient inputs."""

    @staticmethod
    def forward(ctx, X, Y, plus_eye):
        ctx.save_for_backward(X, Y)
        ctx.plus_eye = plus_eye
        return batch_chol_gram(unit_last(X), None if Y is None else unit_last(Y),
                               plus_eye=plus_eye)

    @staticmethod
    def backward(ctx, ct):
        X, Y = ctx.saved_tensors
        gx, gy = _vjp(lambda x, y: _tria_sum_ref(x, y, ctx.plus_eye), ct, X, Y)
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
        return _CholGramCore.apply(X, Y, True)
    floor = _floor(X.dtype)
    s2 = torch.sum(X * X, dim=(-1, -2), keepdim=True)
    if Y is not None:
        s2 = s2 + torch.sum(Y * Y, dim=(-1, -2), keepdim=True)
    is_zero = s2 / X.shape[-2] + floor <= 2.0 * floor
    Xs = torch.where(is_zero, torch.eye(*X.shape[-2:], dtype=X.dtype, device=X.device), X)
    Ys = None if Y is None else torch.where(is_zero, 0.0, Y)
    return torch.where(is_zero, 0.0, _CholGramCore.apply(Xs, Ys, False))

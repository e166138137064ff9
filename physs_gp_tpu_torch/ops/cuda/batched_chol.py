"""Batched pivot-floored Cholesky and fused Gram + Cholesky: CUDA kernels.

Counterpart of `physs_gp_tpu/ops/pallas/batched_chol.py`. Both run the
right-looking Cholesky whose pivot k is floored at
`max(a_kk, eps_rel * d0_k + 1e-30)`, with d0 the diagonal before the
elimination: a per-row, scale-invariant noise floor, so semi-definite and
all-zero inputs give a finite semi-definite factor instead of NaN (a global
scale would crush legitimate small directions). `eps_rel` defaults to 5e-7
in float32 and 1e-14 in float64.

- `batch_cholesky(A)`: L with L Lᵀ ≈ A for explicit PSD A [N, d, d], from
  its lower triangle (replaces `_chol_kernel`; the kernels' GRAM = false).
- `batch_chol_gram(X, Y, plus_eye)`: L = chol(X Xᵀ + Y Yᵀ [+ I]) with the
  Gram formed inside the kernel (replaces `_chol_gram_kernel`; GRAM =
  true). Forming the Gram squares the spread of the spectrum, so it is for
  covariance-side factors only.

Both kernels are in `csrc/batched_factor.cu`: for d <= 32 one warp owns a
matrix with a row per lane in registers (`chol_warp_kernel`), above that one
block per matrix in shared memory (`chol_block_kernel`); `chol_plan` gives
the launch shape, and operands whose base and strides are multiples of 16
bytes are staged 16 bytes at a time (`build.layout_aligned16`).
`cholesky_plain` and `chol_gram_plain` are the same elimination in batched
tensor ops, the CPU implementations of the custom ops
`torch.ops.physs_gp.chol` and `chol_gram` (`chol_op`, `chol_gram_op`), whose
CUDA implementations launch the kernels. `ops/cuda/build.py` counts the
launches (`launch_counts`).
"""
from __future__ import annotations

import functools

import torch

from . import build
from .build import (
    D_MAX, SM_COUNT, WARP_D, WARP_GROUP, WARP_GROUP_SMEM, KernelOp, ceil4, check_smem, dtype_code,
    launch, layout_aligned16, on_cpu, row_pitch, row_stride, stream_of, threads_for,
)

__all__ = [
    "batch_cholesky",
    "batch_chol_gram",
    "cholesky_plain",
    "chol_gram_plain",
    "chol_plan",
    "launch_counts",
    "reset_launch_counts",
]


@functools.lru_cache(maxsize=None)
def chol_plan(N: int, d: int, mx: int, my: int, gram: bool, itemsize: int):
    """(G, threads, shared-memory bytes) of one Cholesky launch.

    d <= 32: one warp per matrix, G matrices per block, each with a
    [32][pitch] tile (the staged [X | Y], Y from column ceil4(mx), or the
    lower triangle of A; the factor leaves through it) and 64 elements for
    the column of the step. G is at most 8 and what 75 KB hold, but no more
    than leaves every SM two blocks: the scan's batch of 256 goes one matrix
    per block. d > 32: one block per matrix, the lower triangle as
    [d][d + 1] beside the staged factors."""
    if d <= WARP_D:
        width = ceil4(mx) + ceil4(my) if gram else d
        per = (WARP_D * row_pitch(max(width, d), itemsize) + 64) * itemsize
        G = max(1, min(WARP_GROUP, WARP_GROUP_SMEM // per, N // (2 * SM_COUNT)))
        return G, 32 * G, G * per
    words = d * (d + 1) + 2 * d + (d * (mx + 1) + d * (my + 1) if gram else 0)
    return 1, threads_for(d * d), words * itemsize


def _eps_rel(dtype, eps_rel):
    if eps_rel is not None:
        return float(eps_rel)
    return 5e-7 if dtype.itemsize < 8 else 1e-14


def _eliminate(A, eps_rel: float):
    """Right-looking Cholesky of A [N, d, d] (lower triangle read) with the
    per-row pivot floor."""
    d = A.shape[-1]
    A = A.clone()
    d0 = torch.diagonal(A, dim1=-2, dim2=-1).clone()
    L = torch.zeros_like(A)
    for k in range(d):
        piv = torch.maximum(A[:, k, k], eps_rel * d0[:, k] + 1e-30)
        lkk = torch.sqrt(piv)
        col = A[:, k + 1:, k] * (1.0 / lkk)[:, None]
        L[:, k, k] = lkk
        L[:, k + 1:, k] = col
        A[:, k + 1:, k + 1:] -= col[:, :, None] * col[:, None, :]
    return L


def cholesky_plain(A, eps_rel=None):
    return _eliminate(A, _eps_rel(A.dtype, eps_rel))


def chol_gram_plain(X, Y=None, plus_eye: bool = False, eps_rel=None):
    A = X @ X.transpose(-1, -2)
    if Y is not None:
        A = A + Y @ Y.transpose(-1, -2)
    if plus_eye:
        A = A + torch.eye(X.shape[-2], dtype=X.dtype, device=X.device)
    return _eliminate(A, _eps_rel(X.dtype, eps_rel))


def _launch(name, kernel, X, Y, gram: bool, plus_eye: bool, eps_rel):
    N, d, mx = X.shape
    my = 0 if Y is None else Y.shape[-1]
    if d > D_MAX or mx > D_MAX or my > D_MAX:
        raise ValueError(f"{name}: [{d}, {mx}] + [{d}, {my}] exceeds {D_MAX}")
    es = X.element_size()
    G, threads, smem = chol_plan(N, d, mx, my, gram, es)
    check_smem(name, smem // es, X)
    L = torch.empty((N, d, d), dtype=X.dtype, device=X.device)
    if N == 0:
        return L
    Yk = X if Y is None else Y
    pX, sX, ldX = X.data_ptr(), X.stride(0), row_stride(X)
    pY, sY, ldY = Yk.data_ptr(), Yk.stride(0), row_stride(Yk)
    launch(
        kernel, "batched_factor", "physs_chol", dtype_code(X), int(gram), pX, pY,
        L.data_ptr(), N, d, mx, my, sX, ldX, sY, ldY, int(plus_eye),
        _eps_rel(X.dtype, eps_rel), G, threads, int(layout_aligned16(pX, sX, ldX, es)),
        int(layout_aligned16(pY, sY, ldY, es)), stream_of(X),
        route="warp" if d <= WARP_D else "block",
    )
    return L


def _square(X):
    return X.new_empty((X.shape[0], X.shape[-2], X.shape[-2]))


chol_op = KernelOp(
    "chol", "(Tensor A, float? eps_rel) -> Tensor",
    lambda A, eps_rel: cholesky_plain(A, eps_rel).contiguous(),
    lambda A, eps_rel: _launch("batch_cholesky", "chol", A, None, False, False, eps_rel),
    lambda A, eps_rel: _square(A),
)
chol_gram_op = KernelOp(
    "chol_gram", "(Tensor X, Tensor? Y, bool plus_eye, float? eps_rel) -> Tensor",
    lambda X, Y, plus_eye, eps_rel: chol_gram_plain(X, Y, plus_eye, eps_rel).contiguous(),
    lambda X, Y, plus_eye, eps_rel: _launch(
        "batch_chol_gram", "chol_gram", X, Y, True, plus_eye, eps_rel),
    lambda X, Y, plus_eye, eps_rel: _square(X),
)


def batch_cholesky(A, eps_rel=None):
    """L [N, d, d] with L Lᵀ ≈ A for explicit PSD A [N, d, d]."""
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"batch_cholesky: need A [N, d, d], got {list(A.shape)}")
    return chol_op(on_cpu("batch_cholesky", A), A, eps_rel)


def batch_chol_gram(X, Y=None, plus_eye: bool = False, eps_rel=None):
    """L [N, d, d] lower with L Lᵀ ≈ X Xᵀ (+ Y Yᵀ) (+ I); X [N, d, mx],
    Y [N, d, my]."""
    if X.dim() != 3 or (Y is not None and (Y.dim() != 3 or Y.shape[:-1] != X.shape[:-1])):
        raise ValueError("batch_chol_gram: need X [N, d, mx] and Y [N, d, my]")
    cpu = on_cpu("batch_chol_gram", *((X,) if Y is None else (X, Y)))
    return chol_gram_op(cpu, X, Y, plus_eye, eps_rel)


def launch_counts() -> dict:
    return build.launch_counts("chol", "chol_gram")


def reset_launch_counts() -> None:
    build.reset_launch_counts("chol", "chol_gram")

"""Batched triangularisation (Householder LQ): a hand-written CUDA kernel.

Counterpart of `physs_gp_tpu/ops/pallas/batched_qr.py`. `batch_tria(B)`
returns, for B [N, d, m] with m >= d, the lower-triangular L [N, d, d] with
L Lᵀ = B Bᵀ, its diagonal made non-negative by flipping the sign of each
column whose diagonal entry is negative (0 counts as positive), and an
exactly zero upper triangle. The kernels are in `csrc/batched_factor.cu`
(they replace `_lq_kernel`): for d <= 32 and m <= 64 one warp owns a matrix
with a row per lane in registers (`lq_warp_kernel`), above that one block per
matrix in shared memory (`lq_block_kernel`); `lq_plan` gives the launch shape.
`tria_plain` is the same Householder LQ in batched tensor ops, the CPU
implementation of the custom op `torch.ops.physs_gp.lq` (`lq_op`), whose CUDA
implementation launches the kernels. `ops/cuda/build.py` counts the launches
(`launch_counts`, and `route_counts` for the two kernels and for the
"library" route that `sqrt_kalman.tria` takes above `lq_fits`).
"""
from __future__ import annotations

import functools

import torch

from . import build
from .build import (
    D_MAX, SM_COUNT, WARP_D, WARP_GROUP, WARP_GROUP_SMEM, KernelOp, check_smem, dtype_code, launch,
    on_cpu, row_pitch, row_stride, stream_of, threads_for,
)

__all__ = ["batch_tria", "lq_fits", "lq_plan", "tria_plain", "launch_counts", "reset_launch_counts"]

WARP_M = 64  # a lane of the warp-per-matrix LQ holds up to 64 columns of its row


def _lq_warp(d: int, m: int) -> bool:
    """Whether the warp-per-matrix kernel takes the shape (the launcher's test)."""
    return 1 <= d <= WARP_D and m <= WARP_M


@functools.lru_cache(maxsize=None)
def lq_plan(N: int, d: int, m: int, itemsize: int):
    """(G, threads, shared-memory bytes) of one LQ launch.

    1 <= d <= 32, m <= 64: one warp per matrix, G per block; each warp has a
    [32][pitch] tile for MW = 32 or 64 columns (B staged in, L staged out),
    two reflectors of MW values and two betas (16 bytes). G is at most 8
    and what 75 KB hold, but no more than leaves every SM two blocks: the
    scan's 256 or 512 matrices go one per block. Otherwise one block per
    matrix with B in shared memory."""
    if _lq_warp(d, m):
        mw = 32 if m <= 32 else 64
        per = (WARP_D * row_pitch(mw, itemsize) + 2 * mw + 16 // itemsize) * itemsize
        G = max(1, min(WARP_GROUP, WARP_GROUP_SMEM // per, N // (2 * SM_COUNT)))
        return G, 32 * G, G * per
    return 1, threads_for((d - 1) * m), (d * m + m + d + 2) * itemsize


def tria_plain(B):
    """Householder LQ of B [N, d, m], step for step as the TPU kernel: step k
    reflects row k's tail (columns >= k) onto alpha e_k and applies the
    reflector to the rows below; a zero tail takes beta = 0, and so does a
    tail whose vᵀv is below the smallest normal number (a numerically zero
    tail of a rank-deficient row, where 2 / vᵀv overflows; the TPU flushes
    such values to zero)."""
    d = B.shape[-2]
    W = B.clone()
    one = torch.ones((), dtype=B.dtype, device=B.device)
    tiny = torch.finfo(B.dtype).tiny
    for k in range(d):
        x = W[:, k, k:]
        xk = x[:, 0]
        norm = torch.sqrt(torch.sum(x * x, -1))
        alpha = torch.where(xk < 0, norm, -norm)
        v = x.clone()
        v[:, 0] = xk - alpha
        vtv = torch.sum(v * v, -1)
        ok = vtv >= tiny
        beta = torch.where(ok, 2.0 / torch.where(ok, vtv, one), 0.0)
        w = torch.sum(W[:, k + 1:, k:] * v[:, None, :], -1)  # rows below k
        W[:, k + 1:, k:] -= (beta[:, None] * w)[:, :, None] * v[:, None, :]
        W[:, k, k] = alpha
        W[:, k, k + 1:] = 0.0
    L = W[:, :, :d]
    sign = torch.where(torch.diagonal(L, dim1=-2, dim2=-1) < 0, -one, one)
    return torch.tril(L * sign[:, None, :])


def lq_fits(d: int, m: int) -> bool:
    """Whether the LQ kernels take a [d, m] pre-array (d <= D_MAX,
    m <= 2 D_MAX); `sqrt_kalman.tria` sends larger ones to the library QR."""
    return d <= D_MAX and m <= 2 * D_MAX


def _lq_cuda(B):
    N, d, m = B.shape
    if not lq_fits(d, m):
        raise ValueError(f"batch_tria: [{d}, {m}] exceeds d <= {D_MAX}, m <= {2 * D_MAX}")
    es = B.element_size()
    _, threads, smem = lq_plan(N, d, m, es)
    check_smem("batch_tria", smem // es, B)
    L = torch.empty((N, d, d), dtype=B.dtype, device=B.device)
    if N == 0:
        return L
    launch(
        "lq", "batched_factor", "physs_lq", dtype_code(B), B.data_ptr(), L.data_ptr(),
        N, d, m, B.stride(0), row_stride(B), threads, stream_of(B),
        route="warp" if _lq_warp(d, m) else "block",
    )
    return L


lq_op = KernelOp(
    "lq", "(Tensor B) -> Tensor", lambda B: tria_plain(B).contiguous(), _lq_cuda,
    lambda B: B.new_empty((B.shape[0], B.shape[-2], B.shape[-2])),
)


def batch_tria(B):
    """L [N, d, d] with L Lᵀ = B Bᵀ for B [N, d, m], m >= d, diag >= 0."""
    if B.dim() != 3 or B.shape[-1] < B.shape[-2]:
        raise ValueError(f"batch_tria: need B [N, d, m] with m >= d, got {list(B.shape)}")
    return lq_op(on_cpu("batch_tria", B), B)


def launch_counts() -> dict:
    return build.launch_counts("lq")


def reset_launch_counts() -> None:
    build.reset_launch_counts("lq")

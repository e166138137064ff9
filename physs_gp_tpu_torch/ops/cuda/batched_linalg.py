"""Batched small-matrix linear algebra: hand-written CUDA kernels for Hopper.

Counterpart of `physs_gp_tpu/ops/pallas/batched_linalg.py`. Three kernels,
all in `csrc/batched_linalg.cu`:

- `batch_bmm(A, B, ta, tb)`: C[b] = op(A[b]) @ op(B[b]), op = transpose when
  ta/tb (replaces `_mm_kernel_g`; `batch_matmul` is its ta = tb = False case
  and replaces `_mm_kernel`).
- `batch_solve(M, R)`: unpivoted Gauss-Jordan solve of M[b] X[b] = R[b]
  (replaces `_gj_solve_kernel`).
- `batch_solve_logdet(M, R)`: the same elimination plus sum_k log|pivot_k| =
  log|det M| for SPD M (replaces `_gj_solve_logdet_kernel`).

Each kernel is the custom op `torch.ops.physs_gp.{bmm, gj_solve,
gj_solve_logdet}` (`bmm_op`, `gj_solve_op`, `gj_solve_logdet_op`): its CPU
implementation is the plain PyTorch version (`*_plain`, same arithmetic in
batched tensor ops), its CUDA implementation launches the kernel or raises.
The wrappers check the operands and call the op (`build.KernelOp`).
Operands are [N, rows, cols] with unit stride along the last dimension; the
batch and row strides are passed to the kernel, so column slices and
broadcast (stride-0) batches need no copy. Outputs are
new contiguous tensors. The product's launch shape (products per block,
threads, shared memory) comes from `bmm_plan`; an operand whose base address,
batch stride and row stride are multiples of 16 bytes is staged 16 bytes at a
time, any other one element at a time (`build.layout_aligned16`). The solves'
launch shape comes from `gj_plan`: for d <= 32 (and r <= 256) a warp per
system with a column per lane (`gj_warp_kernel`), above that a block per
system in shared memory (`gj_block_kernel`); `build.route_counts` tells the
two apart.

The kernels are built at first use by `ops/cuda/build.py`, which counts
their launches (`launch_counts`).
"""
from __future__ import annotations

import functools

import torch

from . import build
from .build import (
    D_MAX, SM_COUNT, WARP_D, WARP_GROUP, KernelOp, ceil4, check_smem, dtype_code, launch,
    layout_aligned16, on_cpu, row_pitch, row_stride, stream_of, threads_for,
)

__all__ = [
    "batch_bmm",
    "batch_matmul",
    "batch_solve",
    "batch_solve_logdet",
    "bmm_plain",
    "bmm_plan",
    "gj_plan",
    "gj_solve_plain",
    "gj_solve_logdet_plain",
    "launch_counts",
    "reset_launch_counts",
]

_THREADS = 256  # threads a block of grouped products aims at
_MAX_THREADS = 512  # the product kernel's launch bound
_GROUP_SMEM = 48 * 1024  # grouped products stay under the opt-in limit
WARP_R = 32 * WARP_GROUP  # right-hand sides a warp-per-system launch holds: a lane each


@functools.lru_cache(maxsize=None)
def bmm_plan(N: int, m: int, n: int, k: int, ta: bool, tb: bool, itemsize: int):
    """(G, threads, shared-memory bytes) of one product launch.

    Each thread owns a 4 x 4 tile of C, so a product takes ceil(m / 4) *
    ceil(n / 4) threads; a block holds G products. G is what 256 threads
    and 48 KB of shared memory hold, but no more than leaves every SM two
    blocks: a small batch (the scan's 256) goes one product per block.
    Operands are staged in their stored layout, rows padded to 4 and to the
    kernels' pitch (`build.row_pitch`)."""
    ra, ca = (k, m) if ta else (m, k)
    rb, cb = (n, k) if tb else (k, n)
    per = (ceil4(ra) * row_pitch(ca, itemsize) + ceil4(rb) * row_pitch(cb, itemsize)) * itemsize
    tiles = -(-m // 4) * -(-n // 4)
    G = max(1, min(_THREADS // tiles, _GROUP_SMEM // per, N // (2 * SM_COUNT)))
    threads = min(_MAX_THREADS, -(-G * tiles // 32) * 32)
    return G, threads, G * per


def _gj_warp(d: int, r: int) -> bool:
    """Whether the warp-per-system kernel takes the shape (the launcher's test)."""
    return 1 <= d <= WARP_D and r <= WARP_R


@functools.lru_cache(maxsize=None)
def gj_plan(N: int, d: int, r: int, itemsize: int):
    """(G, threads, shared-memory bytes) of one Gauss-Jordan launch.

    1 <= d <= 32 and r <= 256: one warp eliminates M with R's first 32
    columns, and each further 32 columns of R take one more warp (wpm =
    max(1, ceil(r / 32)) warps per system); a block holds G systems, at
    most 8 warps, but no more than leaves every SM two blocks: the scan's
    256 or 512 systems go one per block. Shared memory per system: the
    [32][32] history of multipliers and 32 logs. Otherwise one block per
    system with [M | R] in shared memory."""
    if _gj_warp(d, r):
        wpm = max(1, -(-r // 32))
        G = max(1, min(WARP_GROUP // wpm, N // (2 * SM_COUNT)))
        return G, 32 * wpm * G, G * (32 * 32 + 32) * itemsize
    return 1, threads_for(d * (d + r)), (d * (d + r) + d + (d + r)) * itemsize


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference the kernels are
# held to on the card)
# ---------------------------------------------------------------------------


def bmm_plain(A, B, ta: bool = False, tb: bool = False):
    a = A.transpose(-1, -2) if ta else A
    b = B.transpose(-1, -2) if tb else B
    return torch.matmul(a, b)


def _gj_plain(M, R, logdet: bool):
    """The TPU kernel's elimination, vectorised over the batch instead of
    the lanes: for each pivot k, normalise row k and eliminate column k
    from every other row."""
    d = M.shape[-1]
    M = M.clone()
    R = R.clone()
    ld = torch.zeros(M.shape[0], dtype=M.dtype, device=M.device)
    for k in range(d):
        piv = M[:, k, k]
        if logdet:
            ld = ld + torch.log(torch.abs(piv))
        inv = 1.0 / piv
        row_m = M[:, k, :] * inv[:, None]
        row_r = R[:, k, :] * inv[:, None]
        col = M[:, :, k].clone()
        col[:, k] = 0.0
        M = M - col[:, :, None] * row_m[:, None, :]
        R = R - col[:, :, None] * row_r[:, None, :]
        M[:, k, :] = row_m
        R[:, k, :] = row_r
    return R, ld


def gj_solve_plain(M, R):
    return _gj_plain(M, R, logdet=False)[0]


def gj_solve_logdet_plain(M, R):
    return _gj_plain(M, R, logdet=True)


# ---------------------------------------------------------------------------
# The kernels as custom ops (`build.KernelOp`): the plain version on the CPU,
# the launch on the card, a fake for the tracers
# ---------------------------------------------------------------------------


def _bmm_dims(A, B, ta: bool, tb: bool):
    """(m, n, k) of op(A) @ op(B); raises when the contracted dims differ."""
    m = A.shape[-1] if ta else A.shape[-2]
    k = A.shape[-2] if ta else A.shape[-1]
    kb = B.shape[-1] if tb else B.shape[-2]
    n = B.shape[-2] if tb else B.shape[-1]
    if k != kb:
        raise ValueError(f"batch_bmm: contracted dims differ ({k} vs {kb})")
    return m, n, k


def _bmm_cpu(A, B, ta, tb):
    return bmm_plain(A, B, ta, tb).contiguous()


def _bmm_cuda(A, B, ta, tb):
    m, n, k = _bmm_dims(A, B, ta, tb)
    if max(m, n, k) > D_MAX:
        raise ValueError(f"batch_bmm: dims ({m}, {n}, {k}) exceed {D_MAX}")
    N = A.shape[0]
    C = torch.empty((N, m, n), dtype=A.dtype, device=A.device)
    if N == 0:
        return C
    es = A.element_size()
    G, threads, smem = bmm_plan(N, m, n, k, ta, tb, es)
    check_smem("batch_bmm", smem // es, A)
    pA, sA, ldA = A.data_ptr(), A.stride(0), row_stride(A)
    pB, sB, ldB = B.data_ptr(), B.stride(0), row_stride(B)
    launch(
        "bmm", "batched_linalg", "physs_bmm", dtype_code(A), int(ta), int(tb),
        pA, pB, C.data_ptr(), N, m, n, k, sA, ldA, sB, ldB, G, threads,
        int(layout_aligned16(pA, sA, ldA, es)), int(layout_aligned16(pB, sB, ldB, es)),
        stream_of(A),
    )
    return C


def _bmm_fake(A, B, ta, tb):
    m, n, _ = _bmm_dims(A, B, ta, tb)
    return A.new_empty((A.shape[0], m, n))


def _solve_cuda(M, R, logdet: bool):
    name = "batch_solve_logdet" if logdet else "batch_solve"
    N, d, _ = M.shape
    r = R.shape[-1]
    if d > D_MAX:
        raise ValueError(f"{name}: d = {d} exceeds {D_MAX}")
    es = M.element_size()
    _, threads, smem = gj_plan(N, d, r, es)
    check_smem(name, smem // es, M)
    X = torch.empty((N, d, r), dtype=M.dtype, device=M.device)
    ld = torch.empty((N,), dtype=M.dtype, device=M.device)
    if N == 0:
        return X, ld
    launch(
        "gj_solve_logdet" if logdet else "gj_solve", "batched_linalg", "physs_gj_solve",
        dtype_code(M), int(logdet), M.data_ptr(), R.data_ptr(), X.data_ptr(),
        ld.data_ptr(), N, d, r, M.stride(0), row_stride(M), R.stride(0),
        row_stride(R), threads, stream_of(M), route="warp" if _gj_warp(d, r) else "block",
    )
    return X, ld


def _gj_solve_cpu(M, R):
    return gj_solve_plain(M, R).contiguous()


def _gj_solve_logdet_cpu(M, R):
    X, ld = gj_solve_logdet_plain(M, R)
    return X.contiguous(), ld


bmm_op = KernelOp(
    "bmm", "(Tensor A, Tensor B, bool ta, bool tb) -> Tensor", _bmm_cpu, _bmm_cuda, _bmm_fake,
)
gj_solve_op = KernelOp(
    "gj_solve", "(Tensor M, Tensor R) -> Tensor", _gj_solve_cpu,
    lambda M, R: _solve_cuda(M, R, False)[0], lambda M, R: R.new_empty(R.shape),
)
gj_solve_logdet_op = KernelOp(
    "gj_solve_logdet", "(Tensor M, Tensor R) -> (Tensor, Tensor)", _gj_solve_logdet_cpu,
    lambda M, R: _solve_cuda(M, R, True),
    lambda M, R: (R.new_empty(R.shape), M.new_empty(M.shape[:1])),
)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def batch_bmm(A, B, ta: bool = False, tb: bool = False):
    """C[b] = op(A[b]) @ op(B[b]); A [N, ka, ma], B [N, kb, mb]."""
    _bmm_dims(A, B, ta, tb)
    return bmm_op(on_cpu("batch_bmm", A, B), A, B, ta, tb)


def batch_matmul(A, B):
    """C[b] = A[b] @ B[b]: the no-transpose case of `batch_bmm`."""
    return batch_bmm(A, B)


def _check_solve(name, M, R) -> bool:
    if M.dim() != 3 or M.shape[-1] != M.shape[-2] or R.dim() != 3 or R.shape[-2] != M.shape[-1]:
        raise ValueError(f"{name}: need M [N, d, d] and R [N, d, r]")
    return on_cpu(name, M, R)


def batch_solve(M, R):
    """Solve M[b] X[b] = R[b]; M [N, d, d], R [N, d, r]."""
    return gj_solve_op(_check_solve("batch_solve", M, R), M, R)


def batch_solve_logdet(M, R):
    """(X, log|det M|) for SPD M [N, d, d], R [N, d, r]."""
    return gj_solve_logdet_op(_check_solve("batch_solve_logdet", M, R), M, R)


_KERNELS = ("bmm", "gj_solve", "gj_solve_logdet")


def launch_counts() -> dict:
    return build.launch_counts(*_KERNELS)


def reset_launch_counts() -> None:
    build.reset_launch_counts(*_KERNELS)

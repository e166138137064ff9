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

Each wrapper takes its plain PyTorch version (`*_plain`, same arithmetic in
batched tensor ops) for a tensor that lies on the CPU; for a CUDA tensor it
launches the kernel or raises. Operands are [N, rows, cols] with unit stride
along the last dimension; the batch and row strides are passed to the kernel,
so column slices and broadcast (stride-0) batches need no copy. Outputs are
new contiguous tensors.

The kernels are compiled by `nvcc` for sm_90a at first use into `_build/`
beside this package (keyed by a hash of the source and flags) and loaded
through ctypes. Each wrapper counts its launches in `<wrapper>.launches`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = [
    "batch_bmm",
    "batch_matmul",
    "batch_solve",
    "batch_solve_logdet",
    "bmm_plain",
    "gj_solve_plain",
    "gj_solve_logdet_plain",
    "build",
    "launch_counts",
    "reset_launch_counts",
]

_PKG = Path(__file__).resolve().parents[2]
_SOURCE = _PKG / "csrc" / "batched_linalg.cu"
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_SMEM_LIMIT = 232_448  # bytes of dynamic shared memory one block may use
D_MAX = 80
_THREADS = 256

_lib = None
build_info: dict = {}


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
# Build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    src = _SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libbatched_linalg_{key}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            out = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                capture_output=True, text=True,
            )
            if out.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{out.stderr}")
            log = out.stderr
            os.replace(tmp, so)  # atomic: concurrent builds agree
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.physs_bmm.argtypes = [i, i, i, p, p, p, i, i, i, i, ll, ll, ll, ll, i, i, p]
    lib.physs_bmm.restype = i
    lib.physs_gj_solve.argtypes = [i, i, p, p, p, p, i, i, i, ll, ll, ll, ll, i, p]
    lib.physs_gj_solve.restype = i
    build_info.update(path=str(so), seconds=time.perf_counter() - t0, log=log)
    _lib = lib
    return lib


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _dtype_code(x) -> int:
    if x.dtype == torch.float32:
        return 0
    if x.dtype == torch.float64:
        return 1
    raise TypeError(f"batched CUDA kernels take float32/float64, got {x.dtype}")


def _check(name, *xs):
    """Device, dtype, rank and inner-layout checks shared by the wrappers;
    returns True for CPU operands (plain path)."""
    if all(x.device.type == "cpu" for x in xs):
        return True
    for x in xs:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: operands must all be CUDA tensors")
        if x.device != xs[0].device:
            raise ValueError(f"{name}: operands lie on different devices")
        if x.dtype != xs[0].dtype:
            raise TypeError(f"{name}: mixed dtypes {x.dtype}, {xs[0].dtype}")
        if x.dim() != 3:
            raise ValueError(f"{name}: operands must be [N, rows, cols]")
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name}: last dimension must have unit stride")
        if x.shape[0] != xs[0].shape[0]:
            raise ValueError(f"{name}: batch sizes differ")
    _dtype_code(xs[0])
    return False


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ld(x) -> int:
    return x.stride(-2) if x.shape[-2] > 1 else x.shape[-1]


def batch_bmm(A, B, ta: bool = False, tb: bool = False):
    """C[b] = op(A[b]) @ op(B[b]); A [N, ka, ma], B [N, kb, mb]."""
    m = A.shape[-1] if ta else A.shape[-2]
    k = A.shape[-2] if ta else A.shape[-1]
    kb = B.shape[-1] if tb else B.shape[-2]
    n = B.shape[-2] if tb else B.shape[-1]
    if k != kb:
        raise ValueError(f"batch_bmm: contracted dims differ ({k} vs {kb})")
    if _check("batch_bmm", A, B):
        return bmm_plain(A, B, ta, tb)
    if max(m, n, k) > D_MAX:
        raise ValueError(f"batch_bmm: dims ({m}, {n}, {k}) exceed {D_MAX}")
    N = A.shape[0]
    C = torch.empty((N, m, n), dtype=A.dtype, device=A.device)
    if N == 0:
        return C
    per = (m * k + k * n) * A.element_size()
    if per > _SMEM_LIMIT:
        raise ValueError(f"batch_bmm: {per} B of shared memory exceeds the limit")
    # several small products per block so that each block keeps its threads busy
    G = max(1, min(_THREADS // (m * n), (48 * 1024) // per, N))
    lib = build()
    err = lib.physs_bmm(
        _dtype_code(A), int(ta), int(tb), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), N, m, n, k, A.stride(0), _ld(A), B.stride(0), _ld(B),
        G, _THREADS, _stream(A),
    )
    _raise_on(err, "batch_bmm")
    batch_bmm.launches += 1
    return C


batch_bmm.launches = 0


def batch_matmul(A, B):
    """C[b] = A[b] @ B[b]: the no-transpose case of `batch_bmm`."""
    return batch_bmm(A, B)


def _solve(name, M, R, logdet: bool):
    N, d, d2 = M.shape if M.dim() == 3 else (None, None, None)
    if M.dim() != 3 or d != d2 or R.dim() != 3 or R.shape[-2] != d:
        raise ValueError(f"{name}: need M [N, d, d] and R [N, d, r]")
    if _check(name, M, R):
        return _gj_plain(M, R, logdet)
    r = R.shape[-1]
    if d > D_MAX:
        raise ValueError(f"{name}: d = {d} exceeds {D_MAX}")
    smem = (d * (d + r) + d + (d + r)) * M.element_size()
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"{name}: [{d}, {d} + {r}] needs {smem} B of shared memory, "
            f"more than the {_SMEM_LIMIT} B a block may use"
        )
    X = torch.empty((N, d, r), dtype=M.dtype, device=M.device)
    ld = torch.empty((N,), dtype=M.dtype, device=M.device)
    if N == 0:
        return X, ld
    threads = max(32, min(_THREADS, -(-d * (d + r) // 32) * 32))
    lib = build()
    err = lib.physs_gj_solve(
        _dtype_code(M), int(logdet), M.data_ptr(), R.data_ptr(), X.data_ptr(),
        ld.data_ptr(), N, d, r, M.stride(0), _ld(M), R.stride(0), _ld(R),
        threads, _stream(M),
    )
    _raise_on(err, name)
    (batch_solve_logdet if logdet else batch_solve).launches += 1
    return X, ld


def batch_solve(M, R):
    """Solve M[b] X[b] = R[b]; M [N, d, d], R [N, d, r]."""
    return _solve("batch_solve", M, R, logdet=False)[0]


batch_solve.launches = 0


def batch_solve_logdet(M, R):
    """(X, log|det M|) for SPD M [N, d, d], R [N, d, r]."""
    return _solve("batch_solve_logdet", M, R, logdet=True)


batch_solve_logdet.launches = 0

_WRAPPERS = {
    "bmm": batch_bmm,
    "gj_solve": batch_solve,
    "gj_solve_logdet": batch_solve_logdet,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0

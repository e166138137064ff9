"""Build, load and call the port's CUDA sources (`csrc/*.cu`).

Each source is compiled by `nvcc` for sm_90a at first use into `_build/`
beside this package, under a name keyed by a hash of the source, the shared
headers (`csrc/*.cuh`) and the flags,
and loaded through ctypes. `build()` starts one `nvcc` per source that is
not built yet, all side by side, and waits for them together. The helpers
below are the operand checks and launch plumbing the wrappers share;
`launch` counts every kernel launch in `LAUNCHES`; `KernelOp` registers a
kernel as a `torch.library` custom op, with a vmap rule that folds the
vmapped dimension into the kernel's batch.
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
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

__all__ = [
    "build", "library", "build_info", "SMEM_LIMIT", "D_MAX", "LAUNCHES", "ROUTES", "launch",
    "count_route", "launch_counts", "reset_launch_counts", "route_counts", "KernelOp", "traced",
    "transformed",
]

_PKG = Path(__file__).resolve().parents[2]
_BUILD_DIR = _PKG / "_build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SMEM_LIMIT = 232_448  # bytes of dynamic shared memory one block may use
D_MAX = 80  # largest state dimension the kernels cover
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM: small batches spread over them
# The warp-per-matrix kernels (Cholesky, LQ, Gauss-Jordan): up to WARP_D
# rows (or columns) a matrix, one per lane; at most WARP_GROUP warps a block,
# and for the Cholesky and LQ tiles at most WARP_GROUP_SMEM bytes a block,
# so that three blocks share an SM.
WARP_D = 32
WARP_GROUP = 8
WARP_GROUP_SMEM = 75 * 1024

_p, _i, _ll, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# entry points of each source: name -> argtypes (all return int, a cudaError_t)
_ENTRY_POINTS = {
    "batched_linalg": {
        "physs_bmm": [_i, _i, _i, _p, _p, _p, _i, _i, _i, _i, _ll, _ll, _ll, _ll, _i, _i, _i, _i, _p],
        "physs_gj_solve": [_i, _i, _p, _p, _p, _p, _i, _i, _i, _ll, _ll, _ll, _ll, _i, _p],
    },
    "batched_factor": {
        "physs_lq": [_i, _p, _p, _i, _i, _i, _ll, _ll, _i, _p],
        "physs_chol": [_i, _i, _p, _p, _p, _i, _i, _i, _i, _ll, _ll, _ll, _ll, _i, _d, _i, _i, _i, _i, _p],
    },
    # host arrays of input pointers, (batch, row) strides and output pointers
    "fused_combine": {
        "physs_fused_filter": [_i, _p, _p, _p, _i, _i, _i, _i, _p],
        "physs_fused_smooth": [_i, _p, _p, _p, _i, _i, _i, _i, _p],
    },
}

_libs: dict = {}
build_info: dict = {}  # source name -> {"path", "seconds", "log"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str):
    src = _PKG / "csrc" / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted((_PKG / "csrc").glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, _BUILD_DIR / f"lib{name}_{key}.so"


def build(*names: str) -> None:
    """Compile (once per source version) and load the named sources, all of
    them when none is named; the `nvcc` runs go side by side."""
    todo = [n for n in (names or tuple(_ENTRY_POINTS)) if n not in _libs]
    if not todo:
        return
    t0 = time.perf_counter()
    jobs = {}
    try:
        for name in todo:
            src, so = _target(name)
            if so.exists():
                continue
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            jobs[name] = (proc, tmp, so)
        logs = {}
        for name, (proc, tmp, so) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu:\n{err}")
            logs[name] = err
            os.replace(tmp, so)  # atomic: concurrent builds agree
    finally:
        for proc, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    seconds = time.perf_counter() - t0
    for name in todo:
        so = _target(name)[1]
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _ENTRY_POINTS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        build_info[name] = {"path": str(so), "seconds": seconds, "log": logs.get(name, "")}
        _libs[name] = lib


def library(name: str) -> ctypes.CDLL:
    build(name)
    return _libs[name]


# ---------------------------------------------------------------------------
# Shared by the wrappers
# ---------------------------------------------------------------------------


def dtype_code(x) -> int:
    if x.dtype == torch.float32:
        return 0
    if x.dtype == torch.float64:
        return 1
    raise TypeError(f"batched CUDA kernels take float32/float64, got {x.dtype}")


def on_cpu(name, *xs) -> bool:
    """Device, dtype, rank and inner-layout checks shared by the wrappers;
    True for CPU operands (plain path), raises for operands no kernel takes."""
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
    dtype_code(xs[0])
    return False


def check_smem(name, words: int, x) -> None:
    smem = words * x.element_size()
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{name}: {list(x.shape)} needs {smem} B of shared memory, more than "
            f"the {SMEM_LIMIT} B a block may use"
        )


def traced() -> bool:
    """Whether a wrapper runs under a tracer: `torch.export`, `make_fx` and
    fake tensors push a dispatch mode, `torch.compile` compiles."""
    return is_in_torch_dispatch_mode() or torch.compiler.is_compiling()


def transformed() -> bool:
    """Whether a `torch.func` transform (`vmap`, `grad`, ...) is active: it
    works through functorch's dispatch keys, which `traced()` does not see,
    and hands wrapped tensors to the implementations it bypasses."""
    return torch._C._are_functorch_transforms_active()


def _fold(x, dim, B: int):
    """One operand of a vmapped kernel call as the kernel's own batch: the
    vmapped dimension `dim` (None: not vmapped, broadcast to B) moved to the
    front and merged into the leading batch, [B, N, ...] -> [B * N, ...],
    with unit stride along the last dimension."""
    if isinstance(x, (list, tuple)):
        return [_fold(v, d, B) for v, d in zip(x, dim)]
    if not isinstance(x, torch.Tensor):
        return x
    x = x.expand(B, *x.shape) if dim is None else x.movedim(dim, 0)
    x = x.reshape(B * x.shape[1], *x.shape[2:])
    if x.shape[-1] > 1 and x.stride(-1) != 1:
        x = x.contiguous()
    return x


class KernelOp:
    """A kernel as the custom op `torch.ops.physs_gp.<name>` with `schema`:
    `plain` is its CPU implementation, `cuda` the launch code, `fake` the
    outputs' shapes and types for the tracers (new contiguous tensors: no
    output aliases an input).

    A wrapper calls `op(cpu, *args)`, `cpu` from its `on_cpu` check. Under a
    tracer that goes through the dispatcher, which records one node per
    call; in eager mode it goes straight to the implementation for the
    device, which saves the dispatcher's host time on every launch. Under a
    `torch.func` transform it goes through the dispatcher too, where the
    op's vmap rule (`_vmap`) runs the B members of a vmapped call as one
    call of the op on a B times larger batch: one launch, not B."""

    def __init__(self, name: str, schema: str, plain, cuda, fake):
        self.op = torch.library.custom_op(
            f"physs_gp::{name}", plain, mutates_args=(), device_types="cpu", schema=schema)
        self.op.register_kernel("cuda", cuda)
        self.op.register_fake(fake)
        self.op.register_vmap(self._vmap)
        self.plain, self.cuda = plain, cuda

    def __call__(self, cpu: bool, *args):
        if traced():
            return self.op(*args)
        if transformed():
            # the `autograd.Function`s around the kernels carry their
            # gradients (`ops/matrix.py`): the op itself records none
            with torch.no_grad():
                return self.op(*args)
        return (self.plain if cpu else self.cuda)(*args)

    def _vmap(self, info, in_dims, *args):
        """Every operand is [N, ...] and every output [N, ...] per member:
        fold the members into N, call the op once, unfold the outputs."""
        B = info.batch_size
        folded = [_fold(x, d, B) for x, d in zip(args, in_dims)]
        tensors = [t for x in folded for t in (x if isinstance(x, list) else [x])
                   if isinstance(t, torch.Tensor)]
        if any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in tensors):
            out = self.op(*folded)  # another transform around this one
        else:  # plain tensors: the implementation itself, as in eager mode
            cpu = all(t.device.type == "cpu" for t in tensors)
            out = (self.plain if cpu else self.cuda)(*folded)
        if isinstance(out, torch.Tensor):
            return out.reshape(B, -1, *out.shape[1:]), 0
        return tuple(o.reshape(B, -1, *o.shape[1:]) for o in out), (0,) * len(out)


# launches per kernel, counted where the entry point is called and nowhere else
LAUNCHES = dict.fromkeys(
    ("bmm", "gj_solve", "gj_solve_logdet", "lq", "chol", "chol_gram", "fused_filter", "fused_smooth"), 0
)


# launches per kernel and design, where a wrapper picks one of two kernels by
# shape: "block" (a block per matrix or pair, in shared memory) or the
# register-resident design, "warp" (a warp per matrix) or, for the fused
# combines, "tiled" (four warps per pair)
ROUTES: dict = {}
_FAST_ROUTE = {"fused_filter": "tiled", "fused_smooth": "tiled"}


def launch(kernel: str, source: str, entry: str, *args, route: str | None = None) -> None:
    """Call `entry` of `source`'s library, raise on its error, count one
    launch of `kernel` (and of its `route`, when the wrapper names one)."""
    err = getattr(library(source), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")
    LAUNCHES[kernel] += 1
    if route is not None:
        count_route(kernel, route)


def count_route(kernel: str, route: str) -> None:
    """Count one call of `kernel`'s wrapper on `route`: a kernel's design, or
    "library" where the caller sent a shape the kernels do not hold to
    PyTorch's own call (no launch is counted then)."""
    counts = ROUTES.setdefault(kernel, {_FAST_ROUTE.get(kernel, "warp"): 0, "block": 0})
    counts[route] = counts.get(route, 0) + 1


def launch_counts(*kernels: str) -> dict:
    """Launches of the named kernels (all of them when none is named)."""
    return {k: LAUNCHES[k] for k in (kernels or LAUNCHES)}


def route_counts(*kernels: str) -> dict:
    """{kernel: {"warp" or "tiled": n, "block": n}} for the named kernels that chose a
    route since the last reset (all of them when none is named)."""
    return {k: dict(v) for k, v in ROUTES.items() if not kernels or k in kernels}


def reset_launch_counts(*kernels: str) -> None:
    for k in kernels or tuple(LAUNCHES):
        LAUNCHES[k] = 0
        ROUTES.pop(k, None)


def stream_of(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def row_stride(x) -> int:
    return x.stride(-2) if x.shape[-2] > 1 else x.shape[-1]


def ceil4(x: int) -> int:
    return (x + 3) & ~3


def row_pitch(cols: int, itemsize: int) -> int:
    """Elements between the rows of a shared-memory tile of `cols` columns,
    as `csrc/tiles.cuh` lays it out: cols rounded up to 4, then to 16
    (mod 32) bytes, so that rows start 16-byte aligned and neighbouring rows
    lie 4 banks apart."""
    nbytes = ceil4(cols) * itemsize
    if nbytes % 32 == 0:
        nbytes += 16
    return nbytes // itemsize


def layout_aligned16(ptr: int, batch_stride: int, ld: int, itemsize: int) -> bool:
    """Whether 16-byte loads may stage an operand: its base address, batch
    stride and row stride `ld` (in elements) are all multiples of 16 bytes."""
    return ptr % 16 == 0 and (batch_stride * itemsize) % 16 == 0 and (ld * itemsize) % 16 == 0


def aligned16(x) -> bool:
    return layout_aligned16(x.data_ptr(), x.stride(0), row_stride(x), x.element_size())


def threads_for(work: int) -> int:
    """Threads per block: one per work item, whole warps, at most 256."""
    return max(32, min(256, -(-work // 32) * 32))

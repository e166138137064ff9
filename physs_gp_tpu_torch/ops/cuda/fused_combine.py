"""Fused filtering and smoothing combines: hand-written CUDA kernels.

Counterpart of `physs_gp_tpu/ops/pallas/fused_combine.py`. The associative
combines of the covariance-form parallel Kalman filter and smoother, each as
ONE kernel launch (`csrc/fused_combine.cu`): every product, the unpivoted
Gauss-Jordan inverse of I + C_i J_j and both symmetrisations run inside the
kernel.

Filtering combine (Särkkä & García-Fernández eq. 10; ei earlier, ej later):
    U   = (I + C_i J_j)^-1
    A   = A_j U A_i
    b   = b_j + A_j U (b_i + C_i eta_j)
    C   = sym(A_j U C_i A_j^T + C_j)
    W   = U A_i
    eta = eta_i + W^T (eta_j - J_j b_i)
    J   = sym(J_i + W^T J_j A_i)
Smoothing combine (ej later suffix, ei earlier):
    E = E_i E_j,  g = g_i + E_i g_j,  L = sym(L_i + E_i L_j E_i^T)

- `fused_filtering_combine(ei, ej)` replaces `_combine_kernel`,
  `fused_smoothing_combine(ej, ei)` replaces `_smoothing_kernel`. Elements
  are NamedTuples with fields (A, b, C, J, eta) / (E, g, L), matrices
  [N, d, d] and vectors [N, d] with unit stride along the last dimension;
  batch and row strides go to the kernel, so strided views and broadcast
  (stride-0) batches need no copy. Results are new contiguous tensors in the
  type of the first operand.
- Two routes each, chosen by shape (`fused_plan`, counted by
  `build.route_counts`): for 3 <= d <= 32 the tiled kernels
  (`fused_{filter,smooth}_tiled_kernel<T>`: four warps per pair, register-
  tiled products, the inverse in one warp), above that the block kernels
  (`fused_{filter,smooth}_block_kernel<T>`: one block per pair, everything
  in shared memory). An operand whose base address, batch stride and row
  stride are multiples of 16 bytes is staged 16 bytes at a time on the tiled
  route, any other one element at a time (`build.layout_aligned16`).
- `fused_filter_plain` / `fused_smooth_plain` are the kernels' arithmetic in
  batched tensor ops, the CPU implementations of the custom ops
  `torch.ops.physs_gp.fused_filter` / `fused_smooth` (`fused_filter_op`,
  `fused_smooth_op`: a list of both elements' leaves in, the combined
  element's leaves out). For CUDA tensors they launch the kernel or raise.
- `use_fused_combine(first, second, dtype)` is the routing decision of the
  scans, from the shapes of the two operands' matrices: the reference's knob
  `PHYSS_FUSED_COMBINE=1`, read at call time, default off, sends every
  eligible combine to the kernel; eligible means two equal [N, d, d] shapes
  with d >= 3 whose kernel fits one block's shared memory. It does not look
  at the device.

The wrappers carry no gradient: `ops/parallel_kalman.py` wraps them in a
`torch.autograd.Function` whose backward recomputes the unfused combine.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import os

import torch

from .batched_linalg import gj_solve_plain
from .build import (
    SMEM_LIMIT, WARP_D, KernelOp, check_smem, dtype_code, launch, layout_aligned16, on_cpu, row_pitch,
    row_stride, stream_of, threads_for,
)

__all__ = [
    "fused_filtering_combine",
    "fused_smoothing_combine",
    "fused_filter_plain",
    "fused_smooth_plain",
    "use_fused_combine",
    "fits",
    "fused_plan",
]

D_MIN = 3  # below it the closed-form d <= 2 algebra applies
TILED_THREADS = 128  # four warps per pair on the tiled route


def _filter_words(d: int) -> int:
    """Shared-memory words of the block route's filtering kernel: nine
    [d][d + 1] matrices and four vectors."""
    return 9 * d * (d + 1) + 4 * d


def _smooth_words(d: int) -> int:
    """Shared-memory words of the block route's smoothing kernel: five
    matrices, one vector."""
    return 5 * d * (d + 1) + d


def _tiled_words(itemsize: int, smoothing: bool) -> int:
    """Shared-memory words of a tiled kernel, the same for every d <= 32:
    [32][pitch] tiles (filtering: the six inputs and four temporaries;
    smoothing: four inputs and one) and vectors of 32 (six; two)."""
    tile = 32 * row_pitch(32, itemsize)
    return 5 * tile + 2 * 32 if smoothing else 10 * tile + 6 * 32


@functools.lru_cache(maxsize=None)
def fused_plan(N: int, d: int, itemsize: int, smoothing: bool = False):
    """(route, threads, shared-memory bytes) of one fused launch, one pair
    per block at every N (the scans launch at 128 and 256 pairs, so 256
    blocks of four warps spread over the 132 SMs).

    3 <= d <= 32: "tiled", 128 threads, d padded to 32 (f32: 46 848 B for
    the filtering combine, 23 296 B for the smoothing one; f64: 88 576 B,
    44 032 B). Larger d: "block", one thread per element of a d x d matrix
    (at most 256), every matrix in shared memory at a row pitch of d + 1."""
    if d <= WARP_D:
        return "tiled", TILED_THREADS, _tiled_words(itemsize, smoothing) * itemsize
    words = _smooth_words(d) if smoothing else _filter_words(d)
    return "block", threads_for(d * d), words * itemsize


def fits(d: int, dtype, smoothing: bool = False) -> bool:
    """Whether the kernel for state dimension d fits one block's shared
    memory: every d <= 32 on the tiled route; on the block route, filtering
    d <= 56 in float64 and 79 in float32, smoothing 75 and 107."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return d >= D_MIN and fused_plan(1, d, itemsize, smoothing)[2] <= SMEM_LIMIT


def use_fused_combine(first, second, dtype, smoothing: bool = False) -> bool:
    """Whether a combine takes the fused kernel; `first` and `second` are the
    shapes of the two operands' matrices."""
    if os.environ.get("PHYSS_FUSED_COMBINE", "0") != "1":
        return False
    first = tuple(first)
    return (
        first == tuple(second)
        and len(first) == 3
        and first[-1] == first[-2]
        and fits(first[-1], dtype, smoothing)
    )


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the reference the kernels are
# held to on the card)
# ---------------------------------------------------------------------------


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def fused_filter_plain(ei, ej):
    Ai, bi, Ci, Ji, etai = ei
    Aj, bj, Cj, Jj, etaj = ej
    eye = torch.eye(Ai.shape[-1], dtype=Ai.dtype, device=Ai.device)
    # the kernel's elimination: [I + C_i J_j | I] -> [I | U], pivot by pivot
    U = gj_solve_plain(eye + Ci @ Jj, eye.expand(Ai.shape))
    AjU = Aj @ U
    W = U @ Ai
    return type(ei)(
        A=AjU @ Ai,
        b=bj + _mv(AjU, bi + _mv(Ci, etaj)),
        C=_sym(AjU @ Ci @ Aj.transpose(-1, -2) + Cj),
        J=_sym(Ji + W.transpose(-1, -2) @ (Jj @ Ai)),
        eta=etai + _mv(W.transpose(-1, -2), etaj - _mv(Jj, bi)),
    )


def fused_smooth_plain(ej, ei):
    Ej, gj, Lj = ej
    Ei, gi, Li = ei
    return type(ej)(
        E=Ei @ Ej,
        g=gi + _mv(Ei, gj),
        L=_sym(Li + Ei @ Lj @ Ei.transpose(-1, -2)),
    )


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name, smoothing, mats, vecs) -> bool:
    """Shape and size checks, the same on every device, then the shared
    operand checks; True for CPU operands."""
    shape = tuple(mats[0].shape)
    if len(shape) != 3 or shape[-1] != shape[-2]:
        raise ValueError(f"{name}: matrices must be [N, d, d], got {list(shape)}")
    if any(tuple(m.shape) != shape for m in mats) or any(
        tuple(v.shape) != shape[:2] for v in vecs
    ):
        raise ValueError(f"{name}: operands must be [N, d, d] and [N, d] with one N and d")
    if shape[-1] < D_MIN:
        raise ValueError(f"{name}: d = {shape[-1]} is below {D_MIN}")
    es = mats[0].element_size()
    check_smem(name, fused_plan(shape[0], shape[-1], es, smoothing)[2] // es, mats[0])
    if on_cpu(name, *mats, *(v[..., None] for v in vecs)):
        return True
    if any(v.stride(-1) != 1 for v in vecs):
        raise ValueError(f"{name}: last dimension must have unit stride")
    return False


def _launch(kernel, entry, ins, outs, N, d, smoothing):
    route, threads, _ = fused_plan(N, d, ins[0].element_size(), smoothing)
    strides, vec = [], 0
    for q, x in enumerate(ins):
        ld = row_stride(x) if x.dim() == 3 else 0
        strides += [x.stride(0), ld]
        vec |= layout_aligned16(x.data_ptr(), x.stride(0), ld, x.element_size()) << q
    launch(
        kernel, "fused_combine", entry, dtype_code(ins[0]),
        (ctypes.c_void_p * len(ins))(*[x.data_ptr() for x in ins]),
        (ctypes.c_longlong * len(strides))(*strides),
        (ctypes.c_void_p * len(outs))(*[x.data_ptr() for x in outs]),
        N, d, threads, vec, stream_of(ins[0]), route=route,
    )


# The kernels as custom ops (`build.KernelOp`) on the flat list of both
# elements' leaves, first element then second, and the output element's leaves
_Filter = collections.namedtuple("_Filter", "A b C J eta")
_Smooth = collections.namedtuple("_Smooth", "E g L")


def _outputs(cls, like):
    """New contiguous leaves of a `cls` element in the type of `like`
    [N, d, d]: [N, d, d] matrices, [N, d] vectors."""
    N, d, _ = like.shape
    return cls(*(like.new_empty((N, d) if f in ("b", "eta", "g") else (N, d, d))
                 for f in cls._fields))


def _op(kernel, entry, cls, plain, smoothing):
    n = len(cls._fields)

    def cpu(ins):
        return tuple(x.contiguous() for x in plain(cls(*ins[:n]), cls(*ins[n:])))

    def cuda(ins):
        out = _outputs(cls, ins[0])
        N, d, _ = ins[0].shape
        if N:
            _launch(kernel, entry, ins, out, N, d, smoothing)
        return tuple(out)

    schema = f"(Tensor[] ins) -> ({', '.join(['Tensor'] * n)})"
    return KernelOp(kernel, schema, cpu, cuda, lambda ins: tuple(_outputs(cls, ins[0])))


fused_filter_op = _op("fused_filter", "physs_fused_filter", _Filter, fused_filter_plain, False)
fused_smooth_op = _op("fused_smooth", "physs_fused_smooth", _Smooth, fused_smooth_plain, True)


def fused_filtering_combine(ei, ej):
    """The filtering combine of two batches of elements (A, b, C, J, eta)."""
    mats, vecs = (ei.A, ei.C, ei.J, ej.A, ej.C, ej.J), (ei.b, ei.eta, ej.b, ej.eta)
    cpu = _check("fused_filtering_combine", False, mats, vecs)
    return type(ei)(*fused_filter_op(cpu, [*ei, *ej]))


def fused_smoothing_combine(ej, ei):
    """The smoothing combine of two batches of elements (E, g, L); ej is the
    later suffix, ei the earlier element."""
    cpu = _check("fused_smoothing_combine", True, (ej.E, ej.L, ei.E, ei.L), (ej.g, ei.g))
    return type(ej)(*fused_smooth_op(cpu, [*ej, *ei]))

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

- `fused_filtering_combine(ei, ej)` replaces `_combine_kernel`
  (`fused_filter_kernel<T>`), `fused_smoothing_combine(ej, ei)` replaces
  `_smoothing_kernel` (`fused_smooth_kernel<T>`). Elements are NamedTuples
  with fields (A, b, C, J, eta) / (E, g, L), matrices [N, d, d] and vectors
  [N, d] with unit stride along the last dimension; batch and row strides go
  to the kernel, so strided views and broadcast (stride-0) batches need no
  copy. Results are new contiguous tensors in the type of the first operand.
- `fused_filter_plain` / `fused_smooth_plain` are the kernels' arithmetic in
  batched tensor ops; the wrappers take them for CPU tensors only. For CUDA
  tensors they launch the kernel or raise.
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

import ctypes
import os

import torch

from .batched_linalg import gj_solve_plain
from .build import SMEM_LIMIT, check_smem, dtype_code, launch, on_cpu, row_stride, stream_of, threads_for

__all__ = [
    "fused_filtering_combine",
    "fused_smoothing_combine",
    "fused_filter_plain",
    "fused_smooth_plain",
    "use_fused_combine",
    "fits",
]

D_MIN = 3  # below it the closed-form d <= 2 algebra applies


def _filter_words(d: int) -> int:
    """Shared-memory words of `fused_filter_kernel`: nine [d][d + 1]
    matrices and four vectors."""
    return 9 * d * (d + 1) + 4 * d


def _smooth_words(d: int) -> int:
    """Shared-memory words of `fused_smooth_kernel`: five matrices, one vector."""
    return 5 * d * (d + 1) + d


def fits(d: int, dtype, smoothing: bool = False) -> bool:
    """Whether the kernel for state dimension d fits one block's shared
    memory (filtering: d <= 56 in float64, 79 in float32; smoothing: 75, 107)."""
    words = _smooth_words(d) if smoothing else _filter_words(d)
    return d >= D_MIN and words * dtype.itemsize <= SMEM_LIMIT


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


def _check(name, words, mats, vecs) -> bool:
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
    check_smem(name, words(shape[-1]), mats[0])
    if on_cpu(name, *mats, *(v[..., None] for v in vecs)):
        return True
    if any(v.stride(-1) != 1 for v in vecs):
        raise ValueError(f"{name}: last dimension must have unit stride")
    return False


def _launch(kernel, entry, ins, outs, N, d):
    strides = []
    for x in ins:
        strides += [x.stride(0), row_stride(x) if x.dim() == 3 else 0]
    launch(
        kernel, "fused_combine", entry, dtype_code(ins[0]),
        (ctypes.c_void_p * len(ins))(*[x.data_ptr() for x in ins]),
        (ctypes.c_longlong * len(strides))(*strides),
        (ctypes.c_void_p * len(outs))(*[x.data_ptr() for x in outs]),
        N, d, threads_for(d * d), stream_of(ins[0]),
    )


def fused_filtering_combine(ei, ej):
    """The filtering combine of two batches of elements (A, b, C, J, eta)."""
    mats, vecs = (ei.A, ei.C, ei.J, ej.A, ej.C, ej.J), (ei.b, ei.eta, ej.b, ej.eta)
    if _check("fused_filtering_combine", _filter_words, mats, vecs):
        return fused_filter_plain(ei, ej)
    N, d, _ = ei.A.shape
    new = ei.A.new_empty
    out = type(ei)(A=new(N, d, d), b=new(N, d), C=new(N, d, d), J=new(N, d, d), eta=new(N, d))
    if N:
        _launch("fused_filter", "physs_fused_filter", (*ei, *ej), tuple(out), N, d)
    return out


def fused_smoothing_combine(ej, ei):
    """The smoothing combine of two batches of elements (E, g, L); ej is the
    later suffix, ei the earlier element."""
    if _check("fused_smoothing_combine", _smooth_words, (ej.E, ej.L, ei.E, ei.L), (ej.g, ei.g)):
        return fused_smooth_plain(ej, ei)
    N, d, _ = ej.E.shape
    new = ej.E.new_empty
    out = type(ej)(E=new(N, d, d), g=new(N, d), L=new(N, d, d))
    if N:
        _launch("fused_smooth", "physs_fused_smooth", (*ej, *ei), tuple(out), N, d)
    return out

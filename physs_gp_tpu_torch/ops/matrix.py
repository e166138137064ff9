"""Dense matrix primitives for the state-space GP stack (PyTorch).

Counterpart of `physs_gp_tpu/ops/matrix.py`, restricted to what the
config-5 CVI step uses. `bmm`, `psd_solve`, `psd_solve_logdet` and
`gen_solve` send 3-D operands with one shared batch to the hand-written
batched kernels (`ops/cuda/batched_linalg.py`: CUDA kernels on the card,
their plain PyTorch versions on the CPU) whenever the kernel can hold the
matrix size (d <= 80); other shapes go to PyTorch's own routines. The
solve-calculus custom VJPs of the reference become `torch.autograd.Function`s
whose backward calls the same forward entry points; they take the
`forward` / `setup_context` form with a generated vmap rule, so
`torch.func` transforms (`vmap`, `grad`) pass through them to the kernels'
own vmap rules.

`_cholesky_any(A, assume_psd=True)` (hence `safe_cholesky` and
`safe_cholesky_rel`) sends every [N, d, d] or single [d, d] matrix with
3 <= d <= 80 to the pivot-floored Cholesky kernel (`ops/cuda/batched_chol.py`)
with no batch-size gate; its backward recomputes through
`torch.linalg.cholesky`, as the reference's does through XLA's.
`robust_cholesky` stays off that kernel: it reads a failed factorisation as
the sign to escalate its jitter, and the kernel never fails.
"""
from __future__ import annotations

import torch

from .cuda import batched_chol as bc
from .cuda import batched_linalg as bl
from .cuda.build import SMEM_LIMIT, transformed

__all__ = [
    "add_jitter",
    "default_jitter",
    "symmetrize",
    "safe_cholesky",
    "safe_cholesky_rel",
    "robust_cholesky",
    "cholesky_solve",
    "solve_lower",
    "solve_upper",
    "gen_solve",
    "bmm",
    "unit_last",
    "psd_solve",
    "psd_solve_logdet",
    "mat_inv",
    "kron",
    "kron_lift",
    "block_diag",
    "diag_from_XDXT",
    "log_det_from_chol",
    "to_block_diag_batched",
    "get_block_diagonal",
    "kron_mv",
    "project_psd",
    "recompute_vjp",
    "apply_function",
]

# Counterpart of `highest_precision`: every float32 product on the card runs
# in full float32, never TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32

DEFAULT_JITTER = None  # sentinel: pick per dtype


def default_jitter(dtype) -> float:
    """Per-dtype stabilising jitter: 1e-12 for float64, 1e-6 otherwise."""
    return 1e-12 if dtype.itemsize >= 8 else 1e-6


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def add_jitter(A, jitter: float | None = DEFAULT_JITTER):
    if jitter is None:
        jitter = default_jitter(A.dtype)
    return A + jitter * _eye(A.shape[-1], A)


def symmetrize(A):
    return 0.5 * (A + A.transpose(-1, -2))


def apply_function(fn, *args):
    """`fn.apply(*args)` of an `autograd.Function` where autograd needs it
    (grad mode on and an input that requires grad), else its `forward`
    alone: the same values without the Function's host cost (under
    `torch.func.vmap`, that of its generated vmap rule)."""
    if torch.is_grad_enabled() and any(isinstance(a, torch.Tensor) and a.requires_grad
                                       for a in args):
        return fn.apply(*args)
    return fn.forward(*args)


def _cholesky_any(A, assume_psd: bool = False):
    """Batched Cholesky with closed-form n <= 2 branches.

    `assume_psd=True` routes [N, d, d] and [d, d] inputs to the batched
    Cholesky kernel, which floors pivots instead of returning NaN: callers
    that read NaN as the sign of an indefinite input stay off it."""
    n = A.shape[-1]
    if n == 1:
        return torch.sqrt(A)
    if n == 2:
        a11 = A[..., 0, 0]
        a21 = A[..., 1, 0]
        a22 = A[..., 1, 1]
        l11 = torch.sqrt(a11)
        l21 = a21 / l11
        l22 = torch.sqrt(torch.clamp(a22 - l21 * l21, min=0.0))
        z = torch.zeros_like(l11)
        return torch.stack(
            [torch.stack([l11, z], -1), torch.stack([l21, l22], -1)], -2
        )
    if assume_psd and A.dim() in (2, 3) and n <= bl.D_MAX:
        return apply_function(_KernelCholesky, A)
    return torch.linalg.cholesky(A)


class _KernelCholesky(torch.autograd.Function):
    """Forward: the pivot-floored batched Cholesky (a 2-D input runs as a
    batch of one); backward: recomputed through the library Cholesky (the
    same factor for PD inputs; callers jitter where pivots would be
    floored). A member that is not positive definite gets a NaN gradient,
    as through the reference's `jnp.linalg.cholesky`, with no error and no
    read-back to the host."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A):
        if A.dim() == 2:
            return bc.batch_cholesky(unit_last(A[None]))[0]
        return bc.batch_cholesky(unit_last(A))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, ct):
        (A,) = ctx.saved_tensors
        if transformed():  # under `torch.func.grad` / `vmap`: no `requires_grad_`
            _, pull, info = torch.func.vjp(torch.linalg.cholesky_ex, A, has_aux=True)
            (grad,) = pull(ct)
        else:
            with torch.enable_grad():
                a = A.detach().requires_grad_(True)
                L, info = torch.linalg.cholesky_ex(a)
                (grad,) = torch.autograd.grad(L, a, ct)
        return torch.where((info == 0)[..., None, None], grad, float("nan"))


def recompute_vjp(fn, cts, *xs):
    """The cotangents at `xs` of `fn(*xs)` for its outputs' cotangents
    `cts`, by recomputing `fn` (a backward that reruns a reference); None
    entries of `xs` pass through as None. Regular autograd, or
    `torch.func.vjp` under a `torch.func` transform, where `requires_grad_`
    is refused.

    Outside a transform `torch.func.vjp` does not serve: its pull runs the
    recomputed `autograd.Function`s' backwards with no transform active on
    functorch-wrapped saved tensors, so a kernel wrapper there takes its
    direct launch and fails on a tensor without storage (the fused
    combines' backward, on the card; the CPU's plain versions accept
    wrapped tensors)."""
    live = [x for x in xs if x is not None]

    def on_live(*ys):
        it = iter(ys)
        return fn(*[None if x is None else next(it) for x in xs])

    if transformed():
        _, pull = torch.func.vjp(on_live, *live)
        grads = iter(pull(cts))
    else:
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(True) for x in live]
            grads = iter(torch.autograd.grad(on_live(*ins), ins, cts))
    return tuple(None if x is None else next(grads) for x in xs)


def safe_cholesky(A, jitter: float | None = DEFAULT_JITTER):
    """Cholesky of sym(A) + jitter I."""
    return _cholesky_any(add_jitter(symmetrize(A), jitter), assume_psd=True)


def safe_cholesky_rel(A, rel: float | None = None):
    """Cholesky of sym(A) + (rel * max|diag A| + 1e-30) I: a relative jitter
    with an absolute floor, so an exactly-zero A (e.g. Q at dt = 0) factors
    to a negligible multiple of I; differentiable everywhere."""
    if rel is None:
        rel = default_jitter(A.dtype)
    scale = torch.amax(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), -1)
    eps = rel * scale + 1e-30
    return _cholesky_any(
        symmetrize(A) + eps[..., None, None] * _eye(A.shape[-1], A), assume_psd=True
    )


def _cholesky_or_nan(A):
    """Library Cholesky with NaN for the members that are not positive
    definite, as `jnp.linalg.cholesky` gives them; no error and no read-back
    to the host (`cholesky_ex` with `check_errors=False`). n <= 2 runs the
    closed form of `_cholesky_any`."""
    if A.shape[-1] <= 2:
        return _cholesky_any(A)
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    return torch.where((info == 0)[..., None, None], L, float("nan")).tril()


def robust_cholesky(A, rel: float | None = None, escalations=(1e2, 1e3, 1e4)):
    """Cholesky with a per-member escalating relative jitter.

    Projected block covariances S = H P Hᵀ over nearly dependent heads go
    indefinite at the float32 error scale. Probe factorisations of sym(A) +
    rel * lv * max|diag A| I at lv = 1, *escalations, without gradient, pick
    per batch member the smallest level whose factor is finite; one real
    factorisation then runs at that level. A member that fails at every
    probed level takes the highest level unprobed (and is NaN if it fails
    there too)."""
    if rel is None:
        rel = default_jitter(A.dtype)
    A = symmetrize(A)
    eye = _eye(A.shape[-1], A)
    scale = torch.amax(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), -1)[..., None, None] + 1e-30
    levels = (1.0,) + tuple(escalations)
    with torch.no_grad():
        A_probe = A.detach()
        mult = torch.full_like(scale, levels[-1])
        # high to low: a finite smaller level overwrites
        for lv in reversed(levels[:-1]):
            L = _cholesky_or_nan(A_probe + (rel * lv) * scale * eye)
            good = torch.isfinite(L).all(-1, keepdim=True).all(-2, keepdim=True)
            mult = torch.where(good, lv, mult)
    return _cholesky_or_nan(A + (rel * mult) * scale * eye)


def solve_lower(L, B):
    """L⁻¹ B for lower-triangular L [..., n, n], B [..., n, k]; closed form at n <= 2."""
    n = L.shape[-1]
    if n == 1:
        return B / L[..., 0:1, 0:1]
    if n == 2:
        x0 = B[..., 0, :] / L[..., 0:1, 0]
        x1 = (B[..., 1, :] - L[..., 1:2, 0] * x0) / L[..., 1:2, 1]
        return torch.stack([x0, x1], -2)
    return torch.linalg.solve_triangular(L, B, upper=False)


def solve_upper(U, B):
    """U⁻¹ B for upper-triangular U [..., n, n], B [..., n, k]; closed form at n <= 2."""
    n = U.shape[-1]
    if n == 1:
        return B / U[..., 0:1, 0:1]
    if n == 2:
        x1 = B[..., 1, :] / U[..., 1:2, 1]
        x0 = (B[..., 0, :] - U[..., 0:1, 1] * x1) / U[..., 0:1, 0]
        return torch.stack([x0, x1], -2)
    return torch.linalg.solve_triangular(U, B, upper=True)


def cholesky_solve(L, B):
    """Solve A X = B given the lower factor L of A."""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


def log_det_from_chol(L):
    return 2.0 * torch.sum(
        torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))), -1
    )


def mat_inv(A, jitter: float | None = DEFAULT_JITTER):
    eye = _eye(A.shape[-1], A).expand(A.shape)
    return psd_solve(A, eye, jitter)


# ---------------------------------------------------------------------------
# Routing to the batched kernels
# ---------------------------------------------------------------------------


def _kernel_shapes(A, B) -> bool:
    return (
        A.dim() == 3
        and B.dim() == 3
        and A.shape[0] == B.shape[0]
        and max(A.shape[-1], A.shape[-2]) <= bl.D_MAX
        and max(B.shape[-1], B.shape[-2]) <= bl.D_MAX
    )


def _solve_shapes(A, B) -> bool:
    """The solve kernel holds [A | B] in shared memory: d <= 80 and as many
    right-hand sides as fit (97 on the square-root path)."""
    if not (A.dim() == 3 and B.dim() == 3 and A.shape[0] == B.shape[0]):
        return False
    d, r = A.shape[-1], B.shape[-1]
    words = d * (d + r) + d + (d + r)
    return d <= bl.D_MAX and words * A.element_size() <= SMEM_LIMIT


def unit_last(X):
    """X with unit stride along its last dimension (copy only if needed)."""
    if X.shape[-1] == 1 or X.stride(-1) == 1:
        return X
    return X.contiguous()


def _psd_solve_primal(A, B):
    if _solve_shapes(A, B):
        return bl.batch_solve(unit_last(A), unit_last(B))
    return cholesky_solve(_cholesky_any(A), B)


def _psd_solve_logdet_primal(A, B):
    if _solve_shapes(A, B):
        return bl.batch_solve_logdet(unit_last(A), unit_last(B))
    L = _cholesky_any(A)
    return cholesky_solve(L, B), log_det_from_chol(L)


def _gen_solve_primal(A, B):
    if _solve_shapes(A, B):
        return bl.batch_solve(unit_last(A), unit_last(B))
    return torch.linalg.solve(A, B)


def _bmm_primal(A, B, ta: bool, tb: bool):
    if _kernel_shapes(A, B):
        # a view with unit stride along its second-last dimension is the
        # transpose of a row-major matrix: flip the flag instead of copying
        if A.shape[-1] > 1 and A.stride(-1) != 1 and A.stride(-2) == 1:
            A, ta = A.transpose(-1, -2), not ta
        if B.shape[-1] > 1 and B.stride(-1) != 1 and B.stride(-2) == 1:
            B, tb = B.transpose(-1, -2), not tb
        return bl.batch_bmm(unit_last(A), unit_last(B), ta, tb)
    a = A.transpose(-1, -2) if ta else A
    b = B.transpose(-1, -2) if tb else B
    return torch.matmul(a, b)


def _outer_sum(W, X):
    """einsum('...ir,...jr->...ij', W, X)."""
    return torch.matmul(W, X.transpose(-1, -2))


class _PsdSolve(torch.autograd.Function):
    """X = A^-1 B for symmetric A; dB = A^-1 ct, dA = -dB X^T."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A, B):
        return _psd_solve_primal(A, B)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, ct):
        A, X = ctx.saved_tensors
        W = _psd_solve_primal(A, ct)  # A symmetric: A^-T = A^-1
        return -_outer_sum(W, X), W


class _PsdSolveLogdet(torch.autograd.Function):
    """(A^-1 B, log det A); the logdet cotangent adds ct_ld A^-1 to dA."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A, B):
        return _psd_solve_logdet_primal(A, B)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output[0])

    @staticmethod
    def backward(ctx, ct_X, ct_ld):
        A, X = ctx.saved_tensors
        eye = _eye(A.shape[-1], A).expand(A.shape)
        r = ct_X.shape[-1]
        sol = _psd_solve_primal(A, torch.cat([ct_X, eye], -1))
        W, Ainv = sol[..., :r], sol[..., r:]
        A_bar = -_outer_sum(W, X) + ct_ld[..., None, None] * Ainv
        return A_bar, W


class _GenSolve(torch.autograd.Function):
    """X = A^-1 B for general A; dB = A^-T ct, dA = -dB X^T."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A, B):
        return _gen_solve_primal(A, B)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, ct):
        A, X = ctx.saved_tensors
        W = _gen_solve_primal(A.transpose(-1, -2), ct)
        return -_outer_sum(W, X), W


def _unbroadcast_to(x, shape):
    """Sum a cotangent over the dims its primal was broadcast along."""
    if x.shape == shape:
        return x
    ndiff = x.dim() - len(shape)
    if ndiff:
        x = x.sum(dim=tuple(range(ndiff)))
    axes = tuple(
        i for i, (a, b) in enumerate(zip(x.shape, shape)) if b == 1 and a != 1
    )
    if axes:
        x = x.sum(dim=axes, keepdim=True)
    return x


class _Bmm(torch.autograd.Function):
    """C = op(A) op(B); each cotangent is another bmm."""

    generate_vmap_rule = True

    @staticmethod
    def forward(A, B, ta, tb):
        return _bmm_primal(A, B, ta, tb)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, B, ta, tb = inputs
        ctx.save_for_backward(A, B)
        ctx.ta, ctx.tb = ta, tb

    @staticmethod
    def backward(ctx, ct):
        A, B = ctx.saved_tensors
        ta, tb = ctx.ta, ctx.tb
        if not ta:
            dA = _bmm_primal(ct, B, False, not tb)
        else:
            dA = _bmm_primal(B, ct, tb, True)
        if not tb:
            dB = _bmm_primal(A, ct, not ta, False)
        else:
            dB = _bmm_primal(ct, A, True, ta)
        return _unbroadcast_to(dA, A.shape), _unbroadcast_to(dB, B.shape), None, None


def bmm(A, B, ta: bool = False, tb: bool = False):
    """op(A) @ op(B) batched over the leading axis; op = T when ta/tb."""
    return apply_function(_Bmm, A, B, ta, tb)


def gen_solve(A, B):
    """Differentiable batched solve for general, well-conditioned A (e.g.
    the filtering combine's identity-dominated I + C J)."""
    return apply_function(_GenSolve, A, B)


def psd_solve(A, B, jitter: float | None = DEFAULT_JITTER):
    """Solve (sym(A) + jitter I) X = B for batched SPD A."""
    return apply_function(_PsdSolve, add_jitter(symmetrize(A), jitter), B)


def psd_solve_logdet(A, B, jitter: float | None = DEFAULT_JITTER):
    """(X, log det) of the jittered SPD solve, in one pass."""
    return apply_function(_PsdSolveLogdet, add_jitter(symmetrize(A), jitter), B)


def kron(A, B):
    """Batched Kronecker product: [..., m, n] x [..., p, q] -> [..., mp, nq]."""
    m, n = A.shape[-2:]
    p, q = B.shape[-2:]
    out = A[..., :, None, :, None] * B[..., None, :, None, :]
    return out.reshape(out.shape[:-4] + (m * p, n * q))


def kron_lift(B, C):
    """kron(B, C) for one B [m, m] and batched C [T, n, n] -> [T, mn, mn]:
    out[t, i*n + a, j*n + b] = B[i, j] * C[t, a, b]."""
    m = B.shape[-1]
    n = C.shape[-1]
    Bg = B.repeat_interleave(n, dim=-2).repeat_interleave(n, dim=-1)
    Cg = C.repeat(1, m, m)
    return Bg[None] * Cg


def block_diag(*blocks):
    """Dense block-diagonal assembly of differently-sized (possibly
    rectangular) blocks [..., r_i, c_i], batched over shared leading axes."""
    blocks = [torch.atleast_2d(b) for b in blocks]
    batch = torch.broadcast_shapes(*[b.shape[:-2] for b in blocks])
    m = sum(b.shape[-2] for b in blocks)
    n = sum(b.shape[-1] for b in blocks)
    out = blocks[0].new_zeros(batch + (m, n))
    i = j = 0
    for b in blocks:
        r, c = b.shape[-2:]
        out[..., i:i + r, j:j + c] = b
        i += r
        j += c
    return out


def diag_from_XDXT(X, D):
    """diag(X D Xᵀ) without forming the product."""
    return torch.einsum("...ij,...jk,...ik->...i", X, D, X)


def to_block_diag_batched(blocks):
    """[B, k, k] stacked blocks -> the [B·k, B·k] block-diagonal matrix."""
    B, k, _ = blocks.shape
    out = blocks.new_zeros(B, k, B, k)
    idx = torch.arange(B, device=blocks.device)
    out[idx, :, idx, :] = blocks
    return out.reshape(B * k, B * k)


def get_block_diagonal(A, block_size: int):
    """[..., B·k, B·k] -> its [..., B, k, k] diagonal blocks."""
    B = A.shape[-1] // block_size
    A4 = A.reshape(A.shape[:-2] + (B, block_size, B, block_size))
    return torch.einsum("...ikil->...ikl", A4)


def kron_mv(A, B, x):
    """(A ⊗ B) x as B X Aᵀ without forming the Kronecker product; A [m, m],
    B [p, p], x [..., m·p] in `kron(A, B)`'s index order i·p + j."""
    m, p = A.shape[-1], B.shape[-1]
    X = x.reshape(x.shape[:-1] + (m, p))
    return torch.einsum("ab,...bc,dc->...ad", A, X, B).reshape(x.shape)


def project_psd(A, min_eig: float = 0.0):
    """The eigenvalue-clipped PSD projection of sym(A)."""
    w, V = torch.linalg.eigh(symmetrize(A))
    w = torch.clamp(w, min=min_eig)
    return torch.einsum("...ij,...j,...kj->...ik", V, w, V)

"""Iterative SPD solves: batched preconditioned conjugate gradients and
stochastic Lanczos quadrature log-determinants (PyTorch counterpart of
`physs_gp_tpu/ops/cg.py`).

- `cg_solve`: Jacobi-preconditioned CG on every column of [..., n, k] at
  once (one batched matmul per step), with the reference's trip count
  (`maxiter`, n by default) and per-column freezing: a column whose
  residual has met `tol` takes no further update. Once every column is
  frozen the remaining steps change nothing, so the loop stops there; it
  reads that from the card every `_EXIT_EVERY` steps (`steps_run()` lists
  the steps each solve took). The gradient is implicit
  (`torch.autograd.Function`): the backward is one more CG solve against
  the same matrix, never a differentiation through the iterations.
- `slq_logdet`: Hutchinson + stochastic Lanczos quadrature, m Lanczos steps
  with full reorthogonalisation on k Rademacher probes, `eigh` of the
  [k, m, m] tridiagonals, logdet ≈ n · mean_j Σ_i τ_ji² log θ_ji. Its
  backward reuses d logdet = tr(A⁻¹ dA) with the same probes and CG
  solves, symmetrised. The probes come from a `torch.Generator`, or are
  given (`slq_logdet_given`, as the JAX package's draws in the tests).
"""
from __future__ import annotations

from collections import deque

import torch

from .matrix import DEFAULT_JITTER, add_jitter, symmetrize

__all__ = ["cg_solve", "slq_logdet", "slq_logdet_given", "rademacher", "solve",
           "log_determinant", "steps_run", "reset_steps"]

# the loop asks the card whether a column is still active every this many steps
_EXIT_EVERY = 32
_STEPS: deque = deque(maxlen=1024)


def steps_run() -> list:
    """(n, columns, maxiter, steps run) of the CG solves since `reset_steps()`
    (the last 1024)."""
    return list(_STEPS)


def reset_steps() -> None:
    _STEPS.clear()


def _dot_cols(a, b):
    """Per-column inner products: [..., n, k] x2 -> [..., 1, k]."""
    return torch.sum(a * b, -2, keepdim=True)


def _safe_div(num, den):
    """num / den with 0 where |den| underflows."""
    tiny = 1e-30 if num.dtype == torch.float64 else 1e-20
    ok = torch.abs(den) > tiny
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), torch.zeros_like(num))


def _pcg(matvec, B, minv, maxiter: int, tol: float):
    """Preconditioned CG on [..., n, k] right-hand sides for at most
    `maxiter` steps; `minv` [..., n, 1] is the Jacobi preconditioner's
    inverse diagonal (ones: unpreconditioned)."""
    thresh = tol * torch.clamp(torch.sqrt(_dot_cols(B, B)), min=1e-30)
    x = torch.zeros_like(B)
    r = B
    p = minv * r
    rz = _dot_cols(r, p)
    steps = 0
    for steps in range(maxiter):
        active = torch.sqrt(_dot_cols(r, r)) > thresh
        # every column frozen: the steps left would leave x as it is
        if steps and steps % _EXIT_EVERY == 0 and not bool(active.any()):
            break
        Ap = matvec(p)
        alpha = torch.where(active, _safe_div(rz, _dot_cols(p, Ap)), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = minv * r
        rz_new = _dot_cols(r, z)
        beta = torch.where(active, _safe_div(rz_new, rz), 0.0)
        p = z + beta * p
        rz = rz_new
    else:
        steps = maxiter
    _STEPS.append((B.shape[-2], B.shape[-1], maxiter, steps))
    return x


def _jacobi(Aj, precond):
    if precond == "jacobi":
        d = torch.diagonal(Aj, dim1=-2, dim2=-1)[..., None]  # [..., n, 1]
        return _safe_div(torch.ones_like(d), d)
    if precond is None:
        return torch.ones_like(Aj[..., :1])
    raise ValueError(f"unknown preconditioner {precond!r}")


class _CGSolve(torch.autograd.Function):
    """X = Aj⁻¹ B by PCG; dB = Aj⁻¹ ct (one more solve), dAj = −dB Xᵀ."""

    @staticmethod
    def forward(ctx, Aj, B, minv, maxiter, tol):
        X = _pcg(lambda v: Aj @ v, B, minv, maxiter, tol)
        ctx.save_for_backward(Aj, X, minv)
        ctx.maxiter, ctx.tol = maxiter, tol
        return X

    @staticmethod
    def backward(ctx, ct):
        Aj, X, minv = ctx.saved_tensors
        W = _pcg(lambda v: Aj @ v, ct, minv, ctx.maxiter, ctx.tol)
        return -W @ X.transpose(-1, -2), W, None, None, None


def cg_solve(A, B, *, jitter: float | None = DEFAULT_JITTER, precond: str | None = "jacobi",
             tol: float = 1e-6, maxiter: int | None = None):
    """Solve (sym(A) + jitter I) X = B for batched dense SPD A [..., n, n],
    B [..., n] or [..., n, k]; differentiable in A and B."""
    vector_rhs = B.dim() == A.dim() - 1
    if vector_rhs:
        B = B[..., None]
    Aj = add_jitter(symmetrize(A), jitter)
    minv = _jacobi(Aj.detach(), precond)
    X = _CGSolve.apply(Aj, B, minv, A.shape[-1] if maxiter is None else maxiter, tol)
    return X[..., 0] if vector_rhs else X


def _lanczos(matvec, z, m: int):
    """m-step Lanczos with full reorthogonalisation (two passes of classical
    Gram-Schmidt against the basis so far) from start vectors z [..., n]:
    (alphas [..., m], betas [..., m-1]) of the tridiagonal."""
    n = z.shape[-1]
    z0 = z / torch.sqrt(torch.sum(z * z, -1, keepdim=True))
    V = z.new_zeros(z.shape[:-1] + (m, n))
    V[..., 0, :] = z0

    def reorth(w, j_mask):
        c = torch.einsum("...mn,...n->...m", V, w) * j_mask
        return w - torch.einsum("...m,...mn->...n", c, V)

    v_prev, v, beta_prev = torch.zeros_like(z0), z0, z.new_zeros(z.shape[:-1])
    idx = torch.arange(m, dtype=z.dtype, device=z.device)
    alphas, betas = [], []
    for j in range(m):
        w = matvec(v)
        alpha = torch.sum(w * v, -1)
        w = w - alpha[..., None] * v - beta_prev[..., None] * v_prev
        j_mask = (idx <= j).to(z.dtype)
        w = reorth(reorth(w, j_mask), j_mask)  # twice is enough
        beta = torch.sqrt(torch.sum(w * w, -1))
        v_next = _safe_div(w, beta[..., None])
        if j + 1 < m:
            V[..., j + 1, :] = v_next
        v_prev, v, beta_prev = v, v_next, beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas, -1), torch.stack(betas, -1)[..., : m - 1]


def _slq_estimate(A, z, m: int):
    """Hutchinson + SLQ estimate of logdet(A) [...] from probes z [..., k, n]."""
    n = A.shape[-1]
    alphas, betas = _lanczos(lambda x: torch.einsum("...ij,...kj->...ki", A, x), z, m)
    T = (torch.diag_embed(alphas) + torch.diag_embed(betas, offset=1)
         + torch.diag_embed(betas, offset=-1))
    theta, U = torch.linalg.eigh(T)  # [..., k, m], [..., k, m, m]
    tau2 = U[..., 0, :] ** 2  # first-row weights
    floor = 1e-30 if A.dtype == torch.float64 else 1e-20
    quad = torch.sum(tau2 * torch.log(torch.clamp(theta, min=floor)), -1)
    return n * torch.mean(quad, -1)


class _SLQLogdet(torch.autograd.Function):
    """SLQ forward; backward Ā = ct · sym(mean_j w_j z_jᵀ), w_j = A⁻¹ z_j by
    CG on the same probes."""

    @staticmethod
    def forward(ctx, Aj, z, m, tol, maxiter):
        ctx.save_for_backward(Aj, z)
        ctx.tol, ctx.maxiter = tol, maxiter
        return _slq_estimate(Aj, z, m)

    @staticmethod
    def backward(ctx, ct):
        Aj, z = ctx.saved_tensors
        W = cg_solve(Aj, z.transpose(-1, -2), jitter=0.0, tol=ctx.tol, maxiter=ctx.maxiter)
        Abar = (W @ z) / z.shape[-2]
        Abar = 0.5 * (Abar + Abar.transpose(-1, -2))
        return ct[..., None, None] * Abar, None, None, None, None


def rademacher(generator, shape, like):
    """±1 draws of `shape` in `like`'s dtype and device from `generator`."""
    if not isinstance(generator, torch.Generator):
        raise TypeError("the probes need an explicit torch.Generator on the matrix's device")
    bits = torch.randint(0, 2, shape, generator=generator, device=like.device)
    return (2 * bits - 1).to(like.dtype)


def slq_logdet_given(A, probes, *, jitter: float | None = DEFAULT_JITTER, lanczos_iters: int = 32,
                     tol: float = 1e-6, maxiter: int | None = None):
    """Stochastic logdet(sym(A) + jitter I) for batched SPD A [..., n, n]
    from the given probes [..., k, n]."""
    n = A.shape[-1]
    Aj = add_jitter(symmetrize(A), jitter)
    return _SLQLogdet.apply(Aj, probes, min(lanczos_iters, n), tol,
                            n if maxiter is None else maxiter)


def slq_logdet(A, generator, *, jitter: float | None = DEFAULT_JITTER, n_probes: int = 16,
               lanczos_iters: int = 32, tol: float = 1e-6, maxiter: int | None = None):
    """`slq_logdet_given` on `n_probes` Rademacher probes from `generator`:
    unbiased over generators, deterministic given one."""
    z = rademacher(generator, A.shape[:-2] + (n_probes, A.shape[-1]), A)
    return slq_logdet_given(A, z, jitter=jitter, lanczos_iters=lanczos_iters, tol=tol,
                            maxiter=maxiter)


def solve(A, B, method: str = "cholesky", **kw):
    """Solver dispatch: method in {"cholesky", "cg", "exact"}."""
    if method == "cholesky":
        from .matrix import psd_solve

        vec = B.dim() == A.dim() - 1
        X = psd_solve(A, B[..., None] if vec else B, **kw)
        return X[..., 0] if vec else X
    if method == "cg":
        return cg_solve(A, B, **kw)
    if method == "exact":
        return torch.linalg.solve(add_jitter(symmetrize(A), kw.get("jitter", DEFAULT_JITTER)), B)
    raise ValueError(f"unknown solve method {method!r}")


def log_determinant(A, method: str = "cholesky", generator=None, **kw):
    """logdet dispatch: method in {"cholesky", "slq" (or "cg"), "exact"};
    "slq" needs a `generator`."""
    if method == "cholesky":
        from .matrix import log_det_from_chol, safe_cholesky

        return log_det_from_chol(safe_cholesky(A, kw.get("jitter", DEFAULT_JITTER)))
    if method in ("slq", "cg"):
        if generator is None:
            raise ValueError("the slq logdet needs an explicit torch.Generator")
        return slq_logdet(A, generator, **kw)
    if method == "exact":
        return torch.linalg.slogdet(add_jitter(symmetrize(A), kw.get("jitter", DEFAULT_JITTER)))[1]
    raise ValueError(f"unknown logdet method {method!r}")

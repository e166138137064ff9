"""Markov (state-space) kernel interface (PyTorch).

Counterpart of `physs_gp_tpu/kernels/markov.py`: dx = F x dt + L dW,
f = H x, x(inf) ~ N(minf, Pinf), discretised over a gap dt as
A(dt) = expm(F dt) and Q(dt) = Pinf - A Pinf Aᵀ (stationary), batched over
dt ([...] -> [..., d, d]). `to_ss`, `transition_matrix` and `noise_matrix`
compose a `SumKernel` block-diagonally (H concatenated) and a
`ProductKernel` by Kronecker products (F = F₁ ⊗ I + I ⊗ F₂); a product
whose factors are all noiseless but one (the quasi-periodic
Periodic x Matérn) keeps the exact composition kron(..., Pinf, ..., Q, ...).
A kernel without a closed-form `transition` falls back to
`torch.linalg.matrix_exp` on the batch. `StackedMarkov` stacks independent
latent Markov GPs block-diagonally with one output head per latent.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.matrix import block_diag, kron, symmetrize
from .base import ProductKernel, SumKernel

__all__ = ["StateSpace", "MarkovKernel", "StackedMarkov", "to_ss", "transition_matrix",
           "noise_matrix", "stationary_noise", "solve_pinf", "lyapunov_solve"]


@dataclass(frozen=True)
class StateSpace:
    """LTI-SDE representation of a Markov prior."""

    F: torch.Tensor  # [d, d] drift
    L: torch.Tensor  # [d, w] noise input
    Qc: torch.Tensor  # [w, w] white-noise spectral density
    H: torch.Tensor  # [o, d] observation
    Pinf: torch.Tensor  # [d, d] stationary covariance
    minf: torch.Tensor  # [d] stationary mean

    @property
    def state_dim(self) -> int:
        return self.F.shape[-1]


class MarkovKernel:
    """Mixin: kernels with an exact state-space representation."""

    def to_ss(self) -> StateSpace:
        raise NotImplementedError

    @property
    def state_dim(self) -> int:
        return self.to_ss().state_dim

    def transition(self, dt):
        """A(dt) = expm(F dt), batched: dt [...] -> [..., d, d]. The generic
        fallback; closed-form kernels override it."""
        F = self.to_ss().F
        dt = torch.as_tensor(dt, dtype=F.dtype, device=F.device)
        return torch.linalg.matrix_exp(F * dt[..., None, None])

    def stationary_noise(self, A):
        """Q(dt) = Pinf - A Pinf Aᵀ given A = A(dt) [..., d, d]."""
        return stationary_noise(A, self.to_ss().Pinf)


def stationary_noise(A, Pinf):
    APA = torch.einsum("...ij,...jk,...lk->...il", A, Pinf, A)
    return symmetrize(Pinf - APA)


def lyapunov_solve(F, Qc_full):
    """Stationary covariance P solving F P + P F^T + Qc_full = 0 (vec trick;
    d is tiny)."""
    d = F.shape[-1]
    eye = torch.eye(d, dtype=F.dtype, device=F.device)
    M = kron(eye, F) + kron(F, eye)
    vecP = torch.linalg.solve(M, -Qc_full.reshape(d * d, 1))
    return symmetrize(vecP.reshape(d, d))


def solve_pinf(F, L, Qc):
    return lyapunov_solve(F, L @ Qc @ L.T)


def to_ss(kernel) -> StateSpace:
    """The StateSpace of a kernel, sums block-diagonal and products by
    Kronecker products."""
    if isinstance(kernel, SumKernel):
        ps = [to_ss(k) for k in kernel.parts]
        return StateSpace(
            F=block_diag(*[p.F for p in ps]),
            L=block_diag(*[p.L for p in ps]),
            Qc=block_diag(*[p.Qc for p in ps]),
            H=torch.cat([p.H for p in ps], -1),
            Pinf=block_diag(*[p.Pinf for p in ps]),
            minf=torch.cat([p.minf for p in ps], -1),
        )
    if isinstance(kernel, ProductKernel):
        ps = [to_ss(k) for k in kernel.parts]
        out = ps[0]
        for p in ps[1:]:
            eye_p = torch.eye(p.state_dim, dtype=p.F.dtype, device=p.F.device)
            eye_o = torch.eye(out.state_dim, dtype=out.F.dtype, device=out.F.device)
            out = StateSpace(
                F=kron(out.F, eye_p) + kron(eye_o, p.F),
                L=kron(out.L, p.L),
                Qc=kron(out.Qc, p.Qc),
                H=kron(out.H, p.H),
                Pinf=kron(out.Pinf, p.Pinf),
                minf=torch.kron(out.minf, p.minf),
            )
        return out
    return kernel.to_ss()


def transition_matrix(kernel, dt):
    """Batched A(dt): dt [...] -> [..., d, d], for Sum and Product
    combinators of Markov kernels too."""
    if isinstance(kernel, SumKernel):
        return block_diag(*[transition_matrix(k, dt) for k in kernel.parts])
    if isinstance(kernel, ProductKernel):
        As = [transition_matrix(k, dt) for k in kernel.parts]
        out = As[0]
        for A in As[1:]:
            out = kron(out, A)
        return out
    return kernel.transition(dt)


def _noiseless(kernel) -> bool:
    return getattr(kernel, "is_noiseless", False)


def noise_matrix(kernel, dt):
    """Batched discretised process noise Q(dt) [..., d, d]: a kernel's
    cancellation-free `noise_cov` where it has one, else the stationary
    identity Pinf - A Pinf Aᵀ. Sums compose block-diagonally; a product
    whose factors are noiseless (rotations: A Pinf Aᵀ = Pinf) but one takes
    kron(..., Pinf_noiseless, ..., Q_noisy, ...), zeros when none is noisy."""
    if isinstance(kernel, SumKernel):
        return block_diag(*[noise_matrix(k, dt) for k in kernel.parts])
    if isinstance(kernel, ProductKernel):
        noisy = [k for k in kernel.parts if not _noiseless(k)]
        if not noisy:
            ss = to_ss(kernel)
            dt = torch.as_tensor(dt, device=ss.Pinf.device)
            return ss.Pinf.new_zeros(dt.shape + (ss.state_dim, ss.state_dim))
        if len(noisy) == 1:
            out = None
            for k in kernel.parts:
                blk = to_ss(k).Pinf if _noiseless(k) else noise_matrix(k, dt)
                out = blk if out is None else kron(out, blk)
            return out
        return stationary_noise(transition_matrix(kernel, dt), to_ss(kernel).Pinf)
    if hasattr(kernel, "noise_cov"):
        return kernel.noise_cov(dt)
    return stationary_noise(transition_matrix(kernel, dt), to_ss(kernel).Pinf)


class StackedMarkov(nn.Module, MarkovKernel):
    """Q independent latent Markov GPs observed as Q separate heads: the
    states compose block-diagonally and H is block-diagonal too (one row per
    latent), so the filters see a [Q, D] observation matrix."""

    def __init__(self, parts):
        super().__init__()
        self.parts = nn.ModuleList(parts)

    def to_ss(self) -> StateSpace:
        ps = [to_ss(k) for k in self.parts]
        return StateSpace(
            F=block_diag(*[p.F for p in ps]),
            L=block_diag(*[p.L for p in ps]),
            Qc=block_diag(*[p.Qc for p in ps]),
            H=block_diag(*[p.H for p in ps]),
            Pinf=block_diag(*[p.Pinf for p in ps]),
            minf=torch.cat([p.minf for p in ps], -1),
        )

    def transition(self, dt):
        return block_diag(*[transition_matrix(k, dt) for k in self.parts])

    def noise_cov(self, dt):
        return block_diag(*[noise_matrix(k, dt) for k in self.parts])

    def to_lgssm(self, t):
        """Block-diagonal composition of the parts' discretised systems, each
        built by `build_lgssm` (so a `SpatioTemporalKernel` part brings its
        own Kronecker lift); for plain Markov parts this is the `to_ss`
        system."""
        from ..ops.lgssm import LGSSM, build_lgssm

        parts = [build_lgssm(k, t) for k in self.parts]
        return LGSSM(
            A=block_diag(*[p.A for p in parts]),
            Q=block_diag(*[p.Q for p in parts]),
            H=block_diag(*[p.H for p in parts]),
            m0=torch.cat([p.m0 for p in parts], -1),
            P0=block_diag(*[p.P0 for p in parts]),
        )

    @property
    def state_dim(self) -> int:
        return sum(k.state_dim for k in self.parts)

    @property
    def n_outputs(self) -> int:
        return len(self.parts)

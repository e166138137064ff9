"""Markov (state-space) kernel interface (PyTorch).

Counterpart of `physs_gp_tpu/kernels/markov.py`: dx = F x dt + L dW,
f = H x, x(inf) ~ N(minf, Pinf), discretised over a gap dt as
A(dt) = expm(F dt) and Q(dt). `StackedMarkov` stacks independent latent
Markov GPs block-diagonally with one output head per latent. The
Sum/Product combinators are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.matrix import block_diag, kron, symmetrize

__all__ = ["StateSpace", "MarkovKernel", "StackedMarkov", "to_ss", "transition_matrix",
           "noise_matrix", "solve_pinf", "lyapunov_solve"]


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
    return kernel.to_ss()


def transition_matrix(kernel, dt):
    """Batched A(dt): dt [...] -> [..., d, d]."""
    return kernel.transition(dt)


def noise_matrix(kernel, dt):
    """Batched discretised process noise Q(dt) [..., d, d] from the kernel's
    cancellation-free closed form."""
    return kernel.noise_cov(dt)


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

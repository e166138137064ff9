"""Markov (state-space) kernel interface (PyTorch).

Counterpart of `physs_gp_tpu/kernels/markov.py` for single (non-combinator)
Markov kernels: dx = F x dt + L dW, f = H x, x(inf) ~ N(minf, Pinf),
discretised over a gap dt as A(dt) = expm(F dt) and Q(dt). The Sum/Product
combinators are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.matrix import kron, symmetrize

__all__ = ["StateSpace", "MarkovKernel", "to_ss", "transition_matrix",
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

"""Periodic kernel and its truncated-harmonic state space (PyTorch).

Counterpart of `physs_gp_tpu/kernels/periodic.py`. The canonical periodic
kernel

    k(tau) = sigma^2 exp(-2 sin^2(w0 tau / 2) / l^2)

expands as the cosine series sum_j q_j^2 cos(j w0 tau) (Solin & Sarkka
2014), whose state space is J + 1 independent 2-D rotation blocks: a
noiseless system, A_j(dt) a rotation and Q = 0 exactly.

The series weights need modified Bessel functions I_j(1/l^2), evaluated by
the integral I_j(x) = (1/pi) ∫_0^pi e^{x cos t} cos(j t) dt on 64 fixed
trapezoid nodes, as the reference does. exp(x cos t) overflows float32 for
x = 1/l^2 above ~88 (l < ~0.107).
"""
from __future__ import annotations

import math

import torch

from ..ops.matrix import block_diag
from ..utils.params import Param, positive_param
from .base import Kernel
from .markov import MarkovKernel, StateSpace

__all__ = ["Periodic"]


def _bessel_i(orders, x, n_nodes: int = 64):
    """I_j(x) for j in orders by trapezoid quadrature (x a scalar tensor);
    the nodes take x's dtype and device."""
    x = torch.as_tensor(x)
    kw = dict(dtype=x.dtype, device=x.device)
    theta = torch.linspace(0.0, math.pi, n_nodes, **kw)
    w = torch.full((n_nodes,), math.pi / (n_nodes - 1), **kw)
    w[0] *= 0.5
    w[-1] *= 0.5
    integrand = torch.exp(x * torch.cos(theta))  # [n]
    cosjt = torch.cos(torch.as_tensor(orders, **kw)[:, None] * theta[None, :])  # [J, n]
    return (cosjt * integrand * w).sum(-1) / math.pi


class Periodic(Kernel, MarkovKernel):
    """The exact periodic kernel; its Markov interface is the J-harmonic
    approximation (J = `n_harmonics`, state dim 2 (J + 1))."""

    def __init__(self, lengthscales: Param | None = None, variance: Param | None = None,
                 period: Param | None = None, n_harmonics: int = 6, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.lengthscales = lengthscales if lengthscales is not None else positive_param(1.0, **kw)
        self.variance = variance if variance is not None else positive_param(1.0, **kw)
        self.period = period if period is not None else positive_param(1.0, **kw)
        self.n_harmonics = n_harmonics

    # ---- batch (exact) ----
    def k_scalar(self, x1, x2):
        tau = torch.sum(torch.atleast_1d(x1) - torch.atleast_1d(x2))
        s = torch.sin(math.pi * tau / self.period.value) / self.lengthscales.value
        return self.variance.value * torch.exp(-2.0 * s * s)

    # ---- state space (harmonic approximation) ----
    @property
    def is_noiseless(self) -> bool:
        return True

    def _weights(self):
        """q_j^2 for j = 0..J (the cosine-series coefficients)."""
        linv2 = 1.0 / self.lengthscales.value**2
        Ij = _bessel_i(range(self.n_harmonics + 1), linv2)
        # exp(-1/l^2) I_j(1/l^2) formed together, as the reference does
        q2 = 2.0 * self.variance.value * torch.exp(-linv2) * Ij
        return torch.cat([0.5 * q2[:1], q2[1:]])

    def to_ss(self) -> StateSpace:
        J = self.n_harmonics
        w0 = 2.0 * math.pi / self.period.value
        q2 = self._weights()
        kw = dict(dtype=q2.dtype, device=q2.device)
        rot = torch.tensor([[0.0, -1.0], [1.0, 0.0]], **kw)
        F = block_diag(*[rot * (j * w0) for j in range(J + 1)])
        d = 2 * (J + 1)
        return StateSpace(
            F=F,
            L=torch.eye(d, **kw),
            Qc=torch.zeros(d, d, **kw),
            H=torch.tensor([[1.0, 0.0]], **kw).repeat(1, J + 1),
            Pinf=torch.kron(torch.diag(q2), torch.eye(2, **kw)),
            minf=torch.zeros(d, **kw),
        )

    def transition(self, dt):
        """Exact rotations: A_j(dt) = [[cos, -sin], [sin, cos]](j w0 dt)."""
        J = self.n_harmonics
        w0 = 2.0 * math.pi / self.period.value
        dt = torch.as_tensor(dt, device=w0.device)
        dtype = torch.promote_types(dt.dtype, w0.dtype)
        dt = dt.to(dtype)
        ang = dt[..., None] * (torch.arange(J + 1, dtype=dtype, device=dt.device) * w0)
        c, s = torch.cos(ang), torch.sin(ang)
        rot = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)  # [..., J+1, 2, 2]
        return block_diag(*rot.unbind(-3))

    def noise_cov(self, dt):
        """Exactly zero: rotations preserve the stationary covariance."""
        d = 2 * (self.n_harmonics + 1)
        v = self.variance.value
        dt = torch.as_tensor(dt, device=v.device)
        return torch.zeros(dt.shape + (d, d), dtype=torch.promote_types(dt.dtype, v.dtype),
                           device=v.device)

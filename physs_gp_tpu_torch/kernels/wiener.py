"""Wiener-family (non-stationary) Markov kernels (PyTorch).

Counterpart of `physs_gp_tpu/kernels/wiener.py` (`Wiener`,
`WienerVelocity`, `IntegratedWiener`). Non-stationary: there is no P_inf,
so `to_ss().Pinf` holds the initial state covariance P0 (a parameter) and
the discretised noise comes from the exact closed-form integrals, never
from the stationary identity.

    Wiener          x' = w,           A = 1,            Q = q dt
    WienerVelocity  (f, f'): f'' = w, A = [[1, dt], [0, 1]],
                    Q = q [[dt^3/3, dt^2/2], [dt^2/2, dt]]
    IntegratedWiener (any order q): A[i, j] = dt^(j-i) / (j-i)!,
                    Q[i, j] = q_c dt^e / (e (q-i)! (q-j)!), e = 2q + 1 - i - j
"""
from __future__ import annotations

import math

import torch

from ..utils.params import Param, positive_param
from .base import Kernel
from .markov import MarkovKernel, StateSpace

__all__ = ["Wiener", "WienerVelocity", "IntegratedWiener"]


def _times(x1, x2):
    return torch.sum(torch.atleast_1d(x1)), torch.sum(torch.atleast_1d(x2))


class _WienerBase(Kernel, MarkovKernel):
    def __init__(self, variance: Param | None = None, P0: Param | None = None,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.variance = variance if variance is not None else positive_param(1.0, **kw)
        self.P0 = P0 if P0 is not None else positive_param(1e-6, **kw)

    def _dt(self, dt):
        return torch.as_tensor(dt, device=self.variance.raw.device)


class Wiener(_WienerBase):
    """k(t, t') = variance min(t, t') (+ the initial variance P0)."""

    def k_scalar(self, x1, x2):
        t1, t2 = _times(x1, x2)
        return self.variance.value * torch.minimum(t1, t2) + self.P0.value

    def to_ss(self) -> StateSpace:
        q = self.variance.value
        kw = dict(dtype=q.dtype, device=q.device)
        return StateSpace(
            F=torch.zeros(1, 1, **kw), L=torch.ones(1, 1, **kw), Qc=q.reshape(1, 1),
            H=torch.ones(1, 1, **kw), Pinf=self.P0.value.reshape(1, 1), minf=torch.zeros(1, **kw),
        )

    def transition(self, dt):
        dt = self._dt(dt)
        return torch.ones(dt.shape + (1, 1), dtype=dt.dtype, device=dt.device)

    def noise_cov(self, dt):
        return (self.variance.value * self._dt(dt))[..., None, None]


class WienerVelocity(_WienerBase):
    """The integrated Wiener (constant-velocity) process; state (f, f')."""

    def k_scalar(self, x1, x2):
        t1, t2 = _times(x1, x2)
        tmin = torch.minimum(t1, t2)
        return (self.variance.value * (tmin**3 / 3.0 + torch.abs(t1 - t2) * tmin**2 / 2.0)
                + self.P0.value)

    def to_ss(self) -> StateSpace:
        q = self.variance.value
        kw = dict(dtype=q.dtype, device=q.device)
        return StateSpace(
            F=torch.tensor([[0.0, 1.0], [0.0, 0.0]], **kw),
            L=torch.tensor([[0.0], [1.0]], **kw),
            Qc=q.reshape(1, 1),
            H=torch.tensor([[1.0, 0.0]], **kw),
            Pinf=self.P0.value * torch.eye(2, **kw),
            minf=torch.zeros(2, **kw),
        )

    def transition(self, dt):
        dt = self._dt(dt)
        one, zero = torch.ones_like(dt), torch.zeros_like(dt)
        return torch.stack([torch.stack([one, dt], -1), torch.stack([zero, one], -1)], -2)

    def noise_cov(self, dt):
        dt = self._dt(dt)
        Q = torch.stack([torch.stack([dt**3 / 3.0, dt**2 / 2.0], -1),
                         torch.stack([dt**2 / 2.0, dt], -1)], -2)
        return self.variance.value * Q


class IntegratedWiener(_WienerBase):
    """The q-times integrated Wiener process; state (f, f', ..., f^(q)).
    The exact discretisation for any order from the closed forms of the LTI
    SDE x^(q+1) = w(t), and the prior covariance of the observed head from
    k(s, t) = q_c ∫_0^min(s,t) (s-u)^q (t-u)^q du / (q!)^2 expanded termwise.
    q = 0 is `Wiener`, q = 1 `WienerVelocity`."""

    def __init__(self, variance: Param | None = None, P0: Param | None = None, q: int = 2,
                 dtype=None, device=None):
        super().__init__(variance, P0, dtype=dtype, device=device)
        self.q = q

    def k_scalar(self, x1, x2):
        t1, t2 = _times(x1, x2)
        m = torch.minimum(t1, t2)
        q = self.q
        acc = 0.0
        # ∫_0^m (t1-u)^q (t2-u)^q du =
        #   Σ_{i,j} C(q,i) C(q,j) (-1)^{i+j} t1^{q-i} t2^{q-j} m^{i+j+1}/(i+j+1)
        for i in range(q + 1):
            for j in range(q + 1):
                c = math.comb(q, i) * math.comb(q, j) * (-1.0) ** (i + j) / (i + j + 1)
                acc = acc + c * t1 ** (q - i) * t2 ** (q - j) * m ** (i + j + 1)
        return self.variance.value * acc / (math.factorial(q) ** 2) + self.P0.value

    def to_ss(self) -> StateSpace:
        qc = self.variance.value
        kw = dict(dtype=qc.dtype, device=qc.device)
        d = self.q + 1
        L = torch.zeros(d, 1, **kw)
        L[-1, 0] = 1.0
        H = torch.zeros(1, d, **kw)
        H[0, 0] = 1.0
        return StateSpace(
            F=torch.diag(torch.ones(d - 1, **kw), 1), L=L, Qc=qc.reshape(1, 1), H=H,
            Pinf=self.P0.value * torch.eye(d, **kw), minf=torch.zeros(d, **kw),
        )

    def transition(self, dt):
        dt = self._dt(dt)
        d = self.q + 1
        rows = [torch.stack([torch.zeros_like(dt) if j < i else dt ** (j - i) / math.factorial(j - i)
                             for j in range(d)], -1) for i in range(d)]
        return torch.stack(rows, -2)

    def noise_cov(self, dt):
        dt = self._dt(dt)
        q, d = self.q, self.q + 1
        rows = []
        for i in range(d):
            cols = []
            for j in range(d):
                e = 2 * q + 1 - i - j
                cols.append(dt**e / (e * math.factorial(q - i) * math.factorial(q - j)))
            rows.append(torch.stack(cols, -1))
        return self.variance.value * torch.stack(rows, -2)

"""Matérn half-integer kernels with exact closed-form state space (PyTorch).

Counterpart of `physs_gp_tpu/kernels/matern.py` (Matern12, 32, 52 and 72).
One implementation covers order p (nu = p + 1/2, state dim d = p + 1) in the
balanced basis x_k = f^(k) / lam^k:

- F = lam (unit superdiagonal - binomial last row); N = F + lam I is
  nilpotent, so A(dt) = exp(-lam dt) sum_{k<d} N^k dt^k / k! exactly;
- Q(dt) is the exact noise integral, evaluated termwise with the regularised
  incomplete gamma function (positive by construction for every dt);
- Pinf solves the d x d Lyapunov equation;
- `k_deriv_fn` gives the derivative covariances in closed form, exact at
  coincident points where autodiff of the |τ| chain is not.
"""
from __future__ import annotations

import math

import torch

from .base import StationaryKernel
from .markov import MarkovKernel, StateSpace, solve_pinf
from ..utils.params import Param, positive_param

__all__ = ["Matern", "Matern12", "Matern32", "Matern52", "Matern72"]


def _matern_corr(p: int, r):
    """Unit-variance Matérn correlation, r = |x1 - x2| / ls, nu = p + 1/2."""
    sr = math.sqrt(2 * p + 1) * r
    if p == 0:
        poly = 1.0
    elif p == 1:
        poly = 1.0 + sr
    elif p == 2:
        poly = 1.0 + sr + sr**2 / 3.0
    elif p == 3:
        poly = 1.0 + sr + 2.0 * sr**2 / 5.0 + sr**3 / 15.0
    else:
        # p! / (2p)! sum_{i <= p} (p + i)! / (i! (p - i)!) (2 sr)^(p - i)
        poly = sum(
            (math.factorial(p) / math.factorial(2 * p))
            * (math.factorial(p + i) / (math.factorial(i) * math.factorial(p - i)))
            * (2.0 * sr) ** (p - i)
            for i in range(p + 1)
        )
    return poly * torch.exp(-sr)


class Matern(StationaryKernel, MarkovKernel):
    """Matérn kernel of half-integer order nu = p + 1/2 (state dim p + 1)."""

    def __init__(self, lengthscales: Param, variance: Param, p: int = 1):
        super().__init__()
        self.lengthscales = lengthscales
        self.variance = variance
        self.p = p

    def k_from_sqdist(self, d2):
        r = torch.sqrt(torch.clamp(d2, min=1e-36))
        return _matern_corr(self.p, r)

    @property
    def _lam(self):
        # temporal kernels are 1-D: the first (only) lengthscale
        ls = torch.atleast_1d(self.lengthscales.value).reshape(-1)[0]
        return math.sqrt(2 * self.p + 1) / ls

    def to_ss(self) -> StateSpace:
        """State space in the balanced basis: F = lam (S - B)."""
        d = self.p + 1
        lam = self._lam
        var = self.variance.value
        kw = dict(dtype=var.dtype, device=var.device)
        S = torch.diag(torch.ones(d - 1, **kw), 1) if d > 1 else torch.zeros(1, 1, **kw)
        coeffs = torch.tensor([math.comb(d, k) for k in range(d)], **kw)
        S = S.clone()
        S[-1, :] = -coeffs
        F = lam * S
        L = torch.zeros(d, 1, **kw)
        L[-1, 0] = 1.0
        qc = var * 2.0 * math.sqrt(math.pi) * (math.gamma(d) / math.gamma(d - 0.5)) * lam
        Qc = qc.reshape(1, 1)
        H = torch.zeros(1, d, **kw)
        H[0, 0] = 1.0
        Pinf = solve_pinf(F, L, Qc)
        return StateSpace(F=F, L=L, Qc=Qc, H=H, Pinf=Pinf, minf=torch.zeros(d, **kw))

    def k_deriv_fn(self, a: tuple, b: tuple):
        """Exact ∂^a_{x1} ∂^b_{x2} k in closed form. For τ > 0 write
        k(τ) = σ² e^{-λτ} Q₀(λτ); then
            k⁽ʲ⁾(τ) = σ² λʲ e^{-λτ} Q_j(λτ),   Q_{j+1} = Q_j′ − Q_j,
        extended to τ ≤ 0 by evenness (odd j takes sign(τ), which is 0 at
        τ = 0, where odd derivatives of an even function vanish), and
        ∂^m_{x1} ∂^n_{x2} k(x1 − x2) = (−1)ⁿ k⁽ᵐ⁺ⁿ⁾(τ). Orders up to p (the
        derivatives the Markov state carries); inputs must be 1-D."""
        if not (a or b):
            return None  # the value block: k_scalar is exact for any input dim
        if any(i != 0 for i in (*a, *b)):
            raise ValueError("Matern is 1-D (temporal); derivative dims must be 0")
        m, n = len(a), len(b)
        if max(m, n) > self.p:
            raise ValueError(
                f"Matern nu={self.p}+1/2 supports derivative orders <= {self.p}; "
                f"got orders ({m}, {n})"
            )
        p, j = self.p, m + n
        # Q_0 in ascending powers of u = lam |tau| (unit variance; the
        # polynomial of _matern_corr)
        c = [0.0] * (p + 1)
        for i in range(p + 1):
            c[p - i] = (
                (math.factorial(p) / math.factorial(2 * p))
                * (math.factorial(p + i) / (math.factorial(i) * math.factorial(p - i)))
                * 2.0 ** (p - i)
            )
        for _ in range(j):  # Q <- Q' - Q (the degree stays <= p)
            c = [((k + 1) * c[k + 1] if k < p else 0.0) - c[k] for k in range(p + 1)]
        sgn = (-1.0) ** n
        odd = j % 2 == 1

        def fn(x1, x2):
            lam = self._lam
            x1 = torch.atleast_1d(x1).reshape(-1)
            x2 = torch.atleast_1d(x2).reshape(-1)
            if x1.shape[0] != 1 or x2.shape[0] != 1:
                raise ValueError(
                    f"Matern.k_deriv_fn is 1-D (temporal) but got inputs of "
                    f"dim {x1.shape[0]}; route the Matern factor through "
                    f"OnDims(matern, (t_dim,)) inside a ProductKernel"
                )
            tau = x1[0] - x2[0]
            u = lam * torch.abs(tau)
            poly = c[p]
            for k in range(p - 1, -1, -1):  # Horner
                poly = poly * u + c[k]
            val = sgn * self.variance.value * lam**j * torch.exp(-u) * poly
            return val * torch.sign(tau) if odd else val

        return fn

    def _nilpotent(self, dtype):
        d = self.p + 1
        ss = self.to_ss()
        lam = self._lam.to(dtype)
        return ss, lam, ss.F.to(dtype) + lam * torch.eye(d, dtype=dtype, device=lam.device)

    def transition(self, dt):
        """Exact A(dt) by the terminating nilpotent expansion; batched over dt."""
        d = self.p + 1
        _, lam, N = self._nilpotent(dt.dtype)
        powers = [torch.eye(d, dtype=dt.dtype, device=dt.device)]
        for _ in range(d - 1):
            powers.append(powers[-1] @ N)
        powers = torch.stack([powers[k] / math.factorial(k) for k in range(d)])
        dtk = dt[..., None] ** torch.arange(d, dtype=dt.dtype, device=dt.device)
        poly = torch.einsum("...k,kij->...ij", dtk, powers)
        return torch.exp(-lam * dt)[..., None, None] * poly

    def noise_cov(self, dt):
        """Cancellation-free Q(dt) = int_0^dt e^{Fs} L Qc L^T e^{F^T s} ds:
            Q = Qc sum_{k,l} v_k v_l^T / (k! l!) I_{k+l}(dt),  v_k = N^k L,
            I_m(dt) = m! / (2 lam)^{m+1} gammainc(m + 1, 2 lam dt)."""
        d = self.p + 1
        ss, lam, N = self._nilpotent(dt.dtype)
        v = [ss.L[:, 0].to(dt.dtype)]
        for _ in range(d - 1):
            v.append(N @ v[-1])
        C = torch.stack([
            sum(
                torch.outer(v[k], v[m - k]) / (math.factorial(k) * math.factorial(m - k))
                for k in range(max(0, m - d + 1), min(m, d - 1) + 1)
            )
            for m in range(2 * d - 1)
        ])  # [2d-1, d, d]
        kw = dict(dtype=dt.dtype, device=dt.device)
        m_arr = torch.arange(2 * d - 1, **kw)
        fact = torch.tensor([math.factorial(m) for m in range(2 * d - 1)], **kw)
        x = 2.0 * lam * dt[..., None]
        # dt == 0 (the first step of every grid) gives exactly zero noise
        x_is0 = x <= 0.0
        x_safe = torch.where(x_is0, torch.ones_like(x), x)
        Im = fact * (2.0 * lam) ** -(m_arr + 1.0) * torch.special.gammainc(
            m_arr + 1.0, x_safe
        )
        Im = torch.where(x_is0, torch.zeros_like(Im), Im)
        qc = ss.Qc[0, 0].to(dt.dtype)
        return qc * torch.einsum("...m,mij->...ij", Im, C)


def _matern(p, lengthscale, variance, dtype, device) -> Matern:
    """Matérn of order p; plain values are wrapped as positive Params."""
    def wrap(v):
        return v if isinstance(v, Param) else positive_param(v, dtype=dtype, device=device)

    return Matern(lengthscales=wrap(lengthscale), variance=wrap(variance), p=p)


def Matern12(lengthscale=1.0, variance=1.0, dtype=None, device=None) -> Matern:
    """Matérn-1/2 (the exponential kernel), state dim 1."""
    return _matern(0, lengthscale, variance, dtype, device)


def Matern32(lengthscale=1.0, variance=1.0, dtype=None, device=None) -> Matern:
    """Matérn-3/2, state dim 2."""
    return _matern(1, lengthscale, variance, dtype, device)


def Matern52(lengthscale=1.0, variance=1.0, dtype=None, device=None) -> Matern:
    """Matérn-5/2, state dim 3."""
    return _matern(2, lengthscale, variance, dtype, device)


def Matern72(lengthscale=1.0, variance=1.0, dtype=None, device=None) -> Matern:
    """Matérn-7/2, state dim 4."""
    return _matern(3, lengthscale, variance, dtype, device)

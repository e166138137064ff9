"""Dynamic covariance (multivariate volatility) likelihood (PyTorch
counterpart of `physs_gp_tpu/likelihoods/dynamic_covariance.py`).

The Q = P(P−1)/2 latent processes are heads of a `StackedMarkov` CVI model;
tanh of them gives the partial correlations z, `correlation_cholesky(z)` a
correlation Cholesky L, and y_t ~ N(0, D L Lᵀ D) with D = diag(√variances).
The ELL is a reparameterised Monte-Carlo average through the joint block
posterior q(f_t) = N(m_t, S_t), so latent correlations enter it.

The Monte-Carlo noise comes in two independent sets, as in the reference
(its PRNG key for the ELL, the key folded with 1 for the natural-gradient
moments): `draws(m, generator)` returns the pair (eps_ell, eps_ng), each
[n_mc, T, Q], drawn one after the other from `generator` (a
`torch.Generator` on the model's device; None: a fresh generator seeded
with `seed`, the same pair on every call). `CVIGP` hands the pair to both
`expected_log_lik_blocks` and `natgrad_moments`, which take their own half;
`draws=` feeds the JAX package's two sets in.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.matrix import robust_cholesky, solve_lower
from ..ops.sampling import standard_normal
from .gaussian import Likelihood

__all__ = ["correlation_cholesky", "DynamicCovarianceGaussian"]

_LOG2PI = math.log(2.0 * math.pi)


def correlation_cholesky(z, P: int):
    """z [..., Q] in (−1, 1) -> L [..., P, P], the Cholesky factor of a
    correlation matrix, by the canonical partial-correlation construction:

        L[i, 0] = z_i0,  L[i, j] = z_ij √(1 − Σ_{k<j} L[i,k]²),
        L[i, i] = √(1 − Σ_{k<i} L[i,k]²),

    with z in `np.tril_indices(P, -1)`'s row-major order. Built from lists
    and `torch.stack` (no in-place writes), so autograd and `torch.func`
    pass through it."""
    batch = z.shape[:-1]
    rows, cols = np.tril_indices(P, -1)
    entry = {(int(i), int(j)): z[..., k] for k, (i, j) in enumerate(zip(rows, cols))}
    one = torch.ones(batch, dtype=z.dtype, device=z.device)
    zero = torch.zeros(batch, dtype=z.dtype, device=z.device)
    L = [[one] + [zero] * (P - 1)]
    for i in range(1, P):
        rem = one  # 1 - sum_k L[i, k]^2 so far
        row = []
        for j in range(i):
            lij = entry[i, j] * torch.sqrt(torch.clamp(rem, min=1e-30))
            row.append(lij)
            rem = rem - lij * lij
        row.append(torch.sqrt(torch.clamp(rem, min=1e-30)))
        L.append(row + [zero] * (P - 1 - i))
    return torch.stack([torch.stack(r, -1) for r in L], -2)


class DynamicCovarianceGaussian(Likelihood):
    """y_t ~ N(0, Σ_t), Σ_t = D L(z_t) L(z_t)ᵀ D, z_t = tanh(f_t) of the Q
    latent heads; D = diag(√variances), static but trainable. The data live
    here (`y` [T, P], NaN rows skipped): the model's Y is the all-NaN head
    placeholder and `site_active_mask` keeps every site live."""

    def __init__(self, y, variances, n_mc: int = 32, seed: int = 0):
        super().__init__()
        self.register_buffer("y", y)
        self.variances = nn.ModuleList(variances)
        self.n_mc = n_mc
        self.seed = seed

    @property
    def P(self) -> int:
        return len(self.variances)

    def site_active_mask(self, Y):
        return torch.ones_like(Y, dtype=torch.bool)

    def R(self, T: int, p: int = 1):
        """Identity placeholder for the surrogate sites' noise: the filter
        only ever sees the sites (Ỹ, Ṽ)."""
        return torch.eye(p, dtype=self.y.dtype, device=self.y.device).expand(T, p, p)

    def draws(self, m, generator=None):
        """The pair (eps_ell, eps_ng) of [n_mc, *m.shape] standard normals."""
        if generator is None:
            generator = torch.Generator(device=m.device).manual_seed(self.seed)
        shape = (self.n_mc,) + tuple(m.shape)
        return standard_normal(generator, shape, m), standard_normal(generator, shape, m)

    def _logp(self, y, z):
        """log N(y | 0, D L Lᵀ D) batched: y [..., P], z [..., Q] -> [...]."""
        d = torch.sqrt(torch.stack([v.value for v in self.variances]))
        chol = d[:, None] * correlation_cholesky(z, self.P)
        alpha = solve_lower(chol, y.expand(chol.shape[:-1])[..., None])[..., 0]
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), -1)
        return -0.5 * (torch.sum(alpha * alpha, -1) + logdet + self.P * _LOG2PI)

    def _samples(self, m, S, eps):
        return m[None] + torch.einsum("tij,ntj->nti", robust_cholesky(S), eps)

    def expected_log_lik_blocks(self, Y_unused, m, S, generator=None, draws=None):
        """Monte-Carlo ELL through q(f_t) = N(m_t, S_t), m [T, Q], S [T, Q, Q],
        on the first set of draws."""
        eps = (self.draws(m, generator) if draws is None else draws)[0]
        ll = self._logp(torch.nan_to_num(self.y), torch.tanh(self._samples(m, S, eps)))  # [n, T]
        ok = torch.all(torch.isfinite(self.y), -1)
        return torch.sum(torch.where(ok, torch.mean(ll, 0), 0.0))

    def natgrad_moments(self, Y_unused, m, S, residual_hessian: str = "gauss_newton",
                        generator=None, draws=None):
        """(g1, g2) for the CVI site update with an empirical-Fisher Hessian,
        on the second set of draws: g1 = E[s], g2 = −½ E[s sᵀ], s the score
        ∇_f log p(y_t | tanh f). The exact Monte-Carlo Hessian goes
        indefinite within a few steps; −E[s sᵀ] is negative semidefinite by
        construction. Each term depends on its own f only, so the score of
        all [n_mc, T] samples is one autograd call on their sum."""
        eps = (self.draws(m, generator) if draws is None else draws)[1]
        f = self._samples(m, S, eps)  # [n, T, Q]
        y0 = torch.nan_to_num(self.y)
        with torch.enable_grad():
            f_ = f.detach().requires_grad_(True)
            (score,) = torch.autograd.grad(torch.sum(self._logp(y0, torch.tanh(f_))), f_)
        ok = torch.all(torch.isfinite(self.y), -1)
        g1 = torch.where(ok[:, None], torch.mean(score, 0), 0.0)
        g2 = -0.5 * torch.mean(score[..., :, None] * score[..., None, :], 0)
        return g1, torch.where(ok[:, None, None], g2, 0.0)

    def log_prob(self, y, f):
        return self._logp(y, torch.tanh(f))

    def conditional_mean(self, f):
        return torch.zeros_like(f[..., :1])

    def conditional_variance(self, f):
        v = torch.stack([p.value for p in self.variances])
        return v[..., :1].expand(f[..., :1].shape)

    def correlation_path(self, m):
        """Correlation matrices [T, P, P] at the head means m [T, Q]."""
        L = correlation_cholesky(torch.tanh(m), self.P)
        return torch.einsum("tij,tkj->tik", L, L)

"""Composite (multi-head) likelihoods for physics-informed models (PyTorch
counterpart of `physs_gp_tpu/likelihoods/composite.py`).

Column h of Y is observed through its own elementwise likelihood (e.g.
[Gaussian(data), Gaussian(collocation)] for PDEs, [Gaussian, Probit] for
monotonicity constraints). `NonlinearResidual` adds a nonlinear PDE residual
term, evaluated by reparameterised Monte Carlo through the joint block
posterior q(f_t) = N(m_t, S_t).

The Monte-Carlo noise is n_mc standard-normal draws [n_mc, T, p]. Every
method that needs it takes either a `torch.Generator` on the model's device
(`generator=`, where the reference takes a PRNG key) or the draws themselves
(`draws=`); with neither, the draws come from a fresh generator seeded with
`NonlinearResidual.seed`, so they are the same on every call (the
reference's frozen-key semantics).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from ..ops.matrix import robust_cholesky
from ..ops.quadrature import expect_gh, expect_gh_log
from ..ops.sampling import standard_normal
from ..utils.params import Param, positive_param
from .gaussian import Likelihood
from .nongaussian import expected_log_lik, predictive_moments

__all__ = ["CompositeLikelihood", "NonlinearResidual"]

_LOG2PI = math.log(2.0 * math.pi)


class NonlinearResidual(nn.Module):
    """Pseudo-observation 0 = g(f_heads) + eps, eps ~ N(0, noise_var).

    `fn` maps the head vector [..., p] to a scalar residual [...] (one per
    time step: ODEs) or a vector [..., C] (one per collocation point: PDEs
    such as Allen-Cahn); it is written with torch operations, so that
    `torch.func` can differentiate it. The expectation runs over n_mc
    reparameterised samples of the full block q(f_t), so head correlations
    enter it.
    """

    def __init__(self, noise_var: Param | None = None, fn: Callable | None = None,
                 n_mc: int = 32, seed: int = 0):
        super().__init__()
        self.noise_var = positive_param(1e-3) if noise_var is None else noise_var
        self.fn = fn
        self.n_mc = n_mc
        self.seed = seed

    def draws(self, m, generator=None):
        """The [n_mc, T, p] standard-normal draws for block means m [T, p]:
        from `generator`, or from a fresh generator seeded with `seed`."""
        if generator is None:
            generator = torch.Generator(device=m.device).manual_seed(self.seed)
        return standard_normal(generator, (self.n_mc,) + tuple(m.shape), m)

    def _samples(self, m, S, generator=None, draws=None):
        # escalating-jitter factor: S = H P Hᵀ over nearly dependent heads is
        # indefinite at the float32 error scale
        L = robust_cholesky(S)
        eps = self.draws(m, generator) if draws is None else draws
        return m[None] + torch.einsum("tij,ntj->nti", L, eps)

    def ell(self, mask, m, S, generator=None, draws=None):
        """Residual ELL summed over the rows where mask [T] > 0; m [T, p],
        S [T, p, p]."""
        r = self.fn(self._samples(m, S, generator, draws))  # [n, T] or [n, T, C]
        nv = self.noise_var.value
        ll = torch.mean(-0.5 * (_LOG2PI + torch.log(nv) + r * r / nv), 0)
        if ll.dim() == 2:
            ll = torch.sum(ll, -1)
        return torch.sum(torch.where(mask > 0, ll, 0.0))

    def gauss_newton_grads(self, mask, m, S, generator=None, draws=None):
        """(g1, g2) of the residual ELL with the Gauss-Newton Hessian:

            g1 = -E[r(f) J(f)] / sigma^2,   g2 = -0.5 E[J(f) J(f)ᵀ] / sigma^2,

        the exact Monte-Carlo gradient and the Hessian without its r dJ
        term, negative semidefinite by construction, so the site precision
        stays PSD where the exact Monte-Carlo Hessian goes indefinite."""
        f = self._samples(m, S, generator, draws)  # [n, T, p]
        r = self.fn(f)
        nv = self.noise_var.value
        vmap = torch.func.vmap
        if r.dim() == 3:
            # vector residual: J [n, T, C, p]; the GN terms sum over C
            J = vmap(vmap(torch.func.jacfwd(self.fn)))(f)
            g1 = -torch.mean(torch.einsum("ntc,ntcp->ntp", r, J), 0) / nv
            g2 = -0.5 * torch.mean(torch.einsum("ntcp,ntcq->ntpq", J, J), 0) / nv
        else:
            J = vmap(vmap(torch.func.grad(self.fn)))(f)  # [n, T, p]
            g1 = -torch.mean(r[..., None] * J, 0) / nv
            g2 = -0.5 * torch.mean(J[..., :, None] * J[..., None, :], 0) / nv
        g1 = torch.where(mask[:, None] > 0, g1, 0.0)
        g2 = torch.where(mask[:, None, None] > 0, g2, 0.0)
        return g1, g2


class CompositeLikelihood(Likelihood):
    """Per-column elementwise likelihoods (`heads`) and an optional nonlinear
    `residual`, enforced on the rows where `residual_mask` [T] > 0 (every
    row when it is None)."""

    def __init__(self, heads, residual: NonlinearResidual | None = None, residual_mask=None):
        super().__init__()
        self.heads = nn.ModuleList(heads)
        self.residual = residual
        self.register_buffer(
            "residual_mask", None if residual_mask is None else torch.as_tensor(residual_mask)
        )

    def _mask(self, m):
        if self.residual_mask is None:
            return torch.ones(m.shape[0], dtype=m.dtype, device=m.device)
        return self.residual_mask

    def site_active_mask(self, Y):
        """[T, p] site elements that can carry information: the finite data,
        and with a residual every head on the residual's rows (the residual
        couples all heads, so all of them need live sites there)."""
        act = torch.isfinite(Y)
        if self.residual is not None:
            rows = (torch.ones(Y.shape[0], dtype=torch.bool, device=Y.device)
                    if self.residual_mask is None else self.residual_mask > 0)
            act = act | rows[:, None]
        return act

    def _heads_ell(self, Y, m, S):
        v = torch.diagonal(S, dim1=-2, dim2=-1)
        total = 0.0
        for h, lik in enumerate(self.heads):
            total = total + torch.sum(expected_log_lik(lik, Y[:, h], m[:, h], v[:, h]))
        return total

    def expected_log_lik_blocks(self, Y, m, S, generator=None, draws=None):
        """Total ELL given the block moments m [T, p], S [T, p, p]."""
        total = self._heads_ell(Y, m, S)
        if self.residual is not None:
            total = total + self.residual.ell(self._mask(m), m, S, generator, draws)
        return total

    def natgrad_moments(self, Y, m, S, residual_hessian: str = "exact", generator=None,
                        draws=None):
        """(g1, g2) = d ELL / d(m, S) for the CVI site update.
        residual_hessian="gauss_newton" takes the residual term's PSD-safe
        Gauss-Newton form (the heads stay exact)."""
        if self.residual is not None and draws is None:
            draws = self.residual.draws(m, generator)
        exact = residual_hessian == "exact" or self.residual is None
        with torch.enable_grad():
            m_ = m.detach().requires_grad_(True)
            S_ = S.detach().requires_grad_(True)
            ell = (self.expected_log_lik_blocks(Y, m_, S_, draws=draws) if exact
                   else self._heads_ell(Y, m_, S_))
            g1, g2 = torch.autograd.grad(ell, (m_, S_))
        if exact:
            return g1, g2
        r1, r2 = self.residual.gauss_newton_grads(self._mask(m), m, S, draws=draws)
        return g1 + r1, g2 + r2

    def predict_y_moments(self, f_mean, f_var, gh_points: int = 20):
        """Per-head moment-matched predictive p(y*): (mean, var), each
        [T, p], column h through head h's conditional moments by
        Gauss-Hermite quadrature; the residual, a training device, is left
        out."""
        cols = [predictive_moments(lik, f_mean[..., h], f_var[..., h], gh_points)
                for h, lik in enumerate(self.heads)]
        return torch.stack([c[0] for c in cols], -1), torch.stack([c[1] for c in cols], -1)

    def predictive_density(self, y, f_mean, f_var, gh_points: int = 20):
        """Elementwise p(y*_th) = ∫ p(y | f) q(f) df per head; [T, p]."""
        cols = []
        for h, lik in enumerate(self.heads):
            y0 = torch.nan_to_num(y[..., h])  # quadrature-safe; the caller masks
            cols.append(expect_gh(
                lambda ff, lik=lik, y0=y0: torch.exp(lik.log_prob(y0[..., None], ff)),
                f_mean[..., h], f_var[..., h], gh_points,
            ))
        return torch.stack(cols, -1)

    def predictive_log_density(self, y, f_mean, f_var, gh_points: int = 20):
        """Elementwise log p(y*_th) per head by log-domain Gauss-Hermite
        quadrature (float32-safe where exp(log_prob) underflows)."""
        cols = []
        for h, lik in enumerate(self.heads):
            y0 = torch.nan_to_num(y[..., h])
            cols.append(expect_gh_log(
                lambda ff, lik=lik, y0=y0: lik.log_prob(y0[..., None], ff),
                f_mean[..., h], f_var[..., h], gh_points,
            ))
        return torch.stack(cols, -1)

    def log_prob(self, y, f):
        """Columnwise log-prob of the heads (the residual is left out)."""
        if y.dim() > 2:
            outs = [lik.log_prob(y[..., h, :], f[..., h, :]) for h, lik in enumerate(self.heads)]
        else:
            outs = [lik.log_prob(y[..., h], f[..., h]) for h, lik in enumerate(self.heads)]
        return torch.stack(outs, -1)

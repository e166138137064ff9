"""Gaussian Process Regression Network (GPRN): nonlinear multi-output mixing
(PyTorch counterpart of `physs_gp_tpu/models/gprn.py`).

Outputs y_p(x) = sum_l W_pl(x) g_l(x) + eps, where the mixing weights W_pl
and the latent functions g_l are GPs. Inference is mean-field whitened
sparse VI over the stacked latents with a reparameterised Monte-Carlo
expected log-likelihood. Each group's inducing Gram is factored by
`svgp._chol_gram` (the hand-written Cholesky kernel on the card for
M <= 80, its block route above 32).

Mixings (`mixing=`):
- "plain":    y = W g, W the P*L weight GPs;
- "softplus": y = softplus(W) g, positive mixing weights;
- "ldl":      W unit-lower-triangular, strict-lower entries are GPs;
- "drd":      W = diag(scales) corr-chol(2 Phi(W_gp) - 1), a varying
              correlation with trainable static scales (L == P).

The Monte-Carlo noise: `elbo` / `get_objective` take a `torch.Generator` on
the model's device (`generator=`, where the reference takes a PRNG key) or
the [n_mc, L_tot, N] standard-normal draws themselves (`draws=`); with
neither, the draws come from a fresh generator seeded with `seed`, the same
on every call (the reference's frozen noise). `predict_f` does the same
with a generator seeded with `seed + 1` (the reference folds 1 into its
key there).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..likelihoods.dynamic_covariance import correlation_cholesky
from ..ops.gaussian import gaussian_kl
from ..ops.matrix import solve_lower
from ..ops.sampling import standard_normal
from ..utils.params import fill_triangular, param, positive_param, tril_param
from ..utils.shapes import as_points
from .ssgp import GaussianMoments
from .svgp import _chol_gram

__all__ = ["GPRN"]

_LOG2PI = math.log(2.0 * math.pi)


class GPRN(nn.Module):
    """Latent order: [W_11..W_1L, ..., W_P1..W_PL, g_1..g_L] (n_w + L latents)."""

    def __init__(self, X, Y, Z, kernel_w, kernel_g, noise, q_mu, q_sqrt, drd_scales=None,
                 seed: int = 0, n_latent: int = 1, n_mc: int = 16, mixing: str = "plain"):
        super().__init__()
        self.register_buffer("X", X)  # [N, D]
        self.register_buffer("Y", Y)  # [N, P], NaN = missing
        self.register_buffer("Z", Z)  # [M, D]
        self.kernel_w = kernel_w
        self.kernel_g = kernel_g
        self.noise = noise
        self.q_mu = q_mu  # [L_tot, M]
        self.q_sqrt = q_sqrt  # [L_tot, M(M+1)/2]
        self.drd_scales = drd_scales  # [P] positive Param (mixing="drd" only)
        self.seed = seed
        self.n_latent = n_latent
        self.n_mc = n_mc
        self.mixing = mixing

    @staticmethod
    def _n_w(mixing: str, P: int, L: int) -> int:
        """Number of mixing-weight latent GPs of each parameterisation."""
        if mixing in ("plain", "softplus"):
            return P * L
        if mixing == "ldl":
            return len(np.tril_indices(P, -1, L)[0])
        if mixing == "drd":
            if L != P:
                raise ValueError(f"mixing='drd' needs n_latent == n_outputs (got {L} vs {P})")
            return P * (P - 1) // 2
        raise ValueError(f"unknown GPRN mixing {mixing!r}")

    @classmethod
    def init(cls, X, Y, Z, kernel_w, kernel_g, n_latent: int = 1, noise: float = 0.1,
             n_mc: int = 16, seed: int = 0, mixing: str = "plain", dtype=None,
             device="cuda") -> "GPRN":
        """q(v) = N(mu0, 0.09 I) per latent; the data and q on `device`, the
        card unless the caller asks for the CPU."""
        X = as_points(X, dtype=dtype, device=device)
        like = dict(dtype=X.dtype, device=X.device)
        Y, Z = as_points(Y, **like), as_points(Z, **like)
        P = Y.shape[1]
        n_w = cls._n_w(mixing, P, n_latent)
        L_tot = n_w + n_latent
        M = Z.shape[0]
        tril0 = tril_param(0.3 * torch.eye(M, **like)).raw.detach()
        q_mu0 = torch.zeros((L_tot, M), **like)
        if mixing in ("plain", "softplus"):
            q_mu0[:n_w] = 1.0  # break the W g = 0 saddle: weight latents start near 1
        # ldl / drd have a unit diagonal built in: zeros give W = I
        return cls(X, Y, Z, kernel_w, kernel_g, noise=positive_param(noise, **like),
                   q_mu=param(q_mu0), q_sqrt=param(tril0[None].repeat(L_tot, 1)),
                   drd_scales=positive_param(torch.ones(P, **like)) if mixing == "drd" else None,
                   seed=seed, n_latent=n_latent, n_mc=n_mc, mixing=mixing)

    def _mix(self, f, Ns):
        """f [S, L_tot, Ns] latent samples -> mixed outputs y_hat [S, Ns, P]."""
        P = self.Y.shape[1]
        L = self.n_latent
        S = f.shape[0]
        n_w = self._n_w(self.mixing, P, L)
        fW, g = f[:, :n_w], f[:, n_w:]  # [S, n_w, Ns], [S, L, Ns]
        if self.mixing in ("plain", "softplus"):
            W = fW.reshape(S, P, L, Ns)
            if self.mixing == "softplus":
                W = torch.nn.functional.softplus(W)
            return torch.einsum("spln,sln->snp", W, g)
        if self.mixing == "ldl":
            rows, cols = np.tril_indices(P, -1, L)
            W = torch.eye(P, L, dtype=f.dtype, device=f.device).expand(S, Ns, P, L).clone()
            W[:, :, rows, cols] = torch.movedim(fW, 1, -1)
            return torch.einsum("snpl,sln->snp", W, g)
        # drd: correlation Cholesky of squashed weight GPs, static scales
        z = 2.0 * torch.special.ndtr(torch.movedim(fW, 1, -1)) - 1.0
        W = self.drd_scales.value[:, None] * correlation_cholesky(z, P)  # [S, Ns, P, P]
        return torch.einsum("snpl,sln->snp", W, g)

    def _marginals(self, Xs):
        """Whitened per-latent marginals at Xs: mean, var [L_tot, Ns]."""
        M = self.Z.shape[0]
        n_w = self._n_w(self.mixing, self.Y.shape[1], self.n_latent)
        means, variances = [], []
        for kern, sl in ((self.kernel_w, slice(0, n_w)),
                         (self.kernel_g, slice(n_w, n_w + self.n_latent))):
            Lz = _chol_gram(kern.K(self.Z, self.Z))
            A = solve_lower(Lz, kern.K(self.Z, Xs))  # [M, Ns]
            Lq = fill_triangular(self.q_sqrt.value[sl], M)  # [n_lat, M, M]
            SA = torch.einsum("lmk,mn->lkn", Lq, A)  # [n_lat, M, Ns]
            var = kern.K_diag(Xs)[None] - torch.sum(A * A, 0)[None] + torch.sum(SA * SA, 1)
            means.append(self.q_mu.value[sl] @ A)
            variances.append(torch.clamp(var, min=1e-12))
        return torch.cat(means, 0), torch.cat(variances, 0)

    def _kl(self):
        M = self.Z.shape[0]
        qm = self.q_mu.value
        Lq = fill_triangular(self.q_sqrt.value, M)  # [L_tot, M, M]
        eye = torch.eye(M, dtype=qm.dtype, device=qm.device)
        return torch.sum(gaussian_kl(qm, Lq, torch.zeros_like(qm[0]), eye))

    def _draws(self, shape, like, generator, draws, seed):
        if draws is not None:
            return draws
        if generator is None:
            generator = torch.Generator(device=like.device).manual_seed(seed)
        return standard_normal(generator, shape, like)

    def elbo(self, generator=None, draws=None):
        mu, var = self._marginals(self.X)  # [L_tot, N]
        eps = self._draws((self.n_mc,) + tuple(mu.shape), mu, generator, draws, self.seed)
        f = mu[None] + torch.sqrt(var)[None] * eps  # [S, L_tot, N]
        y_hat = self._mix(f, self.X.shape[0])  # [S, N, P]
        nv = self.noise.value
        ok = torch.isfinite(self.Y)
        ll = -0.5 * (_LOG2PI + torch.log(nv) + (torch.nan_to_num(self.Y)[None] - y_hat) ** 2 / nv)
        ell = torch.sum(torch.where(ok[None], ll, 0.0)) / eps.shape[0]
        return ell - self._kl()

    def get_objective(self, generator=None, draws=None):
        return -self.elbo(generator=generator, draws=draws)

    def predict_f(self, Xs, n_mc: int = 64, generator=None, draws=None) -> GaussianMoments:
        """Monte-Carlo moments of the mixed outputs at Xs from [n_mc, L_tot,
        Ns] draws."""
        Xs = as_points(Xs, dtype=self.X.dtype, D=self.X.shape[-1], device=self.X.device)
        mu, var = self._marginals(Xs)
        eps = self._draws((n_mc,) + tuple(mu.shape), mu, generator, draws, self.seed + 1)
        y_hat = self._mix(mu[None] + torch.sqrt(var)[None] * eps, Xs.shape[0])
        return GaussianMoments(mean=torch.mean(y_hat, 0), var=torch.var(y_hat, 0, unbiased=False))

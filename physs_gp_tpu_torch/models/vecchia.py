"""Vecchia (nearest-neighbour) GP: a sparse approximation of the exact GP by
ordered conditioning (PyTorch counterpart of `physs_gp_tpu/models/vecchia.py`).

    log p(y) = sum_i log N(y_i | mu_i + c_i^T C_i^{-1} r_{J(i)},
                            k_ii + v - c_i^T C_i^{-1} c_i)

J(i) is the set of (<= m) nearest PRECEDING points in a maximin ordering,
C_i = K_{J(i)} + v I and c_i = K(X_{J(i)}, x_i). Conditioning on the observed
process makes each term a scalar Gaussian, so the whole lml is one batch of
[N, m, m] solves with two right-hand sides: `ops.matrix.psd_solve`, the
Gauss-Jordan kernel on the card (its warp route at m <= 32), whose backward
is the same kernel. With m = N - 1 the telescoping product is the exact joint
density, so the lml equals `BatchGP.log_marginal_likelihood`.

The ordering and the conditioning sets (`data.neighbours`) are computed at
`init` on the data's device; the neighbour indices are integer buffers.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..likelihoods.gaussian import Gaussian, IndependentGaussian
from ..means.mean import mean_module
from ..ops.gaussian import mask_covariance
from ..ops.matrix import psd_solve
from ..utils.params import positive_param
from ..utils.shapes import as_points
from .ssgp import GaussianMoments

__all__ = ["VecchiaGP"]

_LOG2PI = math.log(2.0 * math.pi)


class VecchiaGP(nn.Module):
    def __init__(self, X, Y, kernel, likelihood, nbrs, nbr_mask, order, mean=None):
        super().__init__()
        self.register_buffer("X", X)  # [N, D] inputs in conditioning order
        self.register_buffer("Y", Y)  # [N, 1] observations in that order, NaN = missing
        self.kernel = kernel
        self.likelihood = likelihood  # Gaussian: response-Vecchia needs conjugate noise
        self.register_buffer("nbrs", nbrs)  # [N, m] int64 indices into the ordered rows
        self.register_buffer("nbr_mask", nbr_mask)  # [N, m] 1 = real neighbour, 0 = padding
        self.register_buffer("order", order)  # [N] int64 permutation of the caller's rows
        self.mean = mean_module(mean)

    @classmethod
    def init(cls, X, Y, kernel, likelihood=None, *, m: int = 16, ordering="maximin",
             dtype=None, device="cuda") -> "VecchiaGP":
        """Build from raw (unordered) data: the ordering and the conditioning
        sets are computed on `device` (the card unless the caller asks for
        the CPU), and everything is stored in the ordered layout."""
        from ..data.neighbours import nearest_neighbour_sets

        X = as_points(X, dtype=dtype, device=device)
        Y = torch.as_tensor(Y, dtype=X.dtype, device=X.device).reshape(X.shape[0], -1)
        if Y.shape[1] != 1:
            raise ValueError(
                f"VecchiaGP is single-output; got Y with {Y.shape[1]} "
                "columns (use one model per output or an LMC BatchGP)"
            )
        order, nbrs, mask = nearest_neighbour_sets(X, m, ordering=ordering)
        if likelihood is None:
            likelihood = Gaussian(positive_param(1.0, dtype=X.dtype, device=X.device))
        return cls(X[order], Y[order], kernel, likelihood, nbrs.long(), mask.to(X.dtype), order)

    @property
    def n_outputs(self) -> int:
        return 1

    def _noise_var(self):
        if isinstance(self.likelihood, IndependentGaussian):
            return self.likelihood._v[0]
        return self.likelihood.variance.value

    def _mu(self, X):
        if self.mean is None:
            return None
        mean = self.mean[0] if isinstance(self.mean, (list, tuple, nn.ModuleList)) else self.mean
        return mean(X)

    def _residuals(self):
        """(r, obs): centred observations [N] and the finite-y mask [N]."""
        y = self.Y[:, 0]
        obs = torch.isfinite(y).to(self.X.dtype)
        mu = self._mu(self.X)
        r = torch.nan_to_num(y) - (0.0 if mu is None else mu)
        return torch.where(obs > 0, r, 0.0), obs

    def _conditionals(self, Xq, nbrs, w, r):
        """Per-point conditionals given conditioning sets: Xq [B, D] query
        points, nbrs [B, m] indices into self.X, w [B, m] neighbour masks,
        r [N] centred observations. Returns (mean_adj [B], var [B]), the
        conditional N(mu(xq) + mean_adj, var) of the latent f at each query
        given the observed y at its conditioning set."""
        v = self._noise_var()
        Xn = self.X[nbrs]  # [B, m, D]
        rn = r[nbrs] * w  # [B, m]
        K = self.kernel.K

        def one(xn, xq):
            return K(xn, xn), K(xn, xq[None, :])[:, 0]

        C, c = torch.func.vmap(one)(Xn, Xq)  # [B, m, m], [B, m]
        eye = torch.eye(C.shape[-1], dtype=C.dtype, device=C.device)
        Cm = mask_covariance(C + v * eye, w)
        c = c * w
        W = psd_solve(Cm, torch.stack([c, rn], -1))  # [B, m, 2]
        kq = self.kernel.K_diag(Xq)
        mean_adj = torch.sum(c * W[..., 1], -1)
        var = kq - torch.sum(c * W[..., 0], -1)
        return mean_adj, var

    def log_marginal_likelihood(self):
        """The sum of scalar conditional log-densities; exact when every
        point conditions on all its predecessors (m = N - 1)."""
        r, obs = self._residuals()
        w = self.nbr_mask * obs[self.nbrs]  # drop missing-y neighbours
        mean_adj, fvar = self._conditionals(self.X, self.nbrs, w, r)
        yvar = fvar + self._noise_var()
        ll = -0.5 * (_LOG2PI + torch.log(yvar) + (r - mean_adj) ** 2 / yvar)
        return torch.sum(torch.where(obs > 0, ll, 0.0))

    def get_objective(self):
        return -self.log_marginal_likelihood()

    def predict_f(self, Xs, m_predict: int | None = None) -> GaussianMoments:
        """Marginal posterior of f at Xs, each point conditioned on its m
        nearest observed training points (a `topk` over the [Ns, N]
        distances, missing rows pushed to inf). Vecchia prediction is
        marginal by construction: use BatchGP for joint test covariances."""
        Xs = as_points(Xs, dtype=self.X.dtype, D=self.X.shape[-1], device=self.X.device)
        r, obs = self._residuals()
        m = self.nbrs.shape[1] if m_predict is None else int(m_predict)
        m = min(m, self.X.shape[0])
        d2 = (torch.sum(Xs * Xs, 1)[:, None] + torch.sum(self.X * self.X, 1)[None, :]
              - 2.0 * (Xs @ self.X.T))
        # missing-y rows cannot inform predictions: push them to the back
        d2 = torch.where(obs[None, :] > 0, d2, torch.inf)
        neg, nbrs = torch.topk(-d2, m, dim=1)  # [Ns, m]
        del d2
        w = torch.isfinite(neg).to(self.X.dtype)
        mean_adj, var = self._conditionals(Xs, nbrs, w, r)
        mu = self._mu(Xs)
        mean = mean_adj if mu is None else mean_adj + mu
        return GaussianMoments(mean=mean[:, None], var=torch.clamp(var, min=0.0)[:, None])

    def predict_y(self, Xs) -> GaussianMoments:
        f = self.predict_f(Xs)
        return GaussianMoments(mean=f.mean, var=f.var + self._noise_var())

    def nlpd(self, Xs, Ys):
        """Mean negative log predictive density over the finite entries of Ys."""
        py = self.predict_y(Xs)
        Ys = torch.as_tensor(Ys, dtype=self.X.dtype, device=self.X.device).reshape(py.mean.shape)
        val = 0.5 * (_LOG2PI + torch.log(py.var) + (Ys - py.mean) ** 2 / py.var)
        ok = torch.isfinite(Ys)
        return torch.sum(torch.where(ok, torch.nan_to_num(val), 0.0)) / torch.sum(ok)

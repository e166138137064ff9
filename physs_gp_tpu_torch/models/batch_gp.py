"""Exact (batch) GP regression with dense conjugate inference (PyTorch
counterpart of `physs_gp_tpu/models/batch_gp.py`).

Multi-output kernels (`DerivativeKernel`, `LMC`) give data-major block
Grams; Y is [N, P] and NaNs are masked inside fixed-shape algebra
(`mask_covariance`). `solver="cholesky"` factors the Gram (a 2-D Gram of
n <= 80 goes to the hand-written Cholesky kernel through `safe_cholesky`,
larger ones to PyTorch's); `solver="cg"` is matrix-free (`ops/cg`:
Jacobi-PCG solves and an SLQ logdet whose probes come from a generator with
a fixed seed, so the lml is a deterministic function of the parameters;
`probes=` feeds given ones). The data live on `device`, the card unless the
caller asks for the CPU.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..likelihoods.gaussian import IndependentGaussian
from ..means.mean import mean_module
from ..ops.cg import cg_solve, rademacher, slq_logdet_given
from ..ops.gaussian import mask_covariance
from ..ops.matrix import log_det_from_chol, safe_cholesky, safe_cholesky_rel, solve_lower
from ..ops.sampling import standard_normal
from ..utils.shapes import as_points
from .ssgp import GaussianMoments

__all__ = ["BatchGP", "DenseModel"]

_LOG2PI = math.log(2.0 * math.pi)
SLQ_SEED = 0  # the seed of the lml's fixed probes (the reference's PRNGKey(0))


class DenseModel(nn.Module):
    """What the dense models (`BatchGP`, `SVGP`) share: the output count of
    their kernel, new inputs as points on the data's device, and joint
    samples from a generator through the model's `sample_f_given`."""

    @property
    def n_outputs(self) -> int:
        return getattr(self.kernel, "n_outputs", 1)

    def _points(self, Xs):
        D = self.X.shape[-1] if self.X.dim() > 1 else 1
        return as_points(Xs, dtype=self.X.dtype, D=D, device=self.X.device)

    def sample_f(self, generator, Xs, n_samples: int):
        """`sample_f_given` with draws from `generator` (a `torch.Generator`
        on the model's device)."""
        n = self._points(Xs).shape[0] * self.n_outputs
        return self.sample_f_given(Xs, standard_normal(generator, (n_samples, n), self.X))


class BatchGP(DenseModel):
    def __init__(self, X, Y, kernel, likelihood, mean=None, solver: str = "cholesky",
                 cg_tol: float = 1e-6, slq_probes: int = 32, slq_iters: int = 48,
                 dtype=None, device="cuda"):
        super().__init__()
        self.register_buffer("X", torch.as_tensor(X, dtype=dtype, device=device))
        self.register_buffer("Y", torch.as_tensor(Y, dtype=dtype, device=device))
        self.kernel = kernel
        self.likelihood = likelihood
        self.mean = mean_module(mean)
        if solver not in ("cholesky", "cg"):
            raise ValueError(f"unknown solver {solver!r}")
        self.solver = solver
        self.cg_tol = cg_tol
        self.slq_probes = slq_probes
        self.slq_iters = slq_iters

    def _mu(self, X):
        """[N, P] prior-mean values, or None (zero mean)."""
        if self.mean is None:
            return None
        means = self.mean if isinstance(self.mean, nn.ModuleList) else [self.mean] * self.n_outputs
        return torch.stack([m(X) for m in means], 1)

    def _noise_diag(self, N: int):
        """Per-entry noise variances [N·P], data-major."""
        if isinstance(self.likelihood, IndependentGaussian):
            return self.likelihood._v.repeat(N)
        return self.likelihood.variance.value.expand(N * self.n_outputs)

    def _masked_gram(self):
        N = self.X.shape[0]
        mu = self._mu(self.X)
        yf = (self.Y if mu is None else self.Y - mu).reshape(-1)
        mask = torch.isfinite(yf).to(self.X.dtype)
        Ky = self.kernel.K(self.X, self.X) + torch.diag(self._noise_diag(N))
        y0 = torch.where(mask > 0, torch.nan_to_num(yf), 0.0)
        return mask_covariance(Ky, mask), y0, mask

    def _probes(self, n: int):
        g = torch.Generator(device=self.X.device).manual_seed(SLQ_SEED)
        return rademacher(g, (self.slq_probes, n), self.X)

    def log_marginal_likelihood(self, probes=None):
        """log p(Y); with solver="cg", `probes` [k, N·P] replaces the fixed
        Rademacher probes of the SLQ logdet."""
        Km, y0, mask = self._masked_gram()
        n_obs = torch.sum(mask)
        if self.solver == "cg":
            alpha = cg_solve(Km, y0, tol=self.cg_tol)
            # masked unit-diagonal rows contribute 0 to the logdet
            ld = slq_logdet_given(Km, self._probes(Km.shape[-1]) if probes is None else probes,
                                  lanczos_iters=self.slq_iters)
            return -0.5 * (torch.sum(y0 * alpha) + ld + n_obs * _LOG2PI)
        L = safe_cholesky(Km)
        alpha = solve_lower(L, y0[:, None])[:, 0]
        return -0.5 * (torch.sum(alpha * alpha) + log_det_from_chol(L) + n_obs * _LOG2PI)

    def get_objective(self):
        return -self.log_marginal_likelihood()

    def _moments(self, Xs, mean, full_cov, quad):
        """(mean, cov) or GaussianMoments from the data-part mean [Ns·P] and
        the reduction `quad` of the cross-covariance (matrix or diagonal)."""
        P = self.n_outputs
        mu_s = self._mu(Xs)
        mean = mean.reshape(-1, P)
        if mu_s is not None:
            mean = mean + mu_s
        if full_cov:
            return mean, self.kernel.K(Xs, Xs) - quad(True)
        return GaussianMoments(mean=mean, var=(self.kernel.K_diag(Xs) - quad(False)).reshape(-1, P))

    def predict_f(self, Xs, full_cov: bool = False):
        """Posterior q(f*) at new inputs: [Ns, P] moments (data-major), or
        (mean [Ns, P], cov [Ns·P, Ns·P]) with `full_cov`."""
        Xs = self._points(Xs)
        Km, y0, mask = self._masked_gram()
        Kxs = self.kernel.K(self.X, Xs) * mask[:, None]  # zero rows for missing entries
        if self.solver == "cg":
            # one multi-column PCG solve for [y0 | Kxs]
            W = cg_solve(Km, torch.cat([y0[:, None], Kxs], 1), tol=self.cg_tol)
            return self._moments(Xs, Kxs.T @ W[:, 0], full_cov,
                                 lambda full: Kxs.T @ W[:, 1:] if full
                                 else torch.sum(Kxs * W[:, 1:], 0))
        L = safe_cholesky(Km)
        A = solve_lower(L, Kxs)  # [N·P, Ns·P]
        alpha = solve_lower(L, y0[:, None])
        return self._moments(Xs, (A.T @ alpha)[:, 0], full_cov,
                             lambda full: A.T @ A if full else torch.sum(A * A, 0))

    def predict_y(self, Xs) -> GaussianMoments:
        f = self.predict_f(Xs)
        Ns = f.mean.shape[0]
        nv = self._noise_diag(Ns).reshape(Ns, self.n_outputs)
        return GaussianMoments(mean=f.mean, var=f.var + nv)

    def sample_f_given(self, Xs, eps):
        """Joint posterior samples [S, Ns, P] at Xs from standard-normal
        draws eps [S, Ns·P]: mean + chol(posterior cov) eps."""
        mean, cov = self.predict_f(Xs, full_cov=True)
        Lc = safe_cholesky_rel(cov)
        return mean[None] + (eps @ Lc.T).reshape((eps.shape[0],) + mean.shape)

    def nlpd(self, Xs, Ys):
        """Mean negative log predictive density (Gaussian closed form) over
        the finite entries of Ys."""
        py = self.predict_y(Xs)
        Ys = torch.as_tensor(Ys, dtype=self.X.dtype, device=self.X.device).reshape(py.mean.shape)
        val = 0.5 * (_LOG2PI + torch.log(py.var) + (Ys - py.mean) ** 2 / py.var)
        ok = torch.isfinite(Ys)
        return torch.sum(torch.where(ok, torch.nan_to_num(val), 0.0)) / torch.sum(ok)

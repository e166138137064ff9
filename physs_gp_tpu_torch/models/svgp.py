"""Dense sparse variational GP with a free-form Gaussian posterior (PyTorch
counterpart of `physs_gp_tpu/models/svgp.py`).

q(u) = N(m, L Lᵀ) at the inducing inputs Z, whitened by default (u = Lz v,
q over v), ELBO = Σ_i E_q[log p(y_i | f_i)] − KL(q || p). The factors of
the inducing Gram, of S and of the natural-gradient precision are 2-D
[M·P, M·P]: `safe_cholesky` sends them to the hand-written Cholesky kernel
when M·P <= 80 (the warp kernel up to 32, the block kernel above), to
PyTorch's above. With a `DerivativeKernel` prior and a
`PerOutputLikelihood` this is the AutoIP-style physics model
(`zoo.diff.deriv_vgp`). `natural_gradient_update` takes one free-form
natural-gradient step and writes the new q into `q_mu` / `q_sqrt`.
"""
from __future__ import annotations

import torch

from ..likelihoods.nongaussian import expected_log_lik, predictive_moments
from ..ops.gaussian import gaussian_kl
from ..ops.matrix import (default_jitter, diag_from_XDXT, safe_cholesky, safe_cholesky_rel,
                          solve_lower, solve_upper)
from ..utils.params import fill_triangular, fill_triangular_inverse, param, tril_param
from ..utils.shapes import as_points
from .batch_gp import DenseModel
from .ssgp import GaussianMoments

__all__ = ["SVGP"]


def _chol_gram(K):
    """Cholesky of an inducing Gram with a relative jitter (smooth dense
    kernels give near-singular Grams once lengthscales grow)."""
    return safe_cholesky_rel(K, rel=100.0 * default_jitter(K.dtype))


class SVGP(DenseModel):
    def __init__(self, X, Y, Z, kernel, likelihood, q_mu, q_sqrt, whiten: bool = True):
        super().__init__()
        self.register_buffer("X", X)  # [N, D]
        self.register_buffer("Y", Y)  # [N, P], NaN = missing
        self.register_buffer("Z", Z)  # [M, D]
        self.kernel = kernel
        self.likelihood = likelihood
        self.q_mu = q_mu  # [M·P]
        self.q_sqrt = q_sqrt  # packed lower triangle of [M·P, M·P]
        self.whiten = whiten

    @classmethod
    def init(cls, X, Y, Z, kernel, likelihood, whiten: bool = True, dtype=None,
             device="cuda") -> "SVGP":
        """q(u) = N(0, I) at Z; the data and q on `device`, the card unless
        the caller asks for the CPU."""
        kw = dict(dtype=dtype, device=device)
        X, Y = as_points(X, **kw), as_points(Y, **kw)
        Z = as_points(Z, D=X.shape[-1], what="inducing inputs Z", **kw)
        M = Z.shape[0] * getattr(kernel, "n_outputs", 1)
        eye = torch.eye(M, dtype=X.dtype, device=X.device)
        return cls(X, Y, Z, kernel, likelihood, q_mu=param(torch.zeros_like(eye[0])),
                   q_sqrt=tril_param(eye), whiten=whiten)

    @property
    def _M(self) -> int:
        return self.Z.shape[0] * self.n_outputs

    def _q(self):
        return self.q_mu.value, fill_triangular(self.q_sqrt.value, self._M)

    def _projection(self, Xs):
        """(Lz, A = Lz⁻¹ Kzx, B): B = A whitened, Lz⁻ᵀ A otherwise."""
        Lz = _chol_gram(self.kernel.K(self.Z, self.Z))
        A = solve_lower(Lz, self.kernel.K(self.Z, Xs))  # [M·P, Ns·P]
        return Lz, A, A if self.whiten else solve_upper(Lz.T, A)

    def _marginals(self, Xs):
        """q(f) at Xs: mean [Ns·P], var [Ns·P] (data-major)."""
        _, A, B = self._projection(Xs)
        m, L = self._q()
        SB = L.T @ B
        var = self.kernel.K_diag(Xs) - torch.sum(A * A, 0) + torch.sum(SB * SB, 0)
        return B.T @ m, torch.clamp(var, min=1e-12)

    def _kl(self, m, Ls):
        if self.whiten:
            eye = torch.eye(m.shape[0], dtype=m.dtype, device=m.device)
            return gaussian_kl(m, Ls, torch.zeros_like(m), eye)
        return gaussian_kl(m, Ls, torch.zeros_like(m), _chol_gram(self.kernel.K(self.Z, self.Z)))

    def elbo(self):
        mean, var = self._marginals(self.X)
        ell = torch.sum(expected_log_lik(self.likelihood, self.Y.reshape(-1), mean, var))
        m, L = self._q()
        return ell - self._kl(m, L)

    def get_objective(self):
        return -self.elbo()

    def _elbo_mS(self, m, S):
        """The ELBO as a function of the raw posterior moments (m, S)."""
        Lz, A, B = self._projection(self.X)
        var = self.kernel.K_diag(self.X) - torch.sum(A * A, 0) + diag_from_XDXT(B.T, S)
        if self.whiten:
            kl = self._kl(m, safe_cholesky(S))
        else:
            kl = gaussian_kl(m, safe_cholesky(S), torch.zeros_like(m), Lz)
        ell = torch.sum(expected_log_lik(self.likelihood, self.Y.reshape(-1), B.T @ m,
                                         torch.clamp(var, min=1e-12)))
        return ell - kl

    def natural_gradient_update(self, lr: float) -> "SVGP":
        """One exponential-family natural-gradient step on q:
        λ <- λ + lr ∂ELBO/∂(expectation parameters). With a Gaussian
        likelihood and lr = 1 it reaches the optimum in one step. Updates
        `q_mu` and `q_sqrt` in place and returns the model."""
        with torch.enable_grad():
            m, L = self._q()
            m = m.detach().requires_grad_(True)
            S = (L @ L.T).detach().requires_grad_(True)
            g1, g2 = torch.autograd.grad(self._elbo_mS(m, S), (m, S))
        with torch.no_grad():
            m, S = m.detach(), S.detach()
            g2 = 0.5 * (g2 + g2.T)
            eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
            Sinv = torch.cholesky_solve(eye, safe_cholesky(S))
            lam1 = Sinv @ m + lr * (g1 - 2.0 * g2 @ m)
            prec = -2.0 * (-0.5 * Sinv + lr * g2)
            S_new = torch.cholesky_solve(eye, safe_cholesky(prec))
            self.q_mu.raw.copy_(S_new @ lam1)
            self.q_sqrt.raw.copy_(fill_triangular_inverse(safe_cholesky(S_new)))
        return self

    def predict_f(self, Xs) -> GaussianMoments:
        mean, var = self._marginals(self._points(Xs))
        return GaussianMoments(mean=mean.reshape(-1, self.n_outputs), var=var.reshape(-1, self.n_outputs))

    def _joint(self, Xs):
        """q(f) at Xs with the full [Ns·P, Ns·P] covariance."""
        _, A, B = self._projection(Xs)
        m, L = self._q()
        SB = L.T @ B
        return B.T @ m, self.kernel.K(Xs, Xs) - A.T @ A + SB.T @ SB

    def sample_f_given(self, Xs, eps):
        """Joint q(f) samples [S, Ns, P] at Xs from standard-normal draws
        eps [S, Ns·P]."""
        mean, cov = self._joint(self._points(Xs))
        Lc = safe_cholesky_rel(cov)
        return (mean[None] + eps @ Lc.T).reshape(eps.shape[0], -1, self.n_outputs)

    def predict_y(self, Xs, gh_points: int = 20) -> GaussianMoments:
        """Moment-matched p(y*) (`predictive_moments`); q(f) itself for a
        likelihood without conditional moments."""
        f = self.predict_f(Xs)
        lik = self.likelihood
        if not (hasattr(lik, "predict_y_moments") or hasattr(lik, "conditional_mean")):
            return f
        return GaussianMoments(*predictive_moments(lik, f.mean, f.var, gh_points))

"""CVI state-space GP: variational inference with a conjugate surrogate (PyTorch).

Counterpart of `physs_gp_tpu/models/cvi_gp.py`. The approximate posterior
is a surrogate state-space GP whose sites (Ỹ, Ṽ) are updated by natural
gradients, and

    ELBO = ELL_data(q) - ELL_sites(q) + lml_surrogate,

all from one Kalman filter + smoother pass over the surrogate.
`step_with_elbo` and `natural_gradient_update` update the model's sites in
place and return the model; `natgrad_step` is the pure step beneath them. Prediction runs on the surrogate as a
`StateSpaceGP` (`surrogate_model`): `predict_f` on its NaN-augmented grid,
`predict_y` by Gauss-Hermite moment matching, `nlpd` by log-domain
Gauss-Hermite quadrature, `sample_f` by Matheron pathwise conditioning on
the surrogate. `mesh` (a `torch.distributed` DeviceMesh) shards the time
axis over its dimension `mesh_axis` (`parallel/sharded.py`): every rank
holds the same t and Y, and its segment of the sites (`CVIGP.init(mesh=)`
splits them; a model given the whole series' sites takes its rows), builds
and passes its segment of the surrogate, and computes the ELLs and the
site update on it; the ELBO is the all-reduced sum of the segments'.
`surrogate_model()` carries the mesh, so predictions and `sample_f` run
sharded and gather their head values over the series.
`init_state` = (m0, P0) replaces the stationary prior of the
filter (online CVI carries the previous segment's filtered state in it,
`models/streaming.py`); as in the reference, `surrogate_model()` does not
pass it on, so `predict_f` and `sample_f` start from the stationary prior.
Block likelihoods (`CompositeLikelihood`: per-column heads and a nonlinear
Monte-Carlo residual) supply the data ELL, its Gauss-Newton site gradients
(`hessian="gauss_newton"`) and their own predictive densities.

Monte-Carlo noise: `elbo`, `get_objective`, `natural_gradient_update` and
`step_with_elbo` take `generator=`, a `torch.Generator` on the model's
device, where the reference takes a PRNG key; one call draws the
likelihood's standard normals once (a residual's [n_mc, T, p]; the pair of
sets of `DynamicCovarianceGaussian`, one for the ELL and one for its site
gradients) and every term of the call takes its share. `generator=None`
draws the same noise on every call (a fresh generator seeded with the
likelihood's `seed`). `draws=` hands in the draws themselves (the JAX
package's, in the tests).

A prior `mean` μ (`means.mean`, at the heads by `head_mean_values`): the
zero-mean surrogate carries the deviation f₀ and the data likelihood sees
f₀ + μ; `posterior`, `predict_f` (hence `predict_y` and `nlpd`) add μ. As in
the reference, `surrogate_model()` and so `sample_f` carry no mean.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn

from ..approx.cvi import Sites, init_sites, natgrad_update
from ..likelihoods.gaussian import BlockDiagonalGaussian
from ..likelihoods.nongaussian import expected_log_lik, predictive_moments
from ..means.mean import head_mean_values, mean_module
from ..ops.gaussian import mask_covariance
from ..ops.lgssm import build_lgssm, project_cov, project_cov_factor, project_mean
from ..ops.matrix import psd_solve_logdet
from ..ops.quadrature import expect_gh_log
from ..ops.runner import run_filter_smoother
from .ssgp import GaussianMoments, StateSpaceGP

__all__ = ["CVIGP", "GaussianMoments"]

_LOG2PI = math.log(2.0 * math.pi)


def _no_grad(method):
    """`torch.no_grad()` around `method`, entered only where grad is on: a
    tracer that runs under `no_grad` (`utils/serving`) then records no
    grad-mode switch, which `torch.export` would have to split the graph
    around."""
    @functools.wraps(method)
    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return method(*args, **kwargs)
        with torch.no_grad():
            return method(*args, **kwargs)
    return run


def check_generator(generator) -> None:
    """A Monte-Carlo source is a `torch.Generator` or None (never a JAX key)."""
    if generator is not None and not isinstance(generator, torch.Generator):
        raise TypeError("Monte-Carlo noise needs a torch.Generator on the model's device")


class CVIGP(nn.Module):
    def __init__(self, t, Y, kernel, likelihood, sites: Sites, observation=None,
                 mean=None, parallel: bool = False, sqrt: bool = False, chunk_size=None,
                 init_state=None, mesh=None, mesh_axis: str = "t"):
        super().__init__()
        self.register_buffer("t", t)
        self.register_buffer("Y", Y)
        self.kernel = kernel
        self.likelihood = likelihood
        self.sites = sites
        self.observation = observation
        self.mean = mean_module(mean)
        self.parallel = parallel
        self.sqrt = sqrt
        self.chunk_size = chunk_size
        self.init_state = init_state
        self.mesh = mesh
        self.mesh_axis = mesh_axis

    @classmethod
    def init(cls, t, Y, kernel, likelihood, observation=None, mean=None, parallel=False,
             sqrt=False, chunk_size=None, site_var: float = 1.0, init_state=None, mesh=None,
             mesh_axis: str = "t"):
        active = (
            likelihood.site_active_mask(Y)
            if hasattr(likelihood, "site_active_mask")
            else None
        )
        Y_sites = Y
        if mesh is not None:  # the rank's segment of the sites
            from ..parallel import sharded

            seg = sharded.segment(Y.shape[0], mesh, mesh_axis, chunk_size)
            Y_sites, active = seg.rows(Y), None if active is None else seg.rows(active)
        return cls(
            t=t.reshape(-1), Y=Y, kernel=kernel, likelihood=likelihood,
            sites=init_sites(Y_sites, site_var, active=active), observation=observation,
            mean=mean, parallel=parallel, sqrt=sqrt, chunk_size=chunk_size,
            init_state=init_state, mesh=mesh, mesh_axis=mesh_axis,
        )

    # ---- time-axis sharding ----
    def _seg(self):
        """The rank's segment of the series, or None without a mesh."""
        if self.mesh is None:
            return None
        from ..parallel import sharded

        return sharded.segment(self.t.shape[0], self.mesh, self.mesh_axis, self.chunk_size)

    def _rows(self, x, dim: int = 0):
        """x's rows of the rank's segment (all of x without a mesh)."""
        seg = self._seg()
        return x if seg is None else seg.rows(x, dim)

    def _local_sites(self) -> Sites:
        """The sites of the rank's segment (all sites without a mesh)."""
        if self.mesh is None:
            return self.sites
        return Sites(self._rows(self.sites.Y), self._rows(self.sites.V))

    def _reduce(self, x):
        """The sum of the ranks' x (x itself without a mesh)."""
        if self.mesh is None:
            return x
        from ..parallel import sharded

        return sharded.all_reduce_sum(x, self.mesh, self.mesh_axis)

    def _whole(self, x):
        """x [rows of the segment, ...] gathered over the series (x itself
        without a mesh)."""
        if self.mesh is None:
            return x
        from ..parallel import sharded

        return sharded.gather_time(x, self.mesh, self._seg(), self.mesh_axis)

    # ---- surrogate filtering ----
    def _surrogate_pass(self):
        """Filter + smooth the surrogate; return (lml, m [T, p], S [T, p, p])
        with the H-projected q(f) block moments (with a mesh: the rank's
        segment of them, and its share of the lml)."""
        seg = self._seg()
        ssm = build_lgssm(self.kernel, self.t, seg)
        if self.observation is not None:
            ssm = ssm._replace(H=self.observation.H(
                self.kernel, None if seg is None else slice(seg.lo, seg.hi)))
        if self.init_state is not None:
            ssm = ssm._replace(m0=self.init_state[0], P0=self.init_state[1])
        sites = self._local_sites()
        f, s = run_filter_smoother(
            ssm, sites.V, sites.Y, parallel=self.parallel,
            sqrt=self.sqrt, chunk_size=self.chunk_size, mesh=self.mesh,
            mesh_axis=self.mesh_axis, T=self.t.shape[0],
        )
        # the square-root smoother ships the covariance factors: (H L)(H L)ᵀ
        # stays PSD in float32 where H P Hᵀ goes indefinite
        S = project_cov(ssm.H, s.Ps) if s.Ls is None else project_cov_factor(ssm.H, s.Ls)
        return f.lml, project_mean(ssm.H, s.ms), S

    # ---- ELL terms ----
    def mc_draws(self, generator=None):
        """The likelihood's Monte-Carlo draws for one call, from `generator`
        (None: the frozen seed), or None when the likelihood has no
        Monte-Carlo term. A likelihood with a `draws` method supplies its own
        (`DynamicCovarianceGaussian`: a pair of sets); otherwise its
        `residual` draws [n_mc, T, p]."""
        check_generator(generator)
        lik = self.likelihood
        source = lik if hasattr(lik, "draws") else getattr(lik, "residual", None)
        if source is None:
            return None
        if self.mesh is None:
            return source.draws(self.sites.Y, generator)
        # the whole series' draws, so a rank's equal the unsharded model's rows
        draws = source.draws(self.Y, generator)
        if isinstance(draws, torch.Tensor):
            return self._rows(draws, 1)
        return type(draws)(self._rows(x, 1) for x in draws)

    def _mu(self, t=None):
        """The prior mean μ [T, p] at the heads (at the training times, or
        at `t`), or None for a zero mean."""
        if self.mean is None:
            return None
        return head_mean_values(self.mean, self.t if t is None else t.reshape(-1),
                                observation=self.observation, p=self.Y.shape[1])

    def _ell_data(self, m, S, draws=None):
        """The data ELL of the q(f) block moments (with a mesh: of the rank's
        segment, m and S its rows)."""
        seg = self._seg()
        mu = self._mu()
        if mu is not None:
            m = m + self._rows(mu)
        if self.observation is not None:
            corr = self.observation.var_correction(
                self.kernel, None if seg is None else slice(seg.lo, seg.hi))
            if corr is not None:
                # off-site heads: q(f(s)) marginal var = H P H^T + ρ(s)
                S = S + torch.diag_embed(corr.expand(m.shape))
        Y = self._rows(self.Y)
        if hasattr(self.likelihood, "expected_log_lik_blocks"):
            # block likelihoods: per-column heads and nonlinear residuals
            return self.likelihood.expected_log_lik_blocks(Y, m, S, draws=draws)
        v = torch.diagonal(S, dim1=-2, dim2=-1)
        return torch.sum(expected_log_lik(self.likelihood, Y, m, v))

    def _ell_sites_ex(self, m, S):
        """(Σ_t E_q[log N(Ỹ_t | f_t, Ṽ_t)] over active site elements,
        (λ1, λ2)): the site inverse of the ELL doubles as the natural
        parameters `natgrad_update` needs. With a mesh: the rank's segment."""
        sites = self._local_sites()
        ok = torch.isfinite(sites.Y).to(m.dtype)  # [T, p]
        p = m.shape[-1]
        Vm = mask_covariance(sites.V, ok)
        eye = torch.eye(p, dtype=m.dtype, device=m.device).expand(Vm.shape)
        Vinv, logdet = psd_solve_logdet(Vm, eye)
        y0 = torch.where(ok > 0, torch.nan_to_num(sites.Y), 0.0)
        diff = y0 - m * ok
        maha = torch.einsum("ti,tij,tj->t", diff, Vinv, diff)
        n_obs = torch.sum(ok, -1)
        logpdf = -0.5 * (maha + logdet + n_obs * _LOG2PI)
        # trace over the active sub-block: tr(Vm^-1 Sm) elementwise
        Sm = S * (ok[..., :, None] * ok[..., None, :])
        tr = torch.sum(Vinv * Sm, (-1, -2))
        value = torch.sum(logpdf) - 0.5 * torch.sum(tr)
        lam1 = torch.einsum("tij,tj->ti", Vinv, y0)
        return value, (lam1, -0.5 * Vinv)

    def _ell_sites(self, m, S):
        return self._ell_sites_ex(m, S)[0]

    # ---- public API ----
    def _draws(self, generator, draws):
        return self.mc_draws(generator) if draws is None else draws

    def _elbo(self, draws):
        lml_sur, m, S = self._surrogate_pass()
        return self._ell_data(m, S, draws) - self._ell_sites(m, S) + lml_sur

    def elbo(self, generator=None, draws=None):
        """The ELBO; with a mesh, the all-reduced sum of the segments' (the
        gradient of a parameter summed over the ranks in the backward)."""
        draws = self._draws(generator, draws)
        if self.mesh is None:
            return self._elbo(draws)
        from ..parallel import sharded

        return self._reduce(sharded.shared_params(self, lambda m: m._elbo(draws), self.mesh,
                                                  self.mesh_axis))

    def get_objective(self, generator=None, draws=None):
        return -self.elbo(generator=generator, draws=draws)

    def _site_grads(self, m, S, hessian: str, draws=None):
        """(g1, g2) of the data ELL from a likelihood that supplies them
        (`natgrad_moments`: the Gauss-Newton form of a residual when hessian
        is not "exact"); None lets `natgrad_update` take the exact gradient
        by autograd."""
        if hessian != "exact" and hasattr(self.likelihood, "natgrad_moments"):
            return self.likelihood.natgrad_moments(self.Y, m, S, residual_hessian=hessian,
                                                   draws=draws)
        return None

    @torch.no_grad()
    def natgrad_step(self, lr: float, hessian: str = "exact", draws=None,
                     with_elbo: bool = True):
        """The pure CVI step under `natural_gradient_update` and
        `step_with_elbo`: (new sites, pre-update ELBO, or None without
        `with_elbo`) from one surrogate filter + smoother pass; the model is
        not changed (`models/stacked.py` runs it under `torch.func.vmap`).
        With the ELBO, the site inverse of its site term gives the natural
        parameters; without it they come from `to_natural(sites)`. With a
        mesh: the rank's segment of the sites, and the all-reduced ELBO."""
        lml_sur, m, S = self._surrogate_pass()
        elbo = naturals = None
        if with_elbo:
            ell_sites, naturals = self._ell_sites_ex(m, S)
            elbo = self._reduce(self._ell_data(m, S, draws) - ell_sites + lml_sur)
        sites = natgrad_update(
            self._local_sites(), m, S, lambda mm, SS: self._ell_data(mm, SS, draws), lr,
            grads=self._site_grads(m, S, hessian, draws), naturals=naturals,
        )
        return sites, elbo

    @torch.no_grad()
    def natural_gradient_update(self, lr: float, hessian: str = "exact", generator=None,
                                draws=None):
        """One CVI step on all sites; the sites are replaced in place."""
        self.sites, _ = self.natgrad_step(lr, hessian, self._draws(generator, draws),
                                          with_elbo=False)
        return self

    @torch.no_grad()
    def step_with_elbo(self, lr: float, hessian: str = "exact", generator=None, draws=None):
        """One CVI step and the (pre-update) ELBO from a single surrogate
        filter + smoother pass; the sites are replaced in place. The ELBO and
        the site gradients share one set of Monte-Carlo draws."""
        self.sites, elbo = self.natgrad_step(lr, hessian, self._draws(generator, draws))
        return self, elbo

    @torch.no_grad()
    def posterior(self) -> GaussianMoments:
        """q(f)'s head means and variances [T, p] (gathered over the series
        with a mesh)."""
        _, m, S = self._surrogate_pass()
        m, v = self._whole(torch.cat([m, torch.diagonal(S, dim1=-2, dim2=-1)], -1)).chunk(2, -1)
        mu = self._mu()
        if mu is not None:
            m = m + mu
        return GaussianMoments(mean=m, var=v)

    def surrogate_model(self) -> StateSpaceGP:
        """The conjugate surrogate as a `StateSpaceGP` whose observations are
        the CVI sites: its smoothed posterior is q(f)."""
        return StateSpaceGP(
            t=self.t, Y=self.sites.Y, kernel=self.kernel,
            likelihood=BlockDiagonalGaussian(V=self.sites.V), observation=self.observation,
            parallel=self.parallel, sqrt=self.sqrt, chunk_size=self.chunk_size,
            mesh=self.mesh, mesh_axis=self.mesh_axis,
        )

    @torch.no_grad()
    def sample_f(self, generator, n_samples: int, t_new=None):
        """Joint posterior sample paths [S, T*, p]: q(f) is the surrogate's
        smoothed posterior, so this is the surrogate's `sample_f`."""
        return self.surrogate_model().sample_f(generator, n_samples, t_new=t_new)

    @torch.no_grad()
    def sample_f_given(self, eps_x, eps_y, eps_corr=None, t_new=None):
        """`sample_f` on given standard-normal draws (`StateSpaceGP.sample_f_given`)."""
        return self.surrogate_model().sample_f_given(eps_x, eps_y, eps_corr, t_new=t_new)

    @_no_grad
    def predict_f(self, t_new) -> GaussianMoments:
        """q(f) at new times through the surrogate's NaN-augmented grid,
        plus the prior mean there."""
        out = self.surrogate_model().predict_f(t_new)
        if self.mean is not None:
            out = GaussianMoments(mean=out.mean + self._mu(t_new), var=out.var)
        return out

    @_no_grad
    def predict_y(self, t_new, gh_points: int = 20) -> GaussianMoments:
        """Moment-matched predictive p(y*): E[y] = E_q[E[y | f]] and
        Var[y] = E_q[Var[y | f] + E[y | f]^2] - E[y]^2 by Gauss-Hermite;
        composite likelihoods route column h through head h."""
        f = self.predict_f(t_new)
        lik = self.likelihood
        return GaussianMoments(*predictive_moments(lik, f.mean, f.var, gh_points))

    @torch.no_grad()
    def nlpd(self, t_new, y_new, gh_points: int = 20):
        """Negative log predictive density by Gauss-Hermite quadrature,
        averaged over the finite elements of y_new: the likelihood's own
        `predictive_log_density` (log domain) where it has one, else its
        `predictive_density`, else the log-domain rule on `log_prob`."""
        f = self.predict_f(t_new)
        y_new = y_new.reshape(f.mean.shape)
        lik = self.likelihood
        if hasattr(lik, "predictive_log_density"):
            val = -lik.predictive_log_density(y_new, f.mean, f.var, gh_points)
        elif hasattr(lik, "predictive_density"):
            pd = lik.predictive_density(y_new, f.mean, f.var, gh_points)
            val = -torch.log(torch.clamp(pd, min=torch.finfo(pd.dtype).tiny))
        else:
            val = -expect_gh_log(
                lambda ff: lik.log_prob(torch.nan_to_num(y_new)[..., None], ff),
                f.mean, f.var, gh_points,
            )
        ok = torch.isfinite(y_new)
        return torch.sum(torch.where(ok, val, 0.0)) / torch.sum(ok)

"""State-space (Markov) GP regression model (PyTorch).

Counterpart of `physs_gp_tpu/models/ssgp.py`: the log marginal likelihood is
one Kalman-filter pass, the posterior a filter + RTS smoother pass, and
prediction augments the time grid with NaN observations, sorts it, filters
and smooths, and unsorts. `parallel=True` runs the parallel scans,
`sqrt=True` the square-root filters, `chunk_size` the chunked scans; the
runner pads the augmented grid to a multiple of the chunk. `mesh` (a
`torch.distributed` DeviceMesh) shards the time axis over its dimension
`mesh_axis` (`parallel/sharded.py`): every rank calls the model with the
same t and Y (Y may also hold just the rank's rows of the series), builds
and passes its segment of the state-space model alone, and holds its
segment of the results. The lml is the all-reduced sum of the segments'
(the gradient of a parameter summed over the ranks in the backward); the
posterior, predictions and samples gather their head values over the
full series. `sample_f` draws
joint posterior sample paths by Matheron pathwise conditioning
(`ops/sampling.py`). A prior `mean` (one `means.mean.Mean`, or one per
head) shifts the heads by μ = `head_mean_values`: inference runs on Y - μ,
and the posterior, predictions and samples add μ back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..likelihoods.gaussian import Gaussian
from ..ops.lgssm import build_lgssm, project_mean, project_var
from ..ops.matrix import diag_from_XDXT
from ..ops.runner import run_filter, run_filter_smoother
from ..ops.sampling import matheron_state_samples_given, standard_normal
from ..means.mean import head_mean_values, mean_module

__all__ = ["StateSpaceGP", "StateSpaceGPView", "GaussianMoments"]


class GaussianMoments(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor


def _lgssm(kernel, observation, t, seg=None):
    """The LGSSM over t, or its rows of the segment `seg` alone."""
    ssm = build_lgssm(kernel, t, seg)
    if observation is not None:
        ssm = ssm._replace(H=observation.H(kernel, None if seg is None else slice(seg.lo, seg.hi)))
    return ssm


class StateSpaceGP(nn.Module):
    def __init__(self, t, Y, kernel, likelihood, observation=None, mean=None,
                 parallel: bool = False, sqrt: bool = False, chunk_size=None,
                 mesh=None, mesh_axis: str = "t"):
        super().__init__()
        self.register_buffer("t", t)
        self.register_buffer("Y", Y)
        self.kernel = kernel
        self.likelihood = likelihood
        self.observation = observation
        self.mean = mean_module(mean)
        self.parallel = parallel
        self.sqrt = sqrt
        self.chunk_size = chunk_size
        self.mesh = mesh
        self.mesh_axis = mesh_axis

    def _seg(self, T=None):
        """The rank's segment of the training series (or of a T-step grid),
        or None without a mesh."""
        if self.mesh is None:
            return None
        from ..parallel import sharded

        return sharded.segment(self.t.shape[0] if T is None else T, self.mesh, self.mesh_axis,
                               self.chunk_size)

    def _rows(self, x, seg):
        """x's rows of the segment (all of x without a mesh)."""
        return x if seg is None else seg.rows(x)

    def _whole(self, x, seg, dim: int = 0):
        """x over the whole series: gathered along `dim` when it holds the
        rank's rows."""
        if seg is None or x.shape[dim] == seg.T:
            return x
        from ..parallel import sharded

        return sharded.gather_time(x, self.mesh, seg, self.mesh_axis, dim)

    def _mu(self, t=None):
        """The prior-mean matrix μ [T, p] at the heads (at the training
        times, or at `t`), or None for a zero mean."""
        if self.mean is None:
            return None
        return head_mean_values(self.mean, self.t if t is None else t,
                                observation=self.observation, p=self.Y.shape[1])

    def _centred(self, seg=None):
        """Y - μ: the observations the filters see (the segment's rows)."""
        mu = self._mu()
        Y = self._rows(self.Y, seg)
        return Y if mu is None else Y - self._rows(mu, seg)

    def _run(self, ssm, R, Y, T=None):
        """The filter + smoother; with a mesh, on the rank's segment of the
        T-step series (default: the training series)."""
        f, s = run_filter_smoother(ssm, R, Y, parallel=self.parallel, sqrt=self.sqrt,
                                   chunk_size=self.chunk_size, mesh=self.mesh,
                                   mesh_axis=self.mesh_axis, T=T or self.t.shape[0])
        return ssm, f, s

    def _corr(self, seg=None):
        """[p] (or [T, p]: the segment's rows) conditional-variance
        correction of off-site heads, or None."""
        if self.observation is None:
            return None
        return self.observation.var_correction(
            self.kernel, None if seg is None else slice(seg.lo, seg.hi))

    def _noise(self, seg=None):
        """R [T, p, p] of the training rows (the segment's); off-site heads
        fold their conditional-variance residual into it."""
        p = self.Y.shape[1]
        T = self.t.shape[0] if seg is None else seg.hi - seg.lo
        R = self._rows(self.likelihood.R(T, p), seg)
        corr = self._corr(seg)
        if corr is not None:
            R = R + torch.diag_embed(corr.expand(T, p))
        return R

    def _filter_inputs(self, seg=None):
        return _lgssm(self.kernel, self.observation, self.t, seg), self._noise(seg)

    def _augmented(self, t_new, what: str):
        """(t, Y, R, inv) of the grid augmented with NaN rows at t_new
        (identity noise there), sorted stably; `inv` unsorts it."""
        if self.observation is not None and self.observation.H(self.kernel).dim() == 3:
            raise ValueError(
                f"{what} does not support time-varying observation operators "
                "(H [T, p, d]): the training H cannot be reused on the augmented grid"
            )
        seg = self._seg()
        T, p = self.t.shape[0], self.Y.shape[1]
        # the whole series' noise and observations: gathered where the
        # model holds the rank's rows of them (a CVI surrogate's sites)
        R = self._whole(self._noise(seg), seg)
        t_all = torch.cat([self.t, t_new])
        Y_all = torch.cat([self._whole(self._centred(seg), seg),
                           self.Y.new_full((t_new.shape[0], p), float("nan"))])
        eye = torch.eye(p, dtype=R.dtype, device=R.device)
        R_all = torch.cat([R, eye.expand(t_new.shape[0], p, p)])
        order = torch.argsort(t_all, stable=True)
        return t_all[order], Y_all[order], R_all[order], torch.argsort(order)

    def _lml(self):
        """The lml, of the rank's segment with a mesh."""
        seg = self._seg()
        ssm, R = self._filter_inputs(seg)
        f, _ = run_filter(ssm, R, self._centred(seg), parallel=self.parallel, sqrt=self.sqrt,
                          chunk_size=self.chunk_size, mesh=self.mesh, mesh_axis=self.mesh_axis,
                          T=self.t.shape[0])
        return f.lml

    def log_marginal_likelihood(self):
        if self.mesh is None:
            return self._lml()
        from ..parallel import sharded

        return sharded.all_reduce_sum(
            sharded.shared_params(self, StateSpaceGP._lml, self.mesh, self.mesh_axis),
            self.mesh, self.mesh_axis)

    def get_objective(self):
        return -self.log_marginal_likelihood()

    def filter_smooth(self, Y=None):
        """(ssm, FilterResult, SmootherResult) of the training series (with
        a mesh: the rank's segment of each, the filter's lml the segment's)."""
        seg = self._seg()
        ssm, R = self._filter_inputs(seg)
        return self._run(ssm, R, self._centred(seg) if Y is None else self._rows(Y, seg))

    def posterior(self) -> GaussianMoments:
        """Smoothed marginals at the training times: [T, p] mean and var
        (gathered over the whole series with a mesh)."""
        seg = self._seg()
        ssm, _, s = self.filter_smooth()
        mean, var = project_mean(ssm.H, s.ms), project_var(ssm.H, s.Ps)
        corr = self._corr(seg)
        if corr is not None:
            var = var + corr
        if seg is not None:
            mean, var = self._whole(torch.cat([mean, var], -1), seg).chunk(2, -1)
        mu = self._mu()
        if mu is not None:
            mean = mean + mu
        return GaussianMoments(mean=mean, var=var)

    def posterior_blocks(self):
        """The smoothed state posterior (m [T, d], P [T, d, d]) and the lml;
        with a mesh, the rank's segment of the blocks and the series' lml."""
        _, f, s = self.filter_smooth()
        lml = f.lml
        if self.mesh is not None:
            from ..parallel import sharded

            lml = sharded.all_reduce_sum(lml, self.mesh, self.mesh_axis)
        return s.ms, s.Ps, lml

    def predict_f(self, t_new) -> GaussianMoments:
        """Posterior at new times: the grid augmented with NaN observations
        (identity noise there), sorted stably, filtered and smoothed, and
        unsorted."""
        t_new = t_new.reshape(-1)
        t, Y, R, inv = self._augmented(t_new, "predict_f")
        T = self.t.shape[0]
        corr = self._corr()
        view = StateSpaceGPView(t=t, Y=Y, R=R, base=self)
        ssm, _, s = view.filter_smooth()
        mean, var = s.ms @ ssm.H.T, diag_from_XDXT(ssm.H, s.Ps)
        if self.mesh is not None:
            seg = self._seg(t.shape[0])
            mean, var = self._whole(torch.cat([mean, var], -1), seg).chunk(2, -1)
        mean, var = mean[inv][T:], var[inv][T:]
        if self.mean is not None:
            mean = mean + self._mu(t=t_new)
        if corr is not None:
            var = var + corr
        return GaussianMoments(mean=mean, var=var)

    def predict_y(self, t_new) -> GaussianMoments:
        f = self.predict_f(t_new)
        if isinstance(self.likelihood, Gaussian):
            return GaussianMoments(f.mean, f.var + self.likelihood.variance.value)
        return f

    def _sample_inputs(self, t_new):
        """(ssm, R, Y, unsort, μ, T*) of the sampling pass over T* steps: the
        training grid, or the grid augmented at `t_new` (`_augmented`), whose
        `unsort` maps the samples back and keeps the new rows; μ is the
        prior mean at the output rows (None for a zero mean). With a mesh,
        ssm, R and Y hold the rank's segment of the grid."""
        if t_new is None:
            seg = self._seg()
            ssm, R = self._filter_inputs(seg)
            return ssm, R, self._centred(seg), None, self._mu(), self.t.shape[0]
        t_new = t_new.reshape(-1)
        t, Y, R, inv = self._augmented(t_new, "sample_f at new times")
        T = self.t.shape[0]
        mu = None if self.mean is None else self._mu(t=t_new)
        seg = self._seg(t.shape[0])
        return (_lgssm(self.kernel, self.observation, t, seg), self._rows(R, seg),
                self._rows(Y, seg), lambda f: f[:, inv][:, T:], mu, t.shape[0])

    def _sample(self, inputs, eps_x, eps_y, eps_corr):
        ssm, R, Y, unsort, mu, n_all = inputs
        xs = matheron_state_samples_given(
            ssm, R, Y, eps_x, eps_y, parallel=self.parallel, sqrt=self.sqrt,
            chunk_size=self.chunk_size, mesh=self.mesh, mesh_axis=self.mesh_axis, T=n_all,
        )  # [S, T*, d]: the rank's rows of them with a mesh
        f = xs @ ssm.H.T if ssm.H.dim() == 2 else torch.einsum("tpd,std->stp", ssm.H, xs)
        f = self._whole(f, self._seg(n_all), dim=1)
        if unsort is not None:
            f = unsort(f)
        if mu is not None:
            f = f + mu[None]
        corr = self._corr()
        if corr is not None:
            # the off-site conditional residual, drawn independently per row:
            # sampled paths carry posterior()'s dispersion
            f = f + torch.sqrt(corr.expand(f.shape[1:])) * eps_corr
        return f

    def sample_f_given(self, eps_x, eps_y, eps_corr=None, t_new=None):
        """Joint posterior sample paths of the heads, [S, T_out, p], from
        given standard-normal draws: eps_x [T*, S, d] for the prior states
        and eps_y [S, T*, p] for the pseudo-observation noise, on the grid
        of the pass (T* rows: the training times, or them and `t_new`
        sorted), and eps_corr [S, T_out, p] for the off-site conditional
        residual (read only when a head has a `var_correction`)."""
        return self._sample(self._sample_inputs(t_new), eps_x, eps_y, eps_corr)

    def sample_f(self, generator, n_samples: int, t_new=None):
        """Joint posterior sample paths of the heads, [S, T_out, p], by
        Matheron pathwise conditioning: prior trajectories by the affine
        scan and one smoother pass per dataset (`ops/sampling.py`).
        `t_new=None` samples at the training times, otherwise at `t_new`
        (the augmented grid of `predict_f`). The draws eps_x, eps_y, then
        eps_corr come from `generator`, a `torch.Generator` on the model's
        device."""
        inputs = self._sample_inputs(t_new)
        ssm, _, Y, _, _, n_all = inputs
        p = Y.shape[1]
        n_out = n_all if t_new is None else n_all - self.t.shape[0]
        eps_x = standard_normal(generator, (n_all, n_samples, ssm.A.shape[-1]), Y)
        eps_y = standard_normal(generator, (n_samples, n_all, p), Y)
        eps_corr = None
        if self._corr() is not None:
            eps_corr = standard_normal(generator, (n_samples, n_out, p), Y)
        return self._sample(inputs, eps_x, eps_y, eps_corr)


class StateSpaceGPView:
    """The base model re-pointed at an augmented (t, Y, R) grid."""

    def __init__(self, t, Y, R, base: StateSpaceGP):
        self.t, self.Y, self.R, self.base = t, Y, R, base

    def filter_smooth(self):
        """The base model's pass over the grid (with a mesh: the rank's
        segment of it)."""
        base = self.base
        T = self.t.shape[0]
        seg = base._seg(T)
        return base._run(_lgssm(base.kernel, base.observation, self.t, seg),
                         base._rows(self.R, seg), base._rows(self.Y, seg), T=T)

"""State-space (Markov) GP regression model (PyTorch).

Counterpart of `physs_gp_tpu/models/ssgp.py`: the log marginal likelihood is
one Kalman-filter pass, the posterior a filter + RTS smoother pass, and
prediction augments the time grid with NaN observations, sorts it, filters
and smooths, and unsorts. `parallel=True` runs the parallel scans,
`sqrt=True` the square-root filters, `chunk_size` the chunked scans; the
runner pads the augmented grid to a multiple of the chunk. A prior mean and
posterior sampling (`sample_f`) are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..likelihoods.gaussian import Gaussian
from ..ops.lgssm import build_lgssm, project_mean, project_var
from ..ops.matrix import diag_from_XDXT
from ..ops.runner import run_filter, run_filter_smoother

__all__ = ["StateSpaceGP", "StateSpaceGPView", "GaussianMoments"]


class GaussianMoments(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor


def _lgssm(kernel, observation, t):
    ssm = build_lgssm(kernel, t)
    if observation is not None:
        ssm = ssm._replace(H=observation.H(kernel))
    return ssm


class StateSpaceGP(nn.Module):
    def __init__(self, t, Y, kernel, likelihood, observation=None, mean=None,
                 parallel: bool = False, sqrt: bool = False, chunk_size=None):
        super().__init__()
        if mean is not None:
            raise NotImplementedError("a prior mean is not ported yet")
        self.register_buffer("t", t)
        self.register_buffer("Y", Y)
        self.kernel = kernel
        self.likelihood = likelihood
        self.observation = observation
        self.parallel = parallel
        self.sqrt = sqrt
        self.chunk_size = chunk_size

    def _run(self, ssm, R, Y):
        f, s = run_filter_smoother(ssm, R, Y, parallel=self.parallel, sqrt=self.sqrt,
                                   chunk_size=self.chunk_size)
        return ssm, f, s

    def _filter_inputs(self):
        ssm = _lgssm(self.kernel, self.observation, self.t)
        T = self.Y.shape[0]
        p = ssm.H.shape[-2]
        R = self.likelihood.R(T, p)
        if self.observation is not None:
            corr = self.observation.var_correction(self.kernel)
            if corr is not None:
                # off-site heads: the conditional-variance residual folds
                # into the observation noise
                R = R + torch.diag_embed(corr.expand(T, p))
        return ssm, R

    def log_marginal_likelihood(self):
        ssm, R = self._filter_inputs()
        f, _ = run_filter(ssm, R, self.Y, parallel=self.parallel, sqrt=self.sqrt,
                          chunk_size=self.chunk_size)
        return f.lml

    def get_objective(self):
        return -self.log_marginal_likelihood()

    def filter_smooth(self, Y=None):
        ssm, R = self._filter_inputs()
        return self._run(ssm, R, self.Y if Y is None else Y)

    def posterior(self) -> GaussianMoments:
        """Smoothed marginals at the training times: [T, p] mean and var."""
        ssm, _, s = self.filter_smooth()
        var = project_var(ssm.H, s.Ps)
        if self.observation is not None:
            corr = self.observation.var_correction(self.kernel)
            if corr is not None:
                var = var + corr
        return GaussianMoments(mean=project_mean(ssm.H, s.ms), var=var)

    def posterior_blocks(self):
        """The smoothed state posterior (m [T, d], P [T, d, d]) and the lml."""
        _, f, s = self.filter_smooth()
        return s.ms, s.Ps, f.lml

    def predict_f(self, t_new) -> GaussianMoments:
        """Posterior at new times: the grid augmented with NaN observations
        (identity noise there), sorted stably, filtered and smoothed, and
        unsorted."""
        t_new = t_new.reshape(-1)
        n_new = t_new.shape[0]
        T, p = self.Y.shape
        corr = None
        if self.observation is not None:
            if self.observation.H(self.kernel).dim() == 3:
                raise ValueError(
                    "predict_f does not support time-varying observation operators "
                    "(H [T, p, d]): the training H cannot be reused on the augmented grid"
                )
            corr = self.observation.var_correction(self.kernel)
        t_all = torch.cat([self.t, t_new])
        Y_all = torch.cat([self.Y, self.Y.new_full((n_new, p), float("nan"))])
        R_train = self.likelihood.R(T, p)
        if corr is not None:
            R_train = R_train + torch.diag_embed(corr.expand(T, p))
        eye = torch.eye(p, dtype=R_train.dtype, device=R_train.device)
        R_all = torch.cat([R_train, eye.expand(n_new, p, p)])
        order = torch.argsort(t_all, stable=True)
        inv = torch.argsort(order)
        view = StateSpaceGPView(t=t_all[order], Y=Y_all[order], R=R_all[order], base=self)
        ssm, _, s = view.filter_smooth()
        mean = (s.ms @ ssm.H.T)[inv][T:]
        var = diag_from_XDXT(ssm.H, s.Ps)[inv][T:]
        if corr is not None:
            var = var + corr
        return GaussianMoments(mean=mean, var=var)

    def predict_y(self, t_new) -> GaussianMoments:
        f = self.predict_f(t_new)
        if isinstance(self.likelihood, Gaussian):
            return GaussianMoments(f.mean, f.var + self.likelihood.variance.value)
        return f


class StateSpaceGPView:
    """The base model re-pointed at an augmented (t, Y, R) grid."""

    def __init__(self, t, Y, R, base: StateSpaceGP):
        self.t, self.Y, self.R, self.base = t, Y, R, base

    def filter_smooth(self):
        base = self.base
        return base._run(_lgssm(base.kernel, base.observation, self.t), self.R, self.Y)

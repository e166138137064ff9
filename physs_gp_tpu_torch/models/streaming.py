"""Streaming / online state-space GP inference: the serving path (PyTorch
counterpart of `physs_gp_tpu/models/streaming.py`).

The filtered state (m, P) at the last seen time is a sufficient statistic for
everything in the past, so new data is assimilated in O(new steps) and
forecasts come from the carried state alone. Streaming over segments
reproduces the full-batch filter's lml, final state and per-step filtered
moments to rounding.

A segment is filtered by prepending ONE dummy step at the carried time
`t_last`: A[0] = I, Q[0] = 0 (`build_lgssm`'s dt_0 = 0 convention,
`ops/lgssm.build_lgssm`) and an all-NaN observation row (a masked update:
no-op, lml contribution 0), with `build_lgssm`'s stationary init replaced by
the carried (m, P). Every runner path (padding, chunking, square-root
refactoring) is reused unchanged. Segments are whatever length the caller
gives: a segment of B rows runs B + 1 steps, which the parallel runner pads
to a multiple of `chunk_size` once B + 1 exceeds it.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import torch
from torch import nn

from ..approx.cvi import Sites
from ..means.mean import head_mean_values, mean_module
from ..ops.lgssm import build_lgssm, project_mean, project_var
from ..ops.runner import run_filter
from .cvi_gp import CVIGP, check_generator
from .ssgp import GaussianMoments

__all__ = ["StreamingGP", "StreamingCVI", "StreamState", "SegmentResult"]


class StreamState(NamedTuple):
    """Carried sufficient statistic: filtered moments at the last seen time."""

    m: torch.Tensor  # [d] filtered state mean at t_last
    P: torch.Tensor  # [d, d] filtered state covariance at t_last
    t_last: torch.Tensor  # [] time of the carried state
    lml: torch.Tensor  # [] accumulated log marginal likelihood so far


class SegmentResult(NamedTuple):
    """Filtered (one-sided, causal) moments over one assimilated segment."""

    f_mean: torch.Tensor  # [B, p] filtered head means E[h(x_k) | y_{1:k}]
    f_var: torch.Tensor  # [B, p] filtered head variances
    lml: torch.Tensor  # [] log p(y_segment | past): this segment's increment


def _like(module):
    """A tensor of the module's dtype and device."""
    for x in module.parameters():
        return x
    for x in module.buffers():
        return x
    raise ValueError(f"{type(module).__name__} holds no tensor to take a dtype and device from")


def _fresh_state(kernel, t0) -> StreamState:
    """The stationary prior anchored at time t0."""
    like = _like(kernel)
    t = torch.as_tensor(t0, dtype=like.dtype, device=like.device).reshape(1)
    ssm = build_lgssm(kernel, t)
    return StreamState(
        m=ssm.m0, P=ssm.P0, t_last=t[0].to(ssm.m0.dtype), lml=ssm.m0.new_zeros(()),
    )


def _times(state, t):
    """(t [B], tc [B + 1] = [t_last, t...]) in their common type."""
    t = torch.as_tensor(t, device=state.t_last.device).reshape(-1)
    dtype = torch.promote_types(t.dtype, state.t_last.dtype)
    t = t.to(dtype)
    return t, torch.cat([state.t_last.to(dtype)[None], t])


def _time_poison(tc, dtype):
    """0 when [t_last, t...] is non-decreasing, else NaN, on the device (no
    read-back): a row before its predecessor means a negative dt went into
    the transitions and the whole segment is untrustworthy. Equal times are
    exact (dt = 0 gives A = I, Q = 0)."""
    ok = torch.all(tc[1:] >= tc[:-1])
    zero = torch.zeros((), dtype=dtype, device=tc.device)
    return torch.where(ok, zero, torch.full_like(zero, float("nan")))


def _carry_ssm(kernel, observation, state, tc):
    """LGSSM over tc = [t_last, t...] initialised from the carried state."""
    ssm = build_lgssm(kernel, tc)
    if observation is not None:
        H = observation.H(kernel)
        if H.dim() == 3:
            raise ValueError(
                "streaming does not support time-varying observation matrices "
                "(H [T, p, d]: rows tied to a fixed training grid); use the batch model"
            )
        ssm = ssm._replace(H=H)
    return ssm._replace(m0=state.m, P0=state.P)


def _head_mean(model, t, p):
    """The prior mean [B, p] at the heads at times t, or None."""
    if model.mean is None:
        return None
    return head_mean_values(model.mean, t, observation=model.observation, p=p)


class StreamingGP(nn.Module):
    """Online wrapper around the state-space GP inference core.

    The configuration of `StateSpaceGP` (kernel, likelihood, physics heads,
    prior mean, filter-variant flags) but no stored data: observations arrive through
    `update`, forecasts come from `forecast`. `StreamingGP.from_model(ssgp)`
    assimilates an existing model's training data and returns the carried
    state, ready to serve.

    `strict_times` (default on): a segment holding a time BEFORE the previous
    row (or before t_last) NaN-poisons the carried m and lml on the device,
    so stale or out-of-order feeds fail loudly instead of silently applying
    negative-dt transitions.
    """

    def __init__(self, kernel, likelihood, observation=None, mean=None,
                 parallel: bool = False, sqrt: bool = False, chunk_size=None,
                 strict_times: bool = True):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.observation = observation
        self.mean = mean_module(mean)
        self.parallel = parallel
        self.sqrt = sqrt
        self.chunk_size = chunk_size
        self.strict_times = strict_times

    @classmethod
    def from_model(cls, model):
        """Wrap a `StateSpaceGP` and assimilate its training data; returns
        (streaming_gp, state) with the filtered moments at `model.t[-1]`."""
        s = cls(kernel=model.kernel, likelihood=model.likelihood,
                observation=model.observation, mean=model.mean, parallel=model.parallel,
                sqrt=model.sqrt, chunk_size=model.chunk_size)
        state = s.init_state(t0=model.t[0])
        state, _ = s.update(state, model.t, model.Y)
        return s, state

    def init_state(self, t0=0.0) -> StreamState:
        """Fresh state: the stationary prior anchored at time t0. The anchor
        does not matter to a stationary kernel (A P∞ Aᵀ + Q = P∞ for any dt);
        a Wiener-family prior is defined at t0 (its P0), so pass the series'
        true start."""
        return _fresh_state(self.kernel, t0)

    def _segment_inputs(self, state, t, Y):
        """LGSSM over [t_last, t...] with a masked dummy row at t_last, and
        the segment's rows centred on the prior mean μ (returned, or None)."""
        t, tc = _times(state, t)
        B = t.shape[0]
        ssm = _carry_ssm(self.kernel, self.observation, state, tc)
        p = ssm.H.shape[-2]
        R = self.likelihood.R(B + 1, p)
        if R.shape[0] != B + 1:
            # a likelihood that stores per-step covariances over a fixed
            # training grid would misalign the streamed rows
            raise ValueError(
                "StreamingGP requires a likelihood whose R(T, p) is parametric in T: "
                f"requested T={B + 1} rows but got R with leading dim {R.shape[0]}. "
                "Length-tied likelihoods cannot stream; use the batch model."
            )
        corr = None
        if self.observation is not None:
            corr = self.observation.var_correction(self.kernel)
            if corr is not None:
                corr = corr.expand(p)
                R = R + torch.diag(corr)[None]
        Yc = torch.as_tensor(Y, dtype=ssm.m0.dtype, device=ssm.m0.device).expand(B, p)
        mu = _head_mean(self, t, p)
        if mu is not None:
            Yc = Yc - mu
        # the dummy row: all-missing at t_last (a no-op update, lml 0)
        Yc = torch.cat([Yc.new_full((1, p), float("nan")), Yc])
        return ssm, R, Yc, mu, corr, tc

    def update(self, state: StreamState, t, Y):
        """Assimilate a segment of observations at or after t_last.

        t: [B] sorted times (dt = 0 rows are exact identity transitions);
        Y: [B, p], NaN = missing (a fixed-size serving loop pads with NaN
        rows). Returns the advanced state and the segment's filtered moments
        and lml increment."""
        ssm, R, Yc, mu, corr, tc = self._segment_inputs(state, t, Y)
        f = run_filter(ssm, R, Yc, parallel=self.parallel, sqrt=self.sqrt,
                       chunk_size=self.chunk_size)[0]
        ms, Ps = f.ms[1:], f.Ps[1:]
        f_mean = project_mean(ssm.H, ms)
        f_var = project_var(ssm.H, Ps)
        if mu is not None:
            f_mean = f_mean + mu
        if corr is not None:
            f_var = f_var + corr
        lml_inc = f.lml
        m_last = ms[-1]
        if self.strict_times:
            bad = _time_poison(tc, m_last.dtype)
            m_last = m_last + bad
            lml_inc = lml_inc + bad
        new_state = StreamState(m=m_last, P=Ps[-1], t_last=tc[-1].to(ms.dtype),
                                lml=state.lml + lml_inc)
        return new_state, SegmentResult(f_mean=f_mean, f_var=f_var, lml=lml_inc)

    def forecast(self, state: StreamState, t) -> GaussianMoments:
        """Predictive head moments at future times t (no assimilation): past
        all assimilated data the smoothed, filtered and predicted posteriors
        coincide, so this is `StateSpaceGP.predict_f` on the whole series."""
        t = torch.as_tensor(t, device=state.m.device).reshape(-1)
        p = self.observation.H(self.kernel).shape[-2] if self.observation is not None else 1
        Y = state.m.new_full((t.shape[0], p), float("nan"))
        _, seg = self.update(state, t, Y)
        return GaussianMoments(mean=seg.f_mean, var=seg.f_var)

    def predict_y(self, state: StreamState, t) -> GaussianMoments:
        """Observation-space forecast: latent moments plus observation noise."""
        t = torch.as_tensor(t, device=state.m.device).reshape(-1)
        f = self.forecast(state, t)
        p = f.mean.shape[-1]
        R = self.likelihood.R(t.shape[0], p)
        if R.shape[0] != t.shape[0]:
            raise ValueError(
                "StreamingGP.predict_y requires a T-parametric likelihood.R "
                f"(requested {t.shape[0]} rows, got {R.shape[0]}); see StreamingGP.update."
            )
        return GaussianMoments(mean=f.mean, var=f.var + torch.diagonal(R, dim1=-2, dim2=-1))


class StreamingCVI(nn.Module):
    """Online CVI: assimilate NON-GAUSSIAN observation segments in O(segment).

    The carried filtered state of the conjugate surrogate is the prior of
    each new segment, on which `n_iters` natural-gradient site steps run;
    past sites are never revisited. With a conjugate Gaussian likelihood and
    lr = 1 the sites reach their exact fixed point, so the segment ELBOs sum
    to the batch lml and the carry equals the batch filter state; otherwise
    this is the standard online approximation.
    """

    def __init__(self, kernel, likelihood, observation=None, mean=None,
                 parallel: bool = False, sqrt: bool = False, chunk_size=None,
                 n_iters: int = 8, lr: float = 0.5, hessian: str = "exact",
                 strict_times: bool = True):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.observation = observation
        self.mean = mean_module(mean)
        self.parallel = parallel
        self.sqrt = sqrt
        self.chunk_size = chunk_size
        self.n_iters = n_iters
        self.lr = lr
        self.hessian = hessian
        self.strict_times = strict_times  # see StreamingGP

    def _segment_likelihood(self, B: int):
        """The likelihood of one segment, with the dummy carry row excluded
        from any nonlinear-residual term (`residual_mask` [0, 1, ..., 1]):
        that row is the previous segment's last data row, whose residual was
        already counted there."""
        lik = self.likelihood
        if getattr(lik, "residual", None) is None:
            return lik
        rm = lik.residual_mask
        like = _like(self.kernel)
        if rm is None:
            rm = torch.ones(B, dtype=like.dtype, device=like.device)
        else:
            rm = torch.as_tensor(rm, device=like.device).reshape(-1)
            if rm.shape[0] != B:
                raise ValueError(
                    "StreamingCVI: likelihood.residual_mask must cover one segment "
                    f"({B} rows), got {rm.shape[0]}. Supply the per-segment mask "
                    "(the dummy carry row is added internally)."
                )
        seg = copy.copy(lik)  # shares the parameters; its own buffer table
        if isinstance(seg, nn.Module):
            seg._buffers = dict(lik._buffers)
        seg.residual_mask = torch.cat([rm.new_zeros(1), rm])
        return seg

    def init_state(self, t0=0.0) -> StreamState:
        """Fresh state: the stationary prior anchored at t0. `lml` accumulates
        the segment ELBO increments, each a lower bound on log p(y_seg | past)."""
        return _fresh_state(self.kernel, t0)

    def update(self, state: StreamState, t, Y, generator=None, draws=None):
        """Assimilate one segment. Returns (state', segment_model), the
        fitted `CVIGP` over [t_last, t...] (its `posterior()` / `predict_y`
        read within the segment; row 0 is the carry row). A Monte-Carlo
        likelihood draws fresh noise from `generator` at each iteration;
        `draws` [n_mc, B + 1, p] are used at every iteration instead, and
        with neither every iteration uses the frozen seed's draws."""
        check_generator(generator)
        t, tc = _times(state, t)
        B = t.shape[0]
        Y = torch.as_tensor(Y, dtype=state.m.dtype, device=state.m.device)
        p = self.observation.H(self.kernel).shape[-2] if self.observation is not None else Y.shape[-1]
        Yc = torch.cat([Y.new_full((1, p), float("nan")), Y.expand(B, p)])
        cvi = CVIGP.init(
            tc, Yc, self.kernel, self._segment_likelihood(B), observation=self.observation,
            mean=self.mean, parallel=self.parallel, sqrt=self.sqrt, chunk_size=self.chunk_size,
            init_state=(state.m, state.P),
        )
        # the carry row at t_last stays site-free
        site_Y = cvi.sites.Y.clone()
        site_Y[0] = float("nan")
        cvi.sites = Sites(site_Y, cvi.sites.V)
        elbo = state.m.new_zeros(())
        for _ in range(self.n_iters):
            cvi, elbo = cvi.step_with_elbo(self.lr, hessian=self.hessian, generator=generator,
                                           draws=draws)
        # the carry: the surrogate's filtered state under the final sites
        ssm = _carry_ssm(self.kernel, self.observation, state, tc)
        with torch.no_grad():
            f = run_filter(ssm, cvi.sites.V, cvi.sites.Y, parallel=self.parallel,
                           sqrt=self.sqrt, chunk_size=self.chunk_size)[0]
        m_last = f.ms[-1]
        if self.strict_times:
            bad = _time_poison(tc, m_last.dtype)
            m_last = m_last + bad
            elbo = elbo + bad
        new_state = StreamState(m=m_last, P=f.Ps[-1], t_last=tc[-1].to(f.ms.dtype),
                                lml=state.lml + elbo)
        return new_state, cvi

    @torch.no_grad()
    def forecast(self, state: StreamState, t) -> GaussianMoments:
        """Latent head moments at future times from the carried state (prior
        propagation: no sites past t_last)."""
        t, tc = _times(state, t)
        ssm = _carry_ssm(self.kernel, self.observation, state, tc)
        p = ssm.H.shape[-2]
        n = tc.shape[0]
        R = torch.eye(p, dtype=state.m.dtype, device=state.m.device).expand(n, p, p)
        Y = state.m.new_full((n, p), float("nan"))
        f = run_filter(ssm, R, Y, parallel=self.parallel, sqrt=self.sqrt,
                       chunk_size=self.chunk_size)[0]
        mean = project_mean(ssm.H, f.ms[1:])
        var = project_var(ssm.H, f.Ps[1:])
        mu = _head_mean(self, t, p)
        if mu is not None:
            mean = mean + mu
        if self.observation is not None:
            corr = self.observation.var_correction(self.kernel)
            if corr is not None:
                var = var + corr.expand(p)
        return GaussianMoments(mean=mean, var=var)

"""Zoo: spatio-temporal model recipes (PyTorch counterpart of
`physs_gp_tpu/zoo/spatio_temporal.py`).

- `st_gp`: Kronecker spatio-temporal GP regression on gridded sensor data
  (BASELINE config 4).
- `advection_diffusion_gp`: physics-informed ST GP for the linear PDE
  ∂t f = a Δf - v·∇f, enforced at spatial collocation points at every time
  step (BASELINE config 5: `build_config5`'s geometry, as a
  `SpatioTemporalGP`).
- `sparse_st_gp`: data at fixed sites read through Ms inducing sites Z
  (optionally trainable), with the conditional-variance residual in the
  noise.
- `scattered_st_gp` / `scattered_st_predict`: raw scattered sensor rows
  (t, s, y) grouped by time and read through a time-varying spatial
  conditional (`ScatteredSpatialHead`), and the posterior at new rows.

Every recipe builds on `device` (the card unless the caller asks for the
CPU) in `dtype` (float64 by default, as in the JAX package).
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.spatiotemporal import TemporallyGroupedData
from ..kernels.matern import Matern32
from ..kernels.rbf import RBF
from ..kernels.spatio_temporal import SpatioTemporalKernel
from ..likelihoods.gaussian import IndependentGaussian, SharedVariance
from ..models.ssgp import GaussianMoments, StateSpaceGP
from ..models.stgp import SpatioTemporalGP
from ..transforms.operators import (OperatorTerm, ScatteredSpatialHead, SpatialHead,
                                    StateObservation, STOperatorHead, s_grad, s_laplacian)
from ..utils.params import NegParam, Param, param, positive_param
from ..utils.shapes import as_points

__all__ = ["st_gp", "advection_diffusion_gp", "sparse_st_gp", "scattered_st_gp",
           "scattered_st_predict"]


def _param(v, fixed=False, **kw):
    if isinstance(v, Param):
        return v
    p = positive_param(v, **kw)
    return p.fix() if fixed else p


def _kernels(k_time, k_space, Z, kw):
    return SpatioTemporalKernel(
        k_time=k_time or Matern32(lengthscale=1.0, variance=1.0, **kw),
        k_space=k_space or RBF(lengthscales=positive_param(1.0, **kw),
                               variance=positive_param(1.0, **kw)),
        Z=Z,
    )


def _grid_gaussian(noise, Ns, extra=(), **kw):
    """IndependentGaussian with one TIED variance across the Ns grid heads (a
    `SharedVariance` group: one trainable parameter) plus a fixed variance
    per extra head."""
    return IndependentGaussian(
        variances=[SharedVariance(p=_param(noise, **kw), n=Ns)]
        + [_param(v, fixed=True, **kw) for v in extra]
    )


def st_gp(t, Y_grid, Z, k_time=None, k_space=None, noise: float = 0.1,
          dtype=torch.float64, parallel: bool = False, sqrt: bool = False,
          chunk_size=None, device="cuda") -> SpatioTemporalGP:
    """Separable ST GP on a time x sites grid (NaN = missing)."""
    kw = dict(dtype=dtype, device=device)
    Z = as_points(Z, **kw)
    kern = _kernels(k_time, k_space, Z, kw)
    return SpatioTemporalGP.build(
        t=torch.as_tensor(t, **kw), Y_grid=torch.as_tensor(Y_grid, **kw), st_kernel=kern,
        likelihood=_grid_gaussian(noise, Z.shape[0], **kw), parallel=parallel, sqrt=sqrt,
        chunk_size=chunk_size,
    )


def advection_diffusion_gp(t, Y_grid, Z, coll_points, diffusivity, velocity=None,
                           k_time=None, k_space=None, noise: float = 0.1,
                           coll_noise: float = 1e-4, dtype=torch.float64,
                           parallel: bool = False, sqrt: bool = False, chunk_size=None,
                           device="cuda") -> SpatioTemporalGP:
    """Physics-informed ST GP: ∂t f - a Δf + v·∇f = 0 at `coll_points`.

    The diffusivity and the velocity components may be trainable Params
    (unknown physics); a Param diffusivity enters as its `NegParam`. The
    residual rows are exact linear functionals of the Kron state, so every
    scan stays exact.
    """
    kw = dict(dtype=dtype, device=device)
    Z = as_points(Z, **kw)
    coll_points = as_points(coll_points, **kw)
    kern = _kernels(k_time, k_space, Z, kw)
    a = diffusivity
    terms = [
        OperatorTerm(coeff=1.0, t_order=1),
        OperatorTerm(coeff=NegParam(base=a) if isinstance(a, Param) else -a, s_op=s_laplacian),
    ]
    if velocity is not None:
        for i in range(Z.shape[1]):
            terms.append(OperatorTerm(coeff=velocity[i], s_op=s_grad(i)))
    head = STOperatorHead(points=coll_points, terms=terms)
    t = torch.as_tensor(t, **kw)
    Nc = coll_points.shape[0]
    return SpatioTemporalGP.build(
        t=t, Y_grid=torch.as_tensor(Y_grid, **kw), st_kernel=kern,
        likelihood=_grid_gaussian(noise, Z.shape[0], extra=[coll_noise] * Nc, **kw),
        extra_heads=[head], extra_Y=torch.zeros((t.shape[0], Nc), **kw),
        parallel=parallel, sqrt=sqrt, chunk_size=chunk_size,
    )


def sparse_st_gp(t, Y, X_space, Z, k_time=None, k_space=None, noise: float = 0.1,
                 dtype=torch.float64, train_z: bool = True, parallel: bool = False,
                 sqrt: bool = False, chunk_size=None, device="cuda") -> StateSpaceGP:
    """Spatially sparse ST GP: data at X_space [Nd, ds], the state carried
    by Ms << Nd inducing sites Z. Observations read the state through the
    spatial conditional w = K_xZ K_ZZ^-1 with the conditional-variance
    residual folded into the noise (the exact DTC-style sparse marginal).
    `train_z=True` makes Z a Param, moved by optimisers jointly with the
    hyperparameters."""
    kw = dict(dtype=dtype, device=device)
    X_space = as_points(X_space, **kw)
    Z = as_points(Z, **kw)
    kern = _kernels(k_time, k_space, param(Z) if train_z else Z, kw)
    return StateSpaceGP(
        t=torch.as_tensor(np.ravel(t), **kw), Y=torch.as_tensor(Y, **kw), kernel=kern,
        likelihood=_grid_gaussian(noise, X_space.shape[0], **kw),
        observation=StateObservation([SpatialHead(points=X_space, correction=True)]),
        parallel=parallel, sqrt=sqrt, chunk_size=chunk_size,
    )


def scattered_st_gp(X, Y, Z=None, n_inducing: int | None = None, k_time=None, k_space=None,
                    noise: float = 0.1, dtype=torch.float64, train_z: bool = False,
                    parallel: bool = False, sqrt: bool = False, chunk_size=None,
                    device="cuda"):
    """Raw scattered sensor rows (t, s, y) end to end (BASELINE config 4):
    rows grouped by time (`TemporallyGroupedData`), ragged groups padded,
    each step's points read through a time-varying spatial conditional
    (`ScatteredSpatialHead`). Returns (model, data); `data.unsort(...)` maps
    grid-shaped posteriors back to the input rows.

    Z defaults to the k-means centres of the spatial points
    (`scipy.cluster.vq.kmeans2`, seed 0) when `n_inducing` is given and
    smaller than the row count, else to all unique points. k-means results
    may differ between scipy versions: pass Z to pin it."""
    kw = dict(dtype=dtype, device=device)
    data = TemporallyGroupedData.from_scattered(np.asarray(X), np.asarray(Y))
    if data.P > 1:
        raise ValueError(
            "scattered_st_gp supports single-output data only "
            f"(got P={data.P}): ScatteredSpatialHead emits Ng observation rows per step. "
            "Model each output column as its own scattered_st_gp."
        )
    if Z is None:
        pts = np.asarray(X)[:, 1:]
        if n_inducing is not None and n_inducing < pts.shape[0]:
            from scipy.cluster.vq import kmeans2

            Z = kmeans2(pts, n_inducing, minit="points", seed=0)[0]
        else:
            Z = np.unique(pts, axis=0)
    Z = as_points(Z, **kw)
    kern = _kernels(k_time, k_space, param(Z) if train_z else Z, kw)
    model = StateSpaceGP(
        t=torch.as_tensor(data.t, **kw), Y=torch.as_tensor(data.Y_flat, **kw), kernel=kern,
        likelihood=_grid_gaussian(noise, data.Ng * data.P, **kw),
        observation=StateObservation([ScatteredSpatialHead(torch.as_tensor(data.X_st, **kw))]),
        parallel=parallel, sqrt=sqrt, chunk_size=chunk_size,
    )
    return model, data


def scattered_st_predict(model, data, X_query) -> GaussianMoments:
    """Posterior q(f) at arbitrary scattered (t, s...) query rows for a
    `scattered_st_gp` model: the grouped grid is rebuilt over the training
    and query rows (query Y = NaN) and smoothed again, by a new
    `StateSpaceGP` that shares the model's kernel and its tied noise
    parameter. Returns one row per query, [nq, P]."""
    X_query = np.atleast_2d(np.asarray(X_query))
    nq, P = X_query.shape[0], data.P
    d2 = TemporallyGroupedData.from_scattered(
        np.vstack([data.X_raw, X_query]), np.vstack([data.Y_raw, np.full((nq, P), np.nan)]))
    kw = dict(dtype=model.t.dtype, device=model.t.device)
    head0 = model.observation.heads[0]
    v0 = model.likelihood.variances[0]
    m2 = StateSpaceGP(
        t=torch.as_tensor(d2.t, **kw), Y=torch.as_tensor(d2.Y_flat, **kw), kernel=model.kernel,
        likelihood=IndependentGaussian([SharedVariance(p=getattr(v0, "p", v0), n=d2.Ng * P)]),
        observation=StateObservation([ScatteredSpatialHead(
            torch.as_tensor(d2.X_st, **kw), t_order=head0.t_order, s_op=head0.s_op,
            correction=head0.correction)]),
        parallel=model.parallel, sqrt=model.sqrt, chunk_size=model.chunk_size,
    )
    post = m2.posterior()
    return GaussianMoments(mean=d2.unsort(post.mean)[-nq:], var=d2.unsort(post.var)[-nq:])

"""Zoo: spatio-temporal model recipes (PyTorch counterpart of the gridded
recipes of `physs_gp_tpu/zoo/spatio_temporal.py`).

- `st_gp`: Kronecker spatio-temporal GP regression on gridded sensor data
  (BASELINE config 4).
- `advection_diffusion_gp`: physics-informed ST GP for the linear PDE
  ∂t f = a Δf - v·∇f, enforced at spatial collocation points at every time
  step (BASELINE config 5: `build_config5`'s geometry, as a
  `SpatioTemporalGP`).

Both build on `device` (the card unless the caller asks for the CPU) in
`dtype` (float64 by default, as in the JAX package). The sparse and
scattered recipes wait for `ScatteredSpatialHead`.
"""
from __future__ import annotations

import torch

from ..kernels.matern import Matern32
from ..kernels.rbf import RBF
from ..kernels.spatio_temporal import SpatioTemporalKernel
from ..likelihoods.gaussian import IndependentGaussian, SharedVariance
from ..models.stgp import SpatioTemporalGP
from ..transforms.operators import OperatorTerm, STOperatorHead, s_grad, s_laplacian
from ..utils.params import NegParam, Param, positive_param
from ..utils.shapes import as_points

__all__ = ["st_gp", "advection_diffusion_gp"]


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

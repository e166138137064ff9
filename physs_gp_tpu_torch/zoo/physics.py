"""Zoo: one-call constructors for physics-informed models (PyTorch
counterpart of `physs_gp_tpu/zoo/physics.py`).

- `ode_gp`: exact conjugate physics-informed GP: a data head and a linear
  ODE residual head observed as 0 at collocation times, through one Kalman
  smoother (BASELINE config 3: the damped oscillator).
- `monotonic_cvi_gp`: CVI model with a Probit head on f' enforcing
  monotonicity.
- `nonlinear_ode_cvi_gp`: CVI model with a nonlinear ODE residual (the
  pendulum's sin f) through the Monte-Carlo expected log-likelihood.
- `allen_cahn_gp`: the spatio-temporal Allen-Cahn CVI model: the linear part
  of the PDE as exact operator rows, u - u³ through the Monte-Carlo residual.

Each builds on `device` (the card unless the caller asks for the CPU) in
`dtype` (float64 by default, as in the JAX package). Residual functions are
written with torch operations.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.grids import merge_time_grids
from ..kernels.matern import Matern32, Matern72
from ..kernels.rbf import RBF
from ..kernels.spatio_temporal import SpatioTemporalKernel
from ..likelihoods.composite import CompositeLikelihood, NonlinearResidual
from ..likelihoods.gaussian import Gaussian, IndependentGaussian
from ..likelihoods.nongaussian import Probit
from ..models.cvi_gp import CVIGP
from ..models.ssgp import StateSpaceGP
from ..transforms.operators import (
    DerivativeHead,
    LinearOperatorHead,
    OperatorTerm,
    SpatialHead,
    StateObservation,
    STOperatorHead,
    ValueHead,
    s_laplacian,
)
from ..utils.params import NegParam, Param, positive_param
from ..utils.shapes import as_points

__all__ = ["ode_gp", "monotonic_cvi_gp", "nonlinear_ode_cvi_gp", "allen_cahn_gp"]


def _param(v, fixed=False, **kw):
    if isinstance(v, Param):
        return v
    p = positive_param(v, **kw)
    return p.fix() if fixed else p


def ode_gp(t_data, y_data, t_coll, ode_coeffs, kernel=None, noise: float = 0.1,
           coll_noise: float = 1e-4, dtype=torch.float64, parallel: bool = False,
           chunk_size=None, device="cuda") -> StateSpaceGP:
    """Physics-informed GP for a linear ODE sum_k c_k f^(k) = 0 (coefficients
    numbers or trainable Params), pseudo-observed as 0 at `t_coll` with the
    fixed variance `coll_noise`; exact conjugate inference."""
    kw = dict(dtype=dtype, device=device)
    kernel = kernel or Matern72(lengthscale=1.0, variance=1.0, **kw)
    t_all, Y = merge_time_grids((t_data, y_data), (t_coll, np.zeros(np.asarray(t_coll).size)))
    obs = StateObservation(heads=[ValueHead(), LinearOperatorHead(coeffs=list(ode_coeffs))])
    lik = IndependentGaussian(variances=[_param(noise, **kw), _param(coll_noise, fixed=True, **kw)])
    return StateSpaceGP(t=torch.as_tensor(t_all, **kw), Y=torch.as_tensor(Y, **kw), kernel=kernel,
                        likelihood=lik, observation=obs, parallel=parallel, chunk_size=chunk_size)


def monotonic_cvi_gp(t_data, y_data, t_coll, kernel=None, noise: float = 0.1,
                     probit_nu: float = 1e-2, dtype=torch.float64, parallel: bool = False,
                     chunk_size=None, constrained: bool = True, device="cuda") -> CVIGP:
    """Monotonic GP: a data head and a Probit head on f' >= 0 at the
    collocation times. `constrained=False` keeps the same model with every
    probit pseudo-observation masked to NaN (the unconstrained baseline)."""
    kw = dict(dtype=dtype, device=device)
    kernel = kernel or Matern72(lengthscale=1.0, variance=1.0, **kw)
    n_coll = np.asarray(t_coll).size
    probit_obs = np.ones(n_coll) if constrained else np.full(n_coll, np.nan)
    t_all, Y = merge_time_grids((t_data, y_data), (t_coll, probit_obs))
    obs = StateObservation(heads=[ValueHead(), DerivativeHead(order=1)])
    lik = CompositeLikelihood(heads=[Gaussian(variance=_param(noise, **kw)), Probit(nu=probit_nu)])
    return CVIGP.init(t=torch.as_tensor(t_all, **kw), Y=torch.as_tensor(Y, **kw), kernel=kernel,
                      likelihood=lik, observation=obs, parallel=parallel, chunk_size=chunk_size)


def nonlinear_ode_cvi_gp(t_data, y_data, t_coll, residual_fn, n_heads: int, kernel=None,
                         noise: float = 0.1, coll_noise: float = 1e-3, n_mc: int = 32,
                         dtype=torch.float64, parallel: bool = False, chunk_size=None,
                         device="cuda") -> CVIGP:
    """CVI model with a nonlinear ODE residual g(f, f', ...) = 0 enforced at
    `t_coll`; residual_fn maps head samples [..., n_heads] to [...], the
    heads being (f, f', ..., f^(n_heads - 1)), e.g. the damped pendulum
    f'' + c f' + w^2 sin(f)."""
    kw = dict(dtype=dtype, device=device)
    kernel = kernel or Matern72(lengthscale=1.0, variance=1.0, **kw)
    t_np = np.asarray(t_data).ravel()
    tc_np = np.asarray(t_coll).ravel()
    # the derivative heads are never observed directly: their columns are
    # NaN, and the collocation times join the grid as NaN rows
    series = [(t_np, np.asarray(y_data).ravel())]
    series += [(tc_np, np.full(tc_np.size, np.nan))] * (n_heads - 1)
    t_all, Y = merge_time_grids(*series)
    coll_mask = torch.as_tensor(np.isin(t_all, tc_np).astype(np.float64), **kw)
    obs = StateObservation(
        heads=[ValueHead()] + [DerivativeHead(order=k) for k in range(1, n_heads)]
    )
    # placeholder Gaussians on the all-NaN derivative columns: they add
    # nothing to the ELL and enter only through the residual
    lik = CompositeLikelihood(
        heads=[Gaussian(variance=_param(noise, **kw))]
        + [Gaussian(variance=_param(1.0, fixed=True, **kw)) for _ in range(n_heads - 1)],
        residual=NonlinearResidual(noise_var=_param(coll_noise, fixed=True, **kw), fn=residual_fn,
                                   n_mc=n_mc),
        residual_mask=coll_mask,
    )
    return CVIGP.init(t=torch.as_tensor(t_all, **kw), Y=torch.as_tensor(Y, **kw), kernel=kernel,
                      likelihood=lik, observation=obs, parallel=parallel, chunk_size=chunk_size)


def allen_cahn_gp(t, Y_grid, Z, coll_points, epsilon: float = 1e-2, k_time=None, k_space=None,
                  noise: float = 1e-2, coll_noise: float = 1e-3, n_mc: int = 32,
                  dtype=torch.float64, parallel: bool = False, sqrt: bool = False,
                  chunk_size=None, site_var: float = 1.0, device="cuda") -> CVIGP:
    """Physics-informed spatio-temporal CVI model for Allen-Cahn,
    ∂t u = ε Δu + u - u³.

    Heads: [Ns grid values | Nc collocation values | Nc linear rows
    ∂t u - ε Δu]; the residual lin_c - u_c + u_c³ -> 0 runs through the
    Monte-Carlo ELL over the joint block posterior, with sites active on
    every head at every step.
    """
    kw = dict(dtype=dtype, device=device)
    Z = as_points(Z, **kw)
    coll = as_points(coll_points, **kw)
    Ns, Nc = Z.shape[0], coll.shape[0]
    T = np.asarray(t).shape[0]
    kern = SpatioTemporalKernel(
        k_time=k_time or Matern32(lengthscale=1.0, variance=1.0, **kw),
        k_space=k_space or RBF(lengthscales=positive_param(1.0, **kw),
                               variance=positive_param(1.0, **kw)),
        Z=Z,
    )
    neg_eps = NegParam(base=epsilon) if isinstance(epsilon, Param) else -epsilon
    obs = StateObservation(heads=[
        SpatialHead(points=Z),
        SpatialHead(points=coll),
        STOperatorHead(points=coll, terms=[
            OperatorTerm(coeff=1.0, t_order=1),
            OperatorTerm(coeff=neg_eps, s_op=s_laplacian),
        ]),
    ])
    Y = torch.cat([torch.as_tensor(Y_grid, **kw), torch.full((T, 2 * Nc), float("nan"), **kw)], 1)

    def residual(f):
        u_c = f[..., Ns:Ns + Nc]
        lin_c = f[..., Ns + Nc:]
        return lin_c - u_c + u_c**3

    lik = CompositeLikelihood(
        heads=[Gaussian(variance=_param(noise, **kw)) for _ in range(Ns)]
        + [Gaussian(variance=_param(1.0, fixed=True, **kw)) for _ in range(2 * Nc)],
        residual=NonlinearResidual(noise_var=_param(coll_noise, fixed=True, **kw), fn=residual,
                                   n_mc=n_mc),
    )
    return CVIGP.init(t=torch.as_tensor(np.ravel(t), **kw), Y=Y, kernel=kern, likelihood=lik,
                      observation=obs, parallel=parallel, sqrt=sqrt, chunk_size=chunk_size,
                      site_var=site_var)

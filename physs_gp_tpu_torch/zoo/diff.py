"""Derivative-observation GP recipes (PyTorch counterpart of
`physs_gp_tpu/zoo/diff.py`): one latent f observed jointly with its
derivatives, Y columns [f, ∂t f ..., ∂s f ...].

- batch (`deriv_gp`, `deriv_vgp`): one autodiff `DerivativeKernel` over the
  base kernel's scalar form (a Matérn base uses its closed forms);
- temporal state space (`deriv_sde_gp`): time derivatives read off the
  Markov state (`DerivativeHead` rows);
- spatio-temporal state space (`deriv_st_gp`): temporal orders off the
  state, spatial orders through the spatial conditional at the sites
  (`SpatialHead(s_op=...)`), optionally at inducing sites `Zs`.

The derivative-order spec follows the reference's ints: k -> orders 1..k,
-2 -> second order only, None / 0 -> none. Every recipe builds on `device`
(the card unless the caller asks for the CPU) in `dtype`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.params import positive_param

__all__ = ["deriv_gp", "deriv_vgp", "deriv_sde_gp", "deriv_st_gp", "diff_orders"]


def diff_orders(n) -> tuple:
    """The reference's diff spec -> a tuple of derivative orders."""
    if not n:
        return ()
    if n == -2:
        return (2,)
    if n < 0:
        raise ValueError(f"unsupported diff spec {n}; use k >= 0 or -2")
    return tuple(range(1, n + 1))


def _param(v, fixed, kw):
    p = positive_param(v, **kw)
    return p.fix() if fixed else p


def _noise_list(noise, n_blocks, fixed, kw):
    vs = noise if isinstance(noise, (list, tuple)) else [noise] * n_blocks
    if len(vs) != n_blocks:
        raise ValueError(f"noise list has {len(vs)} entries; expected {n_blocks}")
    return [_param(v, fixed, kw) for v in vs]


def _as_col(A, kw):
    """1-D point arrays are columns (N points in 1-D)."""
    A = np.asarray(A, float)
    if A.ndim == 1:
        A = A[:, None]
    return torch.as_tensor(A, **kw)


def _batch_deriv_parts(X, Y, time_diff, space_diff, kernel, kw):
    """Inputs, op list and joint kernel shared by deriv_gp and deriv_vgp."""
    from ..kernels.derivative import DerivativeKernel
    from ..kernels.rbf import RBF

    X = _as_col(X, kw)
    D = X.shape[1]
    ops = [()] + [(0,) * o for o in diff_orders(time_diff)]
    for i in range(1, D):
        ops += [(i,) * o for o in diff_orders(space_diff)]
    kernel = kernel or RBF(lengthscales=positive_param(torch.ones(D), **kw),
                           variance=positive_param(1.0, **kw))
    Y = torch.as_tensor(Y, **kw)
    if Y.shape[1] != len(ops):
        raise ValueError(
            f"Y has {Y.shape[1]} columns; the diff spec produces {len(ops)} "
            f"outputs [f, {len(diff_orders(time_diff))} time orders, "
            f"{D - 1} spatial dims x "
            f"{len(diff_orders(space_diff)) if D > 1 else 0} orders]"
        )
    return X, Y, DerivativeKernel(base=kernel, ops=tuple(ops)), ops


def deriv_gp(X, Y, time_diff=1, space_diff=1, kernel=None, noise=0.1, fix_noise: bool = False,
             dtype=torch.float64, device="cuda"):
    """Batch GP observing [f, ∂t^o f ..., ∂_i^o f ...]: X [N, D] (column 0
    is time; D == 1 is temporal only), Y [N, P] data-major with P = 1 +
    |time orders| + (D-1)·|space orders| columns in that order (NaN =
    missing)."""
    from ..likelihoods.gaussian import IndependentGaussian
    from ..models.batch_gp import BatchGP

    kw = dict(dtype=dtype, device=device)
    X, Y, kern, ops = _batch_deriv_parts(X, Y, time_diff, space_diff, kernel, kw)
    lik = IndependentGaussian(_noise_list(noise, len(ops), fix_noise, kw))
    return BatchGP(X, Y, kern, lik, **kw)


def deriv_vgp(X, Y, time_diff=1, space_diff=1, kernel=None, Z=None, liks=None, noise=0.1,
              fix_noise: bool = False, whiten: bool = True, dtype=torch.float64, device="cuda"):
    """Variational batch derivative GP: free-form q(u) at the inducing inputs
    `Z` (None: X) over `deriv_gp`'s joint derivative prior, with one
    likelihood per output column (`liks`; None: Gaussians with `noise`),
    e.g. a Gaussian data head beside a `Probit` monotonicity head."""
    from ..likelihoods.gaussian import Gaussian
    from ..likelihoods.nongaussian import PerOutputLikelihood
    from ..models.svgp import SVGP

    kw = dict(dtype=dtype, device=device)
    X, Y, kern, ops = _batch_deriv_parts(X, Y, time_diff, space_diff, kernel, kw)
    if liks is None:
        liks = [Gaussian(variance=p) for p in _noise_list(noise, len(ops), fix_noise, kw)]
    if len(liks) != len(ops):
        raise ValueError(f"liks has {len(liks)} entries; expected {len(ops)}")
    Z = X if Z is None else _as_col(Z, kw)
    if Z.shape[1] != X.shape[1]:
        raise ValueError(f"Z has {Z.shape[1]} input dims; X has {X.shape[1]}")
    return SVGP.init(X, Y, Z, kern, PerOutputLikelihood(liks), whiten=whiten, **kw)


def _state_space_model(t, Y, kernel, lik, obs, parallel, sqrt, chunk_size, cvi, kw):
    from ..models.cvi_gp import CVIGP
    from ..models.ssgp import StateSpaceGP

    t = torch.as_tensor(t, **kw)
    if cvi:
        return CVIGP.init(t, Y, kernel, lik, observation=obs, parallel=parallel, sqrt=sqrt,
                          chunk_size=chunk_size)
    return StateSpaceGP(t=t, Y=Y, kernel=kernel, likelihood=lik, observation=obs,
                        parallel=parallel, sqrt=sqrt, chunk_size=chunk_size)


def deriv_sde_gp(t, Y, time_diff=1, kernel=None, noise=0.1, fix_noise: bool = False,
                 dtype=torch.float64, parallel: bool = False, sqrt: bool = False,
                 chunk_size=None, cvi: bool = False, device="cuda"):
    """Temporal state-space derivative GP: Y columns [f, f^(o) ...] read off
    the Markov state, exact and O(T). The kernel's state must hold the
    orders (Matérn p >= the highest). `cvi=True` returns the CVI model."""
    from ..kernels.matern import Matern72
    from ..likelihoods.gaussian import IndependentGaussian
    from ..transforms.operators import DerivativeHead, StateObservation, ValueHead

    kw = dict(dtype=dtype, device=device)
    orders = diff_orders(time_diff)
    kernel = kernel or Matern72(lengthscale=1.0, variance=1.0, **kw)
    heads = [ValueHead()] + [DerivativeHead(order=o) for o in orders]
    Y = torch.as_tensor(Y, **kw)
    if Y.shape[1] != len(heads):
        raise ValueError(f"Y has {Y.shape[1]} columns; expected {len(heads)} "
                         f"([f] + orders {orders})")
    lik = IndependentGaussian(_noise_list(noise, len(heads), fix_noise, kw))
    return _state_space_model(t, Y, kernel, lik, StateObservation(heads), parallel, sqrt,
                              chunk_size, cvi, kw)


def deriv_st_gp(t, Y, Z, time_diff=1, space_diff=1, k_time=None, k_space=None, Zs=None,
                noise=0.1, fix_noise: bool = False, dtype=torch.float64, parallel: bool = False,
                sqrt: bool = False, chunk_size=None, cvi: bool = False, device="cuda"):
    """Spatio-temporal hierarchical derivative GP: t [T] sorted times, Z
    [Ns, ds] spatial sites, Y [T, n_blocks·Ns] with column blocks [f(Z),
    ∂t^o f(Z) ..., ∂_i^o f(Z) ... per spatial dim] (NaN = missing). `Zs`
    [M, ds]: inducing sites other than the data sites (the state lives on
    Zs and every head adds the off-site variance correction)."""
    from ..kernels.matern import Matern32
    from ..kernels.rbf import RBF
    from ..kernels.spatio_temporal import SpatioTemporalKernel
    from ..likelihoods.gaussian import IndependentGaussian, SharedVariance
    from ..transforms.operators import SpatialHead, StateObservation, s_grad, s_grad2

    kw = dict(dtype=dtype, device=device)
    Z = _as_col(Z, kw)
    Ns, ds = Z.shape
    t_orders = diff_orders(time_diff)
    s_orders = diff_orders(space_diff)
    if any(o > 2 for o in s_orders):
        raise ValueError("spatial orders above 2 are not implemented")
    sparse = Zs is not None
    if sparse:
        Zs = _as_col(Zs, kw)
        if Zs.shape[1] != ds:
            raise ValueError(f"Zs has {Zs.shape[1]} spatial dims; Z has {ds}")
    kern = SpatioTemporalKernel(
        k_time=k_time or Matern32(lengthscale=1.0, variance=1.0, **kw),
        k_space=k_space or RBF(lengthscales=positive_param(torch.ones(ds), **kw),
                               variance=positive_param(1.0, **kw)),
        Z=Zs if sparse else Z,
    )

    def sh(t_order=0, s_op=None):
        return SpatialHead(points=Z, t_order=t_order, s_op=s_op, correction=sparse)

    heads = [sh()] + [sh(t_order=o) for o in t_orders]
    for i in range(ds):
        heads += [sh(s_op=s_grad(i) if o == 1 else s_grad2(i)) for o in s_orders]
    Y = torch.as_tensor(Y, **kw)
    if Y.shape[1] != len(heads) * Ns:
        raise ValueError(
            f"Y has {Y.shape[1]} columns; expected {len(heads)}*Ns = "
            f"{len(heads) * Ns} ([f, {len(t_orders)} time orders, "
            f"{ds} dims x {len(s_orders)} space orders] site blocks)"
        )
    lik = IndependentGaussian([SharedVariance(p=p, n=Ns)
                               for p in _noise_list(noise, len(heads), fix_noise, kw)])
    return _state_space_model(t, Y, kern, lik, StateObservation(heads), parallel, sqrt,
                              chunk_size, cvi, kw)

"""Zoo: physics-ML vector-field recipes (PyTorch counterpart of
`physs_gp_tpu/zoo/phi_ml.py`).

Batch (dense) recipes, on derivative-operator kernels:

- `curl_free_gp`: H = −∇φ, φ ~ GP, so K_H = ∇∇' k mixed by W = −I
  (`curl_free_kernel`); curl H = 0 by construction;
- `helmholtz_gp`: a 2-D field u = −∇φ + rot ψ as the sum of independent
  curl-free and divergence-free GPs (`div_free_kernel_2d`: u = (∂y ψ,
  −∂x ψ)); the posterior splits the field into its two parts.

State-space recipes:

- `helmholtz_st_gp` / `helmholtz_st_predict`: a 2-D flow over time as two
  independent latent ST GPs, φ (potential) and ψ (stream), stacked
  block-diagonally (`StackedMarkov`) and observed through fixed-mixing
  spatial-derivative rows (`StackedHead`):
      flow(t, s) = [∂x φ + ∂y ψ,  ∂y φ − ∂x ψ](t, s);
  the posterior splits the observed flow into its curl-free and
  divergence-free parts.
- `magnetic_field_gp` / `magnetic_field_predict`: a curl-free 3-D field
  H = −∇φ over (t, x, y) of one latent potential φ, the first coordinate
  carrying the Markov factorisation: H₁ = −∂t φ comes from the time-kernel
  state, H₂ / H₃ = −∂x / −∂y φ through the spatial conditional.

Both are O(T) through the Kalman scans. `cvi=True` returns the CVI model;
the conjugate Gaussian case is exact either way. Every recipe builds on
`device` (the card unless the caller asks for the CPU) in `dtype`.
"""
from __future__ import annotations

import copy

import torch

from ..kernels.base import SumKernel
from ..kernels.derivative import DerivativeKernel, grad_ops
from ..kernels.markov import StackedMarkov
from ..kernels.matern import Matern32
from ..kernels.rbf import RBF
from ..kernels.spatio_temporal import SpatioTemporalKernel
from ..likelihoods.gaussian import Gaussian, IndependentGaussian, SharedVariance
from ..models.batch_gp import BatchGP
from ..models.cvi_gp import CVIGP
from ..models.ssgp import GaussianMoments, StateSpaceGP
from ..ops.lgssm import project_mean, project_var
from ..transforms.operators import SpatialHead, StackedHead, StateObservation, s_grad
from ..utils.params import positive_param
from ..utils.shapes import as_points

__all__ = ["curl_free_kernel", "div_free_kernel_2d", "curl_free_gp", "helmholtz_gp",
           "helmholtz_st_gp", "helmholtz_st_predict", "magnetic_field_gp",
           "magnetic_field_predict"]


def _like(module):
    t = next(iter(module.parameters()))
    return dict(dtype=t.dtype, device=t.device)


def curl_free_kernel(base, ds: int) -> DerivativeKernel:
    """K of H = −∇φ (the negated gradient field of a GP with kernel `base`)."""
    return DerivativeKernel(base=base, ops=grad_ops(ds), W=-torch.eye(ds, **_like(base)))


def div_free_kernel_2d(base) -> DerivativeKernel:
    """K of u = (∂y ψ, −∂x ψ), the 2-D divergence-free field of ψ ~ GP(0, base)."""
    W = torch.tensor([[0.0, 1.0], [-1.0, 0.0]], **_like(base))
    return DerivativeKernel(base=base, ops=grad_ops(2), W=W)


class _MultiOutputSum(SumKernel):
    """Sum of multi-output kernels with a shared output count."""

    @property
    def n_outputs(self) -> int:
        return self.parts[0].n_outputs


def _rbf(ds, kw):
    return RBF(lengthscales=positive_param(torch.ones(ds), **kw), variance=positive_param(1.0, **kw))


def curl_free_gp(X, Y_field, base_kernel=None, noise: float = 1e-3, dtype=torch.float64,
                 device="cuda") -> BatchGP:
    """Exact GP over a curl-free vector field: X [N, ds] positions, Y_field
    [N, ds] the observed components (NaN = missing)."""
    kw = dict(dtype=dtype, device=device)
    X = as_points(X, **kw)
    kern = curl_free_kernel(base_kernel or _rbf(X.shape[1], kw), X.shape[1])
    return BatchGP(X, Y_field, kern, Gaussian(positive_param(noise, **kw)), **kw)


def helmholtz_gp(X, Y_field, base_curl=None, base_div=None, noise: float = 1e-3,
                 dtype=torch.float64, device="cuda") -> BatchGP:
    """2-D Helmholtz decomposition GP: u = curl-free + divergence-free
    parts, each over its own base GP."""
    kw = dict(dtype=dtype, device=device)
    X = as_points(X, **kw)
    if X.shape[1] != 2:
        raise ValueError("helmholtz_gp is the 2-D recipe")
    kern = _MultiOutputSum([curl_free_kernel(base_curl or _rbf(2, kw), 2),
                            div_free_kernel_2d(base_div or _rbf(2, kw))])
    return BatchGP(X, Y_field, kern, Gaussian(positive_param(noise, **kw)), **kw)


def _st_kernel(k_time, k_space, Z, kw):
    return SpatioTemporalKernel(
        k_time=k_time or Matern32(lengthscale=1.0, variance=1.0, **kw),
        k_space=k_space or RBF(lengthscales=positive_param(torch.ones(2), **kw),
                               variance=positive_param(1.0, **kw)),
        Z=Z,
    )


def _model(t, Y, kern, lik, obs, parallel, sqrt, chunk_size, cvi):
    if cvi:
        return CVIGP.init(t, Y, kern, lik, observation=obs, parallel=parallel, sqrt=sqrt,
                          chunk_size=chunk_size)
    return StateSpaceGP(t=t, Y=Y, kernel=kern, likelihood=lik, observation=obs,
                        parallel=parallel, sqrt=sqrt, chunk_size=chunk_size)


def _tied_noise(noise, n, kw):
    """One physical noise variance tied across all n observed rows."""
    return IndependentGaussian([SharedVariance(p=positive_param(noise, **kw), n=n)])


def _helmholtz_flow_heads(points, correction: bool):
    def sh(i):
        return SpatialHead(points=points, s_op=s_grad(i), correction=correction)

    u = StackedHead([sh(0), sh(1)])  # ∂x φ + ∂y ψ
    v = StackedHead([sh(1), (-1.0, sh(0))])  # ∂y φ − ∂x ψ
    return [u, v]


def helmholtz_st_gp(t, Y_flow, Z, k_time=None, k_space=None, noise: float = 1e-2,
                    dtype=torch.float64, parallel: bool = False, sqrt: bool = False,
                    chunk_size=None, cvi: bool = False, device="cuda"):
    """Spatio-temporal Helmholtz flow GP in state-space form.

    t [T] sorted times; Y_flow [T, 2*Ns] with columns [u(sites), v(sites)]
    (NaN = missing); Z [Ns, 2] the sites carrying the latent states.
    `k_time` / `k_space` take one kernel (deep-copied, so the latents stay
    independently trainable) or a `(k_φ, k_ψ)` pair. With identical
    isotropic priors on φ and ψ the u and v components are exactly
    uncorrelated: inferring v from u needs asymmetric latent priors."""
    kw = dict(dtype=dtype, device=device)
    Z = as_points(Z, **kw)
    if Z.shape[1] != 2:
        raise ValueError("helmholtz_st_gp is the 2-D-space recipe")

    def pair(k):
        return k if isinstance(k, tuple) else (k, copy.deepcopy(k))

    kt_phi, kt_psi = pair(k_time)
    ks_phi, ks_psi = pair(k_space)
    kern = StackedMarkov([_st_kernel(kt_phi, ks_phi, Z, kw), _st_kernel(kt_psi, ks_psi, Z, kw)])
    obs = StateObservation(_helmholtz_flow_heads(Z, correction=False))
    return _model(torch.as_tensor(t, **kw), torch.as_tensor(Y_flow, **kw), kern,
                  _tied_noise(noise, 2 * Z.shape[0], kw), obs, parallel, sqrt, chunk_size, cvi)


def _magnetic_heads(points, include_potential: bool, correction: bool):
    def sh(t_order=0, s_op=None, coeff=1.0):
        return SpatialHead(points=points, t_order=t_order, s_op=s_op, coeff=coeff,
                           correction=correction)

    heads = [sh()] if include_potential else []  # φ itself
    heads += [
        sh(t_order=1, coeff=-1.0),  # H₁ = −∂t φ
        sh(s_op=s_grad(0), coeff=-1.0),  # H₂ = −∂x φ
        sh(s_op=s_grad(1), coeff=-1.0),  # H₃ = −∂y φ
    ]
    return heads


def magnetic_field_gp(t, Y_field, Z, k_time=None, k_space=None, noise: float = 1e-2,
                      include_potential: bool = False, dtype=torch.float64,
                      parallel: bool = False, sqrt: bool = False, chunk_size=None,
                      cvi: bool = False, device="cuda"):
    """Curl-free 3-D field GP in state-space form.

    t [T] sorted first coordinates; Y_field [T, 3*Ns] with column blocks
    [H₁(sites), H₂(sites), H₃(sites)] (NaN = missing), the field H = −∇φ
    of one latent potential φ(t, x, y); Z [Ns, 2] the spatial sites.
    `include_potential=True` prepends a φ(sites) block ([T, 4*Ns]). The
    time kernel needs a first-derivative state (Matérn-3/2 or smoother)."""
    kw = dict(dtype=dtype, device=device)
    Z = as_points(Z, **kw)
    Ns = Z.shape[0]
    if Z.shape[1] != 2:
        raise ValueError("magnetic_field_gp takes 2 non-Markov coordinates")
    n_blocks = 4 if include_potential else 3
    Y = torch.as_tensor(Y_field, **kw)
    if Y.shape[1] != n_blocks * Ns:
        raise ValueError(
            f"Y_field has {Y.shape[1]} columns; expected {n_blocks}*Ns = {n_blocks * Ns} "
            f"({'[φ, H1, H2, H3]' if include_potential else '[H1, H2, H3]'} site blocks)"
        )
    obs = StateObservation(_magnetic_heads(Z, include_potential, correction=False))
    return _model(torch.as_tensor(t, **kw), Y, _st_kernel(k_time, k_space, Z, kw),
                  _tied_noise(noise, n_blocks * Ns, kw), obs, parallel, sqrt, chunk_size, cvi)


def _predict_with(model, heads) -> GaussianMoments:
    """Moments of the given heads on the training times, the off-site
    conditional residual included in the variance; a CVI model reads its
    conjugate surrogate, whose smoothed posterior is q."""
    if hasattr(model, "surrogate_model"):
        model = model.surrogate_model()
    obs = StateObservation(heads)
    H = obs.H(model.kernel)
    _, _, s = model.filter_smooth()
    var = project_var(H, s.Ps)
    corr = obs.var_correction(model.kernel)
    if corr is not None:
        var = var + corr
    return GaussianMoments(mean=project_mean(H, s.ms), var=var)


def magnetic_field_predict(model, s_new, include_potential: bool = False) -> GaussianMoments:
    """Field posterior (and φ with `include_potential`) at new spatial
    points on the training times: mean / var [T, (3|4)*N*] with the column
    blocks of `magnetic_field_gp`."""
    s_new = as_points(s_new, dtype=model.t.dtype, device=model.t.device)
    return _predict_with(model, _magnetic_heads(s_new, include_potential, correction=True))


def helmholtz_st_predict(model, s_new) -> GaussianMoments:
    """Flow posterior at new spatial points on the training times: mean /
    var [T, 2*N*] with columns [u(s_new), v(s_new)]."""
    s_new = as_points(s_new, dtype=model.t.dtype, device=model.t.device)
    return _predict_with(model, _helmholtz_flow_heads(s_new, correction=True))

"""Benchmark model builders (PyTorch counterpart of
`physs_gp_tpu/zoo/bench_configs.py`).

`build_config5`: a T-step irregular time series with a 2-D
advection-diffusion PDE prior over a 4x4 spatial grid (Matérn-3/2 ⊗ RBF,
state dim 32), 16 grid observation heads and 16 PDE-residual collocation
heads, CVI inference.

`build_temporal`: a T-step irregular count series over [0, 1000] (Matérn-3/2,
state dim 2, Poisson likelihood under the log link), CVI inference; the
README's quick start and the bench's second workload.

The data come from the same `np.random.default_rng(0)` calls as the JAX
builders, so both packages see identical inputs.
"""
import numpy as np
import torch


def build_config5(T, chunk, parallel=True, dtype=None, sqrt=False, device="cuda", mesh=None):
    """The config-5 CVI model on `device` (the card unless the caller asks
    for the CPU); `sqrt=True` runs the square-root filter and smoother;
    `mesh` shards its time axis over the mesh dimension "t"."""
    from ..kernels.matern import Matern32
    from ..kernels.rbf import RBF
    from ..kernels.spatio_temporal import SpatioTemporalKernel
    from ..likelihoods.gaussian import IndependentGaussian
    from ..models.cvi_gp import CVIGP
    from ..transforms.operators import (
        OperatorTerm,
        STOperatorHead,
        SpatialHead,
        StateObservation,
        s_grad,
        s_laplacian,
    )
    from ..utils.params import positive_param

    dtype = dtype or torch.float32
    kw = dict(dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 100, T)).astype(np.float32)
    gx = np.linspace(0, 1, 4)
    Z = np.stack(np.meshgrid(gx, gx), -1).reshape(-1, 2).astype(np.float32)
    Ns = Z.shape[0]
    coll = (Z + 0.5 * (gx[1] - gx[0]))[:Ns]
    Nc = coll.shape[0]
    Y = np.concatenate(
        [rng.normal(size=(T, Ns)).astype(np.float32),
         np.zeros((T, Nc), np.float32)], axis=1,
    )
    kern = SpatioTemporalKernel(
        k_time=Matern32(lengthscale=5.0, variance=1.0, **kw),
        k_space=RBF(lengthscales=positive_param(0.5, **kw),
                    variance=positive_param(1.0, **kw)),
        Z=torch.as_tensor(Z, **kw),
    )
    obs = StateObservation(heads=[
        SpatialHead(points=torch.as_tensor(Z, **kw)),
        STOperatorHead(points=torch.as_tensor(coll, **kw), terms=[
            OperatorTerm(coeff=1.0, t_order=1),
            OperatorTerm(coeff=-0.1, s_op=s_laplacian),
            OperatorTerm(coeff=0.2, s_op=s_grad(0)),
            OperatorTerm(coeff=0.1, s_op=s_grad(1)),
        ]),
    ])
    lik = IndependentGaussian(
        variances=[positive_param(0.1, **kw) for _ in range(Ns)]
        + [positive_param(1e-3, **kw).fix() for _ in range(Nc)]
    )
    return CVIGP.init(torch.as_tensor(t, **kw), torch.as_tensor(Y, **kw), kern, lik,
                      observation=obs, parallel=parallel, chunk_size=chunk,
                      sqrt=sqrt, mesh=mesh)


def build_temporal(T, chunk, parallel=True, dtype=None, sqrt=False, device="cuda", mesh=None):
    """The temporal Poisson CVI model on `device` (the card unless the caller
    asks for the CPU); `sqrt=True` runs the square-root filter and smoother;
    `mesh` shards its time axis over the mesh dimension "t"."""
    from ..kernels.matern import Matern32
    from ..likelihoods.nongaussian import Poisson
    from ..models.cvi_gp import CVIGP

    dtype = dtype or torch.float32
    kw = dict(dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 1000, T)).astype(np.float32)
    f = 1.2 * np.sin(0.1 * t)
    y = rng.poisson(np.exp(f)).astype(np.float32)
    return CVIGP.init(
        torch.as_tensor(t, **kw), torch.as_tensor(y, **kw)[:, None],
        Matern32(lengthscale=10.0, variance=1.0, **kw), Poisson(),
        parallel=parallel, chunk_size=chunk, sqrt=sqrt, mesh=mesh,
    )

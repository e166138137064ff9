"""Shared parts of the PyTorch port's Allen-Cahn parity tests
(`tests/test_torch_physics_ac*.py`): the recipe `zoo/physics.allen_cahn_gp`
against the JAX package at a small width (T = 10, Ns = Nc = 3, n_mc = 4;
the experiment's kernels, noise 0.02², collocation noise 1e-5).

Two `step_with_elbo(0.3, hessian="gauss_newton")` steps per form, with the
standard normals JAX drew from each step's key handed to the port
(`draws=`). Each parity file runs its forms' JAX references once, in a
module fixture, so that the JAX compiles (~15 s a form) spread over the
test workers; the parallel square-root run routes `_factor_psd` to its TPU
branch, which the port follows. ELBOs agree to rtol 1e-9, sites and
posterior moments to 1e-7 (relative to each array's largest magnitude).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from physs_gp_tpu.kernels import Matern52 as JMatern52
from physs_gp_tpu.kernels.rbf import RBF as JRBF
from physs_gp_tpu.utils.params import positive_param as jpositive
from physs_gp_tpu.zoo import allen_cahn_gp as jallen_cahn
from physs_gp_tpu_torch.kernels.matern import Matern52
from physs_gp_tpu_torch.kernels.rbf import RBF
from physs_gp_tpu_torch.utils.params import positive_param
from physs_gp_tpu_torch.zoo.physics import allen_cahn_gp

T, NS, NC, N_MC, STEPS = 10, 3, 3, 4, 2
FORMS = {"cov": dict(parallel=False, sqrt=False), "sqrt": dict(parallel=False, sqrt=True),
         "parallel sqrt": dict(parallel=True, sqrt=True)}
F64 = dict(dtype=torch.float64, device="cpu")


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    ok = np.isfinite(b)
    assert a.shape == b.shape and np.array_equal(np.isfinite(a), ok)
    return float(np.max(np.abs(a[ok] - b[ok])) / np.max(np.abs(b[ok])))


def _inputs():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 3.5, T)
    Z = np.linspace(-0.9, 0.9, NS)[:, None]
    coll = np.linspace(-0.9, 0.9, NC)[:, None]
    Y = 0.5 * np.sin(0.5 * np.pi * Z[:, 0])[None] + 0.02 * rng.normal(size=(T, NS))
    Y[t > 1.0] = np.nan
    return t, Y, Z, coll


def jax_model(form):
    t, Y, Z, coll = _inputs()
    return jallen_cahn(t, Y, Z, coll, epsilon=0.08,
                       k_time=JMatern52(lengthscale=0.8, variance=1.0),
                       k_space=JRBF(lengthscales=jpositive(jnp.asarray([0.6])), variance=jpositive(1.0)),
                       noise=0.02**2, coll_noise=1e-5, n_mc=N_MC, **FORMS[form])


def port_model(form):
    t, Y, Z, coll = _inputs()
    return allen_cahn_gp(t, Y, Z, coll, epsilon=0.08, k_time=Matern52(0.8, 1.0, **F64),
                         k_space=RBF(positive_param(torch.tensor([0.6], dtype=torch.float64)),
                                     positive_param(1.0, **F64)),
                         noise=0.02**2, coll_noise=1e-5, n_mc=N_MC, device="cpu", **FORMS[form])


def reference_runs(forms):
    """Per form: (draws per step, ELBOs, sites Y, sites V, posterior mean, var)."""
    from physs_gp_tpu.ops import matrix, parallel_sqrt_kalman
    from physs_gp_tpu.ops.pallas import batched_chol

    chol = functools.partial(batched_chol.batch_cholesky.__wrapped__, interpret=True)

    def factor_psd(L):
        S = matrix.symmetrize(L)
        return matrix._cholesky_any(S, assume_psd=True) if S.shape[-1] <= 2 else chol(S)

    saved = parallel_sqrt_kalman._factor_psd
    parallel_sqrt_kalman._factor_psd = factor_psd
    try:
        out = {}
        keys = list(jax.random.split(jax.random.PRNGKey(10), STEPS))
        for form in forms:
            m = jax_model(form)
            draws = [np.asarray(jax.random.normal(k, (N_MC,) + m.Y.shape, jnp.float64)) for k in keys]
            step = jax.jit(lambda mm, k: mm.step_with_elbo(0.3, hessian="gauss_newton", key=k))
            elbos = []
            for k in keys:
                m, e = step(m, k)
                elbos.append(float(e))
            post = jax.jit(lambda mm: mm.posterior())(m)
            out[form] = (draws, elbos, np.asarray(m.sites.Y), np.asarray(m.sites.V),
                         np.asarray(post.mean), np.asarray(post.var))
        return out
    finally:
        parallel_sqrt_kalman._factor_psd = saved


def check_form(reference, form):
    """The port's steps in `form` against the JAX run."""
    draws, elbos, sY, sV, mean, var = reference[form]
    model = port_model(form)
    got = [float(model.step_with_elbo(0.3, hessian="gauss_newton", draws=torch.from_numpy(d))[1])
           for d in draws]
    np.testing.assert_allclose(got, elbos, rtol=1e-9)
    assert rel(model.sites.Y, sY) <= 1e-7
    assert rel(model.sites.V, sV) <= 1e-7
    post = model.posterior()
    assert rel(post.mean, mean) <= 1e-7
    assert rel(post.var, var) <= 1e-7

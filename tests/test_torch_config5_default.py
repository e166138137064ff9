"""PyTorch port: the config-5 CVI slice against JAX's own default scan
schedule (its associative scan, the CPU default), the port on its blocked
scan: ELBOs to rtol 1e-9, final sites and the posterior to rtol 1e-7
(`config5_parity`). The golden-file checks are in `test_torch_config5.py`
and `test_torch_config5_sqrt.py`.

Module checks against the JAX package: the Matérn-3/2 transition and
noise, Kzz, the grid rows of `StateObservation.H` and the lifted LGSSM,
conditional variance corrections, and the spatial operators without a
closed form, which `_op_cross` differentiates by nested autodiff.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.kernels import Matern32 as JMatern32, Matern52 as JMatern52  # noqa: E402
from physs_gp_tpu.kernels.spatio_temporal import SpatioTemporalKernel as JSTKernel  # noqa: E402
from physs_gp_tpu.trainers import natgrad_scan as jscan  # noqa: E402
from physs_gp_tpu.transforms import operators as jops  # noqa: E402
from physs_gp_tpu.zoo.bench_configs import build_config5 as jbuild  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32, Matern52  # noqa: E402
from physs_gp_tpu_torch.kernels.spatio_temporal import SpatioTemporalKernel  # noqa: E402
from physs_gp_tpu_torch.transforms import operators as tops  # noqa: E402
from physs_gp_tpu_torch.zoo.bench_configs import build_config5 as tbuild  # noqa: E402
from config5_parity import CHUNK, STEP0_ELBO, T, _check_against, _close, _jax_leaves, _port_run  # noqa: E402

torch.set_num_threads(1)


def test_matern32_transition_and_noise():
    dt = np.concatenate([[0.0], np.random.default_rng(0).exponential(0.4, 50)])
    jk = JMatern32(lengthscale=jnp.asarray(5.0), variance=jnp.asarray(1.3))
    tk = Matern32(lengthscale=5.0, variance=1.3, dtype=torch.float64)
    dtt = torch.from_numpy(dt)
    _close(tk.transition(dtt), jk.transition(jnp.asarray(dt)), 1e-13, 1e-15)
    _close(tk.noise_cov(dtt), jk.noise_cov(jnp.asarray(dt)), 1e-12, 1e-15)
    _close(tk.to_ss().Pinf, jk.to_ss().Pinf, 1e-13)


def test_kzz_observation_rows_and_lgssm():
    jm = jbuild(64, None, dtype=jnp.float64)
    tm = tbuild(64, None, dtype=torch.float64, device="cpu")
    load_numpy_params(tm, _jax_leaves(jm))
    _close(tm.kernel.Kzz(), jax.jit(lambda m: m.kernel.Kzz())(jm), 1e-13)
    jH = jax.jit(lambda m: m.observation.H(m.kernel))(jm)
    _close(tm.observation.H(tm.kernel), jH, 1e-9, 1e-12)
    assert tm.observation.var_correction(tm.kernel) is None
    assert jm.observation.var_correction(jm.kernel) is None
    jl = jax.jit(lambda m: m.kernel.to_lgssm(m.t))(jm)
    tl = tm.kernel.to_lgssm(tm.t)
    for a, b in zip(tl, jl):
        _close(a, b, 1e-12, 1e-15)


@pytest.mark.parametrize("op", [None, "grad", "laplacian"])
def test_conditional_var_correction(op):
    jm = jbuild(8, None, dtype=jnp.float64)
    tm = tbuild(8, None, dtype=torch.float64, device="cpu")
    load_numpy_params(tm, _jax_leaves(jm))
    s = np.random.default_rng(2).uniform(size=(5, 2))
    jop = {None: None, "grad": jops.s_grad(0), "laplacian": jops.s_laplacian}[op]
    top = {None: None, "grad": tops.s_grad(0), "laplacian": tops.s_laplacian}[op]
    for t_order in (0, 1):
        ref = jax.jit(lambda k, x: k.conditional_var_correction(x, jop, t_order))(
            jm.kernel, jnp.asarray(s)
        )
        out = tm.kernel.conditional_var_correction(torch.from_numpy(s), top, t_order)
        _close(out, ref, 1e-8, 1e-10)


def _user_op(k, s, z):
    """A linear spatial operator with no closed form (no `kind`)."""
    return 1.5 * k(s, z) - 0.5 * k(s + 0.2, z)


@pytest.mark.parametrize("op", ["user", "grad_matern52"])
def test_operator_without_closed_form_matches_jax(op):
    """`_op_cross` falls back to nested autodiff as the reference does: for
    a spatial operator without `kind` (a user function on config-5's RBF
    sites) and for a kinded one on a spatial kernel without `K_op`
    (`s_grad(0)` on a Matérn-5/2). `spatial_weights` and
    `conditional_var_correction` agree with the JAX package at rtol 1e-9 in
    float64."""
    jm = jbuild(8, None, dtype=jnp.float64)
    tm = tbuild(8, None, dtype=torch.float64, device="cpu")
    load_numpy_params(tm, _jax_leaves(jm))
    jker, tker = jm.kernel, tm.kernel
    if op == "user":
        jop = top = _user_op
    else:
        Z = np.array(jm.kernel.sites)
        jker = JSTKernel(k_time=jm.kernel.k_time, Z=jnp.asarray(Z),
                         k_space=JMatern52(lengthscale=jnp.asarray(0.7), variance=jnp.asarray(1.1)))
        tker = SpatioTemporalKernel(tm.kernel.k_time, Matern52(0.7, 1.1, dtype=torch.float64),
                                    torch.from_numpy(Z))
        jop, top = jops.s_grad(0), tops.s_grad(0)
    s = np.random.default_rng(3).uniform(size=(5, 2))
    _close(tker.spatial_weights(torch.from_numpy(s), top),
           jax.jit(lambda k, x: k.spatial_weights(x, jop))(jker, jnp.asarray(s)), 1e-9, 1e-12)
    for t_order in (0, 1):
        ref = jax.jit(lambda k, x: k.conditional_var_correction(x, jop, t_order))(jker, jnp.asarray(s))
        out = tker.conditional_var_correction(torch.from_numpy(s), top, t_order)
        _close(out, ref, 1e-9, 1e-12)


def test_port_matches_jax_default_schedule(monkeypatch):
    """JAX's associative scan (its CPU default) against the port's blocked
    scan."""
    monkeypatch.delenv("PHYSS_INNER_SCAN", raising=False)
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    j0 = jbuild(T, CHUNK, dtype=jnp.float64)
    jm, je = jax.jit(lambda m: jscan(m, 0.5, n_steps=3))(j0)
    post = jax.jit(lambda m: m.posterior())(jm)
    ref = {
        "elbos": je, "site_Y": jm.sites.Y,
        "site_V_diag": jnp.diagonal(jm.sites.V, axis1=-2, axis2=-1),
        "post_mean": post.mean, "post_var": post.var,
    }
    model, elbos = _port_run(j0)
    _close(elbos[0], STEP0_ELBO, 1e-9)
    _check_against(model, elbos, ref)

"""Write the physics-informed path's reference runs of the JAX package to
`tests/data/physics_golden.npz`.

Every run uses the CPU in float64 unless it says otherwise, the sequential
filters (the experiments' setting) and the TPU branch of the square-root
smoother's `_factor_psd` (`make_serving_golden.use_tpu_factor_branch`),
which the port follows.

- Allen-Cahn at the experiment's full width (`experiments_torch/ac.py`'s `FULL`: T = 56,
  Ns = 10, Nc = 12, n_mc = 32; Matérn-5/2 lengthscale 0.8, RBF lengthscale
  0.6, noise 0.02², collocation noise 1e-5, data from
  `experiments_torch/ac.py`'s `inputs`, seed 0): 3 steps of
  `step_with_elbo(0.3, hessian="gauss_newton", key=k_i)` in covariance
  (`ac_cov_*`) and square-root form (`ac_sqrt_*`), with the keys split from
  PRNGKey(5); the standard normals each step drew,
  `jax.random.normal(k_i, (n_mc, T, p))` as `NonlinearResidual._samples`
  draws them, are `ac_draws` [3, 32, 56, 34]. Stored per form: the ELBOs,
  the site means and the diagonal of the site covariances after the steps,
  and the posterior mean and variance.
- The hardware gate's sites: the same model trained by
  `step_with_elbo(0.3, "gauss_newton")` for `TRAIN_ITERS` iterations with
  the keys of `experiments/ac.py`'s `train` (PRNGKey(0), split per
  iteration), covariance form, float64 (`ac_trained_sites_Y`,
  `ac_trained_sites_V`); the float64 covariance posterior from those sites
  (`ac_trained_f64_mean`, `_var`); and the float32 square-root posterior
  from the same sites, computed in a subprocess with 64-bit types off and
  PHYSS_KZZ_JITTER=1e-4 (the experiment's `--cpu32 --eval-sites` arm:
  `ac_trained_f32_mean`, `_var`).
- The pendulum (`experiments/pendulum.py` at full size: 40 data points, 80
  collocation points, n_mc = 16, Matérn-7/2): 3 Gauss-Newton steps at lr 0.3
  with keys from PRNGKey(6) (`pend_*`, draws `pend_draws`).
- The monotonic model (`experiments/monotonic.py` at full size: 30 data
  points, 100 collocation points): 3 exact-Hessian steps at lr 0.5
  (`mono_*`).
- `ode_gp`, the damped oscillator of `tests/test_physics.py` (25 data
  points, 120 collocation points): its lml and `predict_f` at 40 times
  (`ode_*`).

Usage (from the repository root; about 11 minutes on 8 CPU cores, most
of it the 300 training iterations):
    python scripts/port/make_physics_golden.py

`--self-gap` writes nothing: it measures the JAX package against itself on
the Allen-Cahn anchor (the same 3 steps and draws, both forms). Its CPU
branch factors and solves the [56, 34, 34] site blocks by Cholesky; with
`--self-gap` the same run takes its TPU branch instead, the Pallas
Gauss-Jordan solves and Cholesky in interpret mode at every batch (the
algorithm the port runs), and the Monte-Carlo samples' factor of the block
covariance S (`robust_cholesky`, numerically singular here: the collocation
heads are interpolated from the grid heads) takes the Pallas Cholesky at
the jitter level the CPU probes chose. It prints the largest relative gap
of the ELBOs, the sites and the posterior moments between the two. The
anchors' tolerances are set from these gaps.
"""
import os
import subprocess
import sys

GOLDEN = os.path.join("tests", "data", "physics_golden.npz")
HERE = os.path.dirname(os.path.abspath(__file__))
AC_STEPS, AC_LR, AC_KEY, TRAIN_ITERS = 3, 0.3, 5, 300
PEND_KEY, MONO_LR = 6, 0.5
KZZ_JITTER_F32 = "1e-4"


def pendulum_inputs(seed=0, n_data=40, n_coll=80):
    """(t_data, y_data, t_coll) of `experiments/pendulum.py`."""
    import numpy as np
    from scipy.integrate import solve_ivp

    rng = np.random.default_rng(seed)
    sol = solve_ivp(lambda s, x: [x[1], -0.3 * x[1] - 9.0 * np.sin(x[0])], (0, 5.0), [1.2, 0.0],
                    dense_output=True, rtol=1e-9)
    t_data = np.sort(rng.uniform(0, 2.5, n_data))
    y_data = sol.sol(t_data)[0] + 0.03 * rng.normal(size=t_data.size)
    return t_data, y_data, np.linspace(0, 5.0, n_coll)


def monotonic_inputs(seed=0, n_data=30, n_coll=100):
    """(t_data, y_data, t_coll) of `experiments/monotonic.py`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t_pool = rng.uniform(0, 4, 4 * n_data)
    t_data = np.sort(t_pool[(t_pool < 1.2) | (t_pool > 2.8)][:n_data])
    truth = 2.0 / (1.0 + np.exp(-3.0 * (t_data - 2.0))) + 0.1 * t_data
    y_data = truth + 0.15 * rng.normal(size=t_data.size)
    return t_data, y_data, np.linspace(0, 4, n_coll)


def ode_inputs():
    """(t_data, y_data, t_coll, t_test) of `tests/test_physics.py`'s damped
    oscillator."""
    import numpy as np

    rng = np.random.default_rng(1)
    c, k = 0.4, 4.0
    t_data = np.sort(rng.uniform(0, 4, 25))
    w0 = np.sqrt(k)
    wd = np.sqrt(w0**2 - (c / 2) ** 2)
    A, B = 1.0, (c / 2) / wd
    f = np.exp(-c * t_data / 2) * (A * np.cos(wd * t_data) + B * np.sin(wd * t_data))
    y_data = f + 0.05 * rng.normal(size=t_data.size)
    return t_data, y_data, np.linspace(0, 8, 120), np.linspace(4.5, 7.5, 40)


def jax_allen_cahn(t, Y, Z, coll, n_mc, dtype, sqrt):
    """The experiment's model in the JAX package."""
    import jax.numpy as jnp

    from physs_gp_tpu.kernels import Matern52
    from physs_gp_tpu.kernels.rbf import RBF
    from physs_gp_tpu.utils.params import positive_param
    from physs_gp_tpu.zoo import allen_cahn_gp

    return allen_cahn_gp(
        t, Y, Z, coll, epsilon=0.08,
        k_time=Matern52(lengthscale=jnp.asarray(0.8, dtype), variance=jnp.asarray(1.0, dtype)),
        k_space=RBF(lengthscales=positive_param(jnp.asarray([0.6], dtype)),
                    variance=positive_param(jnp.asarray(1.0, dtype))),
        noise=0.02**2, coll_noise=1e-5, n_mc=n_mc, dtype=dtype, sqrt=sqrt,
    )


def pendulum_residual(np_like):
    def residual(f):
        return f[..., 2] + 0.3 * f[..., 1] + 9.0 * np_like.sin(f[..., 0])

    return residual


def _steps(model, keys, lr, hessian):
    """Steps of `step_with_elbo` with the given keys (None: no key)."""
    import jax
    import numpy as np

    step = jax.jit(lambda mm, k: mm.step_with_elbo(lr, hessian=hessian, key=k))
    step0 = jax.jit(lambda mm: mm.step_with_elbo(lr, hessian=hessian))
    elbos = []
    for k in keys:
        model, e = step0(model) if k is None else step(model, k)
        elbos.append(float(e))
    return model, np.asarray(elbos)


def _record(out, tag, model, elbos):
    import numpy as np

    post = model.posterior()
    out[f"{tag}_elbos"] = elbos
    out[f"{tag}_sites_Y"] = np.asarray(model.sites.Y)
    out[f"{tag}_sites_Vdiag"] = np.diagonal(np.asarray(model.sites.V), axis1=-2, axis2=-1)
    out[f"{tag}_mean"] = np.asarray(post.mean)
    out[f"{tag}_var"] = np.asarray(post.var)


def f32_eval(sites_path, out_path):
    """Float32 square-root posterior of the stored sites (64-bit types off)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from experiments_torch.ac import FULL, inputs
    from physs_gp_tpu.utils.struct import replace

    z = np.load(sites_path)
    t, Y, Z, coll, _ = inputs(FULL["T"], FULL["Ns"], FULL["Nc"])
    m = jax_allen_cahn(t, Y, Z, coll, FULL["n_mc"], jnp.float32, True)
    m = replace(m, sites=replace(m.sites, Y=jnp.asarray(z["Y"], jnp.float32),
                                 V=jnp.asarray(z["V"], jnp.float32)))
    post = jax.jit(lambda mm: mm.posterior())(m)
    np.savez(out_path, mean=np.asarray(post.mean), var=np.asarray(post.var))


def reference_runs(tmp):
    """Run the JAX reference; returns a dict of numpy arrays."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from make_serving_golden import use_tpu_factor_branch
    from experiments_torch.ac import FULL, inputs
    from physs_gp_tpu.kernels import Matern72
    from physs_gp_tpu.zoo import monotonic_cvi_gp, nonlinear_ode_cvi_gp, ode_gp

    use_tpu_factor_branch()
    os.environ.pop("PHYSS_KZZ_JITTER", None)
    out = {}
    # Allen-Cahn, full width: 3 steps in both sequential forms
    t, Y, Z, coll, F = inputs(FULL["T"], FULL["Ns"], FULL["Nc"])
    out.update(ac_t=t, ac_Y=Y, ac_Z=Z, ac_coll=coll, ac_F=F)
    keys = list(jax.random.split(jax.random.PRNGKey(AC_KEY), AC_STEPS))
    p = FULL["Ns"] + 2 * FULL["Nc"]
    out["ac_draws"] = np.stack([np.asarray(jax.random.normal(k, (FULL["n_mc"], len(t), p), jnp.float64))
                                for k in keys])
    for form in ("cov", "sqrt"):
        m = jax_allen_cahn(t, Y, Z, coll, FULL["n_mc"], jnp.float64, form == "sqrt")
        m, elbos = _steps(m, keys, AC_LR, "gauss_newton")
        _record(out, f"ac_{form}", m, elbos)
    # the hardware gate's sites: trained as experiments/ac.py trains
    m = jax_allen_cahn(t, Y, Z, coll, FULL["n_mc"], jnp.float64, False)
    key, train_keys = jax.random.PRNGKey(0), []
    for _ in range(TRAIN_ITERS):
        key, k = jax.random.split(key)
        train_keys.append(k)
    m, elbos = _steps(m, train_keys, AC_LR, "gauss_newton")
    out["ac_trained_final_elbo"] = elbos[-1]
    out["ac_trained_sites_Y"] = np.asarray(m.sites.Y)
    out["ac_trained_sites_V"] = np.asarray(m.sites.V)
    post = m.posterior()
    out["ac_trained_f64_mean"] = np.asarray(post.mean)
    out["ac_trained_f64_var"] = np.asarray(post.var)
    sites_path, f32_path = os.path.join(tmp, "sites.npz"), os.path.join(tmp, "f32.npz")
    np.savez(sites_path, Y=out["ac_trained_sites_Y"], V=out["ac_trained_sites_V"])
    env = dict(os.environ, PHYSS_KZZ_JITTER=KZZ_JITTER_F32, JAX_ENABLE_X64="0")
    subprocess.run([sys.executable, os.path.abspath(__file__), "--f32-eval", sites_path, f32_path],
                   check=True, env=env)
    z = np.load(f32_path)
    out["ac_trained_f32_mean"], out["ac_trained_f32_var"] = z["mean"], z["var"]
    # the pendulum at full size: 3 Gauss-Newton steps
    td, yd, tc = pendulum_inputs()
    out.update(pend_t_data=td, pend_y_data=yd, pend_t_coll=tc)
    m = nonlinear_ode_cvi_gp(td, yd, tc, pendulum_residual(jnp), n_heads=3,
                             kernel=Matern72(lengthscale=1.0, variance=1.0), noise=0.03**2,
                             coll_noise=1e-4, n_mc=16)
    keys = list(jax.random.split(jax.random.PRNGKey(PEND_KEY), AC_STEPS))
    out["pend_draws"] = np.stack([np.asarray(jax.random.normal(k, (16,) + m.Y.shape, jnp.float64))
                                  for k in keys])
    m, elbos = _steps(m, keys, AC_LR, "gauss_newton")
    _record(out, "pend", m, elbos)
    # the monotonic model at full size: 3 exact steps, no Monte-Carlo term
    td, yd, tc = monotonic_inputs()
    out.update(mono_t_data=td, mono_y_data=yd, mono_t_coll=tc)
    m = monotonic_cvi_gp(td, yd, tc, noise=0.15**2)
    m, elbos = _steps(m, [None] * AC_STEPS, MONO_LR, "exact")
    _record(out, "mono", m, elbos)
    # ode_gp: lml and predict_f
    td, yd, tc, tt = ode_inputs()
    out.update(ode_t_data=td, ode_y_data=yd, ode_t_coll=tc, ode_t_test=tt)
    m = ode_gp(td, yd, tc, ode_coeffs=[4.0, 0.4, 1.0],
               kernel=Matern72(lengthscale=1.5, variance=1.0), noise=0.05**2, coll_noise=1e-6)
    out["ode_lml"] = np.asarray(m.log_marginal_likelihood())
    f = m.predict_f(jnp.asarray(tt))
    out["ode_f_mean"], out["ode_f_var"] = np.asarray(f.mean), np.asarray(f.var)
    return out


def self_gap():
    """Print the JAX CPU branch's gap to its Pallas branch (interpret mode)
    on the Allen-Cahn anchor; returns {form: {quantity: gap}}."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import functools

    import jax.numpy as jnp
    import numpy as np

    from make_serving_golden import use_tpu_factor_branch
    from experiments_torch.ac import FULL
    from physs_gp_tpu.ops.pallas import batched_chol as jbc
    from physs_gp_tpu.ops.pallas import batched_linalg as jbl

    use_tpu_factor_branch()
    os.environ.pop("PHYSS_KZZ_JITTER", None)
    g = np.load(GOLDEN)
    t, Y, Z, coll = g["ac_t"], g["ac_Y"], g["ac_Z"], g["ac_coll"]
    keys = list(jax.random.split(jax.random.PRNGKey(AC_KEY), AC_STEPS))
    jbl.use_pallas_linalg = lambda shape, d_max=80: len(shape) == 3
    jbc.use_pallas_chol = lambda shape, d_max=80, m_max=160: len(shape) == 3
    for mod, names in ((jbl, ("batch_solve", "batch_solve_logdet", "batch_bmm", "batch_matmul")),
                       (jbc, ("batch_cholesky", "batch_chol_gram"))):
        for name in names:
            setattr(mod, name, functools.partial(getattr(mod, name).__wrapped__, interpret=True))
    from physs_gp_tpu.likelihoods import composite
    from physs_gp_tpu.ops import matrix

    def robust_cholesky_pallas(A, rel=None, escalations=(1e2, 1e3, 1e4)):
        # the reference's level selection (XLA probes), then the Pallas factor
        rel = matrix.default_jitter(A.dtype) if rel is None else rel
        A = matrix.symmetrize(A)
        eye = jnp.eye(A.shape[-1], dtype=A.dtype)
        scale = jnp.max(jnp.abs(jnp.diagonal(A, axis1=-2, axis2=-1)), -1)[..., None, None] + 1e-30
        levels = (1.0,) + tuple(escalations)
        mult = jnp.full_like(scale, levels[-1])
        for lv in reversed(levels[:-1]):
            L = jnp.linalg.cholesky(jax.lax.stop_gradient(A) + (rel * lv) * scale * eye)
            mult = jnp.where(jnp.all(jnp.isfinite(L), axis=(-2, -1), keepdims=True), lv, mult)
        return jbc.batch_cholesky(A + (rel * mult) * scale * eye)

    composite.robust_cholesky = robust_cholesky_pallas
    out = {}
    for form in ("cov", "sqrt"):
        m = jax_allen_cahn(t, Y, Z, coll, FULL["n_mc"], jnp.float64, form == "sqrt")
        m, elbos = _steps(m, keys, AC_LR, "gauss_newton")
        got = {}
        _record(got, "x", m, elbos)
        gaps = {}
        for q in ("elbos", "sites_Y", "sites_Vdiag", "mean", "var"):
            a, b = got[f"x_{q}"], g[f"ac_{form}_{q}"]
            ok = np.isfinite(b)
            gaps[q] = float(np.max(np.abs(a[ok] - b[ok]) / (np.abs(b[ok]) if q == "elbos"
                                                              else np.max(np.abs(b[ok])))))
        out[form] = gaps
        print(f"JAX CPU branch vs Gauss-Jordan branch, Allen-Cahn {form}: "
              + ", ".join(f"{q} {v:.3e}" for q, v in gaps.items()))
    return out


def main():
    import tempfile

    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        arrays = reference_runs(tmp)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--f32-eval"]:
        f32_eval(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--self-gap"]:
        self_gap()
    else:
        main()

"""Write the serving-path reference runs of the JAX package to
`tests/data/serving_T256_golden.npz`.

The runs use the CPU in float64 with the blocked scan schedule
(PHYSS_INNER_SCAN=blocked, PHYSS_SCAN_BLOCKS=8) and the TPU branch of the
square-root smoother's `_factor_psd`, as `make_temporal_golden.py` does.

- Sampling: `build_config5(256, 64, float64)` after 2 `natgrad_scan` steps at
  lr 0.5, then `CVIGP.sample_f(key, 4, t_new)` at 40 new times (`t_new`,
  uniform on [0, 100], seed 12), in covariance form (`cov_f`), square-root
  form (`sqrt_f`) and covariance form with PHYSS_FUSED_COMBINE=1
  (`fused_f`: the JAX knob acts on the TPU backend only, so on the CPU this
  is the covariance run, which the port's fused route is held to). The
  standard-normal draws that `sample_f` makes from its key (`jax_draws`)
  are stored as `eps_x` [296, 4, 32] and `eps_y` [4, 296, 32].
- `StreamingGP` (parallel, chunk 64) over config-5's data with the
  kernel, heads and `IndependentGaussian` of `build_config5`, in segments
  [0, 100), [100, 200), [200, 256): the carried state after each
  (`gp_m`, `gp_P`, `gp_t_last`, `gp_lml`), the last segment's filtered
  moments, `forecast` and `predict_y` at 10 later times (`t_fc`), and the
  batch `log_marginal_likelihood` (`gp_batch_lml`).
- `StreamingCVI` on the same model and segments (lr 1, 2 iterations;
  `c5cvi_*`) and on `build_temporal(256, 64)`'s Poisson data in segments
  [0, 128), [128, 256) (lr 0.5, 3 iterations; `tcvi_*`, with `forecast`
  at 10 later times, `t_fc_temporal`).
- `advection_diffusion_gp` at config-5's geometry (diffusivity 0.1,
  velocity (0.2, 0.1), coll_noise 1e-3, parallel, chunk 64): its lml and
  `predict_grid` at 8 sites (`s_new`, uniform on [0, 1]^2, seed 13) at the
  training times (`grid_mean`, `grid_var`) and at 20 new times
  (`t_grid_new`, seed 14; `grid_new_mean`, `grid_new_var`).

Usage (from the repository root):
    python scripts/port/make_serving_golden.py
"""
import functools
import os
import sys

GOLDEN = os.path.join("tests", "data", "serving_T256_golden.npz")
T, CHUNK, STEPS, LR = 256, 64, 2, 0.5
N_SAMPLES, N_NEW, N_FC, N_SITES, N_GRID_NEW = 4, 40, 10, 8, 20
KEY = 11
SEGMENTS = ((0, 100), (100, 200), (200, 256))
T_SEGMENTS = ((0, 128), (128, 256))


def inputs():
    """(t_new, t_fc, t_fc_temporal, s_new, t_grid_new) from numpy seeds."""
    import numpy as np

    t_new = np.sort(np.random.default_rng(12).uniform(0, 100, N_NEW))
    t_fc = 100.0 + np.sort(np.random.default_rng(15).uniform(0, 5, N_FC))
    t_fc_temporal = 1000.0 + np.sort(np.random.default_rng(16).uniform(0, 20, N_FC))
    s_new = np.random.default_rng(13).uniform(0, 1, (N_SITES, 2))
    t_grid_new = np.sort(np.random.default_rng(14).uniform(0, 100, N_GRID_NEW))
    return t_new, t_fc, t_fc_temporal, s_new, t_grid_new


def jax_draws(key, n_samples, n_all, d, p, n_out=None, dtype=None):
    """The standard-normal draws `StateSpaceGP.sample_f(key, n_samples, ...)`
    makes: (eps_x [n_all, S, d], eps_y [S, n_all, p], eps_corr [S, n_out, p]),
    n_all the rows of the sampling grid and n_out those returned."""
    import jax
    import jax.numpy as jnp

    dtype = dtype or jnp.float64
    key, k_corr = jax.random.split(key)
    k_x, k_y = jax.random.split(key)
    eps_x = jax.random.normal(k_x, (n_all, n_samples, d), dtype)
    eps_y = jax.random.normal(k_y, (n_samples, n_all, p), dtype)
    eps_corr = jax.random.normal(k_corr, (n_samples, n_out or n_all, p), dtype)
    return eps_x, eps_y, eps_corr


def use_tpu_factor_branch():
    """Route the JAX square-root smoother's `_factor_psd` to its TPU branch."""
    from physs_gp_tpu.ops import matrix, parallel_sqrt_kalman
    from physs_gp_tpu.ops.pallas import batched_chol

    chol = functools.partial(batched_chol.batch_cholesky.__wrapped__, interpret=True)

    def factor_psd(L):
        S = matrix.symmetrize(L)
        return matrix._cholesky_any(S, assume_psd=True) if S.shape[-1] <= 2 else chol(S)

    parallel_sqrt_kalman._factor_psd = factor_psd


def _stream(update, state, t, Y, segments):
    """Run the segments; returns the final state, the stacked states and the
    last segment's output."""
    import numpy as np

    states, out = [], None
    for lo, hi in segments:
        state, out = update(state, t[lo:hi], Y[lo:hi])
        states.append(state)
    stack = {k: np.stack([np.asarray(getattr(s, k)) for s in states]) for k in ("m", "P", "t_last", "lml")}
    return state, stack, out


def reference_runs():
    """Run the JAX reference; returns a dict of numpy arrays."""
    os.environ["PHYSS_INNER_SCAN"] = "blocked"
    os.environ["PHYSS_SCAN_BLOCKS"] = "8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from physs_gp_tpu.kernels import Matern32
    from physs_gp_tpu.kernels.rbf import RBF
    from physs_gp_tpu.models import StateSpaceGP, StreamingCVI, StreamingGP
    from physs_gp_tpu.trainers import natgrad_scan
    from physs_gp_tpu.utils.params import positive_param
    from physs_gp_tpu.zoo import advection_diffusion_gp
    from physs_gp_tpu.zoo.bench_configs import build_config5, build_temporal

    use_tpu_factor_branch()
    t_new, t_fc, t_fc_temporal, s_new, t_grid_new = inputs()
    out = {"t_new": t_new, "t_fc": t_fc, "t_fc_temporal": t_fc_temporal, "s_new": s_new,
           "t_grid_new": t_grid_new}
    key = jax.random.PRNGKey(KEY)
    eps_x, eps_y, _ = jax_draws(key, N_SAMPLES, T + N_NEW, 32, 32)
    out.update(eps_x=np.asarray(eps_x), eps_y=np.asarray(eps_y))

    fit = jax.jit(lambda m: natgrad_scan(m, LR, n_steps=STEPS))
    sample = jax.jit(lambda m, tn: m.sample_f(key, N_SAMPLES, t_new=tn))
    for form, sqrt, fused in (("cov", False, False), ("sqrt", True, False), ("fused", False, True)):
        if fused:
            os.environ["PHYSS_FUSED_COMBINE"] = "1"
        try:
            model, elbos = fit(build_config5(T, CHUNK, dtype=jnp.float64, sqrt=sqrt))
            out[f"{form}_elbos"] = np.asarray(elbos)
            out[f"{form}_f"] = np.asarray(sample(model, jnp.asarray(t_new)))
        finally:
            os.environ.pop("PHYSS_FUSED_COMBINE", None)

    c5 = build_config5(T, CHUNK, dtype=jnp.float64)
    gp = StateSpaceGP(t=c5.t, Y=c5.Y, kernel=c5.kernel, likelihood=c5.likelihood,
                      observation=c5.observation, parallel=True, chunk_size=CHUNK)
    out["gp_batch_lml"] = np.asarray(jax.jit(lambda m: m.log_marginal_likelihood())(gp))
    s = StreamingGP(kernel=c5.kernel, likelihood=c5.likelihood, observation=c5.observation,
                    parallel=True, chunk_size=CHUNK)
    state, stack, seg = _stream(jax.jit(s.update), s.init_state(t0=float(c5.t[0])), c5.t, c5.Y,
                                SEGMENTS)
    fc = jax.jit(s.forecast)(state, jnp.asarray(t_fc))
    py = jax.jit(s.predict_y)(state, jnp.asarray(t_fc))
    out.update({f"gp_{k}": v for k, v in stack.items()})
    out.update(gp_seg_mean=np.asarray(seg.f_mean), gp_seg_var=np.asarray(seg.f_var),
               gp_seg_lml=np.asarray(seg.lml), gp_fc_mean=np.asarray(fc.mean),
               gp_fc_var=np.asarray(fc.var), gp_py_var=np.asarray(py.var))

    sc = StreamingCVI(kernel=c5.kernel, likelihood=c5.likelihood, observation=c5.observation,
                      parallel=True, chunk_size=CHUNK, lr=1.0, n_iters=2)
    _, stack, _ = _stream(jax.jit(sc.update), sc.init_state(t0=float(c5.t[0])), c5.t, c5.Y,
                          SEGMENTS)
    out.update({f"c5cvi_{k}": v for k, v in stack.items()})

    tm = build_temporal(T, CHUNK, dtype=jnp.float64)
    st = StreamingCVI(kernel=tm.kernel, likelihood=tm.likelihood, parallel=True,
                      chunk_size=CHUNK, lr=0.5, n_iters=3)
    state, stack, seg = _stream(jax.jit(st.update), st.init_state(t0=float(tm.t[0])), tm.t, tm.Y,
                                T_SEGMENTS)
    fc = jax.jit(st.forecast)(state, jnp.asarray(t_fc_temporal))
    out.update({f"tcvi_{k}": v for k, v in stack.items()})
    out.update(tcvi_seg_post_mean=np.asarray(seg.posterior().mean),
               tcvi_fc_mean=np.asarray(fc.mean), tcvi_fc_var=np.asarray(fc.var))

    gx = np.linspace(0, 1, 4)
    Z = np.stack(np.meshgrid(gx, gx), -1).reshape(-1, 2).astype(np.float32)
    coll = Z + 0.5 * (gx[1] - gx[0])
    Ns = Z.shape[0]
    ad = advection_diffusion_gp(
        c5.t, c5.Y[:, :Ns], Z, coll, diffusivity=0.1, velocity=(0.2, 0.1),
        k_time=Matern32(lengthscale=jnp.asarray(5.0), variance=jnp.asarray(1.0)),
        k_space=RBF(lengthscales=positive_param(0.5), variance=positive_param(1.0)),
        noise=0.1, coll_noise=1e-3, parallel=True, chunk_size=CHUNK,
    )
    out["grid_lml"] = np.asarray(jax.jit(lambda m: m.log_marginal_likelihood())(ad))
    g = jax.jit(lambda m, s: m.predict_grid(s))(ad, jnp.asarray(s_new))
    gn = jax.jit(lambda m, s, tn: m.predict_grid(s, t_new=tn))(ad, jnp.asarray(s_new),
                                                                jnp.asarray(t_grid_new))
    out.update(grid_mean=np.asarray(g.mean), grid_var=np.asarray(g.var),
               grid_new_mean=np.asarray(gn.mean), grid_new_var=np.asarray(gn.var))
    return out


def main():
    import numpy as np

    arrays = reference_runs()
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()

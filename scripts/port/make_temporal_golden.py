"""Write the temporal Poisson and prediction reference runs of the JAX package
to golden files.

Both runs use the CPU in float64 with the blocked scan schedule
(PHYSS_INNER_SCAN=blocked, PHYSS_SCAN_BLOCKS=8), as
`make_config5_golden.py` does.

`tests/data/temporal_T256_golden.npz`: `build_temporal(256, 64, float64)`
in covariance form (`cov_*`) and square-root form (`sqrt_*`), each after 3
`natgrad_scan` steps at lr 0.5. It holds the 3 step ELBOs, the final site
means and site variances, and the posterior mean and variance.

`tests/data/predict_T256_golden.npz`: on each fitted temporal model,
`predict_f`, `predict_y` and `nlpd` at 50 new times (`t_new`, uniform on
[0, 1000], seed 7) with Poisson targets (`y_new`, seed 8). Then
`predict_f` of `build_config5(256, 64, float64)` after the same 3 steps, in
both forms (`c5_cov_*`, `c5_sqrt_*`), at 40 new times (`t5_new`, uniform on
[0, 100], seed 9). The augmented grids (306 and 296 steps) are not
multiples of the chunk, so the runner pads them.

In square-root form, the smoother's final factorisation
(`parallel_sqrt_kalman._factor_psd`) takes its TPU branch, which the port
follows on every device. That branch factors the symmetrised covariance
with no added jitter: in closed form at d <= 2, and with the Pallas
Cholesky (run in interpret mode) above.

Usage (from the repository root):
    python scripts/port/make_temporal_golden.py
"""
import functools
import os
import sys

GOLDEN = os.path.join("tests", "data", "temporal_T256_golden.npz")
GOLDEN_PREDICT = os.path.join("tests", "data", "predict_T256_golden.npz")
T, CHUNK, STEPS, LR = 256, 64, 3, 0.5
N_NEW, N5_NEW = 50, 40


def new_times():
    """(t_new, y_new, t5_new): the prediction inputs, from numpy seeds."""
    import numpy as np

    t_new = np.sort(np.random.default_rng(7).uniform(0, 1000, N_NEW))
    y_new = np.random.default_rng(8).poisson(np.exp(1.2 * np.sin(0.1 * t_new)))[:, None]
    t5_new = np.sort(np.random.default_rng(9).uniform(0, 100, N5_NEW))
    return t_new, y_new.astype(np.float64), t5_new


def use_tpu_factor_branch():
    """Route the JAX square-root smoother's `_factor_psd` to its TPU branch."""
    from physs_gp_tpu.ops import matrix, parallel_sqrt_kalman
    from physs_gp_tpu.ops.pallas import batched_chol

    chol = functools.partial(batched_chol.batch_cholesky.__wrapped__, interpret=True)

    def factor_psd(L):
        S = matrix.symmetrize(L)
        return matrix._cholesky_any(S, assume_psd=True) if S.shape[-1] <= 2 else chol(S)

    parallel_sqrt_kalman._factor_psd = factor_psd


def reference_runs():
    """Run the JAX reference; returns (temporal dict, predict dict) of numpy
    arrays."""
    os.environ["PHYSS_INNER_SCAN"] = "blocked"
    os.environ["PHYSS_SCAN_BLOCKS"] = "8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from physs_gp_tpu.trainers import natgrad_scan
    from physs_gp_tpu.utils.struct import replace
    from physs_gp_tpu.zoo.bench_configs import build_config5, build_temporal

    use_tpu_factor_branch()
    t_new, y_new, t5_new = new_times()
    fit = jax.jit(lambda m: natgrad_scan(m, LR, n_steps=STEPS))
    temporal = {}
    predict = {"t_new": t_new, "y_new": y_new, "t5_new": t5_new}
    for form, sqrt in (("cov", False), ("sqrt", True)):
        model = replace(build_temporal(T, CHUNK, dtype=jnp.float64), sqrt=sqrt)
        model, elbos = fit(model)
        post = jax.jit(lambda m: m.posterior())(model)
        temporal.update({
            f"{form}_elbos": np.asarray(elbos),
            f"{form}_site_Y": np.asarray(model.sites.Y),
            f"{form}_site_V_diag": np.asarray(jnp.diagonal(model.sites.V, axis1=-2, axis2=-1)),
            f"{form}_post_mean": np.asarray(post.mean),
            f"{form}_post_var": np.asarray(post.var),
        })
        f, y, nlpd = jax.jit(lambda m, t, yy: (m.predict_f(t), m.predict_y(t), m.nlpd(t, yy)))(
            model, jnp.asarray(t_new), jnp.asarray(y_new))
        predict.update({
            f"{form}_f_mean": np.asarray(f.mean), f"{form}_f_var": np.asarray(f.var),
            f"{form}_y_mean": np.asarray(y.mean), f"{form}_y_var": np.asarray(y.var),
            f"{form}_nlpd": np.asarray(nlpd),
        })
        c5, _ = fit(build_config5(T, CHUNK, dtype=jnp.float64, sqrt=sqrt))
        f5 = jax.jit(lambda m, t: m.predict_f(t))(c5, jnp.asarray(t5_new))
        predict.update({f"c5_{form}_f_mean": np.asarray(f5.mean),
                        f"c5_{form}_f_var": np.asarray(f5.var)})
    return temporal, predict


def main():
    import numpy as np

    temporal, predict = reference_runs()
    for out, arrays in ((GOLDEN, temporal), (GOLDEN_PREDICT, predict)):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        np.savez_compressed(out, **arrays)
        print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()

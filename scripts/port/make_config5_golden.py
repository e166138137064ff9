"""Write the config-5 reference run of the JAX package to a golden file.

The run: `build_config5(256, 64, float64)` on the CPU with the blocked scan
schedule (PHYSS_INNER_SCAN=blocked, PHYSS_SCAN_BLOCKS=8), then 3
`natgrad_scan` steps at lr 0.5. The file holds the 3 step ELBOs, the final
site means Y, the diagonal of the final site covariances V, and the
posterior mean and variance. The PyTorch port's tests and `chip_smoke.py`
hold the port to it; a CPU test checks that the JAX package still
reproduces it.

`--sqrt` runs the square-root model (`sqrt=True`) into
`config5_sqrt_T256_golden.npz`. There the smoother's final factorisation
(`parallel_sqrt_kalman._factor_psd`) takes its TPU branch, the Pallas
Cholesky with its pivot floor and no added jitter (run in interpret mode),
which the port follows on every device. Its CPU branch adds 1e-12 I before
`jnp.linalg.cholesky`, which moves the step-1 ELBO by 2.8e-9 relative.

Usage (from the repository root):
    python scripts/port/make_config5_golden.py [--sqrt] [out.npz]
"""
import functools
import os
import sys

GOLDEN = os.path.join("tests", "data", "config5_T256_golden.npz")
GOLDEN_SQRT = os.path.join("tests", "data", "config5_sqrt_T256_golden.npz")
T, CHUNK, STEPS, LR = 256, 64, 3, 0.5


def use_tpu_factor_branch():
    """Route the JAX square-root smoother's `_factor_psd` to its TPU branch:
    the Pallas Cholesky (interpret mode) on the symmetrised covariance."""
    from physs_gp_tpu.ops import matrix, parallel_sqrt_kalman
    from physs_gp_tpu.ops.pallas import batched_chol

    chol = functools.partial(batched_chol.batch_cholesky.__wrapped__, interpret=True)
    parallel_sqrt_kalman._factor_psd = lambda L: chol(matrix.symmetrize(L))


def reference_run(sqrt: bool = False):
    """Run the JAX reference; returns a dict of numpy arrays."""
    os.environ["PHYSS_INNER_SCAN"] = "blocked"
    os.environ["PHYSS_SCAN_BLOCKS"] = "8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from physs_gp_tpu.trainers import natgrad_scan
    from physs_gp_tpu.zoo.bench_configs import build_config5

    if sqrt:
        use_tpu_factor_branch()
    model = build_config5(T, CHUNK, dtype=jnp.float64, sqrt=sqrt)
    model, elbos = jax.jit(lambda m: natgrad_scan(m, LR, n_steps=STEPS))(model)
    post = jax.jit(lambda m: m.posterior())(model)
    return {
        "elbos": np.asarray(elbos),
        "site_Y": np.asarray(model.sites.Y),
        "site_V_diag": np.asarray(jnp.diagonal(model.sites.V, axis1=-2, axis2=-1)),
        "post_mean": np.asarray(post.mean),
        "post_var": np.asarray(post.var),
    }


def main():
    import numpy as np

    args = sys.argv[1:]
    sqrt = "--sqrt" in args
    args = [a for a in args if a != "--sqrt"]
    out = args[0] if args else (GOLDEN_SQRT if sqrt else GOLDEN)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, **reference_run(sqrt))
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()

"""Write the config-5 reference run of the JAX package to a golden file.

The run: `build_config5(256, 64, float64)` on the CPU with the blocked scan
schedule (PHYSS_INNER_SCAN=blocked, PHYSS_SCAN_BLOCKS=8), then 3
`natgrad_scan` steps at lr 0.5. The file holds the 3 step ELBOs, the final
site means Y, the diagonal of the final site covariances V, and the
posterior mean and variance. The PyTorch port's tests and `chip_smoke.py`
hold the port to it; a CPU test checks that the JAX package still
reproduces it.

Usage (from the repository root):
    python scripts/port/make_config5_golden.py [out.npz]
"""
import os
import sys

GOLDEN = os.path.join("tests", "data", "config5_T256_golden.npz")
T, CHUNK, STEPS, LR = 256, 64, 3, 0.5


def reference_run():
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

    model = build_config5(T, CHUNK, dtype=jnp.float64)
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

    out = sys.argv[1] if len(sys.argv) > 1 else GOLDEN
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, **reference_run())
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()

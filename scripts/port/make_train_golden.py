"""Write the hyperparameter-training reference run of the JAX package to
`tests/data/train_T256_golden.npz`.

For each model and form (`c5_cov`, `c5_sqrt`: `build_config5(256, 64,
float64)`; `t_cov`, `t_sqrt`: `build_temporal(256, 64, float64)`), on the
CPU with the blocked scan schedule (PHYSS_INNER_SCAN=blocked,
PHYSS_SCAN_BLOCKS=8):
  1. 2 `natgrad_scan` steps at lr 0.5;
  2. `get_objective()` and its gradient with respect to every trainable
     raw (`utils.training.trainable_mask`), by key path;
  3. 3 iterations of `vb_ng_adam_scan(adam_lr=0.05, ng_lr=0.5)`: the
     ELBOs, the final raws by key path, site means, site variances'
     diagonals, and the posterior mean and variance.
Keys are `<form>:<field>`, with `<form>:grad:<key path>` and
`<form>:raw:<key path>`. In square-root form the smoother's final
factorisation (`parallel_sqrt_kalman._factor_psd`) takes its TPU branch, as
`make_config5_golden.py` and `make_temporal_golden.py` set it: closed form
at d <= 2, the Pallas Cholesky (interpret mode) above, no added jitter.
The PyTorch port's tests and `chip_smoke.py` hold the port to this file.

Usage (from the repository root; about 3 minutes):
    python scripts/port/make_train_golden.py [out.npz]
"""
import functools
import os
import sys

GOLDEN = os.path.join("tests", "data", "train_T256_golden.npz")
T, CHUNK, NG_STEPS, NG_LR, ITERS, ADAM_LR = 256, 64, 2, 0.5, 3, 0.05
FORMS = {"c5_cov": ("config5", False), "c5_sqrt": ("config5", True),
         "t_cov": ("temporal", False), "t_sqrt": ("temporal", True)}


def use_tpu_factor_branch(setattr=setattr):
    """Route the JAX square-root smoother's `_factor_psd` to its TPU branch,
    differentiable as on the TPU: the Pallas Cholesky (interpret mode) under
    `matrix._pallas_chol_core`, whose backward recomputes through
    `jnp.linalg.cholesky`; closed form at d <= 2. `setattr` may be a test's
    `monkeypatch.setattr`."""
    from physs_gp_tpu.ops import matrix, parallel_sqrt_kalman
    from physs_gp_tpu.ops.pallas import batched_chol

    setattr(batched_chol, "batch_cholesky",
            functools.partial(batched_chol.batch_cholesky.__wrapped__, interpret=True))

    def factor_psd(L):
        S = matrix.symmetrize(L)
        return matrix._cholesky_any(S, assume_psd=True) if S.shape[-1] <= 2 else matrix._pallas_chol_core(S)

    setattr(parallel_sqrt_kalman, "_factor_psd", factor_psd)


def jax_model(form: str):
    """The JAX model of `form` in float64, before any step."""
    import jax.numpy as jnp

    from physs_gp_tpu.utils.struct import replace
    from physs_gp_tpu.zoo import bench_configs

    which, sqrt = FORMS[form]
    model = getattr(bench_configs, f"build_{which}")(T, CHUNK, dtype=jnp.float64)
    return replace(model, sqrt=sqrt)


def _by_path(tree, keep):
    import jax
    import numpy as np

    return {jax.tree_util.keystr(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0] if keep(path, leaf)}


def reference_run(form: str):
    """Run the reference for one form; returns ({field: numpy array}, the
    fitted model), the gradients and raws under `grad:<key path>` and
    `raw:<key path>`, the posterior left to the caller. The caller sets the
    scan schedule and `_factor_psd` (see `main`)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from physs_gp_tpu.trainers import natgrad_scan, vb_ng_adam_scan
    from physs_gp_tpu.utils.training import trainable_mask

    model, _ = jax.jit(lambda m: natgrad_scan(m, NG_LR, n_steps=NG_STEPS))(jax_model(form))
    obj, grads = jax.jit(jax.value_and_grad(lambda m: m.get_objective()))(model)
    mask = {jax.tree_util.keystr(p): bool(v)
            for p, v in jax.tree_util.tree_flatten_with_path(trainable_mask(model))[0]}
    out = {"objective": np.asarray(obj)}
    out.update({f"grad:{k}": v for k, v in _by_path(grads, lambda p, _: mask[jax.tree_util.keystr(p)]).items()})
    fitted, elbos = jax.jit(
        lambda m: vb_ng_adam_scan(m, ITERS, adam_lr=ADAM_LR, ng_lr=NG_LR))(model)
    out.update({f"raw:{k}": v for k, v in
                _by_path(fitted, lambda p, _: jax.tree_util.keystr(p).endswith(".raw")).items()})
    out.update({
        "elbos": np.asarray(elbos),
        "site_Y": np.asarray(fitted.sites.Y),
        "site_V_diag": np.asarray(jnp.diagonal(fitted.sites.V, axis1=-2, axis2=-1)),
    })
    return out, fitted


def main():
    os.environ["PHYSS_INNER_SCAN"] = "blocked"
    os.environ["PHYSS_SCAN_BLOCKS"] = "8"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    use_tpu_factor_branch()
    out = sys.argv[1] if len(sys.argv) > 1 else GOLDEN
    arrays = {}
    for form in FORMS:
        run, fitted = reference_run(form)
        post = jax.jit(lambda m: m.posterior())(fitted)
        run.update(post_mean=np.asarray(post.mean), post_var=np.asarray(post.var))
        arrays.update({f"{form}:{k}": v for k, v in run.items()})
        print(f"{form}: objective {float(arrays[f'{form}:objective'])!r}", flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()

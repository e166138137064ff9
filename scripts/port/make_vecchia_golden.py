"""Write the JAX package's reference runs of VecchiaGP, GPRN and
LatentVariableGP to `tests/data/vecchia_golden.npz`.

Every run uses the CPU in float64; the inputs and settings come from
`vecchia_outcome.py` (numpy), the port's side of the same configurations.
Each model's `.raw` leaves are moved off their start values by
RAW_SHIFT times seeded standard-normal draws, and stored under
`<config>::flat::<key path>` for the port to load. Keys are
`<config>::<output>`:

- `vec`: `lml`, `grad::<raw path>` (of the lml), `f_mean` / `f_var`,
  `f_wide_mean` / `f_wide_var` (`m_predict` = 40), `y_mean` / `y_var`,
  `nlpd`;
- `vec_nan` (every 5th y missing, a `ConstantMean`): `lml`, `grad::`,
  `f_mean` / `f_var`;
- `gprn_<mixing>`: `in::eps` (the ELBO's draws of the model's key),
  `in::eps_pred` (`predict_f`'s, of `fold_in(key, 1)`), `elbo`, `kl`,
  `grad::` (of the ELBO), `f_mean` / `f_var`;
- `lvgp_<mode>`: `objective`, `grad::` (of the objective), `f_mean` /
  `f_var`, `f_w_mean` / `f_w_var` (with W_new);
- `lvgp_fit`: `in::W0`, the initial latents that
  `tests/test_input_transforms.py:78` draws from `PRNGKey(0)`.

Usage (from the repository root; about a minute on the CPU):
    python scripts/port/make_vecchia_golden.py [out.npz]
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import vecchia_outcome as vo  # noqa: E402


def jax_setup():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def _jrbf(ls, var=1.0):
    import jax.numpy as jnp

    from physs_gp_tpu.kernels.rbf import RBF
    from physs_gp_tpu.utils.params import positive_param

    return RBF(lengthscales=positive_param(jnp.asarray(ls, jnp.float64)),
               variance=positive_param(jnp.asarray(var, jnp.float64)))


def _jgauss(v):
    import jax.numpy as jnp

    from physs_gp_tpu.likelihoods.gaussian import Gaussian
    from physs_gp_tpu.utils.params import positive_param

    return Gaussian(variance=positive_param(jnp.asarray(v, jnp.float64)))


def shift_raws(model, seed):
    """The model with RAW_SHIFT times standard-normal draws added to every
    `.raw` leaf."""
    import jax

    rng = np.random.default_rng(seed)
    paths, treedef = jax.tree_util.tree_flatten_with_path(model)
    return jax.tree_util.tree_unflatten(treedef, [
        v + vo.RAW_SHIFT * rng.standard_normal(np.shape(v))
        if jax.tree_util.keystr(k).endswith(".raw") else v for k, v in paths])


def raw_leaves(model):
    import jax

    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(model)[0]
            if jax.tree_util.keystr(k).endswith(".raw")}


def compute():
    """{key: numpy array} of every configuration (see the module doc)."""
    import jax
    import jax.numpy as jnp

    from physs_gp_tpu.means.mean import ConstantMean
    from physs_gp_tpu.models import GPRN, LatentVariableGP, VecchiaGP
    from physs_gp_tpu.utils.params import param
    from physs_gp_tpu.utils.struct import replace

    out = {}

    def put(cfg, **kv):
        out.update({f"{cfg}::{k}": np.asarray(v) for k, v in kv.items()})

    def put_model(cfg, model, grads):
        put(cfg, **{f"flat::{k}": v for k, v in raw_leaves(model).items()})
        put(cfg, **{f"grad::{k}": v for k, v in raw_leaves(grads).items()})

    def moments(cfg, key, f):
        put(cfg, **{f"{key}_mean": f.mean, f"{key}_var": f.var})

    # one jitted program per configuration: the value and its gradient by
    # every raw, then the predictions
    X, Y, Xs, Ys = vo.vecchia_inputs()
    for i, cfg in enumerate(("vec", "vec_nan")):
        nan = cfg == "vec_nan"
        m = VecchiaGP.init(X, vo.with_missing(Y) if nan else Y, _jrbf(vo.VEC["ls"], vo.VEC["var"]),
                           _jgauss(vo.VEC["noise"]), m=vo.VEC["m"])
        if nan:
            m = replace(m, mean=ConstantMean(c=param(jnp.asarray(0.0, jnp.float64))))
        m = shift_raws(m, seed=100 + i)

        def run(mm, x, y, nan=nan):
            vg = jax.value_and_grad(lambda q: q.log_marginal_likelihood())(mm)
            if nan:
                return vg, (mm.predict_f(x),)
            return vg, (mm.predict_f(x), mm.predict_f(x, m_predict=vo.VEC["m_predict"]),
                        mm.predict_y(x), mm.nlpd(x, y))

        (lml, g), res = jax.jit(run)(m, jnp.asarray(Xs), jnp.asarray(Ys))
        put_model(cfg, m, g)
        put(cfg, lml=lml)
        moments(cfg, "f", res[0])
        if not nan:
            moments(cfg, "f_wide", res[1])
            moments(cfg, "y", res[2])
            put(cfg, nlpd=res[3])
        print(f"[{cfg}] lml {float(lml):.10f}")

    X, Y, Z, Xs = vo.gprn_inputs()
    for i, mixing in enumerate(vo.MIXINGS):
        cfg = f"gprn_{mixing}"
        m = GPRN.init(X, Y, Z, kernel_w=_jrbf(vo.GP["ls_w"]), kernel_g=_jrbf(vo.GP["ls_g"]),
                      n_latent=vo.GP["L"], noise=vo.GP["noise"], n_mc=vo.GP["n_mc"], mixing=mixing)
        m = shift_raws(m, seed=200 + i)
        L_tot = m.q_mu.raw.shape[0]
        eps = jax.random.normal(m.key, (vo.GP["n_mc"], L_tot, X.shape[0]), jnp.float64)
        eps_pred = jax.random.normal(jax.random.fold_in(m.key, 1),
                                     (vo.GP["n_pred_mc"], L_tot, Xs.shape[0]), jnp.float64)
        (elbo, g), kl, f = jax.jit(lambda mm, x: (jax.value_and_grad(lambda q: q.elbo())(mm), mm._kl(),
                                                  mm.predict_f(x, n_mc=vo.GP["n_pred_mc"])))(
            m, jnp.asarray(Xs))
        put(cfg, **{"in::eps": eps, "in::eps_pred": eps_pred})
        put_model(cfg, m, g)
        put(cfg, elbo=elbo, kl=kl)
        moments(cfg, "f", f)
        print(f"[{cfg}] elbo {float(elbo):.10f}")

    for i, mode in enumerate(vo.MODES):
        cfg = f"lvgp_{mode}"
        X, Y, W0, Xs, W_new = vo.lvgp_inputs(mode)
        ls = [1.0, 1.0] if mode == "concat" else [1.0]
        m = LatentVariableGP.init(jnp.asarray(X), jnp.asarray(Y), _jrbf(ls), _jgauss(vo.LV["noise"]),
                                  dw=1, mode=mode, W0=jnp.asarray(W0))
        m = shift_raws(m, seed=300 + i)
        (obj, g), f, fw = jax.jit(lambda mm, x, w: (jax.value_and_grad(lambda q: q.get_objective())(mm),
                                                    mm.predict_f(x), mm.predict_f(x, W_new=w)))(
            m, jnp.asarray(Xs), jnp.asarray(W_new))
        put_model(cfg, m, g)
        put(cfg, objective=obj)
        moments(cfg, "f", f)
        moments(cfg, "f_w", fw)
        print(f"[{cfg}] objective {float(obj):.10f}")

    put("lvgp_fit", **{"in::W0": 0.01 * jax.random.normal(jax.random.PRNGKey(0), (vo.LV_FIT["N"], 1),
                                                           jnp.float64)})
    return out


def main():
    jax_setup()
    path = sys.argv[1] if len(sys.argv) > 1 else vo.GOLDEN
    out = compute()
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {len(out)} arrays, {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()

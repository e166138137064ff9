"""Write the scattered-sensor and vector-field paths' reference runs of the
JAX package to `tests/data/vector_field_golden.npz`.

Every run uses the CPU in float64 and the sequential covariance filters
(`scs`: square-root);
the inputs come from `vector_field_outcome.py` and the drivers
`experiments_torch/scattered_st.py` and `helmholtz.py` (numpy), the port's
side of the same configurations. Keys are `<config>::in::<name>` (inputs),
`<config>::flat::<key path>` (the JAX model's leaves, which the port loads
with `interop.load_numpy_params`) and `<config>::<output>`.

- `sc`: the scattered experiment's full configuration
  (`experiments/scattered_st.py`: 200 times, 1-4 sensors each, 516 rows,
  20 % held out, seed 0) with its 12 k-means inducing sites (`sc::in::Z`,
  from the JAX recipe's `kmeans2(seed=0)`, so the port needs no k-means of
  its own): lml, the posterior at the training rows (`unsort`) and
  `scattered_st_predict` at the held-out rows; `scs`: the same outputs in
  the sequential square-root form, which the port's square-root anchor is
  held to (the square-root form's relative jitter on Q, R and P0 moves the
  posterior by up to 2.1e-9 of its scale from the covariance form's).
- `sp`: `sparse_st_gp(train_z=True)` on `sparse_inputs()`, every raw
  moved by +0.05: lml and its gradient by raw (`sp::grad::<key>`).
- `hz`: the Helmholtz experiment's quick configuration (T = 16, Ns = 25,
  state D = 100): lml and `helmholtz_st_predict` at its 12 new sites;
  `hzs`: the same in the sequential square-root form (D = 100 is above
  the port's kernels, so this form runs PyTorch's own factorisations);
  `hzc`: the same as `cvi=True` with every raw moved by +0.05, one
  `step_with_elbo(1.0)`: the ELBO and the prediction after the step.
- `mf0` / `mf1`: `magnetic_field_gp` without / with the potential block on
  `magnetic_inputs`, raws +0.05: lml and `magnetic_field_predict` at 4 new
  sites.
- `lmc`: `lmc_markov_gp` with a Param mixing W, raws +0.05: lml; `lmcc`:
  the Poisson CVI model with `UnitLowerMixing` (z = 0.05): the ELBOs of two
  `step_with_elbo(0.8)`.

Usage (from the repository root; about a minute on the CPU):
    python scripts/port/make_vector_field_golden.py

The JAX model functions here (`jax_*`) are what the CPU parity tests hold
the port to as well.
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import vector_field_outcome as vf  # noqa: E402

from experiments_torch import helmholtz as hz  # noqa: E402
from experiments_torch import scattered_st as sc  # noqa: E402

GOLDEN = vf.GOLDEN
SHIFT = 0.05  # added to every raw of the perturbed configurations


def jax_setup():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def jax_scattered(train, Z=None, parallel=False, sqrt=False, chunk_size=None):
    import jax.numpy as jnp

    from physs_gp_tpu.kernels import Matern32, RBF
    from physs_gp_tpu.utils.params import positive_param
    from physs_gp_tpu.zoo import scattered_st_gp

    return scattered_st_gp(
        train[:, :3], train[:, 3], Z=Z, n_inducing=sc.N_INDUCING if Z is None else None,
        k_time=Matern32(lengthscale=1.5, variance=1.0),
        k_space=RBF(lengthscales=positive_param(jnp.array([0.8, 0.8])), variance=positive_param(1.0)),
        noise=sc.NOISE**2, parallel=parallel, sqrt=sqrt, chunk_size=chunk_size,
    )


def jax_sparse(t, Y, X_space, Z):
    import jax.numpy as jnp

    from physs_gp_tpu.kernels import Matern32, RBF
    from physs_gp_tpu.utils.params import positive_param
    from physs_gp_tpu.zoo import sparse_st_gp

    return sparse_st_gp(
        t, Y, X_space, Z, k_time=Matern32(lengthscale=0.9, variance=1.2),
        k_space=RBF(lengthscales=positive_param(jnp.array([0.7, 0.8])), variance=positive_param(1.1)),
        noise=0.1, train_z=True,
    )


def jax_helmholtz(t, Z, Y, cvi=False, parallel=False, sqrt=False, chunk_size=None):
    import jax.numpy as jnp

    from physs_gp_tpu.kernels import Matern32, RBF
    from physs_gp_tpu.utils.params import positive_param
    from physs_gp_tpu.zoo import helmholtz_st_gp

    return helmholtz_st_gp(
        t, Y, Z, k_time=Matern32(lengthscale=jnp.asarray(2.0), variance=jnp.asarray(1.0)),
        k_space=(RBF(lengthscales=positive_param(jnp.ones(2)), variance=positive_param(1.0)),
                 RBF(lengthscales=positive_param(jnp.ones(2)), variance=positive_param(0.1))),
        noise=hz.NOISE**2, cvi=cvi, parallel=parallel, sqrt=sqrt, chunk_size=chunk_size,
    )


def jax_magnetic(t, Z, Y, pot, parallel=False, sqrt=False, chunk_size=None, cvi=False):
    import jax.numpy as jnp

    from physs_gp_tpu.kernels import Matern32, RBF
    from physs_gp_tpu.utils.params import positive_param
    from physs_gp_tpu.zoo import magnetic_field_gp

    return magnetic_field_gp(
        t, Y, Z, k_time=Matern32(lengthscale=0.8, variance=1.3),
        k_space=RBF(lengthscales=positive_param(jnp.array([0.7, 0.9])), variance=positive_param(1.1)),
        noise=0.04, include_potential=pot, parallel=parallel, sqrt=sqrt, chunk_size=chunk_size,
        cvi=cvi,
    )


def jax_lmc_latents():
    from physs_gp_tpu.kernels import Matern32, Matern52

    return [Matern32(lengthscale=0.7, variance=1.0), Matern52(lengthscale=1.8, variance=0.6)]


def jax_lmc(t, Y, W, parallel=False, chunk_size=None):
    import jax.numpy as jnp

    from physs_gp_tpu.utils.params import param
    from physs_gp_tpu.zoo import lmc_markov_gp

    return lmc_markov_gp(t, Y, jax_lmc_latents(), mixing=param(jnp.asarray(W)), noise=0.05,
                         parallel=parallel, chunk_size=chunk_size)


def jax_lmc_cvi(t, counts):
    from physs_gp_tpu.kernels.multi_output import UnitLowerMixing
    from physs_gp_tpu.likelihoods import Poisson
    from physs_gp_tpu.zoo import lmc_markov_gp

    return lmc_markov_gp(t, counts, jax_lmc_latents(), mixing=UnitLowerMixing.init(2, 2),
                         likelihood=Poisson(), cvi=True)


def shift_raws(model, shift=SHIFT):
    """The model with `shift` added to every `.raw` leaf."""
    import jax

    paths, treedef = jax.tree_util.tree_flatten_with_path(model)
    return jax.tree_util.tree_unflatten(treedef, [
        v + shift if jax.tree_util.keystr(k).endswith(".raw") else v for k, v in paths])


def leaves(model):
    """{key path: numpy leaf} of a JAX model, without the data and the CVI
    sites (the port's constructors build those from the same inputs)."""
    import jax

    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(model)[0]
            if not jax.tree_util.keystr(k).startswith((".t", ".Y", ".sites"))}


def lml_and_raw_grads(model):
    """(lml, {key path: gradient of the lml} by every `.raw` leaf)."""
    import jax

    lml, g = jax.jit(jax.value_and_grad(lambda m: m.log_marginal_likelihood()))(model)
    return np.asarray(lml), {jax.tree_util.keystr(k): np.asarray(v)
                             for k, v in jax.tree_util.tree_flatten_with_path(g)[0]
                             if jax.tree_util.keystr(k).endswith(".raw")}


def main():
    jax_setup()
    import jax
    import jax.numpy as jnp

    from physs_gp_tpu.zoo import helmholtz_st_predict, magnetic_field_predict
    from physs_gp_tpu.zoo.spatio_temporal import scattered_st_predict

    out = {}

    def put(cfg, **kv):
        out.update({f"{cfg}::{k}": np.asarray(v) for k, v in kv.items()})

    def put_in(cfg, **kv):
        put(cfg, **{f"in::{k}": v for k, v in kv.items()})

    def put_flat(cfg, model):
        put(cfg, **{f"flat::{k}": v for k, v in leaves(model).items()})

    # scattered: the experiment's full configuration
    train, test = sc.rows()
    m, data = jax_scattered(train)
    Z = np.asarray(m.kernel.Z)
    post = m.posterior()
    pred = scattered_st_predict(m, data, test[:, :3])
    res = {"lml": m.log_marginal_likelihood(), "post_mean": data.unsort(np.asarray(post.mean))[:, 0],
           "post_var": data.unsort(np.asarray(post.var))[:, 0],
           "pred_mean": np.asarray(pred.mean)[:, 0], "pred_var": np.asarray(pred.var)[:, 0]}
    put_in("sc", train=train, test=test, Z=Z)
    put("sc", **res)
    metrics = sc.metrics({k: np.asarray(v) for k, v in res.items()}, train, test)
    print(f"[sc] rows {train.shape[0] + test.shape[0]}, Ng {data.Ng}, metrics {metrics}")
    # the same in the square-root form (its relative jitter on Q, R and P0
    # moves the posterior by ~1e-9 of its scale from the covariance form's)
    m, data = jax_scattered(train, Z, sqrt=True)
    lml, post = jax.jit(lambda mm: (mm.log_marginal_likelihood(), mm.posterior()))(m)
    pred = scattered_st_predict(m, data, test[:, :3])
    put("scs", lml=lml, post_mean=data.unsort(np.asarray(post.mean))[:, 0],
        post_var=data.unsort(np.asarray(post.var))[:, 0], pred_mean=np.asarray(pred.mean)[:, 0],
        pred_var=np.asarray(pred.var)[:, 0])

    # sparse sites with a trainable Z
    t, Y, X_space, Zs = vf.sparse_inputs()
    m = shift_raws(jax_sparse(t, Y, X_space, Zs))
    put_in("sp", t=t, Y=Y, X_space=X_space, Z=Zs)
    put_flat("sp", m)
    lml, grads = lml_and_raw_grads(m)
    put("sp", lml=lml, **{f"grad::{k}": v for k, v in grads.items()})

    # Helmholtz quick configuration, conjugate and one CVI step
    t, Zh, Yh, S_new = hz.inputs(hz.T_QUICK)
    m = jax_helmholtz(t, Zh, Yh)
    pred = jax.jit(lambda mm, ss: helmholtz_st_predict(mm, ss))(m, jnp.asarray(S_new))
    put_in("hz", t=t, Z=Zh, Y=Yh, S_new=S_new)
    put_flat("hz", m)
    put("hz", lml=m.log_marginal_likelihood(), pred_mean=pred.mean, pred_var=pred.var)
    print(f"[hz] metrics {hz.metrics(np.asarray(pred.mean), np.asarray(pred.var), t, S_new)}")
    ms = jax_helmholtz(t, Zh, Yh, sqrt=True)
    pred = jax.jit(lambda mm, ss: helmholtz_st_predict(mm, ss))(ms, jnp.asarray(S_new))
    put("hzs", lml=ms.log_marginal_likelihood(), pred_mean=pred.mean, pred_var=pred.var)
    mc = shift_raws(jax_helmholtz(t, Zh, Yh, cvi=True))
    put_flat("hzc", mc)
    mc, elbo = jax.jit(lambda mm: mm.step_with_elbo(1.0))(mc)
    pred = jax.jit(lambda mm, ss: helmholtz_st_predict(mm, ss))(mc, jnp.asarray(S_new))
    put("hzc", elbo=elbo, pred_mean=pred.mean, pred_var=pred.var)

    # magnetic field without and with the potential block
    for pot in (False, True):
        cfg = f"mf{int(pot)}"
        t, Zm, Ym, s_new = vf.magnetic_inputs(pot)
        m = shift_raws(jax_magnetic(t, Zm, Ym, pot))
        pred = magnetic_field_predict(m, jnp.asarray(s_new), include_potential=pot)
        put_in(cfg, t=t, Z=Zm, Y=Ym, s_new=s_new)
        put_flat(cfg, m)
        put(cfg, lml=m.log_marginal_likelihood(), pred_mean=pred.mean, pred_var=pred.var)

    # LMC: conjugate, then Poisson CVI with unit-lower mixing
    t, Yl, counts, W = vf.lmc_inputs()
    m = shift_raws(jax_lmc(t, Yl, W))
    put_in("lmc", t=t, Y=Yl, counts=counts, W=W)
    put_flat("lmc", m)
    put("lmc", lml=m.log_marginal_likelihood())
    mc = shift_raws(jax_lmc_cvi(t, counts))
    put_flat("lmcc", mc)
    step = jax.jit(lambda mm: mm.step_with_elbo(0.8))
    elbos = []
    for _ in range(2):
        mc, elbo = step(mc)
        elbos.append(elbo)
    put("lmcc", elbos=np.asarray(elbos))

    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}: {len(out)} arrays, {os.path.getsize(GOLDEN)} bytes")


if __name__ == "__main__":
    sys.path.insert(0, vf.REPO)
    main()

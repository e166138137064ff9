"""Write the batch GP family's reference runs of the JAX package to
`tests/data/batch_golden.npz`.

Every run uses the CPU in float64; the inputs come from `batch_outcome.py`
(numpy), the port's side of the same configurations. Keys are
`<config>::in::<name>` (inputs), `<config>::flat::<key path>` (the JAX
model's leaves, which the port loads with `interop.load_numpy_params`) and
`<config>::<output>`.

- `cf` / `hz`: `curl_free_gp` on `experiments/curl_free.py`'s quick data
  (N = 40) and `helmholtz_gp` on a curl- plus divergence-free field (N =
  40, 4 entries missing), every raw moved by +0.05: lml, its gradient by
  raw (`grad::<key>`), `predict_f` and `predict_y` at the new points.
- `dg`: `deriv_gp` (f, ∂t f, ∂s f of f = sin t cos s, 20 % NaN), raws
  +0.05: the same outputs and `samples`, the joint posterior draws from the
  stored standard-normal `eps`.
- `cg`: `BatchGP(solver="cg")` with RBF (lengthscale 0.5, noise 0.5) at
  N = 40, raws +0.05, and `probes`, the Rademacher probes of the JAX lml's
  fixed key: lml, its gradient, `predict_f`.
- `sw` / `su`: `SVGP` whitened / unwhitened (RBF, Gaussian, M = 10), raws
  +0.05 (q included): `elbo0`, one `natural_gradient_update(1.0)`, then
  `elbo1`, the raws `q_mu` and `q_sqrt` and `predict_f`.
- `mv`: the monotonic experiment's batch-VI arm at its quick size
  (`deriv_vgp`, Matérn-7/2, Gaussian + Probit, Z = 30, unwhitened): the
  ELBO after each of 5 steps at lr 0.5 (`elbos`) and `predict_f` at
  `t_test`.
- `lmc`: `BatchGP` over a batch `LMC` (two RBF latents, three outputs,
  15 % NaN) with a `ConstantMean`, raws +0.05: lml, its gradient,
  `predict_f`, `predict_y`.
- `mvf`: the batch-VI arm at full size (Z = 50, 300 steps at lr 0.5), once
  as `experiments/monotonic.py` runs it and once from each start with
  q_mu moved by `batch_outcome.MV_PERTURB`: `rmse_gap_vgp`,
  `deriv_violation_rate_vgp`, `elbo` and every step's ELBO (`elbo_trace`)
  per run (the runs end apart; the outcome gate's references are those
  that have locked into a cycle, `batch_outcome.locked_runs`).

Usage (from the repository root; about two minutes on the CPU):
    python scripts/port/make_batch_golden.py

The JAX model functions here (`jax_*`) are what the CPU parity tests hold
the port to as well.
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import batch_outcome as bo  # noqa: E402

from experiments_torch import curl_free as cf  # noqa: E402

GOLDEN = bo.GOLDEN
SHIFT = 0.05  # added to every raw of the perturbed configurations


def jax_setup():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def _jrbf(ls, var):
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


def jax_cf(X, Y):
    from physs_gp_tpu.zoo import curl_free_gp

    return curl_free_gp(X, Y, noise=bo.CF_NOISE**2)


def jax_hz(X, Y):
    from physs_gp_tpu.zoo import helmholtz_gp

    return helmholtz_gp(X, Y, noise=bo.CF_NOISE**2)


def jax_dg(X, Y):
    from physs_gp_tpu.zoo import deriv_gp

    return deriv_gp(X, Y, time_diff=1, space_diff=1, noise=0.05**2)


def jax_cg(X, Y, ls=bo.CG_LS, noise=bo.CG_NOISE, solver="cg"):
    import jax.numpy as jnp

    from physs_gp_tpu.models.batch_gp import BatchGP

    return BatchGP(X=jnp.asarray(X), Y=jnp.asarray(Y), kernel=_jrbf([ls, ls], 1.0),
                   likelihood=_jgauss(noise), solver=solver)


def jax_svgp(X, Y, Z, whiten):
    from physs_gp_tpu.models.svgp import SVGP

    return SVGP.init(X, Y, Z, _jrbf(bo.SVGP_LS, 1.0), _jgauss(0.01), whiten=whiten)


def jax_mv(X, Y, Z):
    from physs_gp_tpu.kernels import Matern72
    from physs_gp_tpu.likelihoods import Probit
    from physs_gp_tpu.zoo import deriv_vgp

    return deriv_vgp(X, Y, time_diff=1, space_diff=None,
                     kernel=Matern72(lengthscale=1.0, variance=1.0),
                     liks=[_jgauss(bo.MV_NOISE**2), Probit(nu=1e-2)], Z=Z, whiten=False)


def jax_lmc(X, Y):
    import jax
    import jax.numpy as jnp

    from physs_gp_tpu.kernels.multi_output import LMC
    from physs_gp_tpu.means.mean import ConstantMean
    from physs_gp_tpu.models.batch_gp import BatchGP
    from physs_gp_tpu.utils.params import param

    kern = LMC.init([_jrbf(0.8, 1.0), _jrbf(2.0, 1.0)], P=3, key=jax.random.PRNGKey(0))
    return BatchGP(X=jnp.asarray(X), Y=jnp.asarray(Y), kernel=kern, likelihood=_jgauss(0.01),
                   mean=ConstantMean(c=param(jnp.asarray(0.0, jnp.float64))))


def jax_probes(n, n_probes=bo.CG_PROBES):
    """The Rademacher probes of the JAX `BatchGP`'s fixed key."""
    import jax
    import jax.numpy as jnp

    return np.asarray(jax.random.rademacher(jax.random.PRNGKey(0), (n_probes, n), dtype=jnp.float64))


def shift_raws(model, shift=SHIFT):
    """The model with `shift` added to every `.raw` leaf."""
    import jax

    paths, treedef = jax.tree_util.tree_flatten_with_path(model)
    return jax.tree_util.tree_unflatten(treedef, [
        v + shift if jax.tree_util.keystr(k).endswith(".raw") else v for k, v in paths])


def leaves(model):
    """{key path: numpy leaf} of a JAX model."""
    import jax

    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(model)[0]}


def lml_and_raw_grads(model):
    """(lml, {key path: gradient of the lml} by every `.raw` leaf)."""
    import jax

    lml, g = jax.jit(jax.value_and_grad(lambda m: m.log_marginal_likelihood()))(model)
    return np.asarray(lml), {jax.tree_util.keystr(k): np.asarray(v)
                             for k, v in jax.tree_util.tree_flatten_with_path(g)[0]
                             if jax.tree_util.keystr(k).endswith(".raw")}


def predictions(model, Xs, y=True):
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda m, xs: m.predict_f(xs))(model, jnp.asarray(Xs))
    out = {"f_mean": f.mean, "f_var": f.var}
    if y:
        py = jax.jit(lambda m, xs: m.predict_y(xs))(model, jnp.asarray(Xs))
        out.update(y_mean=py.mean, y_var=py.var)
    return out


def joint_samples(model, Xs, eps):
    """`BatchGP.sample_f`'s formula on the given standard-normal draws."""
    import jax.numpy as jnp

    from physs_gp_tpu.ops.matrix import safe_cholesky_rel

    mean, cov = model.predict_f(jnp.asarray(Xs), full_cov=True)
    Lc = safe_cholesky_rel(cov)
    return np.asarray(mean[None] + (jnp.asarray(eps) @ Lc.T).reshape((eps.shape[0],) + mean.shape))


def main():
    jax_setup()
    import jax

    out = {}

    def put(cfg, **kv):
        out.update({f"{cfg}::{k}": np.asarray(v) for k, v in kv.items()})

    def put_in(cfg, **kv):
        put(cfg, **{f"in::{k}": v for k, v in kv.items()})

    def put_flat(cfg, model, **extra):
        put(cfg, **{f"flat::{k}": v for k, v in {**leaves(model), **extra}.items()})

    def exact(cfg, model, Xs):
        put_flat(cfg, model)
        lml, grads = lml_and_raw_grads(model)
        put(cfg, lml=lml, **{f"grad::{k}": v for k, v in grads.items()}, **predictions(model, Xs))
        print(f"[{cfg}] lml {float(lml):.6f}")

    X, Y, Xs, _ = cf.inputs(quick=True)
    put_in("cf", X=X, Y=Y, Xs=Xs)
    exact("cf", shift_raws(jax_cf(X, Y)), Xs)

    X, Y, Xs = bo.helmholtz_inputs()
    put_in("hz", X=X, Y=Y, Xs=Xs)
    exact("hz", shift_raws(jax_hz(X, Y)), Xs)

    X, Y, Xs = bo.deriv_inputs()
    eps = np.random.default_rng(9).normal(size=(3, Xs.shape[0] * 3))
    put_in("dg", X=X, Y=Y, Xs=Xs, eps=eps)
    m = shift_raws(jax_dg(X, Y))
    exact("dg", m, Xs)
    put("dg", samples=joint_samples(m, Xs, eps))

    X, Y = bo.bench_inputs(bo.CG_N)
    Xs = X[:6] + 0.1
    put_in("cg", X=X, Y=Y, Xs=Xs, probes=jax_probes(bo.CG_N))
    m = shift_raws(jax_cg(X, Y))
    put_flat("cg", m)
    lml, grads = lml_and_raw_grads(m)
    put("cg", lml=lml, **{f"grad::{k}": v for k, v in grads.items()}, **predictions(m, Xs, y=False))
    print(f"[cg] lml {float(lml):.6f} (Cholesky: "
          f"{float(shift_raws(jax_cg(X, Y, solver='cholesky')).log_marginal_likelihood()):.6f})")

    X, Y, Z, Xs = bo.svgp_inputs()
    for cfg, whiten in (("sw", True), ("su", False)):
        m = shift_raws(jax_svgp(X, Y, Z, whiten))
        put_in(cfg, X=X, Y=Y, Z=Z, Xs=Xs)
        put_flat(cfg, m)
        elbo0 = jax.jit(lambda mm: mm.elbo())(m)
        m = jax.jit(lambda mm: mm.natural_gradient_update(1.0))(m)
        put(cfg, elbo0=elbo0, elbo1=jax.jit(lambda mm: mm.elbo())(m), q_mu=m.q_mu.raw,
            q_sqrt=m.q_sqrt.raw, **predictions(m, Xs, y=False))
        print(f"[{cfg}] elbo {float(elbo0):.6f} -> {float(out[cfg + '::elbo1']):.6f}")

    X, Y, Z, t_test, _, _ = bo.monotonic_inputs(quick=True)
    m = jax_mv(X, Y, Z)
    put_in("mv", X=X, Y=Y, Z=Z, t_test=t_test)
    put_flat("mv", m, **{".likelihood.liks[1].nu": 1e-2})
    step = jax.jit(lambda mm: mm.natural_gradient_update(0.5))
    elbo = jax.jit(lambda mm: mm.elbo())
    elbos = []
    for _ in range(bo.MV_STEPS_ANCHOR):
        m = step(m)
        elbos.append(elbo(m))
    put("mv", elbos=np.asarray(elbos), **predictions(m, t_test, y=False))
    print(f"[mv] elbos {np.asarray(elbos)}")

    X, Y, Xs = bo.lmc_inputs()
    put_in("lmc", X=X, Y=Y, Xs=Xs)
    exact("lmc", shift_raws(jax_lmc(X, Y)), Xs)

    from physs_gp_tpu.utils.struct import replace

    X, Y, Z, t_test, in_gap, truth = bo.monotonic_inputs(quick=False)
    pred = jax.jit(lambda mm, ts: mm.predict_f(ts).mean)
    runs = []
    for eps in bo.MV_PERTURB:
        m = jax_mv(X, Y, Z)
        m = replace(m, q_mu=replace(m.q_mu, raw=m.q_mu.raw + eps))
        trace = []
        for _ in range(bo.MV_STEPS):
            m = step(m)
            trace.append(float(elbo(m)))
        mean = np.asarray(pred(m, t_test))
        runs.append((bo.rmse(mean[in_gap, 0], truth[in_gap]), np.mean(mean[:, 1] < -1e-3),
                     trace[-1], trace))
    put("mvf", perturb=np.asarray(bo.MV_PERTURB), rmse_gap_vgp=[r[0] for r in runs],
        deriv_violation_rate_vgp=[r[1] for r in runs], elbo=[r[2] for r in runs],
        elbo_trace=[r[3] for r in runs])
    print(f"[mvf] (rmse_gap_vgp, violation rate, ELBO) by q_mu move {bo.MV_PERTURB}: "
          f"{[r[:3] for r in runs]}")

    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}: {len(out)} arrays, {os.path.getsize(GOLDEN)} bytes")


if __name__ == "__main__":
    main()

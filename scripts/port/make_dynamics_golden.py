"""Write the JAX package's reference runs of the nonlinear-dynamics and
volatility path to `tests/data/dynamics_golden.npz`.

Every run uses the CPU in float64 with the blocked scan schedule
(PHYSS_INNER_SCAN=blocked, PHYSS_SCAN_BLOCKS=8); the inputs come from
`dynamics_outcome.py` (numpy), the port's side of the same configurations.
Keys are `<config>::<output>`, with the JAX leaves a port model loads under
`<config>::flat::<key path>` and the trained raws under
`<config>::raw::<key path>`:

- `pend`: the pendulum `NonlinearSSGP` of `tests/test_ekf.py` at T = 256 by
  `ekf` and by 8 `iterated_parallel` passes (`ekf::` / `ieks::`): lml,
  filtered and smoothed means and covariances, and the lml's gradient by the
  damping `grad_c` (`jax.grad`);
- `lorenz`: `lorenz_gp` on the first 256 rows of the Lorenz test's data by
  both methods (8 passes): the same outputs without the gradient;
- `lv`, `lfm`: `lotka_volterra_gp` and `latent_force_gp` on the first 128
  rows of their tests' data: lml and smoothed means;
- `em`: `euler_maruyama_sample` of the Ornstein-Uhlenbeck SDE from
  PRNGKey(0): its path `xs` and its draws `eps` [T - 1, n_substeps, 1],
  replayed from the same key splits;
- `cc`: `correlation_cholesky` at P = 4; `drd`: a `BatchGP` over
  `LMC.init_drd` (three RBF latents, z moved off zero): its Gram `K` and
  lml; `het`: `HetGaussian`'s block and diagonal ELLs;
- `dc`: `dynamic_covariance_gp` (P = 2, T = 64, n_mc = 16): its two draw
  sets `eps_ell` = normal(PRNGKey(0)) and `eps_ng` = normal(PRNGKey(1)),
  the initial ELL and `natgrad_moments` (`g1`, `g2`), the ELBOs of 5
  `step_with_elbo(0.3, hessian="gauss_newton")` steps and the posterior
  mean after them;
- `lbfgs`: `LBFGSTrainer`, 10 iterations on `_model()` of
  `tests/test_trainers_metrics.py`: losses and raws;
- `vbp`: `VB_NG_LBFGS(ng_lr=0.8)`, 3 epochs on its Poisson CVIGP: the
  losses, `sites_moved` (max |Δ site mean| in each L-BFGS step: the
  reference's memory carries the natural-gradient step's site change into
  its direction from its second step), and under `trainable::` the same
  epochs with `optax.lbfgs` + `scale_by_zoom_linesearch` over the
  trainable leaves only (losses and raws), the algorithm the port runs;
- `vbc5`: config-5 at T = 256, 2 epochs at ng_lr 0.5 with the
  trainable-leaf L-BFGS (`trainable::losses`): the reference's own
  `VB_NG_LBFGS` cannot start there (`reference_error`: `optax.lbfgs`'s init
  maps every leaf, and config-5 has Python float leaves);
- `out`: the JAX package's figures of the outcome gates on their full data
  (Lotka-Volterra RMSE, Lorenz correlations by both methods, the latent
  force's correlation, the dynamic-correlation path's corr and RMSE).

Usage (from the repository root; several minutes on the CPU, mostly
compiles):
    python scripts/port/make_dynamics_golden.py [out.npz]
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import dynamics_outcome as do  # noqa: E402


def jax_setup():
    os.environ["PHYSS_INNER_SCAN"] = "blocked"
    os.environ["PHYSS_SCAN_BLOCKS"] = do.SCAN_BLOCKS
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def jax_pendulum(t, y, c, **kw):
    """`tests/test_ekf.py::_pendulum_model`."""
    import jax.numpy as jnp

    from physs_gp_tpu.models.ekf_gp import NonlinearSSGP

    T = len(t)

    def drift(params, x):
        cc, w2 = params
        return jnp.stack([x[1], -cc * x[1] - w2 * jnp.sin(x[0])])

    return NonlinearSSGP(
        t=jnp.asarray(t), Y=jnp.asarray(y)[:, None], params=(jnp.asarray(c), jnp.asarray(do.PEND["w2"])),
        L=jnp.asarray([[0.0], [1.0]]), Qc=jnp.asarray([[0.1]]), m0=jnp.asarray([1.4, 0.0]),
        P0=0.1 * jnp.eye(2), R=jnp.broadcast_to(do.PEND["noise_sd"] ** 2 * jnp.eye(1), (T, 1, 1)),
        drift=drift, obs_fn=lambda p, x: x[:1], n_substeps=4, **kw,
    )


def jax_recipe(cfg, T, **kw):
    from physs_gp_tpu.zoo import latent_force_gp, lorenz_gp, lotka_volterra_gp

    if cfg == "lv":
        t, y, truth = do.lv_inputs(T)
        return lotka_volterra_gp(t, y, q=0.01, noise=0.2, **kw), truth
    if cfg == "lorenz":
        t, y, truth = do.lorenz_inputs(max(T, 2000))
        return lorenz_gp(t[:T], y[:T], q=0.5, noise=0.5, **kw), truth[:, :T]
    t, y, u = do.lfm_inputs(T)
    return latent_force_gp(t, y, force_lengthscale=2.0, force_variance=1.0, damping=1.0,
                           noise=0.02, **kw), u


def jax_dc(T):
    from physs_gp_tpu.kernels import Matern32
    from physs_gp_tpu.zoo import dynamic_covariance_gp

    t, Y, rho = do.dc_inputs(T)
    return dynamic_covariance_gp(t, Y, n_mc=do.DC["n_mc"],
                                 k_latent=lambda: Matern32(lengthscale=2.0, variance=0.5)), rho


def _states(pre, f, s):
    return {f"{pre}lml": f.lml, f"{pre}fms": f.ms, f"{pre}fPs": f.Ps, f"{pre}sms": s.ms,
            f"{pre}sPs": s.Ps}


def _by_path(tree, keep):
    import jax

    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0] if keep(jax.tree_util.keystr(p))}


def _raws(model):
    return _by_path(model, lambda k: k.endswith(".raw"))


def trainable_lbfgs(model, max_linesearch_steps=20):
    """(step, state): `optax.lbfgs` with `scale_by_zoom_linesearch` over the
    model's trainable leaves only (the untrainable ones stay out of its
    vectors); `step(model, state) -> (model, state, loss)` is one jitted
    iteration, as `LBFGSTrainer`'s."""
    import jax
    import optax

    from physs_gp_tpu.utils.training import trainable_mask

    mask = jax.tree_util.tree_leaves(trainable_mask(model))
    opt = optax.lbfgs(linesearch=optax.scale_by_zoom_linesearch(
        max_linesearch_steps=max_linesearch_steps))

    def parts(m):
        return [leaf for leaf, k in zip(jax.tree_util.tree_leaves(m), mask) if k]

    def merge(m, tr):
        leaves, treedef = jax.tree_util.tree_flatten(m)
        it = iter(tr)
        return jax.tree_util.tree_unflatten(treedef, [next(it) if k else leaf
                                                      for leaf, k in zip(leaves, mask)])

    @jax.jit
    def step(m, st):
        tr = parts(m)

        def f(p):
            return merge(m, p).get_objective()

        loss, g = jax.value_and_grad(f)(tr)
        upd, st = opt.update(g, st, tr, value=loss, grad=g, value_fn=f)
        return merge(m, optax.apply_updates(tr, upd)), st, loss

    return step, opt.init(parts(model))


def run(cfg):
    """{output: numpy array} of one configuration's reference run."""
    import jax
    import jax.numpy as jnp

    out = {}
    if cfg == "pend":
        t, y, _ = do.pendulum_inputs(do.T_ANCHOR["pend"])
        for method, pre in (("ekf", "ekf::"), ("iterated_parallel", "ieks::")):
            kw = dict(method=method, n_iters=do.IEKS_ITERS)
            f, s = jax.jit(lambda m: m.filter_smooth())(jax_pendulum(t, y, do.PEND["c"], **kw))
            out.update(_states(pre, f, s))
            out[pre + "grad_c"] = jax.jit(jax.grad(
                lambda c: jax_pendulum(t, y, c, **kw).log_marginal_likelihood()))(do.PEND["c"])
    elif cfg == "lorenz":
        for method, pre in (("ekf", "ekf::"), ("iterated_parallel", "ieks::")):
            model, _ = jax_recipe("lorenz", do.T_ANCHOR["lorenz"], method=method,
                                  n_iters=do.IEKS_ITERS)
            out.update(_states(pre, *jax.jit(lambda m: m.filter_smooth())(model)))
    elif cfg in ("lv", "lfm"):
        model, _ = jax_recipe(cfg, do.T_ANCHOR[cfg])
        f, s = jax.jit(lambda m: m.filter_smooth())(model)
        out.update(lml=f.lml, sms=s.ms)
    elif cfg == "em":
        from physs_gp_tpu.ops.ekf import euler_maruyama_sample

        lam, var, n = do.EM["lam"], do.EM["var"], do.EM["n_substeps"]
        t = jnp.asarray(do.em_inputs())
        key = jax.random.PRNGKey(do.EM["seed"])
        out["xs"] = euler_maruyama_sample(lambda x: -lam * x, jnp.eye(1), jnp.asarray([[2 * var * lam]]),
                                          jnp.zeros(1), t, key, n_substeps=n)
        eps = []
        for _ in range(t.shape[0] - 1):  # the sampler's key splits, replayed
            row = []
            for _ in range(n):
                key, sub = jax.random.split(key)
                row.append(jax.random.normal(sub, (1,), jnp.float64))
            eps.append(jnp.stack(row))
        out["eps"] = jnp.stack(eps)
    elif cfg == "cc":
        from physs_gp_tpu.likelihoods.dynamic_covariance import correlation_cholesky

        out["L"] = correlation_cholesky(jnp.asarray(do.cc_inputs()), 4)
    elif cfg == "drd":
        from physs_gp_tpu.kernels.multi_output import LMC
        from physs_gp_tpu.kernels.rbf import RBF
        from physs_gp_tpu.likelihoods.gaussian import Gaussian
        from physs_gp_tpu.models.batch_gp import BatchGP
        from physs_gp_tpu.utils.params import param, positive_param
        from physs_gp_tpu.utils.struct import replace

        X, Y = do.drd_inputs()
        latents = [RBF(lengthscales=positive_param(jnp.asarray(ls)), variance=positive_param(jnp.asarray(1.0)))
                   for ls in (0.5, 1.0, 2.0)]
        kern = LMC.init_drd(latents, scales=[1.0, 2.0, 0.5])
        kern = replace(kern, W=replace(kern.W, z=param(jnp.asarray([0.3, -0.5, 0.8]))))
        model = BatchGP(X=jnp.asarray(X), Y=jnp.asarray(Y), kernel=kern,
                        likelihood=Gaussian(positive_param(jnp.asarray(0.01))))
        out.update({f"flat::{k}": v for k, v in _raws(model).items()})
        out["K"] = kern.K(jnp.asarray(X), jnp.asarray(X))
        out["lml"] = model.log_marginal_likelihood()
    elif cfg == "het":
        from physs_gp_tpu.likelihoods.het_gaussian import HetGaussian

        y, m, S = (jnp.asarray(a) for a in do.het_inputs())
        out["ell_blocks"] = HetGaussian().expected_log_lik_blocks(y, m, S)
        out["ell_diag"] = HetGaussian().expected_log_lik(y, m, jnp.diagonal(S, axis1=-2, axis2=-1))
    elif cfg == "dc":
        model, _ = jax_dc(do.DC["T"])
        shape = (do.DC["n_mc"],) + model.Y.shape
        out["eps_ell"] = jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float64)
        out["eps_ng"] = jax.random.normal(jax.random.PRNGKey(1), shape, jnp.float64)
        _, m, S = jax.jit(lambda mm: mm._surrogate_pass())(model)
        out["ell"] = jax.jit(lambda mm, a, b: mm._ell_data(a, b))(model, m, S)
        out["g1"], out["g2"] = jax.jit(
            lambda mm, a, b: mm.likelihood.natgrad_moments(mm.Y, a, b))(model, m, S)
        step = jax.jit(lambda mm: mm.step_with_elbo(do.DC["lr"], hessian="gauss_newton"))
        elbos = []
        for _ in range(do.DC["steps"]):
            model, e = step(model)
            elbos.append(e)
        out["elbos"] = jnp.stack(elbos)
        out["post_mean"] = jax.jit(lambda mm: mm.posterior().mean)(model)
    elif cfg == "lbfgs":
        from physs_gp_tpu.trainers import LBFGSTrainer

        model = jax_lbfgs_model()
        model, losses = LBFGSTrainer(model).train(model, do.LBFGS_ITERS)
        out["losses"] = np.array(losses)
        out.update({f"raw::{k}": v for k, v in _raws(model).items()})
    elif cfg == "vbp":
        from physs_gp_tpu.trainers import VB_NG_LBFGS

        model = jax_poisson_model()
        tr = VB_NG_LBFGS(model, ng_lr=do.VB_NG_LR)
        losses, moved = [], []
        for _ in range(do.VBP_EPOCHS):
            model = tr.ng.train(model, [tr.ng_lr])
            before = model.sites.Y
            model, ls = tr.lbfgs.train(model, 1)
            losses.extend(ls)
            moved.append(float(jnp.max(jnp.abs(model.sites.Y - before))))
        out["losses"], out["sites_moved"] = np.array(losses), np.array(moved)
        # the same epochs, L-BFGS over the trainable leaves only
        from physs_gp_tpu.trainers import NatGradTrainer

        model = jax_poisson_model()
        step, st = trainable_lbfgs(model)
        ng = NatGradTrainer()
        losses = []
        for _ in range(do.VBP_EPOCHS):
            model = ng.train(model, [do.VB_NG_LR])
            model, st, loss = step(model, st)
            losses.append(float(loss))
        out["trainable::losses"] = np.array(losses)
        out.update({f"trainable::raw::{k}": v for k, v in _raws(model).items()})
    elif cfg == "vbc5":
        from physs_gp_tpu.trainers import VB_NG_LBFGS, NatGradTrainer
        from physs_gp_tpu.zoo import bench_configs

        model = bench_configs.build_config5(do.C5_T, do.C5_CHUNK, dtype=jnp.float64)
        try:
            VB_NG_LBFGS(model, ng_lr=do.C5_NG_LR)
        except AttributeError as e:
            # optax.lbfgs.init runs over every leaf, and config-5 has Python
            # float leaves (operator coefficients)
            out["reference_error"] = np.array(f"{type(e).__name__}: {e}")
        step, st = trainable_lbfgs(model)
        ng = NatGradTrainer()
        losses = []
        for _ in range(do.VBC5_EPOCHS):
            model = ng.train(model, [do.C5_NG_LR])
            model, st, loss = step(model, st)
            losses.append(float(loss))
        out["trainable::losses"] = np.array(losses)
    return {k: np.asarray(v) for k, v in out.items()}


def jax_lbfgs_model():
    import jax.numpy as jnp

    from physs_gp_tpu.kernels import Matern32
    from physs_gp_tpu.likelihoods import Gaussian
    from physs_gp_tpu.models import StateSpaceGP
    from physs_gp_tpu.utils.params import positive_param

    t, y = do.lbfgs_inputs()
    return StateSpaceGP(t=jnp.asarray(t), Y=jnp.asarray(y)[:, None],
                        kernel=Matern32(lengthscale=2.0, variance=0.5),
                        likelihood=Gaussian(positive_param(0.5)))


def jax_poisson_model():
    import jax.numpy as jnp

    from physs_gp_tpu.kernels import Matern32
    from physs_gp_tpu.likelihoods import Poisson
    from physs_gp_tpu.models import CVIGP

    t, y = do.poisson_inputs()
    return CVIGP.init(jnp.asarray(t), jnp.asarray(y)[:, None], Matern32(lengthscale=2.0), Poisson())


def outcome_figures():
    """The JAX package's figures of the outcome gates on their full data."""
    import jax
    import jax.numpy as jnp

    out = {}
    post = jax.jit(lambda m: m.posterior_states()[0])
    model, truth = jax_recipe("lv", 500)
    out["lv::rmse"] = np.sqrt(np.mean((np.asarray(post(model)) - truth) ** 2))
    for method, name in (("ekf", "lorenz_ekf"), ("iterated_parallel", "lorenz_ieks")):
        model, truth = jax_recipe("lorenz", 2000, method=method)
        ms = np.asarray(post(model))
        out[f"{name}::corr_y"] = do._corr(ms[:, 1], truth[1])
        out[f"{name}::corr_z"] = do._corr(ms[:, 2], truth[2])
    model, u = jax_recipe("lfm", 400)
    out["lfm::corr"] = do._corr(np.asarray(post(model))[50:, 1], u[50:])
    model, rho = jax_dc(200)
    step = jax.jit(lambda mm: mm.step_with_elbo(0.3, hessian="gauss_newton"))
    for _ in range(150):
        model, _ = step(model)
    rho_hat = np.asarray(model.likelihood.correlation_path(model.posterior().mean))[:, 1, 0]
    out["dc::corr"] = do._corr(rho_hat, rho)
    out["dc::rmse"] = np.sqrt(np.mean((rho_hat - rho) ** 2))
    return {f"out::{k}": np.asarray(v, np.float64) for k, v in out.items()}


def main():
    jax_setup()
    out = sys.argv[1] if len(sys.argv) > 1 else do.GOLDEN
    arrays = {}
    for cfg in do.CONFIGS:
        arrays.update({f"{cfg}::{k}": v for k, v in run(cfg).items()})
        print(cfg, "done", flush=True)
    arrays.update(outcome_figures())
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()

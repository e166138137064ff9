"""Write the JAX package's reference runs of the Markov-kernel zoo and the
prior mean to `tests/data/markov_golden.npz`.

Every run uses the CPU in float64 with the blocked scan schedule
(PHYSS_INNER_SCAN=blocked, PHYSS_SCAN_BLOCKS=8); the inputs and settings come
from `markov_outcome.py` (numpy), the port's side of the same
configurations. The square-root runs route the JAX `_factor_psd` through its
TPU branch (closed form at d <= 2, the Pallas Cholesky in interpret mode
above), which the port follows. Keys are `<config>::<output>`, with the
JAX `.raw` leaves a port model loads under `<config>::flat::<key path>`:

- `per`, `per_sum`, `qp` (with `qp::flat::`): `<form>::lml`, `post_mean`,
  `post_var`, `pred_mean`, `pred_var` for form `cov` and `sqrt`;
- `wiener`: `<kind>::lml` (and `wiener::<kind>::flat::`) for `w`, `wv`,
  `iw2`, `iw3`; `wv::pred_mean` / `pred_var` (times before t[0] included);
- `stream`: `seg<i>::f_mean` / `f_var`, the carried `m`, `P`, `lml`, and
  the forecast `fc_mean` / `fc_var`;
- `const`: lml and moments; `cvi`: `elbos` of 3 steps and moments;
- `flows`: `<flow>::Z`, `corr`, `mean`, `var`;
- `uin` (with `uin::flat::`): `elbos`, `post_mean`, `post_var`;
- `batch`: `<kernel>::lml` (with `batch::sm::flat::`, `batch::deep::flat::`),
  `agg::lml`, `agg::cross_K`.

Usage (from the repository root; a few minutes on the CPU, mostly
compiles):
    python scripts/port/make_markov_golden.py [out.npz]
"""
import functools
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import markov_outcome as mo  # noqa: E402


def jax_setup():
    os.environ["PHYSS_INNER_SCAN"] = "blocked"
    os.environ["PHYSS_SCAN_BLOCKS"] = mo.SCAN_BLOCKS
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    use_tpu_factor_branch()


def use_tpu_factor_branch():
    """Route the JAX square-root smoother's `_factor_psd` to its TPU branch."""
    from physs_gp_tpu.ops import matrix, parallel_sqrt_kalman
    from physs_gp_tpu.ops.pallas import batched_chol

    chol = functools.partial(batched_chol.batch_cholesky.__wrapped__, interpret=True)

    def factor_psd(L):
        S = matrix.symmetrize(L)
        return matrix._cholesky_any(S, assume_psd=True) if S.shape[-1] <= 2 else chol(S)

    parallel_sqrt_kalman._factor_psd = factor_psd


def _raws(model):
    import jax

    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]
            if jax.tree_util.keystr(p).endswith(".raw")}


def jpp(v, **kw):
    import jax.numpy as jnp

    from physs_gp_tpu.utils.params import positive_param

    return positive_param(jnp.asarray(v, jnp.float64), **kw)


def jkernel(name, trend=mo.TREND_ANCHOR, env=mo.ENV_ANCHOR, J=mo.PER["J"]):
    from physs_gp_tpu.kernels import Matern32, Periodic

    def per():
        return Periodic(lengthscales=jpp(mo.PER["ls"]), variance=jpp(mo.PER["var"]),
                        period=jpp(mo.PER["period"]), n_harmonics=J)

    if name == "per":
        return per()
    m = Matern32(lengthscale=trend[0], variance=trend[1])
    if name == "per_sum":
        return m + per()
    return m + per() * Matern32(lengthscale=env[0], variance=env[1])


def jlinear(w=mo.MEAN_W, b=mo.MEAN_B):
    import jax.numpy as jnp

    from physs_gp_tpu.means.mean import LinearMean
    from physs_gp_tpu.utils.params import param

    return LinearMean(w=param(jnp.asarray([w])), b=param(jnp.asarray(b)))


def jconst(c=mo.CONST_C):
    import jax.numpy as jnp

    from physs_gp_tpu.means.mean import ConstantMean
    from physs_gp_tpu.utils.params import param

    return ConstantMean(c=param(jnp.asarray(c)))


def jss(t, Y, kern, sqrt=False, mean=None, noise=mo.NOISE):
    import jax.numpy as jnp

    from physs_gp_tpu.likelihoods import Gaussian
    from physs_gp_tpu.models import StateSpaceGP

    return StateSpaceGP(t=jnp.asarray(t), Y=jnp.asarray(Y), kernel=kern,
                        likelihood=Gaussian(jpp(noise)), mean=mean, parallel=True, sqrt=sqrt)


def _moments(pre, model, t_new):
    import jax
    import jax.numpy as jnp

    post = jax.jit(lambda m: m.posterior())(model)
    f = jax.jit(lambda m, x: m.predict_f(x))(model, jnp.asarray(t_new))
    return {f"{pre}post_mean": post.mean, f"{pre}post_var": post.var,
            f"{pre}pred_mean": f.mean, f"{pre}pred_var": f.var}


def _lml(model):
    import jax

    return jax.jit(lambda m: m.log_marginal_likelihood())(model)


def _cvi_steps(model, lr, steps):
    import jax
    import jax.numpy as jnp

    step = jax.jit(lambda m: m.step_with_elbo(lr))
    elbos = []
    for _ in range(steps):
        model, e = step(model)
        elbos.append(e)
    return model, jnp.stack(elbos)


def run(cfg):
    import jax
    import jax.numpy as jnp

    out = {}
    if cfg in ("per", "per_sum", "qp"):
        t, Z, _, t_new = mo.anchor_inputs()
        for form in mo.FORMS:
            mean = jlinear() if cfg == "qp" else None
            model = jss(t, Z, jkernel(cfg), sqrt=form == "sqrt", mean=mean)
            out[f"{form}::lml"] = _lml(model)
            out.update(_moments(f"{form}::", model, t_new))
        if cfg == "qp":
            out.update({f"flat::{k}": v for k, v in _raws(model).items()})
    elif cfg == "wiener":
        from physs_gp_tpu.kernels import IntegratedWiener, Wiener, WienerVelocity

        classes = {"w": Wiener, "wv": WienerVelocity, "iw2": IntegratedWiener, "iw3": IntegratedWiener}
        t, y, t_new = mo.wiener_inputs()
        for name, _, extra in mo.WIENER_KINDS:
            k = classes[name](variance=jpp(mo.WIENER["variance"]), P0=jpp(mo.WIENER["P0"]), **extra)
            model = jss(t, y, k, noise=mo.WIENER["noise"])
            out[f"{name}::lml"] = _lml(model)
            out.update({f"{name}::flat::{key}": v for key, v in _raws(model).items()})
            if name == "wv":
                f = jax.jit(lambda m, x: m.predict_f(x))(model, jnp.asarray(t_new))
                out["wv::pred_mean"], out["wv::pred_var"] = f.mean, f.var
    elif cfg == "stream":
        from physs_gp_tpu.kernels import WienerVelocity
        from physs_gp_tpu.likelihoods import Gaussian
        from physs_gp_tpu.models.streaming import StreamingGP

        t, y, _ = mo.wiener_inputs()
        s = StreamingGP(kernel=WienerVelocity(variance=jpp(mo.WIENER["variance"]), P0=jpp(mo.WIENER["P0"])),
                        likelihood=Gaussian(jpp(mo.WIENER["noise"])), mean=jlinear(0.3, -0.2),
                        parallel=True)
        state = s.init_state(t0=jnp.asarray(t[0]))
        for i, (a, b) in enumerate(mo.STREAM_SEGMENTS):
            state, seg = s.update(state, jnp.asarray(t[a:b]), jnp.asarray(y[a:b]))
            out[f"seg{i}::f_mean"], out[f"seg{i}::f_var"] = seg.f_mean, seg.f_var
        out["m"], out["P"], out["lml"] = state.m, state.P, state.lml
        fc = s.forecast(state, jnp.asarray(t[-1] + np.linspace(0.1, 1.0, 10)))
        out["fc_mean"], out["fc_var"] = fc.mean, fc.var
    elif cfg == "const":
        from physs_gp_tpu.kernels import Matern52

        t, Z, _, t_new = mo.anchor_inputs()
        model = jss(t, Z, Matern52(lengthscale=24.0, variance=0.8), mean=jconst(2.5))
        out["lml"] = _lml(model)
        out.update(_moments("", model, t_new))
    elif cfg == "cvi":
        from physs_gp_tpu.likelihoods import Poisson
        from physs_gp_tpu.models import CVIGP

        t, _, counts, t_new = mo.anchor_inputs()
        model = CVIGP.init(jnp.asarray(t), jnp.asarray(counts), jkernel("qp"), Poisson(),
                           mean=jconst(), parallel=True)
        model, out["elbos"] = _cvi_steps(model, mo.CVI["lr"], mo.CVI["steps"])
        out.update(_moments("", model, t_new))
    elif cfg == "flows":
        from physs_gp_tpu.data import transformed as tr

        flows = {
            "log": tr.LogTransform(shift=0.3), "affine": tr.AffineTransform(scale=2.5, loc=-1.0),
            "boxcox": tr.BoxCoxTransform(lam=0.4), "exp": tr.ExpTransform(),
            "softplus": tr.SoftplusTransform(), "square": tr.SquareTransform(),
            "reverse_softplus": tr.ReverseFlow(tr.SoftplusTransform()),
            "composite": tr.CompositeFlow((tr.LogTransform(shift=0.1), tr.AffineTransform(scale=0.7))),
        }
        Y, zm, zv = mo.flow_inputs()
        for name in mo.FLOWS:
            td = tr.TransformedData(Y=jnp.asarray(Y), flow=flows[name])
            out[f"{name}::Z"], out[f"{name}::corr"] = td.Z, td.lml_correction()
            out[f"{name}::mean"], out[f"{name}::var"] = td.to_data_space(jnp.asarray(zm), jnp.asarray(zv))
    elif cfg == "uin":
        from physs_gp_tpu.kernels import Matern52
        from physs_gp_tpu.likelihoods import Gaussian
        from physs_gp_tpu.models import CVIGP
        from physs_gp_tpu.transforms.inputs import UncertainInputLikelihood
        from physs_gp_tpu.transforms.operators import DerivativeHead, StateObservation, ValueHead

        t, Y = mo.uin_inputs()
        lik = UncertainInputLikelihood(base=Gaussian(variance=jpp(mo.UIN["noise"] ** 2, fixed=True)),
                                       input_var=jpp(mo.UIN["sx"] ** 2, fixed=True))
        obs = StateObservation(heads=[ValueHead(), DerivativeHead(order=1)])
        model = CVIGP.init(jnp.asarray(t), jnp.asarray(Y), Matern52(lengthscale=1.0, variance=1.0),
                           lik, observation=obs)
        out.update({f"flat::{k}": v for k, v in _raws(model).items()})
        model, out["elbos"] = _cvi_steps(model, mo.UIN["lr"], mo.UIN["steps"])
        post = jax.jit(lambda m: m.posterior())(model)
        out["post_mean"], out["post_var"] = post.mean, post.var
    elif cfg == "batch":
        from physs_gp_tpu.kernels import RBF, RQ, AggregatedKernel, ArcCosine, DeepKernel, Gibbs, SpectralMixture
        from physs_gp_tpu.likelihoods import Gaussian
        from physs_gp_tpu.models.batch_gp import BatchGP

        X, Y, lows, highs, Ya = mo.batch_inputs()
        kernels = {
            "rq": RQ(lengthscales=jpp(0.8), variance=jpp(1.0), alpha=jpp(1.5)),
            "sm": SpectralMixture.init(3, 2),
            "arccos": ArcCosine(),
            "gibbs": Gibbs(variance=jpp(1.0), l_fn=lambda x: 0.5 + 0.3 * jnp.sum(x**2)),
            "deep": DeepKernel.init(RBF(), [2, 8, 2]),
        }
        for name in mo.MISC:
            model = BatchGP(X=jnp.asarray(X), Y=jnp.asarray(Y), kernel=kernels[name],
                            likelihood=Gaussian(jpp(0.1)))
            out[f"{name}::lml"] = _lml(model)
            if name in ("sm", "deep"):
                out.update({f"{name}::flat::{k}": v for k, v in _raws(model).items()
                            if k.startswith(".kernel")})
        nodes, w = mo.uniform_box_nodes(lows, highs, n_per_dim=8)
        agg = AggregatedKernel(base=RBF(lengthscales=jpp(0.7), variance=jpp(1.0)),
                               nodes=jnp.asarray(nodes), weights=jnp.asarray(w))
        Xa = jnp.arange(Ya.shape[0])[:, None] * 1.0
        model = BatchGP(X=Xa, Y=jnp.asarray(Ya), kernel=agg, likelihood=Gaussian(jpp(1e-4)))
        out["agg::lml"] = _lml(model)
        out["agg::cross_K"] = agg.cross_K(Xa, jnp.linspace(0.2, 3.8, 30)[:, None])
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def main():
    jax_setup()
    out = sys.argv[1] if len(sys.argv) > 1 else mo.GOLDEN
    configs = sys.argv[2].split(",") if len(sys.argv) > 2 else mo.CONFIGS
    arrays = {}
    for cfg in configs:
        arrays.update({f"{cfg}::{k}": v for k, v in run(cfg).items()})
        print(cfg, "done", flush=True)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main()

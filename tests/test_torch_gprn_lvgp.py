"""PyTorch port: GPRN and LatentVariableGP against the JAX package.

The same numpy inputs from a seed go through `physs_gp_tpu.models.GPRN` /
`LatentVariableGP` and the port's, on the CPU in float64; the JAX model's
`.raw` leaves (moved off their start values by seeded draws) are loaded
into the port's through `interop.load_numpy_params`:

- GPRN, each mixing (`plain`, `softplus`, `ldl` with L < P, `drd`): the
  ELBO, its gradient on every raw and the KL on the JAX key's draws
  (passed as `draws=`), `predict_f` on `fold_in(key, 1)`'s draws: rtol
  1e-9, variances 1e-7; `drd` rejects L != P in both packages; the
  frozen default draws and `adam_scan(generator=)`;
- LatentVariableGP, `concat` and `additive`: the MAP objective, its
  gradient on every raw (W included), `predict_f` with and without W_new:
  rtol 1e-9, variances 1e-7; W0 from a generator.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.models import GPRN as JGPRN, LatentVariableGP as JLVGP  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.models import LatentVariableGP  # noqa: E402
from physs_gp_tpu_torch.trainers.scan import adam_scan  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import make_vecchia_golden as mg  # noqa: E402
import vecchia_outcome as vo  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64


def _close(a, b, rtol, atol=0.0):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _gprn_data(P, N=30, seed=4):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-2, 2, N))[:, None]
    Y = np.stack([np.sin((p + 1) * X[:, 0]) for p in range(P)], -1) + 0.05 * rng.normal(size=(N, P))
    Y[3, 0] = np.nan
    return X, Y, X[::4], np.linspace(-2, 2, 9)[:, None]


def _gprn_pair(mixing, P, L):
    X, Y, Z, Xs = _gprn_data(P)
    jm = JGPRN.init(X, Y, Z, kernel_w=mg._jrbf(0.6), kernel_g=mg._jrbf(0.4), n_latent=L, noise=0.02,
                    n_mc=3, mixing=mixing)
    jm = mg.shift_raws(jm, seed=5)
    tm = vo.gprn_model(X, Y, Z, mixing, F64, "cpu", n_latent=L, n_mc=3, noise=0.02, ls_w=0.6, ls_g=0.4)
    load_numpy_params(tm, mg.raw_leaves(jm))
    return jm, tm, Xs


@pytest.mark.parametrize("mixing, P, L", [("plain", 2, 2), ("softplus", 2, 2), ("ldl", 3, 2),
                                          ("drd", 3, 3)])
def test_gprn_matches_jax(mixing, P, L):
    jm, tm, Xs = _gprn_pair(mixing, P, L)
    L_tot = jm.q_mu.raw.shape[0]
    eps = jax.random.normal(jm.key, (3, L_tot, 30), jnp.float64)
    eps_p = jax.random.normal(jax.random.fold_in(jm.key, 1), (16, L_tot, 9), jnp.float64)
    (elbo, g), kl, f = jax.jit(lambda m, x: (jax.value_and_grad(lambda q: q.elbo())(m), m._kl(),
                                             m.predict_f(x, n_mc=16)))(jm, jnp.asarray(Xs))
    out = tm.elbo(draws=torch.from_numpy(np.array(eps)))
    out.backward()
    _close(out, elbo, 1e-9)
    g = mg.raw_leaves(g)
    named = dict(tm.named_parameters())
    assert set(g) == {"." + k for k in named}
    for key, ref in g.items():
        _close(named[key[1:]].grad, ref, 1e-9, 1e-12)
    with torch.no_grad():
        _close(tm._kl(), kl, 1e-9)
        t = tm.predict_f(Xs, n_mc=16, draws=torch.from_numpy(np.array(eps_p)))
    assert t.mean.shape == (9, P)
    _close(t.mean, f.mean, 1e-9, 1e-12)
    _close(t.var, f.var, 1e-7, 1e-12)


def test_gprn_drd_needs_as_many_latents_as_outputs():
    X, Y, Z, _ = _gprn_data(3)
    with pytest.raises(ValueError):
        JGPRN.init(X, Y, Z, kernel_w=mg._jrbf(0.6), kernel_g=mg._jrbf(0.4), n_latent=2, mixing="drd")
    with pytest.raises(ValueError):
        vo.gprn_model(X, Y, Z, "drd", F64, "cpu", n_latent=2)


def test_gprn_draws_and_generator_training():
    """With neither a generator nor draws, the ELBO's noise is frozen (two
    calls agree); `adam_scan(generator=)` passes the generator on, so each
    step draws anew, and the fit improves."""
    X, Y, Z, _ = _gprn_data(2)
    model = vo.gprn_model(X, Y, Z, "plain", F64, "cpu", n_mc=4)
    with torch.no_grad():
        assert float(model.elbo()) == float(model.elbo())
        gen = torch.Generator().manual_seed(3)
        assert float(model.elbo(generator=gen)) != float(model.elbo(generator=gen))
    _, losses = adam_scan(model, 30, lr=0.05, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(losses).all() and losses[-5:].mean() < losses[:5].mean()


@pytest.mark.parametrize("mode", ["concat", "additive"])
def test_lvgp_matches_jax(mode):
    X, Y, W0, Xs, W_new = vo.lvgp_inputs(mode, N=24)
    ls = [1.0, 1.0] if mode == "concat" else [1.0]
    jm = JLVGP.init(jnp.asarray(X), jnp.asarray(Y), mg._jrbf(ls), mg._jgauss(0.05), mode=mode,
                    W0=jnp.asarray(W0))
    jm = mg.shift_raws(jm, seed=6)
    tm = vo.lvgp_model(X, Y, mode, W0, F64, "cpu", noise=0.05)
    load_numpy_params(tm, mg.raw_leaves(jm))
    (obj, g), fs = jax.jit(lambda m, x, w: (jax.value_and_grad(lambda q: q.get_objective())(m),
                                            (m.predict_f(x), m.predict_f(x, W_new=w))))(
        jm, jnp.asarray(Xs), jnp.asarray(W_new))
    out = tm.get_objective()
    out.backward()
    _close(out, obj, 1e-9)
    g = mg.raw_leaves(g)
    named = dict(tm.named_parameters())
    assert set(g) == {"." + k for k in named}
    for key, ref in g.items():
        _close(named[key[1:]].grad, ref, 1e-9, 1e-12)
    with torch.no_grad():
        for w, f in zip((None, W_new), fs):
            t = tm.predict_f(Xs, W_new=w)
            _close(t.mean, f.mean, 1e-9, 1e-12)
            _close(t.var, f.var, 1e-7, 1e-12)


def test_lvgp_initial_latents_come_from_a_generator():
    X, Y, _, _, _ = vo.lvgp_inputs("concat", N=10)
    kw = dict(dtype=F64, device="cpu")

    def build(mode, gen=None):
        return LatentVariableGP.init(X, Y, vo._rbf([1.0, 1.0], 1.0, kw),
                                     vo.Gaussian(vo.positive_param(0.1, **kw)), mode=mode,
                                     generator=gen, **kw)

    a, b = build("concat"), build("concat", torch.Generator().manual_seed(0))
    assert a.W.value.shape == (10, 1) and torch.equal(a.W.value, b.W.value)
    assert build("additive").W.value.shape == X.shape
    assert float(a.W.value.detach().abs().max()) < 0.1


def test_interop_rejects_unknown_paths_of_the_new_models():
    X, Y, Z, _ = _gprn_data(2)
    models = [vo.gprn_model(X, Y, Z, "plain", F64, "cpu"),
              vo.lvgp_model(*vo.lvgp_inputs("concat", N=10)[:2], "concat", None, F64, "cpu"),
              vo.vecchia_model(*vo.vecchia_inputs(N=20)[:2], F64, "cpu", m=4)]
    for model, bad in zip(models, (".kernel_w.nope", ".base.kernel.nope", ".mean_nope")):
        with pytest.raises(KeyError):
            load_numpy_params(model, {bad: np.zeros(())})

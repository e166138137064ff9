"""PyTorch port: the neighbour sets and VecchiaGP against the JAX package.

The same numpy inputs from a seed go through `physs_gp_tpu.data.neighbours`
/ `models.VecchiaGP` and their port counterparts on the CPU in float64:

- `nearest_neighbour_sets` for every `ordering` ("maximin", "input", None,
  an explicit permutation), in 1-D and 2-D, and `maximin_ordering`: equal,
  index for index (tie-free data; the same distance expansion);
- the Vecchia lml at small m, with missing rows and with a `ConstantMean`,
  and its gradient on every raw: rtol 1e-9; at m = N - 1 it equals the
  port's `BatchGP` lml within 1e-8 (relative);
- `predict_f` with and without `m_predict`, `predict_y`, `nlpd`: means and
  nlpd rtol 1e-9, variances 1e-7.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.data import neighbours as jnb  # noqa: E402
from physs_gp_tpu.kernels.rbf import RBF as JRBF  # noqa: E402
from physs_gp_tpu.likelihoods.gaussian import Gaussian as JGaussian  # noqa: E402
from physs_gp_tpu.means.mean import ConstantMean as JConstantMean  # noqa: E402
from physs_gp_tpu.models import VecchiaGP as JVecchiaGP  # noqa: E402
from physs_gp_tpu.utils.params import param as jparam, positive_param as jpp  # noqa: E402
from physs_gp_tpu.utils.struct import replace  # noqa: E402
from physs_gp_tpu_torch.data import neighbours as tnb  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.means.mean import ConstantMean  # noqa: E402
from physs_gp_tpu_torch.models import BatchGP, VecchiaGP  # noqa: E402
from physs_gp_tpu_torch.utils.params import param, positive_param  # noqa: E402

torch.set_num_threads(1)

LS, VAR, NOISE = (0.6, 0.9), 1.2, 0.05


def _close(a, b, rtol, atol=0.0):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _data(N=80, D=2, seed=0, nan=False):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 3, (N, D))
    y = np.sin(2.0 * X.sum(1)) + 0.2 * rng.standard_normal(N)
    if nan:
        y[::5] = np.nan
    return X, y[:, None], rng.uniform(0, 3, (12, D)), rng.standard_normal((12, 1))


def _pair(X, Y, m, mean_c=None):
    """(JAX model, port model) with the same hyperparameters."""
    jm = JVecchiaGP.init(X, Y, JRBF(lengthscales=jpp(jnp.asarray(LS)), variance=jpp(jnp.asarray(VAR))),
                         JGaussian(variance=jpp(jnp.asarray(NOISE))), m=m)
    kw = dict(dtype=torch.float64)
    tm = VecchiaGP.init(X, Y, RBF(positive_param(np.asarray(LS), **kw), positive_param(VAR, **kw)),
                        Gaussian(positive_param(NOISE, **kw)), m=m, device="cpu")
    if mean_c is not None:
        jm = replace(jm, mean=JConstantMean(c=jparam(jnp.asarray(mean_c))))
        tm.mean = ConstantMean(param(mean_c, **kw))
    return jm, tm


@pytest.mark.parametrize("ordering", ["maximin", "input", None, "permutation"])
@pytest.mark.parametrize("D", [1, 2])
def test_neighbour_sets_match_jax(ordering, D):
    X = np.random.default_rng(D).uniform(0, 5, (150, D))
    if D == 1:
        X = X[:, 0]  # 1-D input: N points in one dimension
    if ordering == "permutation":
        ordering = np.random.default_rng(7).permutation(150)
    ref = jnb.nearest_neighbour_sets(X, 9, ordering=ordering, block=64)
    out = tnb.nearest_neighbour_sets(X, 9, ordering=ordering, block=64)
    for r, o in zip(ref, out):
        assert o.dtype == torch.from_numpy(r).dtype and o.device.type == "cpu"
        np.testing.assert_array_equal(o.numpy(), r)
    np.testing.assert_array_equal(tnb.maximin_ordering(X).numpy(), jnb.maximin_ordering(X))
    # the m clamp: at most N - 1 neighbours
    assert tnb.nearest_neighbour_sets(X[:5], 9)[1].shape == (5, 4)


def test_vecchia_full_conditioning_is_exact():
    """m = N - 1: the telescoping product is the exact joint density, in
    both packages, and with missing rows."""
    for nan in (False, True):
        X, Y, _, _ = _data(N=40, nan=nan)
        jm, tm = _pair(X, Y, m=39)
        with torch.no_grad():
            lml = tm.log_marginal_likelihood()
            exact = BatchGP(tm.X, tm.Y, tm.kernel, tm.likelihood, device="cpu").log_marginal_likelihood()
        assert abs(float(lml) - float(exact)) < 1e-8 * abs(float(exact))
        _close(lml, jax.jit(lambda m: m.log_marginal_likelihood())(jm), 1e-9)


@pytest.mark.parametrize("case", ["small_m", "missing", "mean"])
def test_vecchia_lml_and_gradient_match_jax(case):
    X, Y, _, _ = _data(nan=case == "missing", seed=1)
    jm, tm = _pair(X, Y, m=7, mean_c=0.4 if case == "mean" else None)
    lml, g = jax.jit(jax.value_and_grad(lambda m: m.log_marginal_likelihood()))(jm)
    out = tm.log_marginal_likelihood()
    out.backward()
    _close(out, lml, 1e-9)
    _close(tm.kernel.lengthscales.raw.grad, g.kernel.lengthscales.raw, 1e-9)
    _close(tm.kernel.variance.raw.grad, g.kernel.variance.raw, 1e-9)
    _close(tm.likelihood.variance.raw.grad, g.likelihood.variance.raw, 1e-9)
    if case == "mean":
        _close(tm.mean.c.raw.grad, g.mean.c.raw, 1e-9)
    # the neighbour indices are integer buffers, in the JAX model's order
    assert tm.nbrs.dtype == torch.int64 and tm.order.dtype == torch.int64
    np.testing.assert_array_equal(tm.order.numpy(), np.asarray(jm.order).astype(np.int64))


def test_vecchia_predictions_match_jax():
    X, Y, Xs, Ys = _data(seed=2, nan=True)
    jm, tm = _pair(X, Y, m=8, mean_c=0.2)
    with torch.no_grad():
        for kw in ({}, {"m_predict": 30}):
            f = jax.jit(lambda m, x: m.predict_f(x, **kw))(jm, jnp.asarray(Xs))
            t = tm.predict_f(Xs, **kw)
            assert t.mean.shape == (12, 1)
            _close(t.mean, f.mean, 1e-9, 1e-13)
            _close(t.var, f.var, 1e-7, 1e-13)
        py = jax.jit(lambda m, x: m.predict_y(x))(jm, jnp.asarray(Xs))
        t = tm.predict_y(Xs)
        _close(t.mean, py.mean, 1e-9, 1e-13)
        _close(t.var, py.var, 1e-7)
        Ys = Ys.copy()
        Ys[3] = np.nan
        _close(tm.nlpd(Xs, Ys), jax.jit(lambda m, x, y: m.nlpd(x, y))(jm, jnp.asarray(Xs), jnp.asarray(Ys)),
               1e-9)


def test_vecchia_rejects_multi_output_and_defaults_to_the_card():
    import inspect

    X, Y, _, _ = _data(N=10)
    with pytest.raises(ValueError):
        VecchiaGP.init(X, np.concatenate([Y, Y], 1), RBF(positive_param(1.0), positive_param(1.0)),
                       device="cpu")
    assert inspect.signature(VecchiaGP.init).parameters["device"].default == "cuda"

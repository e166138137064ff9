"""PyTorch port: streaming assimilation (`models/streaming.py`) against the
JAX package.

Counterparts of `tests/test_streaming.py`: segmented against batch with the
same splits, the filter variants, forecast against `predict_f`, physics
heads, StreamingCVI's Gaussian exactness, one segment and two Poisson
segments, `strict_times`, the length-tied R error and the NaN-padded
serving loop. The same numpy inputs go through the JAX function and the
port in float64 on the CPU: carried states (m, P, t_last, lml), segment
moments, segment lml and forecasts agree to 1e-9 relative to each output's
largest magnitude. Within the port, the streamed lml equals the batch lml
as in the reference (rtol 1e-10; 1e-8 for StreamingCVI's Gaussian fixed
point). `tests/data/serving_T256_golden.npz` holds the JAX StreamingGP and
StreamingCVI runs on config-5 and the temporal Poisson data, which
`chip_smoke.py` holds the port to on the card.

`CVIGP`'s `init_state` is held here too: it replaces the filter's prior in
the ELBO, and, as in the reference, `surrogate_model()` (so `predict_f`)
does not carry it. The reference's residual-mask test has its counterpart
here on the port's `CompositeLikelihood`, and a stream with a Monte-Carlo
residual is held to the JAX one on the draws JAX makes from its frozen key.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.kernels import Matern32 as JMatern32  # noqa: E402
from physs_gp_tpu.likelihoods import Gaussian as JGaussian  # noqa: E402
from physs_gp_tpu.likelihoods import Poisson as JPoisson  # noqa: E402
from physs_gp_tpu.models import CVIGP as JCVIGP  # noqa: E402
from physs_gp_tpu.models import StateSpaceGP as JSSGP  # noqa: E402
from physs_gp_tpu.models import StreamingCVI as JStreamingCVI  # noqa: E402
from physs_gp_tpu.models import StreamingGP as JStreamingGP  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpositive  # noqa: E402
from physs_gp_tpu.zoo import advection_diffusion_gp as jadvection  # noqa: E402
from physs_gp_tpu_torch.interop import load_stream_state  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import BlockDiagonalGaussian, Gaussian  # noqa: E402
from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson  # noqa: E402
from physs_gp_tpu_torch.models import (  # noqa: E402
    CVIGP,
    StateSpaceGP,
    StreamingCVI,
    StreamingGP,
    StreamState,
)
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.bench_configs import build_config5, build_temporal  # noqa: E402
from physs_gp_tpu_torch.zoo.spatio_temporal import advection_diffusion_gp  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "serving_T256_golden.npz")
F64 = dict(dtype=torch.float64)
TOL = 1e-9
NOISE = 0.05 ** 2
SEGMENTS = ((0, 100), (100, 200), (200, 256))  # the golden file's


def rel(a, b):
    """max |a - b| / max |b| over the finite entries of b (same NaN pattern)."""
    a, b = (x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    ok = np.isfinite(b)
    assert a.shape == b.shape and np.array_equal(np.isfinite(a), ok)
    return float(np.max(np.abs(a[ok] - b[ok])) / np.max(np.abs(b[ok])))


def t_(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, tol=TOL):
    """Every field of a port NamedTuple against its JAX counterpart."""
    for name in port._fields:
        assert rel(getattr(port, name), getattr(ref, name)) <= tol, name


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("PHYSS_INNER_SCAN", "blocked")
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")


def _series(T=60, seed=0):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 8.0, T))
    y = np.sin(1.7 * t)[:, None] + 0.05 * rng.normal(size=(T, 1))
    y[rng.choice(T, 5, replace=False), 0] = np.nan  # missing rows
    return t, y


def _gp(**kw):
    j = JStreamingGP(kernel=JMatern32(lengthscale=0.9), likelihood=JGaussian(jpositive(NOISE)))
    p = StreamingGP(kernel=Matern32(lengthscale=0.9, **F64),
                    likelihood=Gaussian(positive_param(NOISE, **F64)), **kw)
    return j, p


def _jax_stream(s, t, y, bounds, update=None):
    """The JAX states and segment results over [lo, hi) bounds."""
    update = update or jax.jit(s.update)
    st = s.init_state(t0=float(t[0]))
    out = []
    for lo, hi in bounds:
        st, seg = update(st, jnp.asarray(t[lo:hi]), jnp.asarray(y[lo:hi]))
        out.append((st, seg))
    return out


def _bounds(splits, T):
    edges = [0, *splits, T]
    return list(zip(edges[:-1], edges[1:]))


# ---------------------------------------------------------------------------
# StreamingGP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("splits", [(20, 45), (1, 59), (30,)])
def test_segmented_matches_jax_and_batch(splits):
    t, y = _series()
    js, ps = _gp()
    ref = _jax_stream(js, t, y, _bounds(splits, 60))
    st = ps.init_state(t0=float(t[0]))
    means = []
    for (lo, hi), (jst, jseg) in zip(_bounds(splits, 60), ref):
        st, seg = ps.update(st, t_(t[lo:hi]), t_(y[lo:hi]))
        _close(st, jst)
        _close(seg, jseg)
        means.append(seg.f_mean)
    batch = StateSpaceGP(t=t_(t), Y=t_(y), kernel=ps.kernel, likelihood=ps.likelihood)
    with torch.no_grad():
        assert rel(st.lml, batch.log_marginal_likelihood()) <= 1e-10
        _, f, _ = batch.filter_smooth()
    assert rel(st.m, f.ms[-1]) <= 1e-10 and rel(st.P, f.Ps[-1]) <= 1e-10
    assert rel(torch.cat(means)[:, 0], f.ms[:, 0]) <= 1e-10


_SEQ_REF = {}


@pytest.mark.parametrize("kw", [
    dict(parallel=True), dict(sqrt=True), dict(parallel=True, sqrt=True, chunk_size=16)],
    ids=["parallel", "sqrt", "parallel-sqrt-chunk16"])
def test_filter_variants_match_jax(kw):
    """Each filter variant of the port against the JAX sequential stream
    (one function: the reference holds its variants together to 1e-8)."""
    t, y = _series(T=48, seed=1)
    js, ps = _gp(**kw)
    if not _SEQ_REF:
        _SEQ_REF["ref"] = _jax_stream(js, t, y, [(0, 25), (25, 48)])
    st = ps.init_state(t0=float(t[0]))
    for (lo, hi), (jst, jseg) in zip([(0, 25), (25, 48)], _SEQ_REF["ref"]):
        st, seg = ps.update(st, t_(t[lo:hi]), t_(y[lo:hi]))
        _close(st, jst)
        _close(seg, jseg)


def test_forecast_matches_jax_and_predict_f():
    t, y = _series(T=50, seed=2)
    jm = JSSGP(t=jnp.asarray(t), Y=jnp.asarray(y), kernel=JMatern32(lengthscale=0.9),
               likelihood=JGaussian(jpositive(NOISE)))
    js, jstate = JStreamingGP.from_model(jm)
    tm = StateSpaceGP(t=t_(t), Y=t_(y), kernel=Matern32(lengthscale=0.9, **F64),
                      likelihood=Gaussian(positive_param(NOISE, **F64)))
    ps, state = StreamingGP.from_model(tm)
    _close(state, jstate)
    t_fut = np.linspace(t[-1] + 0.1, t[-1] + 2.0, 7)
    jfc, jpy = jax.jit(lambda s, tt: (js.forecast(s, tt), js.predict_y(s, tt)))(jstate, jnp.asarray(t_fut))
    with torch.no_grad():
        fc, py = ps.forecast(state, t_(t_fut)), ps.predict_y(state, t_(t_fut))
        pf = tm.predict_f(t_(t_fut))
    _close(fc, jfc)
    _close(py, jpy)
    assert rel(fc.mean, pf.mean) <= 1e-9 and rel(fc.var, pf.var) <= 1e-9
    assert rel(py.var, fc.var + NOISE) <= 1e-12


def _physics_pair(T=20):
    """A small 2-D advection-diffusion model (physics heads, a tied noise
    group) in both packages."""
    rng = np.random.default_rng(3)
    t = np.sort(rng.uniform(0, 4, T))
    gx = np.linspace(0, 1, 2)
    Z = np.stack(np.meshgrid(gx, gx), -1).reshape(-1, 2)
    coll = np.array([[0.5, 0.5], [0.25, 0.75]])
    Y = rng.normal(size=(T, 4))
    Y[rng.uniform(size=Y.shape) < 0.2] = np.nan
    kw = dict(diffusivity=0.1, velocity=(0.2, 0.1), noise=0.1, coll_noise=1e-3)
    jm = jadvection(t, Y, Z, coll, **kw)
    pm = advection_diffusion_gp(t, Y, Z, coll, **kw, device="cpu")
    return jm.core, pm.core


def test_streaming_physics_heads_match_jax_and_batch():
    """The PDE-residual rows stay active while streaming: two segments give
    the batch lml, and the states and forecast of the JAX stream."""
    jcore, pcore = _physics_pair()
    js = JStreamingGP(kernel=jcore.kernel, likelihood=jcore.likelihood, observation=jcore.observation)
    ps = StreamingGP(kernel=pcore.kernel, likelihood=pcore.likelihood, observation=pcore.observation)
    t, Y = np.asarray(jcore.t), np.asarray(jcore.Y)
    ref = _jax_stream(js, t, Y, [(0, 10), (10, 20)])
    st = ps.init_state(t0=float(t[0]))
    for (lo, hi), (jst, jseg) in zip([(0, 10), (10, 20)], ref):
        st, seg = ps.update(st, t_(t[lo:hi]), t_(Y[lo:hi]))
        _close(st, jst)
        _close(seg, jseg)
    with torch.no_grad():
        assert rel(st.lml, pcore.log_marginal_likelihood()) <= 1e-9
        fc = ps.forecast(st, t_([4.1, 4.3]))
    _close(fc, jax.jit(js.forecast)(ref[-1][0], jnp.asarray([4.1, 4.3])))


def test_serving_loop_with_nan_padding():
    """Fixed-width segments give the batch lml; a segment of all-NaN rows
    only advances the clock."""
    t, y = _series(T=64, seed=4)
    _, ps = _gp()
    st = ps.init_state(t0=float(t[0]))
    for k in range(4):
        st, _ = ps.update(st, t_(t[16 * k:16 * (k + 1)]), t_(y[16 * k:16 * (k + 1)]))
    batch = StateSpaceGP(t=t_(t), Y=t_(y), kernel=ps.kernel, likelihood=ps.likelihood)
    with torch.no_grad():
        assert rel(st.lml, batch.log_marginal_likelihood()) <= 1e-10
    st2, _ = ps.update(st, t_(t[-1] + np.array([1.0, 1.5, 3.0])), torch.full((3, 1), float("nan"), **F64))
    assert rel(st2.lml, st.lml) <= 1e-12 and float(st2.t_last) == t[-1] + 3.0


def test_strict_times_poisons_out_of_order_segment():
    """A segment starting before t_last NaN-poisons the carried m and lml
    on the device; with `strict_times=False` the port carries what the JAX
    stream carries."""
    t, y = _series(T=30, seed=8)
    js, ps = _gp()
    st = ps.init_state(t0=float(t[0]))
    st, _ = ps.update(st, t_(t[:20]), t_(y[:20]))
    assert torch.isfinite(st.lml)
    bad_t = t[10:20] - 0.5
    st_bad, seg_bad = ps.update(st, t_(bad_t), t_(y[10:20]))
    assert not torch.isfinite(st_bad.lml) and not torch.isfinite(st_bad.m).all()
    assert not torch.isfinite(seg_bad.lml)
    js_loose, ps_loose = _gp(strict_times=False)
    js_loose = JStreamingGP(kernel=js.kernel, likelihood=js.likelihood, strict_times=False)
    jst = js_loose.init_state(t0=float(t[0]))
    jst, _ = jax.jit(js_loose.update)(jst, jnp.asarray(t[:20]), jnp.asarray(y[:20]))
    jst, jseg = jax.jit(js_loose.update)(jst, jnp.asarray(bad_t), jnp.asarray(y[10:20]))
    st_loose, seg_loose = ps_loose.update(st, t_(bad_t), t_(y[10:20]))
    assert float(st_loose.t_last) == bad_t[-1]
    _close(st_loose, jst)
    _close(seg_loose, jseg)


def test_streaming_rejects_length_tied_likelihood_R():
    t, y = _series(T=20, seed=9)
    s = StreamingGP(kernel=Matern32(lengthscale=0.9, **F64),
                    likelihood=BlockDiagonalGaussian(V=0.01 * torch.eye(1, **F64).expand(12, 1, 1)))
    st = s.init_state(t0=float(t[0]))
    with pytest.raises(ValueError, match="parametric in T"):
        s.update(st, t_(t[:8]), t_(y[:8]))


def test_interop_carries_a_jax_stream_state():
    """A JAX StreamState carried into the port continues the JAX stream."""
    t, y = _series(T=40, seed=6)
    js, ps = _gp()
    (jst, _), (jst2, jseg2) = _jax_stream(js, t, y, [(0, 22), (22, 40)])
    st = load_stream_state({k: np.asarray(getattr(jst, k)) for k in StreamState._fields}, device="cpu")
    st2, seg2 = ps.update(st, t_(t[22:]), t_(y[22:]))
    _close(st2, jst2)
    _close(seg2, jseg2)


def test_config5_streaming_gp_matches_golden(env):
    """config-5 (T = 256) as a StateSpaceGP, parallel, chunk 64, streamed in
    the golden file's three segments."""
    gold = np.load(GOLDEN)
    c5 = build_config5(256, 64, dtype=torch.float64, device="cpu")
    gp = StateSpaceGP(t=c5.t, Y=c5.Y, kernel=c5.kernel, likelihood=c5.likelihood,
                      observation=c5.observation, parallel=True, chunk_size=64)
    s = StreamingGP(kernel=c5.kernel, likelihood=c5.likelihood, observation=c5.observation,
                    parallel=True, chunk_size=64)
    with torch.no_grad():
        assert rel(gp.log_marginal_likelihood(), gold["gp_batch_lml"]) <= TOL
        st = s.init_state(t0=c5.t[0])
        for k, (lo, hi) in enumerate(SEGMENTS):
            st, seg = s.update(st, c5.t[lo:hi], c5.Y[lo:hi])
            for name in StreamState._fields:
                assert rel(getattr(st, name), gold[f"gp_{name}"][k]) <= TOL, name
        fc = s.forecast(st, t_(gold["t_fc"]))
        py = s.predict_y(st, t_(gold["t_fc"]))
    assert rel(seg.f_mean, gold["gp_seg_mean"]) <= TOL and rel(seg.f_var, gold["gp_seg_var"]) <= TOL
    assert rel(seg.lml, gold["gp_seg_lml"]) <= TOL
    assert rel(fc.mean, gold["gp_fc_mean"]) <= TOL and rel(fc.var, gold["gp_fc_var"]) <= TOL
    assert rel(py.var, gold["gp_py_var"]) <= TOL


# ---------------------------------------------------------------------------
# StreamingCVI
# ---------------------------------------------------------------------------


def test_streaming_cvi_gaussian_segments_exact():
    """Conjugate Gaussian, lr = 1: the segment ELBOs sum to the batch lml and
    the carry is the batch filter state; states match the JAX stream."""
    t, y = _series(T=40, seed=5)
    js = JStreamingCVI(kernel=JMatern32(lengthscale=0.9), likelihood=JGaussian(jpositive(NOISE)),
                       lr=1.0, n_iters=2)
    ps = StreamingCVI(kernel=Matern32(lengthscale=0.9, **F64),
                      likelihood=Gaussian(positive_param(NOISE, **F64)), lr=1.0, n_iters=2)
    ref = _jax_stream(js, t, y, [(0, 18), (18, 40)])
    st = ps.init_state(t0=float(t[0]))
    for (lo, hi), (jst, _) in zip([(0, 18), (18, 40)], ref):
        st, _ = ps.update(st, t_(t[lo:hi]), t_(y[lo:hi]))
        _close(st, jst)
    batch = StateSpaceGP(t=t_(t), Y=t_(y), kernel=ps.kernel, likelihood=ps.likelihood)
    with torch.no_grad():
        assert rel(st.lml, batch.log_marginal_likelihood()) <= 1e-8
        _, f, _ = batch.filter_smooth()
    # the reference's tolerance (atol 1e-9 beside assert_allclose's rtol 1e-7)
    np.testing.assert_allclose(st.m.numpy(), f.ms[-1].numpy(), atol=1e-9)
    np.testing.assert_allclose(st.P.numpy(), f.Ps[-1].numpy(), atol=1e-9)


def _poisson(T, seed, hi, freq, lengthscale):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, hi, T))
    y = rng.poisson(np.exp(1.2 * np.sin(freq * t) + (0.3 if seed == 7 else 0.0)))[:, None]
    return t, y.astype(np.float64), lengthscale


def test_streaming_cvi_single_segment_matches_jax_and_batch():
    """One segment over all data is batch CVIGP (same iterations and lr)."""
    t, y, ls = _poisson(60, 6, 10, 1.1, 1.0)
    js = JStreamingCVI(kernel=JMatern32(lengthscale=ls), likelihood=JPoisson(), lr=0.5, n_iters=5)
    ps = StreamingCVI(kernel=Matern32(lengthscale=ls, **F64), likelihood=Poisson(), lr=0.5, n_iters=5)
    ((jst, jseg),) = _jax_stream(js, t, y, [(0, 60)])
    st, seg = ps.update(ps.init_state(t0=float(t[0])), t_(t), t_(y))
    _close(st, jst)
    assert rel(seg.posterior().mean, jseg.posterior().mean) <= TOL
    batch = CVIGP.init(t_(t), t_(y), ps.kernel, Poisson())
    for _ in range(5):
        batch, elbo = batch.step_with_elbo(0.5)
    assert rel(st.lml, elbo) <= 1e-8
    assert rel(seg.posterior().mean[1:], batch.posterior().mean) <= 1e-8


def test_streaming_cvi_poisson_two_segments():
    """Two online segments track the batch CVI posterior (RMSE < 0.35, the
    reference's bound) and forecast a finite mean and positive variance. The
    JAX stream of two Poisson segments is held at T = 256 through the
    golden file (`test_config5_and_temporal_streaming_cvi_match_golden`)."""
    t, y, ls = _poisson(80, 7, 12, 0.9, 1.4)
    ps = StreamingCVI(kernel=Matern32(lengthscale=ls, **F64), likelihood=Poisson(), lr=0.5, n_iters=15)
    st = ps.init_state(t0=float(t[0]))
    means = []
    for lo, hi in [(0, 40), (40, 80)]:
        st, seg = ps.update(st, t_(t[lo:hi]), t_(y[lo:hi]))
        means.append(seg.posterior().mean[1:])
    assert torch.isfinite(st.lml)
    batch = CVIGP.init(t_(t), t_(y), ps.kernel, Poisson())
    for _ in range(15):
        batch, _ = batch.step_with_elbo(0.5)
    rmse = float(torch.sqrt(torch.mean((torch.cat(means) - batch.posterior().mean) ** 2)))
    assert rmse < 0.35, rmse
    fc = ps.forecast(st, t_(t[-1] + np.array([0.1, 0.5, 1.0])))
    assert torch.isfinite(fc.mean).all() and (fc.var > 0).all()


def test_streaming_cvi_rejects_a_key():
    """Monte-Carlo noise comes from a `torch.Generator`; a JAX-style key is
    refused."""
    _, ps = _gp()
    s = StreamingCVI(kernel=ps.kernel, likelihood=Poisson())
    with pytest.raises(TypeError, match="torch.Generator"):
        s.update(s.init_state(), t_([0.5]), t_([[1.0]]), generator=0)


def _residual_pair(mask=None):
    from physs_gp_tpu.likelihoods.composite import CompositeLikelihood as JComposite
    from physs_gp_tpu.likelihoods.composite import NonlinearResidual as JResidual
    from physs_gp_tpu_torch.likelihoods.composite import CompositeLikelihood, NonlinearResidual

    jlik = JComposite(heads=[JGaussian(jpositive(0.05))],
                      residual=JResidual(fn=lambda f: f[..., 0] ** 2 - 0.5, noise_var=jpositive(0.1),
                                         n_mc=4),
                      residual_mask=None if mask is None else jnp.asarray(mask))
    lik = CompositeLikelihood(heads=[Gaussian(positive_param(0.05, **F64))],
                              residual=NonlinearResidual(fn=lambda f: f[..., 0] ** 2 - 0.5,
                                                         noise_var=positive_param(0.1, **F64),
                                                         n_mc=4),
                              residual_mask=None if mask is None else t_(mask))
    return jlik, lik


def test_segment_likelihood_mask_matches_jax():
    """The carry row drops out of a residual likelihood's mask; a user mask
    keeps its rows behind it; a mask of another length raises; the model's
    own likelihood keeps its mask."""
    kern = Matern32(**F64)
    for mask, B in ((None, 5), ([1.0, 0.0, 1.0], 3)):
        jlik, lik = _residual_pair(mask)
        want = JStreamingCVI(kernel=JMatern32(), likelihood=jlik)._segment_likelihood(B).residual_mask
        seg = StreamingCVI(kernel=kern, likelihood=lik)._segment_likelihood(B)
        assert np.array_equal(seg.residual_mask.numpy(), np.asarray(want))
        assert lik.residual_mask is None or lik.residual_mask.shape == (B,)  # untouched
        assert seg.residual is lik.residual and seg.heads is lik.heads
    with pytest.raises(ValueError, match="must cover one segment"):
        StreamingCVI(kernel=kern, likelihood=_residual_pair([1.0, 0.0, 1.0])[1])._segment_likelihood(7)


def test_streaming_cvi_segment_likelihood_residual_mask():
    """Counterpart of the reference's test of the same name: the dummy carry
    row is excluded from the residual ([0, 1, ..., 1]; a user mask stays
    behind the 0). Then two segments of a `StreamingCVI` with the residual,
    fed the draws JAX makes from its frozen key (PRNGKey(0), [n_mc, B + 1,
    p] per segment), carry the JAX states."""
    kern = Matern32(lengthscale=0.9, **F64)
    jlik, lik = _residual_pair()
    rm = StreamingCVI(kernel=kern, likelihood=lik)._segment_likelihood(5).residual_mask
    assert rm.shape == (6,) and rm[0] == 0.0 and bool(torch.all(rm[1:] == 1.0))
    _, lik2 = _residual_pair([1.0, 0.0, 1.0])
    rm2 = StreamingCVI(kernel=kern, likelihood=lik2)._segment_likelihood(3).residual_mask
    np.testing.assert_array_equal(rm2.numpy(), [0.0, 1.0, 0.0, 1.0])

    t, y = _series(T=24, seed=10)
    bounds = [(0, 10), (10, 24)]
    js = JStreamingCVI(kernel=JMatern32(lengthscale=0.9), likelihood=jlik, lr=0.5, n_iters=3,
                       hessian="gauss_newton")
    ps = StreamingCVI(kernel=kern, likelihood=lik, lr=0.5, n_iters=3, hessian="gauss_newton")
    ref = _jax_stream(js, t, y, bounds)
    st = ps.init_state(t0=float(t[0]))
    for (lo, hi), (jst, jseg) in zip(bounds, ref):
        draws = t_(jax.random.normal(jax.random.PRNGKey(0), (4, hi - lo + 1, 1), jnp.float64))
        st, seg = ps.update(st, t_(t[lo:hi]), t_(y[lo:hi]), draws=draws)
        _close(st, jst)
        assert rel(seg.posterior().mean, jseg.posterior().mean) <= TOL
    # a generator draws fresh noise at each iteration: another state than
    # the frozen draws give
    st0 = ps.init_state(t0=float(t[0]))
    frozen, _ = ps.update(st0, t_(t[:10]), t_(y[:10]))
    fresh, _ = ps.update(st0, t_(t[:10]), t_(y[:10]), generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(fresh.m).all() and not torch.equal(fresh.m, frozen.m)


def test_cvi_init_state_matches_jax():
    """`init_state` replaces the prior in the ELBO; `surrogate_model()` does
    not carry it (the reference's behaviour), so predict_f starts from the
    stationary prior."""
    t, y, ls = _poisson(30, 6, 10, 1.1, 1.0)
    rng = np.random.default_rng(12)
    m0 = rng.normal(size=2)
    B = rng.normal(size=(2, 2))
    P0 = B @ B.T + 0.5 * np.eye(2)
    jm = JCVIGP.init(jnp.asarray(t), jnp.asarray(y), JMatern32(lengthscale=ls), JPoisson(),
                     init_state=(jnp.asarray(m0), jnp.asarray(P0)))
    pm = CVIGP.init(t_(t), t_(y), Matern32(lengthscale=ls, **F64), Poisson(),
                    init_state=(t_(m0), t_(P0)))
    plain = CVIGP.init(t_(t), t_(y), pm.kernel, Poisson())
    # one natural-gradient step moves the sites off zero (so does the mean)
    jm, jelbo = jax.jit(lambda m: m.step_with_elbo(0.5))(jm)
    _, elbo = pm.step_with_elbo(0.5)
    plain.step_with_elbo(0.5)
    assert rel(elbo, jelbo) <= TOL
    t_new = t_(np.array([2.5, 11.0]))
    with torch.no_grad():
        assert rel(pm.elbo(), jax.jit(lambda m: m.elbo())(jm)) <= TOL
        plain.sites = pm.sites
        assert not torch.allclose(pm.elbo(), plain.elbo())
        f, f_plain = pm.predict_f(t_new), plain.predict_f(t_new)
    assert torch.equal(f.mean, f_plain.mean) and torch.equal(f.var, f_plain.var)
    _close(f, jax.jit(lambda m: m.predict_f(jnp.asarray([2.5, 11.0])))(jm))


def test_config5_and_temporal_streaming_cvi_match_golden(env):
    """StreamingCVI on config-5 (lr 1, 2 iterations, three segments) and on
    the temporal Poisson data (lr 0.5, 3 iterations, two segments, with a
    forecast) against the golden file."""
    gold = np.load(GOLDEN)
    c5 = build_config5(256, 64, dtype=torch.float64, device="cpu")
    runs = [("c5cvi", c5, dict(observation=c5.observation, lr=1.0, n_iters=2), SEGMENTS)]
    tm = build_temporal(256, 64, dtype=torch.float64, device="cpu")
    runs.append(("tcvi", tm, dict(lr=0.5, n_iters=3), ((0, 128), (128, 256))))
    for tag, model, kw, bounds in runs:
        s = StreamingCVI(kernel=model.kernel, likelihood=model.likelihood, parallel=True,
                         chunk_size=64, **kw)
        st = s.init_state(t0=model.t[0])
        for k, (lo, hi) in enumerate(bounds):
            st, seg = s.update(st, model.t[lo:hi], model.Y[lo:hi])
            for name in StreamState._fields:
                assert rel(getattr(st, name), gold[f"{tag}_{name}"][k]) <= TOL, (tag, name)
    assert rel(seg.posterior().mean, gold["tcvi_seg_post_mean"]) <= TOL
    fc = s.forecast(st, t_(gold["t_fc_temporal"]))
    assert rel(fc.mean, gold["tcvi_fc_mean"]) <= TOL and rel(fc.var, gold["tcvi_fc_var"]) <= TOL

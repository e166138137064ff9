"""PyTorch port: the temporal Poisson workload against the JAX package.

Every case feeds the same numpy inputs, made from a seed, to the JAX
function (CPU, float64) and to its counterpart in the port (CPU, float64).

- Modules: `Poisson` (`log_prob`, the closed-form `expected_log_lik`,
  conditional moments; NaN y contributes exactly 0), Gauss-Hermite
  quadrature (n = 20), and `Matern12` / `Matern32` / `Matern52` /
  `Matern72` (`_matern_corr`, `to_ss`, `transition`, `noise_cov`), to
  rtol 1e-11 (`noise_cov` with an absolute 1e-13 on its small entries).
- Scans: the d = 2 flat filter and smoother (T = 256, chunked at 64 and
  unchunked, PHYSS_SCAN_BLOCKS=8), d = 1 (`Matern12`) and d = 3 (`Matern52`)
  through the general path, each against the JAX parallel filter and
  smoother and against the port's sequential `ops/kalman`, rtol 1e-9 (lml
  1e-10); `PHYSS_FUSED_COMBINE=1` leaves d = 1 and 2 unchanged, bit for bit,
  and reaches no fused combine. The sequential square-root filter and
  smoother against the JAX `sqrt_kalman_filter` / `sqrt_rts_smoother`
  (rtol 1e-10) and against the port's parallel square-root pair (rtol 1e-9).
- The slice: `build_temporal(256, 64, float64)` in covariance and
  square-root form, the port's leaves loaded from the JAX model through
  `interop.load_numpy_params`, 3 `natgrad_scan` steps at lr 0.5 on both
  sides: ELBOs to rtol 1e-10, sites and posterior to rtol 1e-8 (atol
  1e-12). The JAX run also reproduces `tests/data/temporal_T256_golden.npz`
  (made by `scripts/port/make_temporal_golden.py`), which `chip_smoke.py`
  holds the port to on the card. In square-root form the JAX smoother's
  `_factor_psd` takes its TPU branch (closed form at d = 2, no jitter), as
  the golden script and the port do.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.kernels import matern as jmatern  # noqa: E402
from physs_gp_tpu.likelihoods import Poisson as JPoisson  # noqa: E402
from physs_gp_tpu.ops import matrix as jmatrix  # noqa: E402
from physs_gp_tpu.ops import parallel_kalman as jpk  # noqa: E402
from physs_gp_tpu.ops import parallel_sqrt_kalman as jpsk  # noqa: E402
from physs_gp_tpu.ops import quadrature as jq  # noqa: E402
from physs_gp_tpu.ops import sqrt_kalman as jsk  # noqa: E402
from physs_gp_tpu.trainers import natgrad_scan as jscan  # noqa: E402
from physs_gp_tpu.utils.struct import replace  # noqa: E402
from physs_gp_tpu.zoo.bench_configs import build_temporal as jbuild  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels import matern as tmatern  # noqa: E402
from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson  # noqa: E402
from physs_gp_tpu_torch.ops import kalman as tk  # noqa: E402
from physs_gp_tpu_torch.ops import parallel_kalman as tpk  # noqa: E402
from physs_gp_tpu_torch.ops import parallel_sqrt_kalman as tpsk  # noqa: E402
from physs_gp_tpu_torch.ops import quadrature as tq  # noqa: E402
from physs_gp_tpu_torch.ops import sqrt_kalman as tsk  # noqa: E402
from physs_gp_tpu_torch.trainers.scan import natgrad_scan as tscan  # noqa: E402
from physs_gp_tpu_torch.zoo.bench_configs import build_temporal as tbuild  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "temporal_T256_golden.npz")
T, CHUNK = 256, 64
MATERNS = ["Matern12", "Matern32", "Matern52", "Matern72"]


def _close(a, b, rtol, atol=0.0):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _tt(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _jj(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.fixture
def blocked_env(monkeypatch):
    monkeypatch.setenv("PHYSS_INNER_SCAN", "blocked")
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")


def tpu_factor_psd(L):
    """The TPU branch of the JAX `_factor_psd` at d <= 2: the closed-form
    Cholesky of the symmetrised covariance, no added jitter."""
    S = jmatrix.symmetrize(L)
    assert S.shape[-1] <= 2
    return jmatrix._cholesky_any(S, assume_psd=True)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("binsize", [1.0, 2.5])
def test_poisson_matches_jax(binsize):
    rng = np.random.default_rng(0)
    y = rng.poisson(3.0, size=(40, 2)).astype(np.float64)
    y[rng.random((40, 2)) < 0.2] = np.nan
    m, v = rng.normal(size=(40, 2)), rng.uniform(0.01, 2.0, size=(40, 2))
    jl, tl = JPoisson(binsize=binsize), Poisson(binsize=binsize)
    ell = tl.expected_log_lik(*_tt(y, m, v))
    _close(ell, jl.expected_log_lik(*_jj(y, m, v)), 1e-12)
    assert torch.equal(ell[torch.isnan(torch.from_numpy(y))], torch.zeros(int(np.isnan(y).sum()),
                                                                         dtype=torch.float64))
    y0 = np.nan_to_num(y)
    _close(tl.log_prob(*_tt(y0, m)), jl.log_prob(*_jj(y0, m)), 1e-12)
    _close(tl.conditional_mean(*_tt(m)), jl.conditional_mean(*_jj(m)), 1e-14)
    _close(tl.conditional_variance(*_tt(m)), jl.conditional_variance(*_jj(m)), 1e-14)


def test_gauss_hermite_matches_jax():
    rng = np.random.default_rng(1)
    m, v = rng.normal(size=(30, 1)), rng.uniform(0.0, 1.5, size=(30, 1))
    y = rng.poisson(2.0, size=(30, 1)).astype(np.float64)
    x, w = tq.gauss_hermite_points(20)
    jx, jw = jq.gauss_hermite_points(20)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(w, jw)
    jl, tl = JPoisson(), Poisson()
    _close(tq.expect_gh(tl.conditional_mean, *_tt(m, v)),
           jq.expect_gh(jl.conditional_mean, *_jj(m, v)), 1e-13)
    _close(tq.expect_gh(lambda f: f ** 2, *_tt(m, v)), m ** 2 + v, 1e-12)
    ty, jy = torch.from_numpy(y)[..., None], jnp.asarray(y)[..., None]
    _close(tq.expect_gh_log(lambda f: tl.log_prob(ty, f), *_tt(m, v)),
           jq.expect_gh_log(lambda f: jl.log_prob(jy, f), *_jj(m, v)), 1e-12)


@pytest.mark.parametrize("name", MATERNS)
def test_matern_family_matches_jax(name):
    rng = np.random.default_rng(2)
    dt = np.concatenate([[0.0], rng.exponential(2.0, 40)])
    jkern = getattr(jmatern, name)(lengthscale=jnp.asarray(4.0), variance=jnp.asarray(1.3))
    tkern = getattr(tmatern, name)(lengthscale=4.0, variance=1.3, dtype=torch.float64)
    d2 = rng.uniform(0, 9, size=(6, 5))
    jk, jss, jA, jQ = jax.jit(lambda k, d2, dt: (k.k_from_sqdist(d2), k.to_ss(), k.transition(dt),
                                                 k.noise_cov(dt)))(jkern, jnp.asarray(d2), jnp.asarray(dt))
    with torch.no_grad():
        _close(tkern.k_from_sqdist(torch.from_numpy(d2)), jk, 1e-13)
        tss = tkern.to_ss()
        for field in ("F", "L", "Qc", "H", "Pinf", "minf"):
            _close(getattr(tss, field), getattr(jss, field), 1e-12, 1e-14)
        _close(tkern.transition(torch.from_numpy(dt)), jA, 1e-12, 1e-15)
        # Q's entries are sums of O(1) terms: the small ones carry their
        # absolute rounding, hence the absolute tolerance
        _close(tkern.noise_cov(torch.from_numpy(dt)), jQ, 1e-11, 1e-13)
    assert tss.F.shape[-1] == MATERNS.index(name) + 1


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------


def _markov_lgssm(name, seed=0):
    """The LGSSM of a Matérn prior at T seeded irregular times with one
    noisy head and missing observations: (A, Q, H, R, y, m0, P0)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100, T))
    kern = getattr(jmatern, name)(lengthscale=jnp.asarray(3.0), variance=jnp.asarray(1.0))
    from physs_gp_tpu.ops.lgssm import build_lgssm

    ssm = jax.jit(build_lgssm)(kern, jnp.asarray(t))
    A, Q, H, m0, P0 = (np.asarray(x) for x in ssm)
    R = np.broadcast_to(0.3 * np.eye(1), (T, 1, 1)).copy()
    y = np.sin(0.2 * t)[:, None] + 0.5 * rng.normal(size=(T, 1))
    y[rng.random(T) < 0.15] = np.nan
    return A, Q, H, R, y, m0, P0


def _jax_filter_smoother(args, chunk):
    A, Q = jnp.asarray(args[0]), jnp.asarray(args[1])
    jf = jax.jit(jpk.parallel_kalman_filter, static_argnames="chunk_size")(*_jj(*args), chunk_size=chunk)
    js = jax.jit(jpk.parallel_rts_smoother, static_argnames="chunk_size")(A, Q, jf, chunk_size=chunk)
    return jf, js


def _check_filter_smoother(f, s, ref_f, ref_s, rtol=1e-9):
    _close(f.lml, ref_f.lml, 1e-10)
    for a, b in [(f.ms, ref_f.ms), (f.Ps, ref_f.Ps), (s.ms, ref_s.ms), (s.Ps, ref_s.Ps)]:
        _close(a, b, rtol, 1e-12)


@pytest.mark.parametrize("chunk", [CHUNK, None])
def test_flat2_scans_match_jax_and_sequential(blocked_env, chunk):
    args = _markov_lgssm("Matern32")
    tf = tpk.parallel_kalman_filter(*_tt(*args), chunk_size=chunk)
    ts = tpk.parallel_rts_smoother(*_tt(args[0], args[1]), tf, chunk_size=chunk)
    jf, js = _jax_filter_smoother(args, chunk)
    _check_filter_smoother(tf, ts, jf, js)
    _close(tf.lmls, jf.lmls, 1e-10, 1e-12)
    _close(ts.Gs, js.Gs, 1e-9, 1e-12)
    rf, rs = tk.filter_smoother(*_tt(*args))
    _check_filter_smoother(tf, ts, rf, rs)


def test_flat2_combines_match_jax():
    """One flat filtering and one flat smoothing combine, full and final."""
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(2, 50, 14)) * 0.3
    for flat in (x, y):  # C and J are PSD: diagonals positive
        flat[:, [6, 8, 9, 11]] = np.abs(flat[:, [6, 8, 9, 11]]) + 0.5
    for name in ("_flat2_filtering_operator", "_flat2_smoothing_operator"):
        a, b = (x, y) if "filter" in name else (x[:, :9], y[:, :9])
        _close(getattr(tpk, name)(*_tt(a, b)), getattr(jpk, name)(*_jj(a, b)), 1e-13)
    for name in ("_flat2_filtering_final", "_flat2_smoothing_final"):
        a, b = (x, y) if "filter" in name else (x[:, :9], y[:, :9])
        for p, q in zip(getattr(tpk, name)(*_tt(a, b)), getattr(jpk, name)(*_jj(a, b))):
            _close(p, q, 1e-13)
    M = rng.normal(size=(20, 2, 2)) + 2 * np.eye(2)
    _close(tpk._inv2(torch.from_numpy(M)), np.linalg.inv(M), 1e-13)


@pytest.mark.parametrize("name", ["Matern12", "Matern52"])
def test_general_path_d1_and_d3(blocked_env, name):
    args = _markov_lgssm(name, seed=4)
    assert args[0].shape[-1] == {"Matern12": 1, "Matern52": 3}[name]
    tf = tpk.parallel_kalman_filter(*_tt(*args), chunk_size=CHUNK)
    ts = tpk.parallel_rts_smoother(*_tt(args[0], args[1]), tf, chunk_size=CHUNK)
    jf, js = _jax_filter_smoother(args, CHUNK)
    _check_filter_smoother(tf, ts, jf, js)
    rf, rs = tk.filter_smoother(*_tt(*args))
    _check_filter_smoother(tf, ts, rf, rs)


@pytest.mark.parametrize("name", ["Matern12", "Matern32"])
def test_fused_knob_leaves_small_d_unchanged(blocked_env, monkeypatch, name):
    """The fused kernels take d >= 3: with the knob on, d = 1 and 2 reach
    no fused combine and give the same bits as with it off."""
    args = _tt(*_markov_lgssm(name, seed=5))

    def run():
        f = tpk.parallel_kalman_filter(*args, chunk_size=CHUNK)
        s = tpk.parallel_rts_smoother(args[0], args[1], f, chunk_size=CHUNK)
        return f.ms, f.Ps, f.lml, s.ms, s.Ps

    off = run()
    calls = []
    for wrapper in ("fused_filtering_combine", "fused_smoothing_combine"):
        monkeypatch.setattr(tpk.fc, wrapper, lambda *a, w=wrapper: calls.append(w))
    monkeypatch.setenv("PHYSS_FUSED_COMBINE", "1")
    on = run()
    assert not calls
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def _sqrt_inputs(name, seed):
    A, Q, H, R, y, m0, P0 = _markov_lgssm(name, seed=seed)
    factor = jax.jit(jmatrix.safe_cholesky_rel)
    Qs, Rs, P0s = (np.asarray(factor(jnp.asarray(x))) for x in (Q, R, P0))
    return A, Qs, H, Rs, y, m0, P0s


@pytest.mark.parametrize("name", ["Matern32", "Matern52"])
def test_sequential_sqrt_matches_jax_and_parallel(blocked_env, monkeypatch, name):
    monkeypatch.setattr(jpsk, "_factor_psd", tpu_factor_psd)
    args = _sqrt_inputs(name, seed=6)
    A, Qs = args[0], args[1]
    jf = jax.jit(jsk.sqrt_kalman_filter)(*_jj(*args))
    js = jax.jit(jsk.sqrt_rts_smoother)(jnp.asarray(A), jnp.asarray(Qs), jf)
    tf = tsk.sqrt_kalman_filter(*_tt(*args))
    ts = tsk.sqrt_rts_smoother(*_tt(A, Qs), tf)
    _close(tf.lml, jf.lml, 1e-10)
    for a, b in [(tf.ms, jf.ms), (tf.Ps, jf.Ps), (tf.lmls, jf.lmls), (ts.ms, js.ms),
                 (ts.Ps, js.Ps), (ts.Gs, js.Gs)]:
        _close(a, b, 1e-10, 1e-12)
    # the parallel pair on the same inputs: filtered factors, smoothed covariances
    pf = tpsk.parallel_sqrt_kalman_filter(*_tt(*args), chunk_size=CHUNK)
    ps = tpsk.parallel_sqrt_rts_smoother(*_tt(A, Qs), pf, chunk_size=CHUNK)
    _close(pf.lml, tf.lml, 1e-10)
    for a, b in [(pf.ms, tf.ms), (pf.Ps, tf.Ps), (ps.ms, ts.ms), (ps.Ps, ts.Ps @ ts.Ps.mT)]:
        _close(a, b, 1e-9, 1e-12)


def test_psd_sqrt_matches_jax():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(9, 3, 2))
    A = X @ np.swapaxes(X, -1, -2)
    A[0] = 0.0
    S = tsk.psd_sqrt(torch.from_numpy(A))
    _close(S @ S.mT, A, 1e-12, 1e-13)
    jS = np.asarray(jsk.psd_sqrt(jnp.asarray(A)))
    _close(S @ S.mT, jS @ np.swapaxes(jS, -1, -2), 1e-12, 1e-13)


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------


def _jax_leaves(model):
    """The JAX model's parameter and data leaves by key path, and its
    likelihood's static binsize."""
    out = {".likelihood.binsize": np.asarray(model.likelihood.binsize)}
    for path, leaf in jax.tree_util.tree_flatten_with_path(model)[0]:
        key = jax.tree_util.keystr(path)
        if key.endswith(".raw") or key in (".t", ".Y", ".sites.Y", ".sites.V"):
            out[key] = np.asarray(leaf)
    return out


def test_load_numpy_params_carries_the_temporal_model():
    from physs_gp_tpu.likelihoods import Poisson as JP
    from physs_gp_tpu.utils.params import positive_param as jpositive

    jm = jbuild(64, None, parallel=False, dtype=jnp.float64)
    kern = replace(jm.kernel, lengthscales=jpositive(jnp.asarray(7.3)),
                   variance=jpositive(jnp.asarray(0.6)))
    jm = replace(jm, kernel=kern, likelihood=JP(binsize=2.0))
    tm = tbuild(64, None, parallel=False, dtype=torch.float64, device="cpu")
    load_numpy_params(tm, _jax_leaves(jm))
    assert tm.likelihood.binsize == 2.0 and isinstance(tm.likelihood.binsize, float)
    _close(tm.kernel.lengthscales.value, jm.kernel.lengthscales.value, 1e-14)
    _close(tm.kernel.variance.value, jm.kernel.variance.value, 1e-14)
    with torch.no_grad():
        _close(tm.elbo(), jax.jit(lambda m: m.elbo())(jm), 1e-12)
    with pytest.raises(ValueError):
        load_numpy_params(tm, {".likelihood.binsize": np.ones(2)})


@pytest.fixture(scope="module")
def jax_slices():
    """The JAX temporal slice in both forms: {form: (fitted model, ELBOs,
    posterior)}, on the blocked schedule with 8 blocks, the square-root
    smoother's `_factor_psd` on its TPU branch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PHYSS_INNER_SCAN", "blocked")
        mp.setenv("PHYSS_SCAN_BLOCKS", "8")
        mp.setattr(jpsk, "_factor_psd", tpu_factor_psd)
        out = {}
        for form in ("cov", "sqrt"):
            jm = replace(jbuild(T, CHUNK, dtype=jnp.float64), sqrt=form == "sqrt")
            fitted, elbos = jax.jit(lambda m: jscan(m, 0.5, n_steps=3))(jm)
            out[form] = (jm, fitted, elbos, jax.jit(lambda m: m.posterior())(fitted))
    return out


@pytest.mark.parametrize("form", ["cov", "sqrt"])
def test_temporal_slice_matches_jax(jax_slices, monkeypatch, form):
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    jm, jfit, jelbos, jpost = jax_slices[form]
    model = tbuild(T, CHUNK, dtype=torch.float64, sqrt=form == "sqrt", device="cpu")
    load_numpy_params(model, _jax_leaves(jm))
    model, elbos = tscan(model, 0.5, n_steps=3)
    post = model.posterior()
    _close(elbos, jelbos, 1e-10)
    _close(model.sites.Y, jfit.sites.Y, 1e-8, 1e-12)
    _close(model.sites.V, jfit.sites.V, 1e-8, 1e-12)
    _close(post.mean, jpost.mean, 1e-8, 1e-12)
    _close(post.var, jpost.var, 1e-8, 1e-12)


@pytest.mark.parametrize("form", ["cov", "sqrt"])
def test_jax_reproduces_temporal_golden(jax_slices, form):
    gold = np.load(GOLDEN)
    _, jfit, jelbos, jpost = jax_slices[form]
    _close(jelbos, gold[f"{form}_elbos"], 1e-12)
    _close(jfit.sites.Y, gold[f"{form}_site_Y"], 1e-10, 1e-14)
    _close(jnp.diagonal(jfit.sites.V, axis1=-2, axis2=-1), gold[f"{form}_site_V_diag"], 1e-10)
    _close(jpost.mean, gold[f"{form}_post_mean"], 1e-10, 1e-14)
    _close(jpost.var, gold[f"{form}_post_var"], 1e-10)


def test_temporal_forms_agree():
    """Covariance and square-root form are one function: their golden
    ELBOs agree to rounding."""
    gold = np.load(GOLDEN)
    _close(gold["sqrt_elbos"], gold["cov_elbos"], 1e-10)

"""PyTorch port: posterior sampling against the JAX package.

`ops/sampling` (the affine prior scan in its sequential, parallel and
chunked forms, Matheron state samples in all four `parallel` x `sqrt`
forms, the zero-Q factor), `StateSpaceGP.sample_f` at the training and at
new times and with off-site heads, `CVIGP.sample_f`,
`sample_confidence_intervals` (with a `link`) and `response_curve`.

The JAX functions draw from a PRNG key; the port's `*_given` layers take the
standard-normal draws themselves, so each comparison feeds the port the
draws the JAX function made (`jax_draws` of
`scripts/port/make_serving_golden.py`). Float64 on the CPU; every output
agrees to 1e-9 relative to its largest magnitude (max |port - jax| /
max |jax|). `tests/data/serving_T256_golden.npz` holds the JAX
`CVIGP.sample_f` of config-5 in its three forms; the port is held to the
covariance form here and to all three on the card (`chip_smoke.py`). One Monte-Carlo check (S = 2000, T = 8, the
port's own generator) holds the samples' moments to the posterior.

The ops-level tests hold each of the port's forms to the same JAX form. At
the model level the JAX side runs its sequential filters (one cheap
compile) and the port its parallel and square-root forms, which the
ops-level tests hold to the JAX ones: one function, so they agree to
rounding.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.kernels import Matern32 as JMatern32  # noqa: E402
from physs_gp_tpu.kernels import Matern52 as JMatern52  # noqa: E402
from physs_gp_tpu.kernels.rbf import RBF as JRBF  # noqa: E402
from physs_gp_tpu.kernels.spatio_temporal import SpatioTemporalKernel as JSTK  # noqa: E402
from physs_gp_tpu.likelihoods import Gaussian as JGaussian  # noqa: E402
from physs_gp_tpu.likelihoods.gaussian import IndependentGaussian as JIndep  # noqa: E402
from physs_gp_tpu.metrics.metrics import response_curve as jresponse  # noqa: E402
from physs_gp_tpu.metrics.metrics import sample_confidence_intervals as jsci  # noqa: E402
from physs_gp_tpu.models import StateSpaceGP as JSSGP  # noqa: E402
from physs_gp_tpu.ops.lgssm import build_lgssm as jbuild_lgssm  # noqa: E402
from physs_gp_tpu.ops.sampling import matheron_state_samples as jmatheron  # noqa: E402
from physs_gp_tpu.ops.sampling import sample_lgssm_states as jprior  # noqa: E402
from physs_gp_tpu.transforms import operators as jops  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpositive  # noqa: E402
from physs_gp_tpu.utils.struct import replace  # noqa: E402
from physs_gp_tpu.zoo.bench_configs import build_temporal as jbuild_temporal  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32, Matern52  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.kernels.spatio_temporal import SpatioTemporalKernel  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian, IndependentGaussian  # noqa: E402
from physs_gp_tpu_torch.metrics.metrics import response_curve, sample_confidence_intervals  # noqa: E402
from physs_gp_tpu_torch.models import StateSpaceGP  # noqa: E402
from physs_gp_tpu_torch.ops.lgssm import build_lgssm  # noqa: E402
from physs_gp_tpu_torch.ops.matrix import safe_cholesky_rel  # noqa: E402
from physs_gp_tpu_torch.ops.sampling import (  # noqa: E402
    matheron_state_samples,
    matheron_state_samples_given,
    sample_lgssm_states,
    sample_lgssm_states_given,
)
from physs_gp_tpu_torch.trainers.scan import natgrad_scan  # noqa: E402
from physs_gp_tpu_torch.transforms.operators import SpatialHead, StateObservation  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.bench_configs import build_config5, build_temporal  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "serving_T256_golden.npz")
_spec = importlib.util.spec_from_file_location(
    "make_serving_golden", os.path.join(REPO, "scripts", "port", "make_serving_golden.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)
F64 = dict(dtype=torch.float64)
TOL = 1e-9


def rel(a, b):
    """max |a - b| / max |b| over the finite entries of b (same NaN pattern)."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    ok = np.isfinite(b)
    assert a.shape == b.shape and np.array_equal(np.isfinite(a), ok)
    return float(np.max(np.abs(a[ok] - b[ok])) / np.max(np.abs(b[ok])))


def t_(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("PHYSS_INNER_SCAN", "blocked")
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")


def _times(T, seed, hi=4.0):
    return np.sort(np.random.default_rng(seed).uniform(0, hi, T))


def _ssm(T, seed):
    t = _times(T, seed)
    return (jbuild_lgssm(JMatern52(lengthscale=0.7, variance=1.3), jnp.asarray(t)),
            build_lgssm(Matern52(lengthscale=0.7, variance=1.3, **F64), t_(t)))


# ---------------------------------------------------------------------------
# ops/sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parallel,chunk", [(False, None), (True, None), (True, 16)])
def test_prior_scan_matches_jax(env, parallel, chunk):
    """The affine prior scan: sequential, one parallel scan, and chunked
    with a carried state (T = 40 is not a multiple of the chunk: padding)."""
    jssm, tssm = _ssm(40, 9)
    key = jax.random.PRNGKey(0)
    want = jax.jit(lambda: jprior(key, jssm, 3, parallel=parallel, chunk_size=chunk))()
    eps = jax.random.normal(key, (40, 3, 3), jnp.float64)
    with torch.no_grad():
        got = sample_lgssm_states_given(tssm, t_(eps), parallel=parallel, chunk_size=chunk)
    assert got.shape == (3, 40, 3)
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("parallel,sqrt", [(False, False), (True, False), (False, True), (True, True)])
def test_matheron_samples_match_jax(env, parallel, sqrt):
    """Matheron state samples in the four forms (a missing row; chunk 8 on
    the parallel forms), the prior and noise draws the JAX key gives."""
    T, S = 24, 3
    jssm, tssm = _ssm(T, 2)
    t = _times(T, 2)
    y = np.sin(1.3 * t) + 0.3 * np.random.default_rng(2).normal(size=T)
    y[5] = np.nan
    R = np.broadcast_to(0.1 * np.eye(1), (T, 1, 1)).copy()
    chunk = 8 if parallel else None
    key = jax.random.PRNGKey(2)
    want = jax.jit(lambda: jmatheron(key, jssm, jnp.asarray(R), jnp.asarray(y)[:, None], S,
                                     parallel=parallel, sqrt=sqrt, chunk_size=chunk))()
    k_x, k_y = jax.random.split(key)
    eps_x = jax.random.normal(k_x, (T, S, 3), jnp.float64)
    eps_y = jax.random.normal(k_y, (S, T, 1), jnp.float64)
    with torch.no_grad():
        got = matheron_state_samples_given(tssm, t_(R), t_(y)[:, None], t_(eps_x), t_(eps_y),
                                           parallel=parallel, sqrt=sqrt, chunk_size=chunk)
    assert rel(got, want) <= TOL


def test_zero_q_factor_has_no_jitter_floor():
    """An exactly-zero Q factors to ~0 in both types, as in the reference: an
    absolute jitter floor would inject a random walk over zero-Q steps."""
    for dtype in (torch.float32, torch.float64):
        L = safe_cholesky_rel(torch.zeros((4, 3, 3), dtype=dtype))
        assert float(L.abs().max()) < 1e-12


def test_sampling_needs_an_explicit_generator():
    """Draws come from the caller's generator, never the global one: the same
    seed gives the same samples, no generator raises."""
    _, tssm = _ssm(12, 3)
    a = sample_lgssm_states(torch.Generator().manual_seed(5), tssm, 2)
    b = sample_lgssm_states(torch.Generator().manual_seed(5), tssm, 2)
    assert torch.equal(a, b)
    R = 0.1 * torch.eye(1, **F64).expand(12, 1, 1)
    with pytest.raises(TypeError, match="Generator"):
        matheron_state_samples(None, tssm, R, torch.zeros(12, 1, **F64), 2)


# ---------------------------------------------------------------------------
# StateSpaceGP.sample_f / CVIGP.sample_f
# ---------------------------------------------------------------------------


def _gp_pair(T, seed, **kw):
    t = _times(T, seed)
    y = np.cos(t) + 0.2 * np.random.default_rng(seed).normal(size=T)
    jm = JSSGP(t=jnp.asarray(t), Y=jnp.asarray(y)[:, None],
               kernel=JMatern52(lengthscale=1.1, variance=1.0),
               likelihood=JGaussian(jpositive(0.05)), **kw)
    tm = StateSpaceGP(t=t_(t), Y=t_(y)[:, None],
                      kernel=Matern52(lengthscale=1.1, variance=1.0, **F64),
                      likelihood=Gaussian(positive_param(0.05, **F64)), **kw)
    return jm, tm


_SSGP_REF = {}


def _ssgp_ref(at):
    """The JAX sequential model's sample_f (key 3, S = 3) at 5 new times or at
    the training times, computed once per case."""
    if at not in _SSGP_REF:
        jm, _ = _gp_pair(8, 3)
        ts = jnp.linspace(0.2, 3.8, 5) if at == "new" else None
        _SSGP_REF[at] = jax.jit(lambda: jm.sample_f(jax.random.PRNGKey(3), 3, t_new=ts))()
    return _SSGP_REF[at]


@pytest.mark.parametrize("parallel,sqrt,at", [
    (False, False, "new"), (True, True, "new"), (True, False, "train")])
def test_ssgp_sample_f_matches_jax(env, parallel, sqrt, at):
    """At 5 new times (the NaN-augmented grid, stably sorted) and at the
    training times."""
    T, S = 8, 3
    _, tm = _gp_pair(T, 3, parallel=parallel, sqrt=sqrt,
                     **({"chunk_size": 4} if parallel else {}))
    ts = np.linspace(0.2, 3.8, 5) if at == "new" else None
    key = jax.random.PRNGKey(3)
    want = _ssgp_ref(at)
    n_out = T if ts is None else 5
    eps_x, eps_y, _ = ref.jax_draws(key, S, T + (0 if ts is None else 5), 3, 1, n_out)
    with torch.no_grad():
        got = tm.sample_f_given(t_(eps_x), t_(eps_y), t_new=None if ts is None else t_(ts))
    assert got.shape == (S, n_out, 1)
    assert rel(got, want) <= TOL


def _st_pair():
    """A Kronecker ST model with on-site heads and off-site heads whose
    conditional residual folds into the noise (`correction=True`)."""
    rng = np.random.default_rng(10)
    T, Z, Zs = 6, np.linspace(-1, 1, 3)[:, None], np.array([[-0.6], [0.4]])
    t = np.sort(rng.uniform(0, 2, T))
    Y = rng.normal(size=(T, 5))
    jk = JSTK(k_time=JMatern32(lengthscale=0.8, variance=1.0),
              k_space=JRBF(lengthscales=jpositive(0.7), variance=jpositive(1.0)), Z=jnp.asarray(Z))
    jobs = jops.StateObservation(heads=[jops.SpatialHead(points=jnp.asarray(Z)),
                                        jops.SpatialHead(points=jnp.asarray(Zs), correction=True)])
    jm = JSSGP(t=jnp.asarray(t), Y=jnp.asarray(Y), kernel=jk, observation=jobs,
               likelihood=JIndep(variances=[jpositive(0.1) for _ in range(5)]))
    tk = SpatioTemporalKernel(k_time=Matern32(lengthscale=0.8, variance=1.0, **F64),
                              k_space=RBF(lengthscales=positive_param(0.7, **F64),
                                          variance=positive_param(1.0, **F64)), Z=t_(Z))
    tobs = StateObservation(heads=[SpatialHead(points=t_(Z)), SpatialHead(points=t_(Zs), correction=True)])
    tm = StateSpaceGP(t=t_(t), Y=t_(Y), kernel=tk, observation=tobs,
                      likelihood=IndependentGaussian([positive_param(0.1, **F64) for _ in range(5)]),
                      parallel=True, chunk_size=4)
    return jm, tm


def test_ssgp_sample_f_off_site_heads_matches_jax(env):
    """Off-site heads get their conditional residual as an independent
    per-row draw (the key's first split), as `posterior()` adds it to var."""
    jm, tm = _st_pair()
    key = jax.random.PRNGKey(10)
    want = jax.jit(lambda: jm.sample_f(key, 4))()
    eps_x, eps_y, eps_c = ref.jax_draws(key, 4, 6, 6, 5)
    with torch.no_grad():
        got = tm.sample_f_given(t_(eps_x), t_(eps_y), t_(eps_c))
        without = tm.sample_f_given(t_(eps_x), t_(eps_y), torch.zeros(4, 6, 5, **F64))
    assert rel(got, want) <= TOL
    # only the off-site columns carry the residual draw
    assert torch.equal(got[..., :3], without[..., :3]) and not torch.equal(got[..., 3:], without[..., 3:])


def test_sample_f_rejects_a_time_varying_h_at_new_times():
    class Scattered(torch.nn.Module):
        def H(self, kernel):
            return torch.ones(4, 1, 2, **F64)

        def var_correction(self, kernel):
            return None

    m = StateSpaceGP(t=t_(np.arange(4.0)), Y=torch.zeros(4, 1, **F64),
                     kernel=Matern32(**F64), likelihood=Gaussian(positive_param(0.1, **F64)),
                     observation=Scattered())
    with pytest.raises(ValueError, match="time-varying"):
        m.sample_f(torch.Generator(), 2, t_new=t_([0.5]))


def _jax_leaves(model):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(model)[0]:
        key = jax.tree_util.keystr(path)
        if key.endswith(".raw") or key in (".t", ".Y", ".sites.Y", ".sites.V"):
            out[key] = np.asarray(leaf)
    return out


def test_cvi_sample_f_matches_jax(env):
    """CVIGP.sample_f is its surrogate's: the temporal Poisson model with
    sites away from their initial values, at 6 new times."""
    from physs_gp_tpu.approx.cvi import Sites as JSites

    T, S = 32, 3
    rng = np.random.default_rng(4)
    jm = jbuild_temporal(T, 16, dtype=jnp.float64)
    V = np.eye(1) * rng.uniform(0.3, 2.0, size=(T, 1, 1))
    jm = replace(jm, sites=JSites(Y=jnp.asarray(rng.normal(size=(T, 1))), V=jnp.asarray(V)),
                 parallel=False)
    tm = build_temporal(T, 16, dtype=torch.float64, device="cpu")
    load_numpy_params(tm, _jax_leaves(jm))
    ts = np.sort(rng.uniform(0, 1000, 6))
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda m: m.sample_f(key, S, t_new=jnp.asarray(ts)))(jm)
    eps_x, eps_y, _ = ref.jax_draws(key, S, T + 6, 2, 1, 6)
    got = tm.sample_f_given(t_(eps_x), t_(eps_y), t_new=t_(ts))
    assert rel(got, want) <= TOL


def test_config5_sample_f_matches_golden(env):
    """config-5 (T = 256, chunk 64) after the port's own 2 natural-gradient
    steps, sampled at 40 new times from the golden file's draws, against
    the JAX `sample_f` in covariance form. The card runs all three forms of
    the file (covariance, square-root, fused) and all four samples
    (`chip_smoke.py`)."""
    form = "cov"
    gold = np.load(GOLDEN)
    model = build_config5(256, 64, dtype=torch.float64, device="cpu")
    model, elbos = natgrad_scan(model, 0.5, n_steps=2)
    assert rel(elbos, gold[f"{form}_elbos"]) <= TOL
    # sample s depends on draws s only: the first two of the four suffice
    f = model.sample_f_given(t_(gold["eps_x"][:, :2]), t_(gold["eps_y"][:2]),
                             t_new=t_(gold["t_new"]))
    assert f.shape == (2, 40, 32)
    assert rel(f, gold[f"{form}_f"][:2]) <= TOL


def test_sample_f_moments_match_the_posterior():
    """Monte Carlo, the port's own generator: S = 2000 joint samples at the
    8 training times. Their mean lies within 4 standard errors of the
    posterior mean (sd / sqrt(S)), their variance within 4 standard errors
    of a normal sample variance (var * sqrt(2 / (S - 1)))."""
    _, tm = _gp_pair(8, 3)
    S = 2000
    with torch.no_grad():
        fs = tm.sample_f(torch.Generator().manual_seed(3), S)[..., 0]
        post = tm.posterior()
    var = post.var[:, 0]
    assert torch.all((fs.mean(0) - post.mean[:, 0]).abs() <= 4 * torch.sqrt(var / S))
    assert torch.all((fs.var(0) - var).abs() <= 4 * var * np.sqrt(2 / (S - 1)))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


_SCI_REF = {}


@pytest.mark.parametrize("link", [None, "exp"])
def test_sample_confidence_intervals_matches_jax(env, link):
    """Median and 95 % bounds by linear interpolation (`jnp.quantile`'s
    default), on the JAX model's samples at the training times."""
    jm, tm = _gp_pair(8, 8)
    key = jax.random.PRNGKey(8)
    S = 64
    if not _SCI_REF:  # both links in one compile
        _SCI_REF.update(zip((None, "exp"), jax.jit(lambda: (
            jsci(jm, key, n_samples=S), jsci(jm, key, n_samples=S, link=jnp.exp)))()))
    want = _SCI_REF[link]
    eps_x, eps_y, _ = ref.jax_draws(key, S, 8, 3, 1)

    class Given:
        def sample_f(self, generator, n_samples, t_new=None):
            assert generator == "gen" and n_samples == S and t_new is None
            return tm.sample_f_given(t_(eps_x), t_(eps_y))

    with torch.no_grad():
        got = sample_confidence_intervals(Given(), "gen", n_samples=S,
                                          link=None if link is None else torch.exp)
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL


@pytest.mark.parametrize("x_ref", [None, [0.5]])
def test_response_curve_matches_jax(x_ref):
    jm, tm = _gp_pair(8, 5)
    grid = np.linspace(0.1, 3.9, 7)
    want = jax.jit(lambda: jresponse(jm, jnp.asarray(grid),
                                     X_ref=None if x_ref is None else jnp.asarray(x_ref)))()
    with torch.no_grad():
        got = response_curve(tm, t_(grid), X_ref=None if x_ref is None else t_(x_ref))
    for g, w in zip(got, want):
        assert rel(g, w) <= 1e-10

"""PyTorch port: the prediction path against the JAX package.

The same numpy inputs, made from seeds, go through the JAX function (CPU,
float64) and the port (CPU, float64). Predictive moments agree to rtol 1e-8
(atol 1e-12), the nlpd and the lml to rtol 1e-10. The JAX side runs its
sequential filters (`parallel=False`, one cheap compile), the port its
parallel chunked scans, which the other port tests hold to the JAX
parallel scans: one function, so they agree to rounding.

- `StateSpaceGP` with a `Gaussian` likelihood on the temporal series (d = 2),
  covariance and square-root form, parallel and chunked: lml, objective,
  posterior, `posterior_blocks`, `predict_f`, `predict_y`.
- `CVIGP` on the temporal Poisson model with seeded sites, both forms:
  `surrogate_model`, `predict_f`, `predict_y` (Gauss-Hermite moment
  matching), `nlpd` (log-domain Gauss-Hermite), `natural_gradient_update`
  and `get_objective`.
- `CVIGP.predict_f` on `build_config5(256, 64)` with seeded sites in both
  forms. The augmented grids (306 and 296 steps) are not multiples of the
  chunk, so the runner pads them.
- The port after its own 3 `natgrad_scan` steps against
  `tests/data/predict_T256_golden.npz` (the JAX package after the same
  steps, `scripts/port/make_temporal_golden.py`), which `chip_smoke.py`
  holds the port to on the card.

Prediction reads the smoothed covariances, not their factors, so the JAX
square-root smoother's `_factor_psd` branch does not enter these
comparisons; the golden file's fitted sites were made with its TPU branch,
which the port follows.
"""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.approx.cvi import Sites as JSites  # noqa: E402
from physs_gp_tpu.likelihoods import Gaussian as JGaussian  # noqa: E402
from physs_gp_tpu.models import StateSpaceGP as JStateSpaceGP  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpositive  # noqa: E402
from physs_gp_tpu.utils.struct import replace  # noqa: E402
from physs_gp_tpu.zoo.bench_configs import build_config5 as jbuild5  # noqa: E402
from physs_gp_tpu.zoo.bench_configs import build_temporal as jbuild  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.models.cvi_gp import CVIGP  # noqa: E402
from physs_gp_tpu_torch.models.ssgp import StateSpaceGP  # noqa: E402
from physs_gp_tpu_torch.trainers.scan import natgrad_scan as tscan  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.bench_configs import build_config5 as tbuild5  # noqa: E402
from physs_gp_tpu_torch.zoo.bench_configs import build_temporal as tbuild  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "predict_T256_golden.npz")
T, CHUNK = 256, 64
FORMS = ["cov", "sqrt"]


def _close(a, b, rtol=1e-8, atol=1e-12):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("PHYSS_INNER_SCAN", "blocked")
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")


def _leaves(model, keys=(".t", ".Y", ".kernel.Z", ".sites.Y", ".sites.V")):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(model)[0]:
        key = jax.tree_util.keystr(path)
        if key.endswith(".raw") or key in keys:
            out[key] = np.asarray(leaf)
    return out


def _new_times(seed, n, hi):
    return np.sort(np.random.default_rng(seed).uniform(0, hi, n))


def _seeded_sites(model, seed):
    """Sites away from their initial values: means N(0, 1), variances
    diagonal in [0.3, 2] (NaN site means stay NaN)."""
    rng = np.random.default_rng(seed)
    Tn, p = model.sites.Y.shape
    Y = np.where(np.isfinite(np.asarray(model.sites.Y)), rng.normal(size=(Tn, p)), np.nan)
    V = np.eye(p) * rng.uniform(0.3, 2.0, size=(Tn, p, 1))
    return JSites(Y=jnp.asarray(Y), V=jnp.asarray(V))


# ---------------------------------------------------------------------------
# StateSpaceGP with a Gaussian likelihood
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", FORMS)
def test_ssgp_gaussian_matches_jax(env, form):
    jt = jbuild(T, CHUNK, dtype=jnp.float64)
    jm = JStateSpaceGP(t=jt.t, Y=jt.Y, kernel=jt.kernel,
                       likelihood=JGaussian(variance=jpositive(jnp.asarray(0.7))),
                       parallel=False, sqrt=form == "sqrt")
    tt = tbuild(T, CHUNK, dtype=torch.float64, device="cpu")
    tm = StateSpaceGP(t=tt.t, Y=tt.Y, kernel=tt.kernel,
                      likelihood=Gaussian(variance=positive_param(0.7, dtype=torch.float64)),
                      parallel=True, sqrt=form == "sqrt", chunk_size=CHUNK)
    load_numpy_params(tm, _leaves(jm))
    t_new = _new_times(11, 50, 1000.0)
    lml, post, y = jax.jit(lambda m, t: (m.log_marginal_likelihood(), m.posterior(),
                                         m.predict_y(t)))(jm, jnp.asarray(t_new))
    with torch.no_grad():
        _close(tm.log_marginal_likelihood(), lml, 1e-10)
        _close(tm.get_objective(), -lml, 1e-10)
        tpost = tm.posterior()
        _close(tpost.mean, post.mean)
        _close(tpost.var, post.var)
        ms, Ps, blml = tm.posterior_blocks()
        _close(ms[:, 0], post.mean[:, 0])
        _close(Ps[:, 0, 0], post.var[:, 0])
        _close(blml, lml, 1e-10)
        tf, ty = tm.predict_f(torch.from_numpy(t_new)), tm.predict_y(torch.from_numpy(t_new))
    assert tf.mean.shape == (50, 1)
    _close(ty.mean, y.mean)
    _close(ty.var, y.var)
    # predict_y adds the noise variance to predict_f's
    _close(tf.mean, y.mean)
    _close(tf.var, np.asarray(y.var) - 0.7)


def test_ssgp_sequential_matches_parallel():
    """The sequential runners (covariance and square-root) give the
    parallel scans' predictions."""
    tt = tbuild(T, CHUNK, dtype=torch.float64, device="cpu")
    t_new = torch.from_numpy(_new_times(12, 20, 1000.0))
    out = {}
    for parallel in (True, False):
        for sqrt in (False, True):
            tm = StateSpaceGP(t=tt.t, Y=tt.Y, kernel=tt.kernel,
                              likelihood=Gaussian(variance=positive_param(0.5, dtype=torch.float64)),
                              parallel=parallel, sqrt=sqrt, chunk_size=CHUNK)
            with torch.no_grad():
                out[parallel, sqrt] = tm.predict_f(t_new)
    for key, f in out.items():
        _close(f.mean, out[True, False].mean, 1e-9)
        _close(f.var, out[True, False].var, 1e-9)


def test_ssgp_predict_raises_for_a_time_varying_h():
    class TimeVarying:
        def H(self, kernel):
            return torch.zeros(T, 1, 2, dtype=torch.float64)

        def var_correction(self, kernel):
            return None

    tt = tbuild(T, CHUNK, dtype=torch.float64, device="cpu")
    tm = StateSpaceGP(t=tt.t, Y=tt.Y, kernel=tt.kernel, likelihood=Gaussian(),
                      observation=TimeVarying())
    with pytest.raises(ValueError):
        tm.predict_f(torch.zeros(3, dtype=torch.float64))


# ---------------------------------------------------------------------------
# CVIGP on the temporal Poisson model and on config-5
# ---------------------------------------------------------------------------


def _cvi_pair(jbuilder, tbuilder, form, seed):
    jm = replace(jbuilder(T, CHUNK, parallel=False, dtype=jnp.float64), sqrt=form == "sqrt")
    jm = replace(jm, sites=_seeded_sites(jm, seed))
    tm = tbuilder(T, CHUNK, dtype=torch.float64, sqrt=form == "sqrt", device="cpu")
    load_numpy_params(tm, _leaves(jm))
    return jm, tm


@pytest.mark.parametrize("form", FORMS)
def test_temporal_predictions_match_jax(env, form):
    """predict_f against the JAX method; predict_y and nlpd against the JAX
    quadrature on the JAX predict_f (the methods' own outputs are held in
    the golden file); the update and the objective in covariance form."""
    from physs_gp_tpu.ops import quadrature as jq

    jm, tm = _cvi_pair(jbuild, tbuild, form, seed=13)
    t_new = _new_times(14, 50, 1000.0)
    y_new = np.random.default_rng(15).poisson(2.0, size=(50, 1)).astype(np.float64)
    y_new[3] = np.nan  # drops out of the nlpd
    f = jax.jit(lambda m, t: m.predict_f(t))(jm, jnp.asarray(t_new))
    lik = jm.likelihood
    ey = jq.expect_gh(lik.conditional_mean, f.mean, f.var, 20)
    ey2 = jq.expect_gh(lambda g: lik.conditional_variance(g) + lik.conditional_mean(g) ** 2,
                       f.mean, f.var, 20)
    yj = jnp.asarray(y_new)
    lp = -jq.expect_gh_log(lambda g: lik.log_prob(jnp.nan_to_num(yj)[..., None], g), f.mean, f.var, 20)
    nlpd = jnp.sum(jnp.where(jnp.isfinite(yj), lp, 0.0)) / jnp.sum(jnp.isfinite(yj))
    sur = tm.surrogate_model()
    assert isinstance(sur, StateSpaceGP) and torch.equal(sur.Y, tm.sites.Y)
    tf, ty = tm.predict_f(torch.from_numpy(t_new)), tm.predict_y(torch.from_numpy(t_new))
    _close(tf.mean, f.mean)
    _close(tf.var, f.var)
    _close(ty.mean, ey)
    _close(ty.var, ey2 - ey ** 2)
    _close(tm.nlpd(torch.from_numpy(t_new), torch.from_numpy(y_new)), nlpd, 1e-10)
    if form == "sqrt":
        return
    obj, jnext = jax.jit(lambda m: (m.get_objective(), m.natural_gradient_update(0.5)))(jm)
    with torch.no_grad():
        _close(tm.get_objective(), obj, 1e-10)
    tnext = tm.natural_gradient_update(0.5)
    assert tnext is tm
    _close(tnext.sites.Y, jnext.sites.Y)
    _close(tnext.sites.V, jnext.sites.V)


@pytest.mark.parametrize("form", FORMS)
def test_config5_predict_f_matches_jax(env, form):
    jm, tm = _cvi_pair(jbuild5, tbuild5, form, seed=16)
    t_new = _new_times(17, 40, 100.0)
    f = jax.jit(lambda m, t: m.predict_f(t))(jm, jnp.asarray(t_new))
    tf = tm.predict_f(torch.from_numpy(t_new))
    assert tf.mean.shape == (40, 32)
    _close(tf.mean, f.mean)
    _close(tf.var, f.var)


@pytest.mark.parametrize("form", FORMS)
def test_temporal_predictions_match_golden(monkeypatch, form):
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    gold = np.load(GOLDEN)
    model, _ = tscan(tbuild(T, CHUNK, dtype=torch.float64, sqrt=form == "sqrt", device="cpu"),
                     0.5, n_steps=3)
    t_new, y_new = torch.from_numpy(gold["t_new"]), torch.from_numpy(gold["y_new"])
    f, y = model.predict_f(t_new), model.predict_y(t_new)
    _close(f.mean, gold[f"{form}_f_mean"])
    _close(f.var, gold[f"{form}_f_var"])
    _close(y.mean, gold[f"{form}_y_mean"])
    _close(y.var, gold[f"{form}_y_var"])
    _close(model.nlpd(t_new, y_new), gold[f"{form}_nlpd"], 1e-10)


@pytest.mark.parametrize("form", FORMS)
def test_config5_predict_f_matches_golden(monkeypatch, form):
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    gold = np.load(GOLDEN)
    model, _ = tscan(tbuild5(T, CHUNK, dtype=torch.float64, sqrt=form == "sqrt", device="cpu"),
                     0.5, n_steps=3)
    f = model.predict_f(torch.from_numpy(gold["t5_new"]))
    _close(f.mean, gold[f"c5_{form}_f_mean"])
    _close(f.var, gold[f"c5_{form}_f_var"])


def test_what_is_not_ported_raises():
    model = tbuild(8, None, dtype=torch.float64, device="cpu")
    # Monte-Carlo noise is ported: it takes a torch.Generator, never a JAX key
    for call in (lambda: model.elbo(generator=0), lambda: model.step_with_elbo(0.5, generator=0),
                 lambda: model.natural_gradient_update(0.5, generator=0)):
        with pytest.raises(TypeError):
            call()
    # the prior mean is ported: a constant mean c is the zero-mean model on Y - c
    from physs_gp_tpu_torch.means.mean import ConstantMean

    c = ConstantMean(dtype=torch.float64)
    with torch.no_grad():
        c.c.raw.fill_(0.7)
    cvi = CVIGP.init(model.t, model.Y, model.kernel, model.likelihood, mean=c)
    assert torch.equal(cvi.predict_f(model.t[:3]).mean,
                       CVIGP.init(model.t, model.Y, model.kernel,
                                  model.likelihood).predict_f(model.t[:3]).mean + 0.7)
    Y = torch.nan_to_num(model.Y)
    lml = StateSpaceGP(model.t, Y, model.kernel, Gaussian(), mean=c).log_marginal_likelihood()
    assert torch.equal(lml, StateSpaceGP(model.t, Y - 0.7, model.kernel,
                                         Gaussian()).log_marginal_likelihood())


def test_port_entry_points_run_on_the_card_by_default():
    for builder in (tbuild, tbuild5):
        assert inspect.signature(builder).parameters["device"].default == "cuda"


def test_new_modules_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['physs_gp_tpu'] = None\n"
        "import physs_gp_tpu_torch.models.ssgp, physs_gp_tpu_torch.ops.quadrature\n"
        "import physs_gp_tpu_torch.likelihoods.nongaussian, physs_gp_tpu_torch.zoo.bench_configs\n"
        "from physs_gp_tpu_torch.kernels.matern import Matern12, Matern52, Matern72\n"
        "from physs_gp_tpu_torch.ops.sqrt_kalman import sqrt_kalman_filter, sqrt_rts_smoother\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr

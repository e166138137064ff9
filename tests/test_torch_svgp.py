"""PyTorch port: SVGP, deriv_vgp, PerOutputLikelihood, Power,
LossLikelihood, the batch LMC, the means and the fill_triangular packing
against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function
(float64, CPU) and the port's; values, predictions and gradients (against
`jax.grad`) agree to rtol 1e-9 relative to each output's largest magnitude.
The JAX raws are moved off their defaults and carried into the port by
`interop.load_numpy_params`. The monotonic batch-VI arm's natural-gradient
steps are held to the JAX package through `batch_golden.npz`
(tests/test_torch_batch_golden.py).
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.kernels.multi_output import LMC as JLMC  # noqa: E402
from physs_gp_tpu.likelihoods import nongaussian as jng  # noqa: E402
from physs_gp_tpu.likelihoods.gaussian import Gaussian as JGaussian  # noqa: E402
from physs_gp_tpu.means import mean as jmean  # noqa: E402
from physs_gp_tpu.ops import gaussian as jgauss  # noqa: E402
from physs_gp_tpu.transforms import operators as jops  # noqa: E402
from physs_gp_tpu.utils import params as jparams  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.multi_output import LMC  # noqa: E402
from physs_gp_tpu_torch.likelihoods import nongaussian as png  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.means import mean as pmean  # noqa: E402
from physs_gp_tpu_torch.models.batch_gp import BatchGP  # noqa: E402
from physs_gp_tpu_torch.ops import gaussian as pgauss  # noqa: E402
from physs_gp_tpu_torch.transforms import operators as pops  # noqa: E402
from physs_gp_tpu_torch.utils import params  # noqa: E402
from physs_gp_tpu_torch.utils.params import param, positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.diff import deriv_gp, deriv_vgp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import batch_outcome as bo  # noqa: E402
import make_batch_golden as mg  # noqa: E402

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")
TOL = 1e-9


def rel(a, b):
    """max |a - b| / max |b| (max |a - b| when b is 0); NaNs in the same places."""
    a, b = (x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    return float(np.nanmax(np.abs(a - b)) / (np.nanmax(np.abs(b)) or 1.0))


def t_(x):
    return torch.from_numpy(np.array(x))


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_fill_triangular_packs_as_jax():
    """Row-major `tril_indices` packing, batched, its inverse, `tril_param`
    and the gradient through the packing."""
    vec = np.random.default_rng(0).normal(size=(2, 3, 10))
    L = params.fill_triangular(t_(vec), 4)
    assert rel(L, jparams.fill_triangular(jnp.asarray(vec), 4)) <= 0
    assert torch.equal(params.fill_triangular_inverse(L), t_(vec))
    M = np.tril(np.random.default_rng(1).normal(size=(5, 5)))
    p, jp = params.tril_param(t_(M)), jparams.tril_param(jnp.asarray(M))
    assert rel(p.raw, jp.raw) <= 0 and torch.equal(params.tril_value(p, 5), t_(M))
    v = t_(vec[0, 0]).requires_grad_(True)
    (params.fill_triangular(v, 4) * t_(np.arange(16.0).reshape(4, 4))).sum().backward()
    assert torch.equal(v.grad, t_(np.tril(np.arange(16.0).reshape(4, 4))[np.tril_indices(4)]))


def test_gaussian_kl_and_mvn_logpdf_match_jax():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(6, 6))
    S = A @ A.T + 0.5 * np.eye(6)
    Lq, Lp = np.linalg.cholesky(S), np.tril(rng.normal(size=(6, 6))) + 3 * np.eye(6)
    mq, mp, y = rng.normal(size=6), rng.normal(size=6), rng.normal(size=6)
    assert rel(pgauss.gaussian_kl(t_(mq), t_(Lq), t_(mp), t_(Lp)),
               jgauss.gaussian_kl(jnp.asarray(mq), jnp.asarray(Lq), jnp.asarray(mp),
                                  jnp.asarray(Lp))) <= TOL
    assert rel(pgauss.mvn_logpdf(t_(y), t_(mq), t_(S)),
               jgauss.mvn_logpdf(jnp.asarray(y), jnp.asarray(mq), jnp.asarray(S))) <= TOL


# ---------------------------------------------------------------------------
# SVGP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("whiten", [True, False])
def test_svgp_matches_jax(whiten):
    """ELBO and its gradient by every raw, one natural-gradient step at lr
    0.7 (q after it), predict_f, predict_y and the joint covariance."""
    X, Y, Z, Xs = bo.svgp_inputs()
    jm = mg.shift_raws(mg.jax_svgp(X, Y, Z, whiten))

    def run(m):
        elbo, g = jax.value_and_grad(lambda mm: mm.elbo())(m)
        m = m.natural_gradient_update(0.7)
        return elbo, g, m.q_mu.raw, m.q_sqrt.raw, m.predict_f(Xs), m.predict_y(Xs), m._joint(Xs)

    elbo, g, q_mu, q_sqrt, *pred = jax.jit(run)(jm)
    pm = bo.svgp_model(X, Y, Z, whiten, **F64)
    load_numpy_params(pm, mg.leaves(jm))
    val = pm.elbo()
    val.backward()
    assert rel(val, elbo) <= TOL
    pg = {n: p.grad for n, p in pm.named_parameters()}
    for k, v in jax.tree_util.tree_flatten_with_path(g)[0]:
        key = jax.tree_util.keystr(k)
        if key.endswith(".raw"):
            assert rel(pg[bo._jax_name(key)], v) <= TOL, key
    with torch.no_grad():
        assert pm.natural_gradient_update(0.7) is pm
        assert rel(pm.q_mu.raw, q_mu) <= TOL and rel(pm.q_sqrt.raw, q_sqrt) <= TOL
        got = (pm.predict_f(Xs), pm.predict_y(Xs), pm._joint(pm._points(Xs)))
    for a, b in zip(_leaves(got), _leaves(pred)):
        assert rel(a, b) <= TOL
    draws = pm.sample_f(torch.Generator().manual_seed(0), Xs, 3)
    assert draws.shape == (3, Xs.shape[0], 1) and torch.isfinite(draws).all()


def test_svgp_natural_gradient_is_exact_for_a_gaussian():
    """With Z = X, a Gaussian likelihood and lr = 1, one step reaches the
    exact posterior: the ELBO equals the BatchGP lml and predict_f its
    posterior, for deriv_vgp against deriv_gp (NaN entries masked), to the
    relative jitter of the inducing Gram's factor (rtol 1e-7, as the JAX
    package's own test)."""
    X, Y, Xs = bo.deriv_inputs(n=8)
    exact = deriv_gp(X, Y, noise=0.1, **F64)
    for whiten in (True, False):
        vgp = deriv_vgp(X, Y, noise=0.1, whiten=whiten, **F64)
        with torch.no_grad():
            vgp.natural_gradient_update(1.0)
            assert rel(vgp.elbo(), exact.log_marginal_likelihood()) <= 1e-7
            a, b = vgp.predict_f(Xs), exact.predict_f(Xs)
            assert rel(a.mean, b.mean) <= 1e-7 and rel(a.var, b.var) <= 1e-7


def test_deriv_vgp_matches_jax():
    """The monotonic arm's model at a small size (Matérn-7/2, Gaussian +
    Probit through PerOutputLikelihood, unwhitened): ELBO and its gradient,
    predict_f and predict_y (the per-output moments)."""
    X, Y, Z, t_test, _, _ = bo.monotonic_inputs(quick=True)
    X, Y, Z, t_test = X[::4], Y[::4], Z[::3], t_test[::20]
    jm = mg.shift_raws(mg.jax_mv(X, Y, Z))

    def run(m):
        return jax.value_and_grad(lambda mm: mm.elbo())(m), m.predict_f(t_test), m.predict_y(t_test)

    (elbo, g), *pred = jax.jit(run)(jm)
    pm = bo.monotonic_model(X, Y, Z, **F64)
    load_numpy_params(pm, mg.leaves(jm))
    val = pm.elbo()
    val.backward()
    assert rel(val, elbo) <= TOL
    assert rel(pm.kernel.base.lengthscales.raw.grad, g.kernel.base.lengthscales.raw) <= TOL
    assert rel(pm.q_sqrt.raw.grad, g.q_sqrt.raw) <= TOL
    with torch.no_grad():
        got = (pm.predict_f(t_test), pm.predict_y(t_test))
    for a, b in zip(_leaves(got), _leaves(pred)):
        assert rel(a, b) <= TOL


# ---------------------------------------------------------------------------
# likelihoods
# ---------------------------------------------------------------------------


def _liks():
    loss = lambda y, f: (y - f) ** 2 + 0.1 * jnp.abs(f)  # noqa: E731
    tloss = lambda y, f: (y - f) ** 2 + 0.1 * torch.abs(f)  # noqa: E731
    j = [JGaussian(variance=jparams.positive_param(jnp.asarray(0.3))), jng.Probit(nu=0.5),
         jng.Poisson(), jng.Power(power=3.0), jng.LossLikelihood(loss=loss)]
    p = [Gaussian(positive_param(0.3, **F64)), png.Probit(nu=0.5), png.Poisson(),
         png.Power(power=3.0), png.LossLikelihood(loss=tloss)]
    return jng.PerOutputLikelihood(liks=j), png.PerOutputLikelihood(p)


def test_per_output_likelihood_matches_jax():
    """Per-column routing of data-major arrays: log_prob, the expected log
    likelihood (NaN entries give 0), predict_y_moments and the predictive
    log density; Power and LossLikelihood through it."""
    jl, pl = _liks()
    rng = np.random.default_rng(3)
    N, P = 6, 5
    y = np.abs(rng.normal(size=(N, P))).round(1)
    y[:, 1] = (y[:, 1] > 0.5).astype(float)
    y[2, 0] = y[4, 3] = np.nan
    f, m, v = rng.normal(size=(N, P)), rng.normal(size=(N, P)), rng.uniform(0.1, 1.0, (N, P))

    def run(lik, y, f, m, v):
        return (lik.log_prob(y.reshape(-1), f.reshape(-1)),
                lik.expected_log_lik(y.reshape(-1), m.reshape(-1), v.reshape(-1)),
                lik.predict_y_moments(m, v), lik.predictive_log_density(y, m, v))

    want = jax.jit(run)(jl, *(jnp.asarray(a) for a in (y, f, m, v)))
    got = run(pl, *(t_(a) for a in (y, f, m, v)))
    for a, b in zip(_leaves(got), _leaves(want)):
        assert rel(a, b) <= TOL
    assert torch.all(got[1].reshape(N, P)[2, 0] == 0)


# ---------------------------------------------------------------------------
# LMC and means
# ---------------------------------------------------------------------------


def test_lmc_matches_jax():
    """K_blocks, the data-major K and K_diag of a batch LMC; `init` draws W
    from a generator, `init_ldl` starts at W = I."""
    rng = np.random.default_rng(4)
    X1, X2 = rng.normal(size=(5, 1)), rng.normal(size=(3, 1))
    W = rng.normal(size=(3, 2))
    jk = JLMC(latents=[mg._jrbf(0.8, 1.0), mg._jrbf(2.0, 0.5)], W=jparams.param(jnp.asarray(W)))
    pk = LMC([bo._rbf(0.8, 1.0, F64), bo._rbf(2.0, 0.5, F64)], param(W, **F64))
    want = jax.jit(lambda k, a, b: (k.K_blocks(a, b), k.K(a, b), k.K_diag(a)))(
        jk, jnp.asarray(X1), jnp.asarray(X2))
    got = (pk.K_blocks(t_(X1), t_(X2)), pk.K(t_(X1), t_(X2)), pk.K_diag(t_(X1)))
    for a, b in zip(got, want):
        assert rel(a, b) <= TOL
    assert torch.equal(got[1].reshape(5, 3, 3, 3).permute(1, 3, 0, 2), got[0])
    lat = [bo._rbf(1.0, 1.0, F64)] * 2
    a = LMC.init(lat, P=3, generator=torch.Generator().manual_seed(1), **F64)
    b = LMC.init(lat, P=3, generator=torch.Generator().manual_seed(1), **F64)
    assert a.n_outputs == 3 and torch.equal(a.W.value, b.W.value)
    assert torch.equal(LMC.init_ldl(lat, P=2, **F64).W.value, torch.eye(2, **F64))


def test_means_match_jax():
    """The mean functions, their derivatives by autodiff, head_mean_values
    over value, derivative, linear-operator and spatial heads, and a
    BatchGP with a linear mean."""
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0, 2, 6))
    w = np.array([0.7])

    def jf(x):
        return jnp.sin(2.0 * x[0])

    def pf(x):
        return torch.sin(2.0 * x[0])

    jms = [jmean.ZeroMean(), jmean.ConstantMean(c=jparams.param(jnp.asarray(0.4))),
           jmean.LinearMean(w=jparams.param(jnp.asarray(w)), b=jparams.param(jnp.asarray(0.2))),
           jmean.FunctionMean(fn=jf)]
    pms = [pmean.ZeroMean(), pmean.ConstantMean(param(0.4, **F64)),
           pmean.LinearMean(param(w, **F64), param(0.2, **F64)), pmean.FunctionMean(pf)]
    for jm, pm in zip(jms, pms):
        assert rel(pm(t_(t)), jm(jnp.asarray(t))) <= TOL
        for order in (1, 2):
            assert rel(pm.deriv(t_(t), order), jm.deriv(jnp.asarray(t), order)) <= TOL
    pts = rng.uniform(-1, 1, (2, 1))
    sc = rng.uniform(-1, 1, (6, 3, 1))
    jheads = [jops.ValueHead(), jops.DerivativeHead(order=1),
              jops.LinearOperatorHead(coeffs=[1.0, jparams.param(jnp.asarray(0.3))]),
              jops.SpatialHead(points=jnp.asarray(pts)),
              jops.ScatteredSpatialHead(points=jnp.asarray(sc)),
              jops.SpatialHead(points=jnp.asarray(pts), t_order=1)]
    pheads = [pops.ValueHead(), pops.DerivativeHead(order=1),
              pops.LinearOperatorHead([1.0, param(0.3, **F64)]), pops.SpatialHead(t_(pts)),
              pops.ScatteredSpatialHead(t_(sc)), pops.SpatialHead(t_(pts), t_order=1)]
    jlin = jmean.LinearMean(w=jparams.param(jnp.asarray([0.7, -0.2])))
    plin = pmean.LinearMean(param([0.7, -0.2], **F64))
    means = [(jms[3], pms[3])] * 3 + [(jlin, plin)] * 3
    got = pmean.head_mean_values([p for _, p in means], t_(t), pops.StateObservation(pheads))
    want = jmean.head_mean_values([j for j, _ in means], jnp.asarray(t),
                                  jops.StateObservation(heads=jheads))
    assert got.shape == (6, 10) and rel(got, want) <= TOL
    assert rel(pmean.head_mean_values(pms[2], t_(t), p=2),
               jmean.head_mean_values(jms[2], jnp.asarray(t), p=2)) <= TOL
    X, Y, _, _ = bo.svgp_inputs()
    jb = mg.jax_cg(X, Y, solver="cholesky")
    jb = jb.__class__(**{**{f: getattr(jb, f) for f in ("X", "Y", "kernel", "likelihood")},
                        "mean": jms[2]})
    pb = BatchGP(X, Y, bo._rbf([bo.CG_LS, bo.CG_LS], 1.0, F64),
                 Gaussian(positive_param(bo.CG_NOISE, **F64)), mean=pms[2], **F64)
    load_numpy_params(pb, mg.leaves(jb))
    assert rel(pb.log_marginal_likelihood(), jax.jit(lambda m: m.log_marginal_likelihood())(jb)) <= TOL

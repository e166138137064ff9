"""PyTorch port: the Monte-Carlo and composite-likelihood layer of the
physics-informed path against the JAX package.

`ops/matrix.robust_cholesky` (members that factor at the base jitter, that
must escalate, and one that fails at every probed level), `ops/quadrature.
expect_mc`, `Probit` and `Bernoulli`, `NonlinearResidual.ell` and
`gauss_newton_grads` for scalar and vector residuals, and every method of
`CompositeLikelihood`. The same numpy inputs go through both packages in
float64 on the CPU; the Monte-Carlo terms get the standard normals the JAX
function draws from its key (`jax.random.normal(key, shape)`), handed to
the port through `draws=`. Values agree to rtol 1e-9, moments and
gradients to 1e-7. The generator semantics mirror
`tests/test_keys_predictive.py`: the same seed gives equal draws, another
seed other draws, and no generator the frozen draws on every call.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.likelihoods import Gaussian as JGaussian  # noqa: E402
from physs_gp_tpu.likelihoods.composite import CompositeLikelihood as JComposite  # noqa: E402
from physs_gp_tpu.likelihoods.composite import NonlinearResidual as JResidual  # noqa: E402
from physs_gp_tpu.likelihoods.nongaussian import Bernoulli as JBernoulli  # noqa: E402
from physs_gp_tpu.likelihoods.nongaussian import Probit as JProbit  # noqa: E402
from physs_gp_tpu.ops.matrix import robust_cholesky as jrobust  # noqa: E402
from physs_gp_tpu.ops.quadrature import expect_mc as jexpect_mc  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpositive  # noqa: E402
from physs_gp_tpu_torch.likelihoods.composite import CompositeLikelihood, NonlinearResidual  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.likelihoods.nongaussian import Bernoulli, Probit  # noqa: E402
from physs_gp_tpu_torch.ops.matrix import robust_cholesky  # noqa: E402
from physs_gp_tpu_torch.ops.quadrature import expect_mc  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402

torch.set_num_threads(1)

T, P, N_MC = 7, 3, 8
F64 = dict(dtype=torch.float64)


def _close(a, b, rtol=1e-9, atol=1e-12):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, equal_nan=True)


def t_(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _blocks(seed=0, T=T, p=P):
    """Block moments m [T, p], S [T, p, p] (PSD, scale ~0.3)."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(T, p))
    X = rng.normal(size=(T, p, p))
    S = 0.1 * X @ np.swapaxes(X, -1, -2) + 0.05 * np.eye(p)
    return m, S


def _draws(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float64))


# ---------------------------------------------------------------------------
# robust_cholesky, expect_mc, Probit, Bernoulli
# ---------------------------------------------------------------------------


def _escalating_batch(n, dtype):
    """Members: PD; indefinite by ~5e-11 of its scale in f64 (2e-5 in f32),
    so the probes at 1 and 1e2 times the base jitter fail and 1e3 holds;
    indefinite by O(1), which fails at every level; rank-one PSD."""
    rng = np.random.default_rng(n)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    base = 1e-12 if dtype == np.float64 else 1e-6
    eig_pd = np.linspace(1.0, 2.0, n)
    eig_esc = eig_pd.copy()
    eig_esc[0] = -50 * base * 2.0
    eig_bad = eig_pd.copy()
    eig_bad[0] = -1.0
    v = rng.normal(size=(n, 1))
    mats = [Q @ np.diag(e) @ Q.T for e in (eig_pd, eig_esc, eig_bad)] + [v @ v.T]
    return np.stack(mats)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_robust_cholesky_matches_jax(n):
    A = _escalating_batch(n, np.float64)
    want = np.asarray(jrobust(jnp.asarray(A)))
    got = robust_cholesky(t_(A))
    if n > 2:
        # the indefinite member fails at every level, in both packages
        low = np.tril_indices(n)
        assert np.isnan(want[2][low]).all() and torch.isnan(got[2][low]).all()
        # the escalating member factors (at 1e3 times the base jitter)
        assert np.isfinite(want[1]).all() and torch.isfinite(got[1]).all()
    # normwise per member: the escalated member's last pivot is ~sqrt of
    # its jitter, whose rounding no elementwise tolerance can bound
    got = got.numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    for a, b in zip(got, want):
        if np.isfinite(b).all():
            assert np.max(np.abs(a - b)) <= 1e-9 * np.max(np.abs(b))
    # the gradient flows through the one real factorisation, on the members
    # that factor there (at n <= 2 the closed form clamps the indefinite and
    # rank-one members onto sqrt's singularity at 0, where rounding picks
    # NaN or a finite value)
    idx = [0, 1] if n > 2 else [0]
    A_ = t_(A[idx]).requires_grad_(True)
    robust_cholesky(A_).sum().backward()
    gj = jax.grad(lambda a: jnp.sum(jrobust(a)))(jnp.asarray(A[idx]))
    _close(A_.grad, gj, rtol=1e-7, atol=1e-9)


def test_expect_mc_matches_jax_on_its_draws():
    m, S = _blocks(1)
    v = np.diagonal(S, axis1=-2, axis2=-1)
    key = jax.random.PRNGKey(3)
    g = np.sin
    want = jexpect_mc(jnp.sin, jnp.asarray(m), jnp.asarray(v), key, n=16)
    eps = _draws(key, m.shape + (16,))
    _close(expect_mc(torch.sin, t_(m), t_(v), n=16, draws=t_(eps)), want)
    gen = torch.Generator().manual_seed(0)
    a = expect_mc(torch.sin, t_(m), t_(v), torch.Generator().manual_seed(0), n=16)
    assert torch.equal(a, expect_mc(torch.sin, t_(m), t_(v), gen, n=16))
    assert np.isfinite(g(a.numpy())).all()


@pytest.mark.parametrize("name", ["probit", "bernoulli"])
def test_probit_and_bernoulli_match_jax(name):
    rng = np.random.default_rng(2)
    m = rng.normal(size=(6, 4)) * 0.05
    v = rng.uniform(1e-4, 0.1, size=(6, 4))
    y = (rng.uniform(size=(6, 4)) > 0.4).astype(float)
    y[1, 2] = np.nan
    f = rng.normal(size=(6, 4)) * 0.05
    jl, tl = (JProbit(nu=0.02), Probit(nu=0.02)) if name == "probit" else (JBernoulli(), Bernoulli())
    J = lambda x: jnp.asarray(x)  # noqa: E731
    _close(tl.expected_log_lik(t_(y), t_(m), t_(v)), jl.expected_log_lik(J(y), J(m), J(v)))
    y0 = np.nan_to_num(y)
    _close(tl.log_prob(t_(y0), t_(f)), jl.log_prob(J(y0), J(f)))
    _close(tl.conditional_mean(t_(f)), jl.conditional_mean(J(f)))
    _close(tl.conditional_variance(t_(f)), jl.conditional_variance(J(f)))


# ---------------------------------------------------------------------------
# NonlinearResidual
# ---------------------------------------------------------------------------


def _scalar_fn(np_like):
    return lambda f: f[..., 2] + 0.3 * f[..., 1] + 9.0 * np_like.sin(f[..., 0])


def _vector_fn(f):
    return f[..., 1:] - f[..., :1] + f[..., :1] ** 3  # C = p - 1 residuals


RESIDUALS = {"scalar": (_scalar_fn(jnp), _scalar_fn(torch)), "vector": (_vector_fn, _vector_fn)}


def _residual_pair(kind, nv=0.05):
    jfn, tfn = RESIDUALS[kind]
    return (JResidual(noise_var=jpositive(jnp.asarray(nv)), fn=jfn, n_mc=N_MC),
            NonlinearResidual(noise_var=positive_param(nv, **F64), fn=tfn, n_mc=N_MC))


@pytest.mark.parametrize("kind", ["scalar", "vector"])
def test_residual_ell_and_gauss_newton_match_jax(kind):
    jr, tr = _residual_pair(kind)
    m, S = _blocks(4)
    mask = np.array([1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    key = jax.random.PRNGKey(7)
    eps = t_(_draws(key, (N_MC, T, P)))
    J = lambda x: jnp.asarray(x)  # noqa: E731
    _close(tr.ell(t_(mask), t_(m), t_(S), draws=eps), jr.ell(J(mask), J(m), J(S), key=key))
    g1, g2 = tr.gauss_newton_grads(t_(mask), t_(m), t_(S), draws=eps)
    w1, w2 = jax.jit(lambda *a: jr.gauss_newton_grads(*a, key=key))(J(mask), J(m), J(S))
    _close(g1, w1, rtol=1e-7)
    _close(g2, w2, rtol=1e-7)
    # the frozen seed: JAX draws from PRNGKey(seed); the port's own
    # generator seeded alike gives other numbers but the same on each call
    a = tr.ell(t_(mask), t_(m), t_(S))
    assert torch.equal(a, tr.ell(t_(mask), t_(m), t_(S))) and torch.isfinite(a)


def test_residual_generator_semantics():
    """Same generator seed -> equal ELL; another seed -> another; None ->
    frozen (the counterpart of tests/test_keys_predictive.py)."""
    _, tr = _residual_pair("scalar")
    m, S = _blocks(5)
    mask = torch.ones(T, **F64)

    def ell(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        return float(tr.ell(mask, t_(m), t_(S), generator=gen).detach())

    assert ell(1) == ell(1)
    assert ell(1) != ell(2)
    assert ell(None) == ell(None)
    assert ell(None) == ell(tr.seed)  # None is the generator seeded with `seed`
    g1a, _ = tr.gauss_newton_grads(mask, t_(m), t_(S), generator=torch.Generator().manual_seed(1))
    g1b, _ = tr.gauss_newton_grads(mask, t_(m), t_(S), generator=torch.Generator().manual_seed(2))
    assert not torch.allclose(g1a, g1b)
    with pytest.raises(TypeError):
        tr.ell(mask, t_(m), t_(S), generator=0)


# ---------------------------------------------------------------------------
# CompositeLikelihood
# ---------------------------------------------------------------------------


def _composite_pair(mask=None, residual="vector"):
    heads_j = [JGaussian(jpositive(jnp.asarray(0.1))), JProbit(nu=0.05), JGaussian(jpositive(jnp.asarray(1.0)))]
    heads_t = [Gaussian(positive_param(0.1, **F64)), Probit(nu=0.05), Gaussian(positive_param(1.0, **F64))]
    jr, tr = _residual_pair(residual) if residual else (None, None)
    return (JComposite(heads=heads_j, residual=jr,
                       residual_mask=None if mask is None else jnp.asarray(mask)),
            CompositeLikelihood(heads=heads_t, residual=tr,
                                residual_mask=None if mask is None else t_(mask)))


def _Y(seed=6):
    rng = np.random.default_rng(seed)
    Y = np.stack([rng.normal(size=T), (rng.uniform(size=T) > 0.3).astype(float),
                  np.full(T, np.nan)], 1)
    Y[[1, 4], 0] = np.nan
    Y[2, 1] = np.nan
    return Y


@pytest.mark.parametrize("mask", [None, [1.0, 1.0, 0.0, 1.0, 0.0, 0.0, 1.0]])
def test_composite_blocks_and_natgrad_moments_match_jax(mask):
    jl, tl = _composite_pair(mask)
    m, S = _blocks(8)
    m[:, 1] *= 0.05  # probit head near its boundary
    Y = _Y()
    J = lambda x: jnp.asarray(x)  # noqa: E731
    assert np.array_equal(tl.site_active_mask(t_(Y)).numpy(), np.asarray(jl.site_active_mask(J(Y))))
    key = jax.random.PRNGKey(9)
    eps = t_(_draws(key, (N_MC, T, P)))
    _close(tl.expected_log_lik_blocks(t_(Y), t_(m), t_(S), draws=eps),
           jl.expected_log_lik_blocks(J(Y), J(m), J(S), key=key))
    for hessian in ("exact", "gauss_newton"):
        g = tl.natgrad_moments(t_(Y), t_(m), t_(S), residual_hessian=hessian, draws=eps)
        w = jax.jit(lambda *a, h=hessian: jl.natgrad_moments(*a, residual_hessian=h, key=key))(
            J(Y), J(m), J(S))
        _close(g[0], w[0], rtol=1e-7, atol=1e-10)
        _close(g[1], w[1], rtol=1e-7, atol=1e-10)


def test_composite_without_residual_and_predictives_match_jax():
    jl, tl = _composite_pair(residual=None)
    m, S = _blocks(10)
    m[:, 1] *= 0.05
    v = np.diagonal(S, axis1=-2, axis2=-1)
    Y = _Y(11)
    J = lambda x: jnp.asarray(x)  # noqa: E731
    assert np.array_equal(tl.site_active_mask(t_(Y)).numpy(), np.isfinite(Y))
    _close(tl.expected_log_lik_blocks(t_(Y), t_(m), t_(S)), jl.expected_log_lik_blocks(J(Y), J(m), J(S)))
    g = tl.natgrad_moments(t_(Y), t_(m), t_(S), residual_hessian="gauss_newton")
    w = jax.jit(lambda *a: jl.natgrad_moments(*a, residual_hessian="gauss_newton"))(J(Y), J(m), J(S))
    _close(g[0], w[0], rtol=1e-7, atol=1e-10)
    _close(g[1], w[1], rtol=1e-7, atol=1e-10)
    ey, vy = tl.predict_y_moments(t_(m), t_(v))
    wy, wv = jl.predict_y_moments(J(m), J(v))
    _close(ey, wy, rtol=1e-7, atol=1e-12)
    _close(vy, wv, rtol=1e-7, atol=1e-12)
    _close(tl.predictive_density(t_(Y), t_(m), t_(v)), jl.predictive_density(J(Y), J(m), J(v)),
           rtol=1e-7, atol=1e-12)
    _close(tl.predictive_log_density(t_(Y), t_(m), t_(v)),
           jl.predictive_log_density(J(Y), J(m), J(v)), rtol=1e-9)
    y0 = np.nan_to_num(Y)
    _close(tl.log_prob(t_(y0), t_(m)), jl.log_prob(J(y0), J(m)))
    f3 = np.random.default_rng(12).normal(size=(T, P, 4)) * 0.05
    y3 = np.repeat(y0[..., None], 4, -1)
    _close(tl.log_prob(t_(y3), t_(f3)), jl.log_prob(J(y3), J(f3)))


@pytest.mark.parametrize("method", ["log_prob", "conditional_mean", "conditional_variance",
                                    "quadrature_axis"])
def test_independent_gaussian_methods_match_jax(method):
    """`IndependentGaussian.log_prob`, `conditional_mean` and
    `conditional_variance` on [T, p] (a `SharedVariance` group among the
    heads), as the JAX package's; on a quadrature axis [T, p, n] the
    per-head variances broadcast against n in both packages, which fails
    there as here (a multi-head `CVIGP.predict_y`)."""
    from physs_gp_tpu.likelihoods.gaussian import IndependentGaussian as JIndep
    from physs_gp_tpu.likelihoods.gaussian import SharedVariance as JShared
    from physs_gp_tpu_torch.likelihoods.gaussian import IndependentGaussian, SharedVariance

    rng = np.random.default_rng(5)
    y, f = rng.normal(size=(2, T, P))
    jl = JIndep(variances=[jpositive(0.3), JShared(p=jpositive(0.05), n=P - 1)])
    pl = IndependentGaussian([positive_param(0.3, **F64),
                              SharedVariance(positive_param(0.05, **F64), n=P - 1)])
    if method == "log_prob":
        _close(pl.log_prob(t_(y), t_(f)), jl.log_prob(jnp.asarray(y), jnp.asarray(f)))
    elif method == "quadrature_axis":
        ff = rng.normal(size=(T, P, 20))
        with pytest.raises(ValueError):
            jl.conditional_variance(jnp.asarray(ff))
        with pytest.raises(RuntimeError):
            pl.conditional_variance(t_(ff))
    else:
        _close(getattr(pl, method)(t_(f)), getattr(jl, method)(jnp.asarray(f)))

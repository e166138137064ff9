"""PyTorch port: the volatility path (`correlation_cholesky`,
`CorrelationMixing` / `LMC.init_drd`, `DynamicCovarianceGaussian`,
`HetGaussian`, the generalised Monte-Carlo draws of `CVIGP`) against the
JAX package.

Live cases feed the same numpy inputs (and the JAX package's draws) to both
packages at small sizes (float64, rtol 1e-9): the correlation Cholesky, the
probit-squashed mixing, the score against `jax.grad`, the ELL and the
empirical-Fisher moments, the heteroscedastic ELLs. The golden cases hold
the port to `tests/data/dynamics_golden.npz`: the `init_drd` Gram and lml
through `interop.load_numpy_params`, and 5 CVI steps of
`dynamic_covariance_gp` on the JAX package's two draw sets. JAX is imported
only inside the live cases, so the `cuda` twin runs on the card:

    python3 -m pytest --noconftest -m cuda tests/test_torch_dynamic_covariance.py
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import dynamics_outcome as do  # noqa: E402

from physs_gp_tpu_torch.likelihoods.dynamic_covariance import correlation_cholesky  # noqa: E402
from physs_gp_tpu_torch.likelihoods.het_gaussian import HetGaussian  # noqa: E402

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def gold():
    return np.load(do.GOLDEN)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(res):
    for key, (got, want, tol) in res.items():
        r = do.relerr(got, want)
        assert r <= tol, (key, r, tol)


@pytest.mark.parametrize("P", [2, 4, 5])
def test_correlation_cholesky_matches_jax(P):
    """L [..., P, P] from z in `jnp.tril_indices` order: equal to the JAX
    package's, a valid correlation Cholesky, and differentiable by
    `torch.func` (the construction writes nothing in place)."""
    import jax.numpy as jnp

    from physs_gp_tpu.likelihoods.dynamic_covariance import correlation_cholesky as jcc

    rng = np.random.default_rng(P)
    z = np.tanh(rng.normal(size=(7, P * (P - 1) // 2)))
    L = correlation_cholesky(torch.as_tensor(z, **F64), P)
    assert do.relerr(do.numpy(L), np.asarray(jcc(jnp.asarray(z), P))) <= 1e-12
    C = do.numpy(L @ L.transpose(-1, -2))
    np.testing.assert_allclose(np.diagonal(C, axis1=1, axis2=2), 1.0, atol=1e-12)
    J = torch.func.vmap(torch.func.jacrev(lambda zz: correlation_cholesky(zz, P)))(
        torch.as_tensor(z, **F64))
    assert J.shape == (7, P, P, z.shape[1]) and torch.all(torch.isfinite(J))


def test_correlation_mixing_matches_jax():
    """`CorrelationMixing.value` = diag(scales) L(2 Φ(z) - 1) with the same
    raws as the JAX package's."""
    import jax.numpy as jnp

    from physs_gp_tpu.kernels.multi_output import CorrelationMixing as JCM
    from physs_gp_tpu.utils.params import param as jparam
    from physs_gp_tpu.utils.struct import replace
    from physs_gp_tpu_torch.kernels.multi_output import CorrelationMixing

    z = np.array([0.4, -1.2, 0.7, 2.0, -0.3, 0.1])
    jm = replace(JCM.init(4, scales=jnp.asarray([1.0, 2.0, 0.5, 3.0])), z=jparam(jnp.asarray(z)))
    m = CorrelationMixing.init(4, scales=[1.0, 2.0, 0.5, 3.0], **F64)
    with torch.no_grad():
        m.z.raw.copy_(torch.as_tensor(z))
    assert do.relerr(do.numpy(m.value), np.asarray(jm.value)) <= 1e-12


@pytest.mark.parametrize("cfg", ["cc", "drd", "het", "dc"])
def test_port_matches_dynamics_golden(gold, cfg):
    _check(do.anchors(gold, "cpu", (cfg,))[cfg])


def _jax_dc(T):
    import make_dynamics_golden as ref

    return ref.jax_dc(T)


def test_score_ell_and_natgrad_moments_match_jax():
    """On the JAX model's q(f) and draws (T = 24, n_mc = 16): the score
    ∇_f log p by one autograd call over [n_mc, T] against
    `vmap(vmap(jax.grad))`, the Monte-Carlo ELL (first draw set) and the
    empirical-Fisher (g1, g2) (second draw set)."""
    import jax
    import jax.numpy as jnp

    jm, _ = _jax_dc(24)
    model, _ = do.dc_model(24, device="cpu")
    _, m, S = jax.jit(lambda mm: mm._surrogate_pass())(jm)
    shape = (16,) + jm.Y.shape
    e0 = jax.random.normal(jax.random.PRNGKey(0), shape, jnp.float64)
    e1 = jax.random.normal(jax.random.PRNGKey(1), shape, jnp.float64)
    draws = (torch.as_tensor(np.array(e0), **F64), torch.as_tensor(np.array(e1), **F64))
    tm, tS = torch.as_tensor(np.asarray(m), **F64), torch.as_tensor(np.asarray(S), **F64)
    lik, jlik = model.likelihood, jm.likelihood

    f = np.asarray(m)[None] + 0.7 * np.asarray(e0)
    y0 = jnp.nan_to_num(jlik.y)
    want = jax.jit(jax.vmap(jax.vmap(jax.grad(lambda yr, fr: jlik._logp(yr, jnp.tanh(fr)),
                                              argnums=1))))(
        jnp.broadcast_to(y0, (16,) + y0.shape), jnp.asarray(f))
    ft = torch.as_tensor(f, **F64).requires_grad_(True)
    (got,) = torch.autograd.grad(lik._logp(torch.nan_to_num(lik.y), torch.tanh(ft)).sum(), ft)
    assert do.relerr(do.numpy(got), np.asarray(want)) <= 1e-9

    ell, (g1, g2) = jax.jit(lambda ll, a, b: (ll.expected_log_lik_blocks(None, a, b),
                                              ll.natgrad_moments(None, a, b)))(jlik, m, S)
    assert do.relerr(do.numpy(lik.expected_log_lik_blocks(model.Y, tm, tS, draws=draws)),
                     np.asarray(ell)) <= 1e-9
    t1, t2 = lik.natgrad_moments(model.Y, tm, tS, draws=draws)
    assert do.relerr(do.numpy(t1), np.asarray(g1)) <= 1e-9
    assert do.relerr(do.numpy(t2), np.asarray(g2)) <= 1e-9


def test_dynamic_covariance_draws_are_two_sets():
    """A generator gives the pair (ELL draws, natural-gradient draws), one
    after the other; None gives the same pair on every call (the frozen
    seed); the CVIGP hands the likelihood's own draws on."""
    model, _ = do.dc_model(16, device="cpu")
    a, b = model.mc_draws(torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    shape = (model.likelihood.n_mc, 16, 1)
    assert torch.equal(a, torch.randn(shape, generator=g, **F64))
    assert torch.equal(b, torch.randn(shape, generator=g, **F64))
    f0, f1 = model.mc_draws(), model.mc_draws()
    assert torch.equal(f0[0], f1[0]) and torch.equal(f0[1], f1[1]) and not torch.equal(f0[0], f0[1])


def test_composite_draws_are_unchanged():
    """A `CompositeLikelihood` still draws through its residual: [n_mc, T, p]
    from the generator, or from its frozen seed, bit for bit."""
    from physs_gp_tpu_torch.zoo.physics import nonlinear_ode_cvi_gp

    t = np.linspace(0, 3, 12)
    model = nonlinear_ode_cvi_gp(t, np.sin(t), t, residual_fn=lambda f: f[..., 0] - f[..., 1],
                                 n_heads=2, n_mc=8, device="cpu")
    res = model.likelihood.residual
    got = model.mc_draws(torch.Generator().manual_seed(9))
    want = torch.randn((8,) + tuple(model.sites.Y.shape), generator=torch.Generator().manual_seed(9),
                       dtype=model.sites.Y.dtype)
    assert torch.equal(got, want)
    frozen = torch.randn((8,) + tuple(model.sites.Y.shape),
                         generator=torch.Generator().manual_seed(res.seed), dtype=model.sites.Y.dtype)
    assert torch.equal(model.mc_draws(), frozen)


def test_load_numpy_params_walks_the_volatility_leaves():
    """The JAX key paths of `dynamic_covariance_gp`'s leaves load into the
    port's model: the variances' raws and the data."""
    import jax

    jm, _ = _jax_dc(16)
    model, _ = do.dc_model(16, device="cpu")
    flat = {jax.tree_util.keystr(p): np.array(v) + (0.1 if jax.tree_util.keystr(p).endswith(".raw") else 0)
            for p, v in jax.tree_util.tree_flatten_with_path(jm)[0]
            if jax.tree_util.keystr(p).startswith(".likelihood")}
    assert set(flat) == {".likelihood.y", ".likelihood.variances[0].raw", ".likelihood.variances[1].raw"}
    from physs_gp_tpu_torch.interop import load_numpy_params

    load_numpy_params(model, flat)
    for i in range(2):
        assert float(model.likelihood.variances[i].raw) == float(flat[f".likelihood.variances[{i}].raw"])


def test_het_gaussian_matches_jax():
    """Block ELL (one value per row, 0 on NaN rows), diagonal ELL,
    log_prob and the conditional moments."""
    import jax.numpy as jnp

    from physs_gp_tpu.likelihoods.het_gaussian import HetGaussian as JHet

    y, m, S = do.het_inputs()
    lik, jlik = HetGaussian(), JHet()
    ty, tm, tS = (torch.as_tensor(a, **F64) for a in (y, m, S))
    pairs = [
        (lik.expected_log_lik_blocks(ty, tm, tS), jlik.expected_log_lik_blocks(y, m, S)),
        (lik.expected_log_lik(ty, tm, torch.diagonal(tS, dim1=-2, dim2=-1)),
         jlik.expected_log_lik(y, m, np.diagonal(S, axis1=-2, axis2=-1))),
        (lik.log_prob(torch.nan_to_num(ty), tm), jlik.log_prob(jnp.nan_to_num(y), m)),
        (lik.conditional_mean(tm), jlik.conditional_mean(m)),
        (lik.conditional_variance(tm), jlik.conditional_variance(m)),
    ]
    for got, want in pairs:
        assert do.relerr(do.numpy(got), np.asarray(want)) <= 1e-12
    assert do.numpy(pairs[0][0]).shape == (len(y),)


@pytest.mark.cuda
def test_cuda_dynamic_covariance_step_matches_golden(cuda, gold):
    """The card twin: 5 CVI steps on the JAX draws, the scans (d = 2) on the
    flat combines and the Monte-Carlo terms on the card."""
    _check(do.anchors(gold, "cuda", ("dc",))["dc"])

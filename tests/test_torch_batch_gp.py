"""PyTorch port: kernels/base, kernels/derivative, BatchGP in both solvers,
ops/cg and the batch recipes of zoo/phi_ml and zoo/diff against the JAX
package.

The same numpy inputs, made from a seed, go through the JAX function
(float64, CPU, jitted) and the port's; values, predictions and gradients
(against `jax.grad`) agree to rtol 1e-9 relative to each output's largest
magnitude, CG and SLQ fed the JAX probes to 1e-8. The CG cases use
well-conditioned Grams: near convergence on a clustered spectrum CG's
iterates amplify the two libraries' summation-order differences
(`scripts/port/batch_outcome.py`, `CG_NOISE`).
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.kernels import base as jbase  # noqa: E402
from physs_gp_tpu.kernels.derivative import DerivativeKernel as JDeriv  # noqa: E402
from physs_gp_tpu.kernels.matern import Matern52 as JM52, Matern72 as JM72  # noqa: E402
from physs_gp_tpu.kernels.rbf import RBF as JRBF  # noqa: E402
from physs_gp_tpu.ops import cg as jcg  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpp  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels import base  # noqa: E402
from physs_gp_tpu_torch.kernels.derivative import (DerivativeKernel, grad_ops,  # noqa: E402
                                                   second_order_ops)
from physs_gp_tpu_torch.kernels.matern import Matern52, Matern72  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.ops import cg  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo import diff  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import batch_outcome as bo  # noqa: E402
import make_batch_golden as mg  # noqa: E402

from experiments_torch import curl_free as cf  # noqa: E402

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")
TOL, TOL_CG = 1e-9, 1e-8


def rel(a, b):
    """max |a - b| / max |b| (max |a - b| when b is 0); NaNs in the same places."""
    a, b = (x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    return float(np.nanmax(np.abs(a - b)) / (np.nanmax(np.abs(b)) or 1.0))


def t_(x):
    return torch.from_numpy(np.array(x))


def _pair(ls, var, D=2):
    """(JAX RBF, port RBF) with the same values."""
    ls = np.full(D, ls) if np.ndim(ls) == 0 else np.asarray(ls)
    return (JRBF(lengthscales=jpp(jnp.asarray(ls)), variance=jpp(jnp.asarray(var))),
            RBF(positive_param(ls, **F64), positive_param(var, **F64)))


def _grams(jk, pk, X1, X2):
    jK, jd = jax.jit(lambda k, a, b: (k.K(a, b), k.K_diag(a)))(jk, jnp.asarray(X1), jnp.asarray(X2))
    return (pk.K(t_(X1), t_(X2)), pk.K_diag(t_(X1))), (jK, jd)


# ---------------------------------------------------------------------------
# kernels/base
# ---------------------------------------------------------------------------


def test_combinators_match_jax():
    """Sum, product, OnDims, WhiteNoise, Bias and Linear: K, K_diag and the
    scalar form through the generic vmap Gram."""
    rng = np.random.default_rng(0)
    X1, X2 = rng.normal(size=(7, 2)), rng.normal(size=(5, 2))
    X2[1] = X1[3]  # a coincident pair for WhiteNoise
    jr, pr = _pair([0.7, 1.3], 1.2)
    jm, pm = JM52(lengthscale=jnp.asarray(0.9), variance=jnp.asarray(0.8)), Matern52(0.9, 0.8, **F64)
    v = dict(variance=jpp(jnp.asarray(0.3)))
    jk = (jr + jbase.OnDims(base=jm, dims=(1,)) * jbase.Bias(**v) + jbase.WhiteNoise(**v)
          + jbase.LinearKernel(variance=jpp(jnp.asarray(0.2))))
    pv = dict(variance=positive_param(0.3, **F64))
    pk = (pr + base.OnDims(pm, (1,)) * base.Bias(**pv) + base.WhiteNoise(**pv)
          + base.LinearKernel(positive_param(0.2, **F64)))
    assert isinstance(pk, base.SumKernel) and len(pk.parts) == 4
    (pK, pd), (jK, jd) = _grams(jk, pk, X1, X2)
    assert rel(pK, jK) <= TOL and rel(pd, jd) <= TOL
    pS = base.pairwise(pk.k_scalar, t_(X1), t_(X2))
    assert rel(pS, jK) <= TOL


# the derivative towers: RBF by autodiff (a second-order op among them), a
# separable Matérn-7/2 x RBF product by the per-factor closed form and
# autodiff
KERNELS = {
    "rbf": (lambda: _pair([0.8, 1.4], 1.3), ((), (0,), (1, 1))),
    "matern_x_rbf": (
        lambda: (jbase.OnDims(base=JM72(lengthscale=jnp.asarray(1.1), variance=jnp.asarray(0.7)),
                              dims=(0,))
                 * jbase.OnDims(base=JRBF(lengthscales=jpp(jnp.asarray([0.6])),
                                          variance=jpp(jnp.asarray(1.0))), dims=(1,)),
                 base.OnDims(Matern72(1.1, 0.7, **F64), (0,))
                 * base.OnDims(RBF(positive_param([0.6], **F64), positive_param(1.0, **F64)),
                               (1,))),
        ((), (0,), (1,), (0, 1)),
    ),
}


@pytest.mark.parametrize("name", KERNELS)
def test_derivative_kernel_matches_jax(name):
    """K_blocks and the mixed K_diag against the JAX package, coincident
    points included; K is the data-major layout of W B Wᵀ."""
    make, ops = KERNELS[name]
    jb, pb = make()
    rng = np.random.default_rng(1)
    X1, X2 = rng.normal(size=(5, 2)), rng.normal(size=(4, 2))
    X2[0] = X1[2]
    W = rng.normal(size=(2, len(ops)))
    jk, pk = JDeriv(base=jb, ops=ops, W=jnp.asarray(W)), DerivativeKernel(pb, ops, W=t_(W))
    jB, jd = jax.jit(lambda k, a, b: (k.K_blocks(a, b), k.K_diag(a)))(
        jk, jnp.asarray(X1), jnp.asarray(X2))
    B = pk.K_blocks(t_(X1), t_(X2))
    assert rel(B, jB) <= TOL and rel(pk.K_diag(t_(X1)), jd) <= TOL
    assert pk.n_outputs == 2 and len(second_order_ops(2)) == 5 and grad_ops(2) == ((0,), (1,))
    # data-major: row i·P + p, column j·P + q hold block [p, q] at (i, j)
    mixed = torch.einsum("pa,abnm,qb->pqnm", t_(W), B, t_(W))
    assert torch.equal(pk.K(t_(X1), t_(X2)).reshape(5, 2, 4, 2).permute(1, 3, 0, 2), mixed)
    pk0 = DerivativeKernel(pb, ops)
    P = len(ops)
    K0 = pk0.K(t_(X1), t_(X1))
    assert torch.equal(K0.reshape(5, P, 5, P).permute(1, 3, 0, 2), pk0.K_blocks(t_(X1), t_(X1)))
    assert torch.allclose(torch.diagonal(K0), pk0.K_diag(t_(X1)), rtol=1e-12, atol=0)


def test_matern_closed_forms():
    """Matern.k_deriv_fn against the JAX closed forms at and off τ = 0 for
    every order pair up to p, and its errors (a dim other than 0, too
    high an order, inputs of more than one dim; a non-separable product)."""
    jm, pm = JM72(lengthscale=jnp.asarray(0.8), variance=jnp.asarray(1.3)), Matern72(0.8, 1.3, **F64)
    x = np.array([[0.3], [0.3], [1.1], [-0.4]])
    for m in range(4):
        for n in range(4):
            a, b = (0,) * m, (0,) * n
            if not (a or b):
                assert pm.k_deriv_fn(a, b) is None
                continue
            jf, pf = jm.k_deriv_fn(a, b), pm.k_deriv_fn(a, b)
            want = [float(jf(jnp.asarray(u), jnp.asarray(v))) for u, v in zip(x[:-1], x[1:])]
            got = [float(pf(t_(u), t_(v))) for u, v in zip(x[:-1], x[1:])]
            assert rel(np.array(got), np.array(want)) <= TOL, (m, n)
    with pytest.raises(ValueError, match="dims must be 0"):
        pm.k_deriv_fn((1,), ())
    with pytest.raises(ValueError, match="orders <= 3"):
        pm.k_deriv_fn((0,) * 4, ())
    with pytest.raises(ValueError, match="1-D"):
        pm.k_deriv_fn((0,), ())(t_([0.1, 0.2]), t_([0.3, 0.4]))
    prod = base.ProductKernel([Matern72(0.8, 1.3, **F64), RBF(positive_param(1.0, **F64),
                                                                positive_param(1.0, **F64))])
    with pytest.raises(ValueError, match="disjoint OnDims"):
        prod.k_deriv_fn((0,), ())


# ---------------------------------------------------------------------------
# BatchGP and the recipes
# ---------------------------------------------------------------------------


def test_curl_free_recipe_matches_jax():
    """The curl-free lml and its gradient by every raw (the lengthscales'
    through the nested `torch.func.grad` Gram) against `jax.grad`;
    predict_f (also full_cov), predict_y and nlpd, a NaN entry masked.
    Helmholtz, deriv_gp and the batch LMC are held to the JAX package
    through `batch_golden.npz` (tests/test_torch_batch_golden.py)."""
    X, Y, Xs, _ = cf.inputs(quick=True)
    X, Y, Xs = X[:12], Y[:12].copy(), Xs[:5]
    Y[2, 0] = np.nan
    jm = mg.shift_raws(mg.jax_cf(X, Y))
    pm = bo.curl_free_gp(X, Y, noise=bo.CF_NOISE**2, **F64)
    load_numpy_params(pm, mg.leaves(jm))
    lml, grads = mg.lml_and_raw_grads(jm)
    val = pm.log_marginal_likelihood()
    val.backward()
    assert rel(val, lml) <= TOL
    pg = {n: p.grad for n, p in pm.named_parameters()}
    assert set(grads) == {".kernel.base.lengthscales.raw", ".kernel.base.variance.raw",
                          ".likelihood.variance.raw"}
    for key, g in grads.items():
        assert rel(pg[bo._jax_name(key)], g) <= TOL, key
    Ys = np.cos(Xs) * 0.5
    Ys[0, 0] = np.nan
    out = jax.jit(lambda m, xs, ys: (m.predict_f(xs), m.predict_f(xs, full_cov=True),
                                     m.predict_y(xs), m.nlpd(xs, ys)))(
        jm, jnp.asarray(Xs), jnp.asarray(Ys))
    with torch.no_grad():
        got = (pm.predict_f(Xs), pm.predict_f(Xs, full_cov=True), pm.predict_y(Xs), pm.nlpd(Xs, Ys))
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(out)):
        assert rel(g, w) <= TOL


def test_sample_f_draws_from_the_generator():
    X, Y, Xs = bo.deriv_inputs(n=8)
    pm = bo.deriv_gp(X, Y, noise=0.05**2, **F64)
    draw = [pm.sample_f(torch.Generator().manual_seed(3), Xs[:3], 4) for _ in range(2)]
    assert draw[0].shape == (4, 3, 3) and torch.equal(draw[0], draw[1])
    eps = torch.randn(4, 9, generator=torch.Generator().manual_seed(3), **F64)
    assert torch.equal(draw[0], pm.sample_f_given(Xs[:3], eps))
    with pytest.raises(TypeError):
        pm.sample_f(None, Xs[:3], 4)


def test_state_space_recipes():
    """deriv_sde_gp (f, f', f'') by the Kalman filter gives the lml of
    deriv_gp over the same observations (Matérn's closed forms);
    deriv_st_gp (f, ∂t f, ∂s f at the sites, dense and at inducing sites)
    against the JAX package."""
    from physs_gp_tpu.zoo import diff as jdiff

    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0, 3, 10))
    Y = np.stack([np.sin(t), np.cos(t), -np.sin(t)], 1) + 0.05 * rng.normal(size=(10, 3))
    Y[3, 1] = np.nan
    sde = diff.deriv_sde_gp(t, Y, time_diff=2, noise=0.01, **F64)
    dense = diff.deriv_gp(t, Y, time_diff=2, space_diff=None, kernel=Matern72(1.0, 1.0, **F64),
                          noise=0.01, **F64)
    assert rel(sde.log_marginal_likelihood(), dense.log_marginal_likelihood()) <= TOL
    Z, Zs = rng.uniform(-1, 1, (3, 1)), np.array([[-0.5], [0.5]])
    Yst = rng.normal(size=(10, 3 * 3))
    Yst[2, 4] = np.nan
    want = jax.jit(lambda a, b: (a.log_marginal_likelihood(), b.log_marginal_likelihood()))(*[
        jdiff.deriv_st_gp(t, Yst, Z, time_diff=1, space_diff=1, Zs=zs, noise=0.1)
        for zs in (None, Zs)])
    for zs, w in zip((None, Zs), want):
        m = diff.deriv_st_gp(t, Yst, Z, time_diff=1, space_diff=1, Zs=zs, noise=0.1, **F64)
        assert rel(m.log_marginal_likelihood(), w) <= TOL
    assert diff.diff_orders(2) == (1, 2) and diff.diff_orders(-2) == (2,)
    assert diff.diff_orders(None) == ()
    with pytest.raises(ValueError):
        diff.diff_orders(-1)


# ---------------------------------------------------------------------------
# ops/cg
# ---------------------------------------------------------------------------


def _spd(n, noise=0.5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 2))
    return np.exp(-0.5 * ((X[:, None] - X[None]) ** 2).sum(-1) / 0.25) + noise * np.eye(n)


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_cg_solve_and_its_gradient_match_jax(rhs):
    """The solve and the implicit gradient by A and B (one more CG solve)."""
    A = _spd(30)
    B = np.random.default_rng(1).normal(size=(30,) if rhs == "vector" else (30, 3))
    W = np.random.default_rng(2).normal(size=B.shape)

    def jf(a, b):
        return jnp.sum(jnp.asarray(W) * jcg.cg_solve(a, b))

    jval, (jgA, jgB) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1)))(jnp.asarray(A), jnp.asarray(B))
    a, b = t_(A).requires_grad_(True), t_(B).requires_grad_(True)
    val = torch.sum(t_(W) * cg.cg_solve(a, b))
    val.backward()
    assert rel(val, jval) <= TOL_CG
    assert rel(a.grad, jgA) <= TOL_CG and rel(b.grad, jgB) <= TOL_CG


def test_slq_logdet_matches_jax():
    """The SLQ estimate and its custom backward on the JAX probes."""
    A = _spd(36, seed=3)
    key = jax.random.PRNGKey(4)
    z = np.asarray(jax.random.rademacher(key, (8, 36), dtype=jnp.float64))
    jval, jg = jax.jit(jax.value_and_grad(
        lambda a: jcg.slq_logdet(a, key, n_probes=8, lanczos_iters=20)))(jnp.asarray(A))
    a = t_(A).requires_grad_(True)
    val = cg.slq_logdet_given(a, t_(z), lanczos_iters=20)
    val.backward()
    assert rel(val, jval) <= TOL_CG and rel(a.grad, jg) <= TOL_CG
    draws = cg.rademacher(torch.Generator().manual_seed(0), (8, 36), t_(A))
    assert set(draws.unique().tolist()) == {-1.0, 1.0}
    assert torch.isfinite(cg.slq_logdet(t_(A), torch.Generator().manual_seed(0)))


def test_cg_batch_gp_matches_jax():
    """BatchGP(solver="cg") on the JAX probes: lml, its gradient by every
    raw, predict_f by one multi-column solve, near the Cholesky solver."""
    X, Y = bo.bench_inputs(24)
    Y[4] = np.nan
    jm = mg.shift_raws(mg.jax_cg(X, Y))
    lml, grads = mg.lml_and_raw_grads(jm)
    pm = bo.cg_model(X, Y, **F64)
    load_numpy_params(pm, mg.leaves(jm))
    val = pm.log_marginal_likelihood(probes=t_(mg.jax_probes(24)))
    val.backward()
    assert rel(val, lml) <= TOL_CG
    pg = {n: p.grad for n, p in pm.named_parameters()}
    for key, g in grads.items():
        assert rel(pg[bo._jax_name(key)], g) <= TOL_CG, key
    jp = jax.jit(lambda m, xs: m.predict_f(xs))(jm, jnp.asarray(X[:5] + 0.1))
    with torch.no_grad():
        pp = pm.predict_f(X[:5] + 0.1)
        assert rel(pp.mean, jp.mean) <= TOL_CG and rel(pp.var, jp.var) <= TOL_CG
        # the fixed-seed probes: deterministic, and near the exact lml
        ch = bo.cg_model(X, Y, solver="cholesky", **F64)
        load_numpy_params(ch, mg.leaves(jm))
        assert pm.log_marginal_likelihood() == pm.log_marginal_likelihood()
        assert abs(float(pm.log_marginal_likelihood() / ch.log_marginal_likelihood()) - 1) < 0.05


def test_cg_early_exit_leaves_the_same_bits(monkeypatch):
    """Stopping once every column is frozen gives the bits of the full trip
    count; the steps run are recorded."""
    A, B = t_(_spd(80, noise=1.0)), t_(np.random.default_rng(6).normal(size=(80, 4)))
    cg.reset_steps()
    early = cg.cg_solve(A, B)
    (n, k, maxiter, steps), = cg.steps_run()
    assert (n, k, maxiter) == (80, 4, 80) and steps < maxiter and steps % cg._EXIT_EVERY == 0
    monkeypatch.setattr(cg, "_EXIT_EVERY", 10**9)
    cg.reset_steps()
    full = cg.cg_solve(A, B)
    assert cg.steps_run()[0][-1] == 80
    assert torch.equal(early, full)


def test_solver_dispatch_matches_jax():
    A, B = _spd(20), np.random.default_rng(7).normal(size=(20, 2))
    for method in ("cholesky", "cg", "exact"):
        assert rel(cg.solve(t_(A), t_(B), method=method),
                   jcg.solve(jnp.asarray(A), jnp.asarray(B), method=method)) <= TOL_CG
    for method in ("cholesky", "exact"):
        assert rel(cg.log_determinant(t_(A), method=method),
                   jcg.log_determinant(jnp.asarray(A), method=method)) <= TOL
    with pytest.raises(ValueError):
        cg.log_determinant(t_(A), method="slq")
    with pytest.raises(ValueError):
        cg.solve(t_(A), t_(B), method="lu")

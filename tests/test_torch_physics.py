"""PyTorch port: the temporal physics heads, the time grids, the physics zoo
recipes `ode_gp`, `monotonic_cvi_gp` and `nonlinear_ode_cvi_gp`, the
Monte-Carlo generators of the trainers and `load_numpy_params` on the
physics leaves, against the JAX package.

The same numpy inputs go through both packages in float64 on the CPU, in
the form the experiments run (sequential covariance): `ode_gp`'s lml and
`predict_f`, and 2 CVI steps of each CVI recipe (the pendulum's with the
standard normals JAX drew from each step's key, handed to the port through
`draws=`). ELBO and lml agree to rtol 1e-9, sites and moments to 1e-7. The
JAX reference runs happen once, in a module fixture.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.data.grids import merge_time_grids as jmerge  # noqa: E402
from physs_gp_tpu.data.grids import sort_time_series as jsort  # noqa: E402
from physs_gp_tpu.kernels import Matern52 as JMatern52  # noqa: E402
from physs_gp_tpu.kernels import Matern72 as JMatern72  # noqa: E402
from physs_gp_tpu.kernels.rbf import RBF as JRBF  # noqa: E402
from physs_gp_tpu.kernels.spatio_temporal import SpatioTemporalKernel as JSTKernel  # noqa: E402
from physs_gp_tpu.transforms import operators as jops  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpositive  # noqa: E402
from physs_gp_tpu.zoo import monotonic_cvi_gp as jmonotonic  # noqa: E402
from physs_gp_tpu.zoo import nonlinear_ode_cvi_gp as jnonlinear  # noqa: E402
from physs_gp_tpu.zoo import ode_gp as jode_gp  # noqa: E402
from physs_gp_tpu_torch import trainers  # noqa: E402
from physs_gp_tpu_torch.data.grids import merge_time_grids, sort_time_series  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern52, Matern72  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.kernels.spatio_temporal import SpatioTemporalKernel  # noqa: E402
from physs_gp_tpu_torch.transforms import operators as tops  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.physics import monotonic_cvi_gp, nonlinear_ode_cvi_gp, ode_gp  # noqa: E402

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
STEPS = 2


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
    b = np.asarray(b)
    ok = np.isfinite(b)
    assert a.shape == b.shape and np.array_equal(np.isfinite(a), ok)
    return float(np.max(np.abs(a[ok] - b[ok])) / np.max(np.abs(b[ok])))


def t_(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _series(seed, n_data, n_coll, hi):
    rng = np.random.default_rng(seed)
    t_data = np.sort(rng.uniform(0, hi / 2, n_data))
    y_data = np.cos(3.0 * t_data) + 0.03 * rng.normal(size=n_data)
    return t_data, y_data, np.linspace(0, hi, n_coll)


def _pendulum(np_like):
    return lambda f: f[..., 2] + 0.3 * f[..., 1] + 9.0 * np_like.sin(f[..., 0])


def _recipes(pkg):
    """The three recipes of one package at a small width."""
    jax_side = pkg == "jax"
    M72 = (lambda ls: JMatern72(lengthscale=ls, variance=1.0)) if jax_side else \
        (lambda ls: Matern72(ls, 1.0, **F64))
    kw = {} if jax_side else {"device": "cpu"}
    td, yd, tc = _series(1, 8, 10, 8.0)
    ode = (jode_gp if jax_side else ode_gp)(
        td, yd, tc, [4.0, (jpositive if jax_side else lambda v: positive_param(v, **F64))(0.4), 1.0],
        kernel=M72(1.5), noise=0.05**2, coll_noise=1e-6, **kw)
    td, yd, tc = _series(2, 8, 12, 4.0)
    mono = (jmonotonic if jax_side else monotonic_cvi_gp)(td, np.linspace(0, 2, 8) + yd, tc,
                                                          kernel=M72(1.0), noise=0.15**2, **kw)
    td, yd, tc = _series(3, 8, 10, 5.0)
    pend = (jnonlinear if jax_side else nonlinear_ode_cvi_gp)(
        td, yd, tc, _pendulum(jnp if jax_side else torch), n_heads=3, kernel=M72(1.0),
        noise=0.03**2, coll_noise=1e-4, n_mc=4, **kw)
    return ode, mono, pend


T_NEW = np.linspace(4.5, 7.5, 6)


@pytest.fixture(scope="module")
def reference():
    ode, mono, pend = _recipes("jax")
    out = {"ode_lml": float(jax.jit(lambda mm: mm.log_marginal_likelihood())(ode))}
    f = jax.jit(lambda mm, tt: mm.predict_f(tt))(ode, jnp.asarray(T_NEW))
    out["ode_f"] = (np.asarray(f.mean), np.asarray(f.var))
    step = jax.jit(lambda mm: mm.step_with_elbo(0.5))
    elbos = []
    for _ in range(STEPS):
        mono, e = step(mono)
        elbos.append(float(e))
    out["mono"] = (elbos, mono)
    keys = list(jax.random.split(jax.random.PRNGKey(4), STEPS))
    draws = [np.asarray(jax.random.normal(k, (4,) + pend.Y.shape, jnp.float64)) for k in keys]
    gstep = jax.jit(lambda mm, k: mm.step_with_elbo(0.3, hessian="gauss_newton", key=k))
    elbos = []
    for k in keys:
        pend, e = gstep(pend, k)
        elbos.append(float(e))
    out["pend"] = (elbos, pend, draws)
    return out


def _hold_cvi(model, ref):
    assert rel(model.sites.Y, ref.sites.Y) <= 1e-7
    assert rel(model.sites.V, ref.sites.V) <= 1e-7
    p, q = model.posterior(), ref.posterior()
    assert rel(p.mean, q.mean) <= 1e-7 and rel(p.var, q.var) <= 1e-7


# ---------------------------------------------------------------------------
# heads and grids
# ---------------------------------------------------------------------------


def test_temporal_heads_match_jax():
    for jk, tk in ((JMatern72(lengthscale=0.7, variance=1.3), Matern72(0.7, 1.3, **F64)),
                   (JMatern52(lengthscale=1.1, variance=0.5), Matern52(1.1, 0.5, **F64))):
        jobs = jops.StateObservation(heads=[
            jops.ValueHead(), jops.DerivativeHead(order=1), jops.DerivativeHead(order=2),
            jops.LinearOperatorHead(coeffs=[2.0, jpositive(0.3), 1.0])])
        tobs = tops.StateObservation(heads=[
            tops.ValueHead(), tops.DerivativeHead(order=1), tops.DerivativeHead(order=2),
            tops.LinearOperatorHead(coeffs=[2.0, positive_param(0.3, **F64), 1.0])])
        assert rel(tobs.H(tk), jobs.H(jk)) <= 1e-14
        assert tobs.var_correction(tk) is None and jobs.var_correction(jk) is None
    with pytest.raises(ValueError):
        tops.DerivativeHead(order=3).row(Matern52(1.0, 1.0, **F64))
    # a trainable coefficient is a parameter of the head
    head = tops.LinearOperatorHead(coeffs=[1.0, positive_param(0.3, **F64)])
    assert len(list(head.parameters())) == 1 and head.coeffs[0] == 1.0


@pytest.mark.parametrize("op", ["identity", "grad2"])
def test_spatial_operators_match_jax(op):
    rng = np.random.default_rng(5)
    Z = rng.uniform(0, 1, (5, 2))
    s = rng.uniform(0, 1, (4, 2))
    jk = JSTKernel(k_time=JMatern52(lengthscale=1.0, variance=1.0),
                   k_space=JRBF(lengthscales=jpositive(jnp.asarray([0.4, 0.6])), variance=jpositive(1.2)),
                   Z=jnp.asarray(Z))
    tk = SpatioTemporalKernel(k_time=Matern52(1.0, 1.0, **F64),
                              k_space=RBF(positive_param(t_([0.4, 0.6])), positive_param(1.2, **F64)),
                              Z=t_(Z))
    jop = jops.s_identity if op == "identity" else jops.s_grad2(1)
    top = tops.s_identity if op == "identity" else tops.s_grad2(1)
    assert rel(tk.spatial_weights(t_(s), top), jk.spatial_weights(jnp.asarray(s), jop)) <= 1e-10
    # the autodiff form of each operator agrees with the closed form it is tagged for
    k = tk.k_space.k_scalar
    auto = torch.stack([torch.stack([top(k, a, b) for b in t_(Z)]) for a in t_(s)])
    assert rel(auto, tk._op_cross(t_(s), top)) <= 1e-12
    for t_order in (0, 1):
        want = jk.conditional_var_correction(jnp.asarray(s), jop, t_order)
        assert rel(tk.conditional_var_correction(t_(s), top, t_order), want) <= 1e-8


def test_time_grids_match_jax():
    rng = np.random.default_rng(6)
    a = (np.sort(rng.uniform(0, 5, 7)), rng.normal(size=7))
    b = (np.linspace(0, 5, 6), np.zeros(6))
    c = (a[0][[1, 4]], np.ones(2))
    for got, want in zip(merge_time_grids(a, b, c), jmerge(a, b, c)):
        np.testing.assert_array_equal(got, want)
    t = rng.uniform(0, 1, 9)
    Y = rng.normal(size=(9, 2))
    for got, want in zip(sort_time_series(t, Y), jsort(t, Y)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the recipes
# ---------------------------------------------------------------------------


def test_ode_gp_matches_jax(reference):
    ode, _, _ = _recipes("torch")
    np.testing.assert_allclose(float(ode.log_marginal_likelihood().detach()), reference["ode_lml"],
                               rtol=1e-9)
    f = ode.predict_f(t_(T_NEW))
    assert rel(f.mean, reference["ode_f"][0]) <= 1e-7 and rel(f.var, reference["ode_f"][1]) <= 1e-7


def test_monotonic_cvi_gp_matches_jax(reference):
    _, mono, _ = _recipes("torch")
    elbos, ref = reference["mono"]
    got = [float(mono.step_with_elbo(0.5)[1]) for _ in range(STEPS)]
    np.testing.assert_allclose(got, elbos, rtol=1e-9)
    _hold_cvi(mono, ref)
    t_new = jnp.asarray(np.linspace(0.1, 3.9, 5))
    y_new = np.stack([np.linspace(0, 2, 5), np.ones(5)], 1)
    yp, yr = mono.predict_y(t_(t_new)), jax.jit(lambda mm, tt: mm.predict_y(tt))(ref, t_new)
    assert rel(yp.mean, yr.mean) <= 1e-7 and rel(yp.var, yr.var) <= 1e-7
    want = jax.jit(lambda mm, tt, yy: mm.nlpd(tt, yy))(ref, t_new, jnp.asarray(y_new))
    np.testing.assert_allclose(float(mono.nlpd(t_(t_new), t_(y_new))), float(want), rtol=1e-9)


def test_nonlinear_ode_cvi_gp_matches_jax(reference):
    _, _, pend = _recipes("torch")
    elbos, ref, draws = reference["pend"]
    got = [float(pend.step_with_elbo(0.3, hessian="gauss_newton", draws=t_(d))[1]) for d in draws]
    np.testing.assert_allclose(got, elbos, rtol=1e-9)
    _hold_cvi(pend, ref)
    assert torch.equal(pend.likelihood.residual_mask.bool(),
                       torch.from_numpy(np.asarray(ref.likelihood.residual_mask) > 0))


def test_recipes_default_to_the_card():
    import inspect

    for fn in (ode_gp, monotonic_cvi_gp, nonlinear_ode_cvi_gp):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# generators through the model, the scans and the trainers
# ---------------------------------------------------------------------------


def _pend():
    return _recipes("torch")[2]


def test_step_with_elbo_generator_semantics():
    """Different generators -> different ELBO and sites; the same seed ->
    the same; none -> the frozen draws, equal to the seed's own generator."""
    def step(gen):
        return _pend().step_with_elbo(0.3, hessian="gauss_newton", generator=gen)

    g = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    (m1, e1), (m2, e2), (m3, e3) = step(g(0)), step(g(99)), step(g(0))
    assert float(e1) != float(e2) and float(e1) == float(e3)
    assert not torch.allclose(torch.nan_to_num(m1.sites.Y), torch.nan_to_num(m2.sites.Y))
    (_, f1), (_, f2) = step(None), step(None)
    assert float(f1) == float(f2) == float(e1)  # the residual's seed is 0
    with pytest.raises(TypeError):
        step(0)


def test_natgrad_scan_and_trainers_take_generators():
    lrs = [0.25, 0.5, 0.25]  # exact in float32, the scans' learning-rate type
    gen = torch.Generator().manual_seed(5)
    _, elbos = trainers.natgrad_scan(_pend(), lrs, hessian="gauss_newton", generator=gen)
    m, gen2, manual = _pend(), torch.Generator().manual_seed(5), []
    for lr in lrs:
        m, e = m.step_with_elbo(lr, hessian="gauss_newton", generator=gen2)
        manual.append(float(e))
    assert elbos.tolist() == manual
    _, frozen = trainers.natgrad_scan(_pend(), lrs, hessian="gauss_newton")
    assert frozen.tolist() != manual
    # NatGradTrainer(seed=) draws each step from a generator seeded once
    a = trainers.NatGradTrainer(hessian="gauss_newton", seed=5).train(_pend(), lrs)
    b, gen3 = _pend(), torch.Generator().manual_seed(5)
    for lr in lrs:
        b.natural_gradient_update(lr, "gauss_newton", generator=gen3)
    assert torch.equal(a.sites.V, b.sites.V)
    c = trainers.NatGradTrainer(hessian="gauss_newton", seed=6).train(_pend(), lrs)
    assert not torch.equal(a.sites.V, c.sites.V)
    # AdamTrainer and VB_NG_Adam take a seed; the objective resamples per epoch
    m = _pend()
    m, losses = trainers.AdamTrainer(m, 0.01, seed=1).train(m, 2)
    assert np.isfinite(losses).all()
    m = _pend()
    m, losses = trainers.VB_NG_Adam(m, 0.01, 0.3, hessian="gauss_newton", seed=1).train(m, 2)
    assert np.isfinite(losses).all()
    m, elbos = trainers.vb_ng_adam_scan(_pend(), 2, 0.01, 0.3, hessian="gauss_newton",
                                        generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(elbos).all()


# ---------------------------------------------------------------------------
# interop
# ---------------------------------------------------------------------------


def test_load_numpy_params_carries_the_physics_leaves():
    """Every leaf of the JAX recipes, moved off its value, lands in the port:
    per-head variances, the residual's noise, its mask, a trainable ODE
    coefficient and a number coefficient, and static numbers."""
    jmodels = _recipes("jax")
    for jm, tm in zip(jmodels, _recipes("torch")):
        flat = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jm)[0]:
            key = jax.tree_util.keystr(path)
            if key.endswith(".raw") or key.endswith("coeffs[0]") or "residual_mask" in key:
                flat[key] = np.asarray(leaf) + 0.25
        assert any("noise_var" in k for k in flat) or "residual" not in str(type(jm.likelihood))
        load_numpy_params(tm, flat)
        for key, value in flat.items():
            node = tm
            for step in key.replace("]", "").replace("[", ".").split(".")[1:]:
                node = node[int(step)] if step.isdigit() else getattr(node, step)
            np.testing.assert_allclose(np.asarray(node.detach() if hasattr(node, "detach") else node),
                                       value, rtol=1e-15)
    ode, mono, pend = _recipes("torch")
    load_numpy_params(mono, {".likelihood.heads[1].nu": np.asarray(0.5)})
    load_numpy_params(pend, {".likelihood.residual.n_mc": np.asarray(7)})
    assert mono.likelihood.heads[1].nu == 0.5 and pend.likelihood.residual.n_mc == 7
    assert isinstance(pend.likelihood.residual.n_mc, int)
    with pytest.raises(KeyError):
        load_numpy_params(ode, {".observation.heads[1].coeffs[1]": np.asarray(1.0)})

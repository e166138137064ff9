"""PyTorch port: the spatio-temporal model and its recipes against the JAX
package.

`utils/shapes.as_points`, `utils/params.param` / `NegParam`,
`likelihoods/gaussian.SharedVariance` (tied under training),
`models/stgp.SpatioTemporalGP` (passthroughs, `predict_grid` at the
training times and at new times) and the `zoo/spatio_temporal` recipes
`st_gp` and `advection_diffusion_gp`. The same numpy inputs go through the
JAX function and the port in float64 on the CPU; lml, gradients, posterior
and `predict_grid` moments agree to 1e-9 relative to each output's largest
magnitude. `tests/data/serving_T256_golden.npz` holds the JAX
`advection_diffusion_gp` at config-5's geometry (T = 256), which
`chip_smoke.py` holds the port to on the card; its lml equals config-5's
`StateSpaceGP` (the same prior, heads and noise).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.kernels import Matern32 as JMatern32  # noqa: E402
from physs_gp_tpu.kernels.rbf import RBF as JRBF  # noqa: E402
from physs_gp_tpu.likelihoods.gaussian import IndependentGaussian as JIndep  # noqa: E402
from physs_gp_tpu.likelihoods.gaussian import SharedVariance as JShared  # noqa: E402
from physs_gp_tpu.utils import params as jparams  # noqa: E402
from physs_gp_tpu.utils.shapes import as_points as jas_points  # noqa: E402
from physs_gp_tpu.zoo import advection_diffusion_gp as jadvection  # noqa: E402
from physs_gp_tpu.zoo import st_gp as jst_gp  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import IndependentGaussian, SharedVariance  # noqa: E402
from physs_gp_tpu_torch.models import SpatioTemporalGP, StateSpaceGP  # noqa: E402
from physs_gp_tpu_torch.utils.params import NegParam, param, positive_param  # noqa: E402
from physs_gp_tpu_torch.utils.shapes import as_points  # noqa: E402
from physs_gp_tpu_torch.utils.training import trainable_parameters  # noqa: E402
from physs_gp_tpu_torch.zoo.bench_configs import build_config5  # noqa: E402
from physs_gp_tpu_torch.zoo.spatio_temporal import advection_diffusion_gp, st_gp  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "serving_T256_golden.npz")
F64 = dict(dtype=torch.float64)
TOL = 1e-9


def rel(a, b):
    """max |a - b| / max |b| over the entries of b."""
    a, b = (x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def t_(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("PHYSS_INNER_SCAN", "blocked")
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")


# ---------------------------------------------------------------------------
# shapes, params, likelihood groups
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x", [0.5, [0.1, 0.2, 0.3], [[0.1, 0.2], [0.3, 0.4]]],
                         ids=["scalar", "column", "rows"])
def test_as_points_matches_jax(x):
    want = np.asarray(jas_points(np.asarray(x)))
    got = as_points(np.asarray(x))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="expected 3"):
        as_points(np.asarray(x), D=3)
    with pytest.raises(ValueError, match="expected 3"):
        jas_points(np.asarray(x), D=3)


def test_neg_param_is_the_negated_view_of_its_base():
    """The value is -base.value, and the gradient reaches the base's raw as
    `jax.grad` finds it; `param` wraps a value unconstrained."""
    jneg = jparams.NegParam(base=jparams.positive_param(0.3))
    neg = NegParam(positive_param(0.3, **F64))
    assert rel(neg.value, jneg.value) <= 1e-15
    neg.value.backward()
    jgrad = jax.grad(lambda r: jparams.NegParam(base=jparams.Param(
        raw=r, bijector=jparams.positive)).value)(jneg.base.raw)
    assert rel(neg.base.raw.grad, jgrad) <= 1e-15
    p = param([1.0, -2.0], **F64)
    assert torch.equal(p.value, t_([1.0, -2.0])) and p.raw.requires_grad


def test_shared_variance_stays_tied():
    """A tied group is one trainable parameter broadcast to its heads: R and
    the gradient of its sum match the JAX likelihood, and an optimiser step
    moves the heads together."""
    jlik = JIndep(variances=[JShared(p=jparams.positive_param(0.1), n=4),
                             jparams.positive_param(1e-3).fix()])
    lik = IndependentGaussian([SharedVariance(positive_param(0.1, **F64), n=4),
                               positive_param(1e-3, **F64).fix()])
    assert rel(lik.R(5, 5), jlik.R(5, 5)) <= 1e-15
    assert len(trainable_parameters(lik)) == 1
    torch.sum(lik.R(5, 5)).backward()
    jg = jax.grad(lambda l: jnp.sum(l.R(5, 5)))(jlik)
    assert rel(lik.variances[0].p.raw.grad, jg.variances[0].p.raw) <= 1e-15
    torch.optim.SGD(trainable_parameters(lik), lr=0.5).step()
    v = lik._v.detach()
    assert torch.all(v[:4] == v[0]) and v[0] != 0.1 and v[4] == lik.variances[1].value
    assert SharedVariance(positive_param(0.2, **F64), n=3).fix().p.fixed


# ---------------------------------------------------------------------------
# recipes and SpatioTemporalGP
# ---------------------------------------------------------------------------


def _st_inputs(seed=0, T=14, Ns=5, ds=2):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 3, T))
    Z = rng.uniform(-1, 1, (Ns, ds))
    Y = rng.normal(size=(T, Ns))
    Y[rng.uniform(size=Y.shape) < 0.2] = np.nan
    return t, Z, Y


def _kernels(ls):
    return (dict(k_time=JMatern32(lengthscale=0.8, variance=1.3),
                 k_space=JRBF(lengthscales=jparams.positive_param(jnp.asarray(ls)))),
            dict(k_time=Matern32(lengthscale=0.8, variance=1.3, **F64),
                 k_space=RBF(lengthscales=positive_param(ls, **F64),
                             variance=positive_param(1.0, **F64))))


@pytest.mark.parametrize("parallel", [False, True])
def test_st_gp_matches_jax(env, parallel):
    """lml and posterior of the Kronecker ST GP (20 % missing); the port in
    both scans, the JAX side sequential."""
    t, Z, Y = _st_inputs()
    jk, pk = _kernels([0.7, 0.9])
    jm = jst_gp(t, Y, Z, noise=0.07, **jk)
    pm = st_gp(t, Y, Z, noise=0.07, parallel=parallel, chunk_size=4 if parallel else None,
               device="cpu", **pk)
    assert isinstance(pm, SpatioTemporalGP)
    lml, post = jax.jit(lambda m: (m.log_marginal_likelihood(), m.posterior()))(jm)
    with torch.no_grad():
        assert rel(pm.log_marginal_likelihood(), lml) <= TOL
        assert rel(pm.get_objective(), -lml) <= TOL
        p = pm.posterior()
    assert rel(p.mean, post.mean) <= TOL and rel(p.var, post.var) <= TOL
    assert pm.kernel is pm.core.kernel


@pytest.mark.parametrize("at", ["train", "new"])
def test_predict_grid_matches_jax(env, at):
    """Off-grid spatial prediction at the training times and at new times
    (the grid augmented with NaN rows, sorted stably)."""
    t, Z, Y = _st_inputs(seed=1, T=10, Ns=4)
    jk, pk = _kernels([0.8, 0.8])
    jm = jst_gp(t, Y, Z, noise=0.05, **jk)
    pm = st_gp(t, Y, Z, noise=0.05, parallel=True, chunk_size=4, device="cpu", **pk)
    s_new = np.random.default_rng(1).uniform(-0.8, 0.8, (3, 2))
    t_new = np.linspace(0.1, 3.4, 5) if at == "new" else None
    want = jax.jit(lambda m: m.predict_grid(jnp.asarray(s_new), t_new=t_new if t_new is None
                                            else jnp.asarray(t_new)))(jm)
    with torch.no_grad():
        got = pm.predict_grid(t_(s_new), t_new=None if t_new is None else t_(t_new))
    assert got.mean.shape == (10 if at == "train" else 5, 3)
    assert rel(got.mean, want.mean) <= TOL and rel(got.var, want.var) <= TOL


def test_advection_diffusion_gp_matches_jax(env):
    """1-D advection-diffusion with a trainable diffusivity (a NegParam) and
    a velocity: the objective and its gradient with respect to every raw,
    then again after carrying perturbed JAX raws (the tied group's `.p.raw`,
    the diffusivity's `.base.raw`) into the port."""
    rng = np.random.default_rng(4)
    t = np.linspace(0, 1, 12)
    Z = np.linspace(0, 2, 6)[:, None]
    Y = rng.normal(size=(12, 6))
    coll = np.array([[0.7], [1.3]])
    jm = jadvection(t, Y, Z, coll, diffusivity=jparams.positive_param(0.3), velocity=[0.5], noise=0.1)
    pm = advection_diffusion_gp(t, Y, Z, coll, diffusivity=positive_param(0.3, **F64),
                                velocity=[0.5], noise=0.1, device="cpu")
    value_and_grad = jax.jit(jax.value_and_grad(lambda m: m.get_objective()))
    for step in range(2):
        val, grads = value_and_grad(jm)
        pm.zero_grad()
        obj = pm.get_objective()
        obj.backward()
        assert rel(obj, val) <= TOL
        jg = {jax.tree_util.keystr(k): np.asarray(v)
              for k, v in jax.tree_util.tree_flatten_with_path(grads)[0] if jax.tree_util.keystr(k).endswith(".raw")}
        named = dict(pm.named_parameters())
        for key in (".core.likelihood.variances[0].p.raw",
                    ".core.observation.heads[1].terms[1].coeff.base.raw",
                    ".core.kernel.k_time.lengthscales.raw"):
            name = key[1:].replace("[", ".").replace("]", "")
            assert rel(named[name].grad, jg[key]) <= TOL, key
        # perturb the JAX raws and carry them over
        leaves = {jax.tree_util.keystr(k): np.asarray(v) + 0.1 * (step + 1)
                  for k, v in jax.tree_util.tree_flatten_with_path(jm)[0]
                  if jax.tree_util.keystr(k).endswith(".raw")}
        jm = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jm),
            [jnp.asarray(leaves[jax.tree_util.keystr(k)]) if jax.tree_util.keystr(k) in leaves else v
             for k, v in jax.tree_util.tree_flatten_with_path(jm)[0]])
        load_numpy_params(pm, leaves)


def test_config5_geometry_matches_golden_and_config5(env):
    """`advection_diffusion_gp` at config-5's geometry (T = 256, parallel,
    chunk 64): lml and `predict_grid` at 8 sites, at the training times and
    at 20 new times, against the golden file; its lml is config-5's
    `StateSpaceGP` lml (the same prior, heads and noise)."""
    gold = np.load(GOLDEN)
    c5 = build_config5(256, 64, dtype=torch.float64, device="cpu")
    gx = np.linspace(0, 1, 4)
    Z = np.stack(np.meshgrid(gx, gx), -1).reshape(-1, 2).astype(np.float32)
    coll = Z + 0.5 * (gx[1] - gx[0])
    m = advection_diffusion_gp(
        c5.t, c5.Y[:, :16], Z, coll, diffusivity=0.1, velocity=(0.2, 0.1),
        k_time=Matern32(lengthscale=5.0, variance=1.0, **F64),
        k_space=RBF(lengthscales=positive_param(0.5, **F64), variance=positive_param(1.0, **F64)),
        noise=0.1, coll_noise=1e-3, parallel=True, chunk_size=64, device="cpu",
    )
    gp = StateSpaceGP(t=c5.t, Y=c5.Y, kernel=c5.kernel, likelihood=c5.likelihood,
                      observation=c5.observation, parallel=True, chunk_size=64)
    with torch.no_grad():
        lml = m.log_marginal_likelihood()
        assert rel(lml, gold["grid_lml"]) <= TOL
        assert rel(lml, gp.log_marginal_likelihood()) <= TOL
        g = m.predict_grid(t_(gold["s_new"]))
        gn = m.predict_grid(t_(gold["s_new"]), t_new=t_(gold["t_grid_new"]))
    assert rel(g.mean, gold["grid_mean"]) <= TOL and rel(g.var, gold["grid_var"]) <= TOL
    assert rel(gn.mean, gold["grid_new_mean"]) <= TOL and rel(gn.var, gold["grid_new_var"]) <= TOL

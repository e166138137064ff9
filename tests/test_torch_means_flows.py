"""PyTorch port: the prior mean in the state-space models, the flows and
`TransformedData`, uncertain inputs, the matrix / Gaussian / bijector
helpers and `load_numpy_params` on every new leaf, against the JAX package.

The same numpy inputs go through both packages in float64 (CPU):
`StateSpaceGP` with a `ConstantMean` and a `LinearMean` in covariance and
square-root form (lml, posterior, `predict_f`, and equal to the zero-mean
model on Y - μ), 3 Poisson `CVIGP` steps with a `LinearMean` in both forms
(ELBOs, `predict_f`), `StreamingGP` with a mean in both forms (segment
moments, carried state, forecast) and `StreamingCVI` with a mean (the
zero-mean online fit of Y - μ, its forecast shifted by μ); every flow's
forward, inverse and log-Jacobian, `TransformedData`'s correction as a
change of variables and its log-normal moments; `UncertainInputLikelihood`'s
moment transform; `to_block_diag_batched`, `get_block_diagonal`, `kron_mv`,
`project_psd`, `gaussian_expected_logpdf_diag`, `symmetrize_cov`, `Sigmoid`.
Values, lml, ELBO and means rtol 1e-9, variances 1e-7. The live models
run the sequential filters (the JAX package compiles its parallel scans
for ~10 s each); `tests/test_torch_markov_golden.py` holds the parallel
forms.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.utils.params import param as jparam  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpp_  # noqa: E402
from physs_gp_tpu_torch.data import transformed as tr  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels import Matern32  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson  # noqa: E402
from physs_gp_tpu_torch.means.mean import ConstantMean, LinearMean  # noqa: E402
from physs_gp_tpu_torch.models import CVIGP, StateSpaceGP, StreamingCVI, StreamingGP  # noqa: E402
from physs_gp_tpu_torch.utils.params import param, positive_param  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import markov_outcome as mo  # noqa: E402

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")
TOL, TOL_VAR = 1e-9, 1e-7
T_LIVE = 40


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    return float(np.nanmax(np.abs(a - b)) / (np.nanmax(np.abs(b)) or 1.0))


def t_(x):
    return torch.from_numpy(np.array(x, np.float64))


def jpp(v, **kw):
    return jpp_(jnp.asarray(v, jnp.float64), **kw)


def _data(T=T_LIVE, seed=0):
    """`tests/test_means.py::_data`, with one missing row."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 5, T))
    y = np.sin(t) + 2.0 + 0.5 * t + 0.1 * rng.normal(size=T)
    y[3] = np.nan
    return t, y[:, None]


def _means(kind):
    """(JAX mean, port mean, μ(t) in numpy)."""
    from physs_gp_tpu.means.mean import ConstantMean as JC, LinearMean as JL

    if kind == "constant":
        return (JC(c=jparam(jnp.asarray(2.5))), ConstantMean(param(torch.tensor(2.5, **F64))),
                lambda t: np.full_like(t, 2.5))
    return (JL(w=jparam(jnp.asarray([0.5])), b=jparam(jnp.asarray(2.0))),
            LinearMean(param(t_([0.5])), param(torch.tensor(2.0, **F64))), lambda t: 2.0 + 0.5 * t)


@pytest.mark.parametrize("form, kind", [("cov", "constant"), ("sqrt", "linear")])
def test_ssgp_mean_matches_jax(form, kind):
    from physs_gp_tpu.kernels import Matern32 as JM32
    from physs_gp_tpu.likelihoods import Gaussian as JG
    from physs_gp_tpu.models import StateSpaceGP as JS

    t, Y = _data()
    t_new = np.linspace(-0.5, 6.0, 9)
    jmean, pmean, mu = _means(kind)
    sqrt = form == "sqrt"
    jm = JS(t=jnp.asarray(t), Y=jnp.asarray(Y), kernel=JM32(lengthscale=1.0, variance=1.0),
            likelihood=JG(jpp(0.05)), mean=jmean, sqrt=sqrt)
    lml, post, f = jax.jit(lambda m, x: (m.log_marginal_likelihood(), m.posterior(), m.predict_f(x)))(
        jm, jnp.asarray(t_new))
    kern, lik = Matern32(1.0, 1.0, **F64), Gaussian(positive_param(0.05, **F64))
    pm = StateSpaceGP(t_(t), t_(Y), kern, lik, mean=pmean, sqrt=sqrt)
    assert rel(pm.log_marginal_likelihood(), lml) <= TOL
    pp, pf = pm.posterior(), pm.predict_f(t_(t_new))
    assert rel(pp.mean, post.mean) <= TOL and rel(pp.var, post.var) <= TOL_VAR
    assert rel(pf.mean, f.mean) <= TOL and rel(pf.var, f.var) <= TOL_VAR
    # the zero-mean model on the centred data, shifted back
    p0 = StateSpaceGP(t_(t), t_(Y - mu(t)[:, None]), kern, lik, sqrt=sqrt)
    assert rel(pm.log_marginal_likelihood(), p0.log_marginal_likelihood()) <= 1e-12
    assert rel(pf.mean, p0.predict_f(t_(t_new)).mean + t_(mu(t_new))[:, None]) <= 1e-12


@pytest.mark.parametrize("form", ["cov", "sqrt"])
def test_cvi_mean_matches_jax(form):
    """3 Poisson steps with a `LinearMean`: ELBOs, posterior and
    `predict_f` (the mean added at the new times)."""
    from physs_gp_tpu.kernels import Matern32 as JM32
    from physs_gp_tpu.likelihoods import Poisson as JPoisson
    from physs_gp_tpu.models import CVIGP as JCVIGP

    rng = np.random.default_rng(4)
    t = np.sort(rng.uniform(0, 10, T_LIVE))
    y = rng.poisson(np.exp(0.5 + 0.1 * t + np.sin(t)))[:, None].astype(float)
    t_new = np.linspace(-1.0, 11.0, 7)
    jmean, pmean, _ = _means("linear")
    sqrt = form == "sqrt"
    jm = JCVIGP.init(jnp.asarray(t), jnp.asarray(y), JM32(lengthscale=2.0, variance=1.0), JPoisson(),
                     mean=jmean, sqrt=sqrt)

    @jax.jit
    def run(m, x):
        elbos = []
        for _ in range(3):
            m, e = m.step_with_elbo(0.5)
            elbos.append(e)
        return jnp.stack(elbos), m.posterior(), m.predict_f(x)

    elbos, post, f = run(jm, jnp.asarray(t_new))
    pm = CVIGP.init(t_(t), t_(y), Matern32(2.0, 1.0, **F64), Poisson(), mean=pmean, sqrt=sqrt)
    pe = torch.stack([pm.step_with_elbo(0.5)[1] for _ in range(3)])
    assert rel(pe, elbos) <= TOL
    pp, pf = pm.posterior(), pm.predict_f(t_(t_new))
    assert rel(pp.mean, post.mean) <= TOL and rel(pp.var, post.var) <= TOL_VAR
    assert rel(pf.mean, f.mean) <= TOL and rel(pf.var, f.var) <= TOL_VAR


@pytest.mark.parametrize("form", ["cov", "sqrt"])
def test_streaming_mean_matches_jax(form):
    """`StreamingGP` with a `LinearMean` over three segments: filtered
    moments, carried state and lml, and a forecast."""
    from physs_gp_tpu.kernels import Matern32 as JM32
    from physs_gp_tpu.likelihoods import Gaussian as JG
    from physs_gp_tpu.models.streaming import StreamingGP as JSGP

    t, Y = _data()
    jmean, pmean, _ = _means("linear")
    sqrt = form == "sqrt"
    js = JSGP(kernel=JM32(lengthscale=1.0, variance=1.0), likelihood=JG(jpp(0.05)), mean=jmean,
              sqrt=sqrt)
    ps = StreamingGP(Matern32(1.0, 1.0, **F64), Gaussian(positive_param(0.05, **F64)), mean=pmean,
                     sqrt=sqrt)
    t_fc = t[-1] + np.linspace(0.1, 2.0, 6)

    @jax.jit
    def run(s):
        state, segs = s.init_state(t0=jnp.asarray(t[0])), []
        for a, b in ((0, 15), (15, T_LIVE)):
            state, seg = s.update(state, jnp.asarray(t[a:b]), jnp.asarray(Y[a:b]))
            segs.append(seg)
        return state, segs, s.forecast(state, jnp.asarray(t_fc))

    jstate, jsegs, jfc = run(js)
    state = ps.init_state(t0=float(t[0]))
    for (a, b), jseg in zip(((0, 15), (15, T_LIVE)), jsegs):
        state, seg = ps.update(state, t_(t[a:b]), t_(Y[a:b]))
        assert rel(seg.f_mean, jseg.f_mean) <= TOL and rel(seg.f_var, jseg.f_var) <= TOL_VAR
    assert rel(state.m, jstate.m) <= TOL and rel(state.P, jstate.P) <= TOL_VAR
    assert rel(state.lml, jstate.lml) <= TOL
    fc = ps.forecast(state, t_(t_fc))
    assert rel(fc.mean, jfc.mean) <= TOL and rel(fc.var, jfc.var) <= TOL_VAR


def test_streaming_cvi_mean_is_the_centred_fit():
    """`StreamingCVI` with a mean (Poisson, two segments) carries the state
    of the zero-mean online fit of the same sites on a shifted likelihood:
    with a Gaussian likelihood, the zero-mean fit of Y - μ; its forecast
    adds μ."""
    t, Y = _data()
    _, mean, mu = _means("linear")
    kern, lik = Matern32(1.0, 1.0, **F64), Gaussian(positive_param(0.05, **F64))
    cvi, cvi0 = StreamingCVI(kern, lik, mean=mean, n_iters=2), StreamingCVI(kern, lik, n_iters=2)
    s, s0 = cvi.init_state(t0=float(t[0])), cvi0.init_state(t0=float(t[0]))
    for a, b in ((0, 20), (20, T_LIVE)):
        s, _ = cvi.update(s, t_(t[a:b]), t_(Y[a:b]))
        s0, _ = cvi0.update(s0, t_(t[a:b]), t_(Y[a:b] - mu(t[a:b])[:, None]))
    assert rel(s.m, s0.m) <= TOL and rel(s.P, s0.P) <= TOL_VAR and rel(s.lml, s0.lml) <= TOL
    t_fc = t[-1] + np.linspace(0.1, 1.0, 4)
    assert rel(cvi.forecast(s, t_(t_fc)).mean, cvi0.forecast(s0, t_(t_fc)).mean + t_(mu(t_fc))[:, None]) <= TOL


FLOWS = mo.FLOWS


def _jax_flow(name):
    from physs_gp_tpu.data import transformed as jtr

    return {"log": lambda: jtr.LogTransform(shift=0.3),
            "affine": lambda: jtr.AffineTransform(scale=2.5, loc=-1.0),
            "boxcox": lambda: jtr.BoxCoxTransform(lam=0.4), "exp": jtr.ExpTransform,
            "softplus": jtr.SoftplusTransform, "square": jtr.SquareTransform,
            "reverse_softplus": lambda: jtr.ReverseFlow(jtr.SoftplusTransform()),
            "composite": lambda: jtr.CompositeFlow((jtr.LogTransform(shift=0.1),
                                                    jtr.AffineTransform(scale=0.7)))}[name]()


@pytest.mark.parametrize("name", FLOWS)
def test_flow_matches_jax(name):
    """Forward, inverse and log-Jacobian against JAX; the round trip; the
    log-Jacobian against the port's own autodiff fallback."""
    rng = np.random.default_rng(0)
    y = rng.uniform(0.4, 3.0, 64)  # a positive domain fits every flow
    jf, pf = _jax_flow(name), mo.flow(name)
    z, ldj = jax.jit(lambda v: (jf.forward(v), jf.log_det_jacobian(v)))(jnp.asarray(y))
    pz = pf.forward(t_(y))
    assert rel(pz, z) <= TOL and rel(pf.log_det_jacobian(t_(y)), ldj) <= TOL
    assert rel(pf.inverse(pz), y) <= TOL
    assert rel(tr.Flow.log_det_jacobian(pf, t_(y)), ldj) <= TOL


def test_transformed_data_is_a_change_of_variables():
    """`tests/test_flows.py`: lml_y = lml_z + Σ log|g'(y)| against the dense
    Gaussian density of log y, and the exact log-normal moments against
    Monte Carlo."""
    rng = np.random.default_rng(2)
    T = 60
    t = np.sort(rng.uniform(0, 5, T))
    y = np.exp(0.4 * np.sin(2 * t) + 0.1 * rng.normal(size=T))
    td = tr.TransformedData(t_(y)[:, None], tr.LogTransform())
    kern = Matern32(1.0, 0.3, **F64)
    lml_z = StateSpaceGP(t_(t), td.Z, kern, Gaussian(positive_param(0.05, **F64))).log_marginal_likelihood()
    K = kern.K(t_(t), t_(t)).numpy() + 0.05 * np.eye(T)
    z = np.log(y)
    dense = -0.5 * z @ np.linalg.solve(K, z) - 0.5 * np.linalg.slogdet(K)[1] - T / 2 * np.log(2 * np.pi)
    assert rel(lml_z, dense) <= TOL
    assert rel(td.lml_correction(), -np.sum(np.log(y))) <= 1e-12
    mean, var = tr.TransformedData(torch.ones(4, 1, **F64), tr.LogTransform()).to_data_space(
        t_([0.2]), t_([0.3]))
    ys = np.exp(np.random.default_rng(3).normal(0.2, np.sqrt(0.3), 400_000))
    np.testing.assert_allclose(float(mean[0]), ys.mean(), rtol=5e-3)
    np.testing.assert_allclose(float(var[0]), ys.var(), rtol=2e-2)


def test_uncertain_input_moments():
    """`tests/test_input_transforms.py`: V[f(x+w)] = V[f] + σ_x² (f'² + V[f'])
    (and the Hessian's mean shift), the active derivative sites, and the
    model's effective noise above the base noise where |f'| > 0."""
    from physs_gp_tpu.likelihoods import Gaussian as JG
    from physs_gp_tpu.transforms.inputs import UncertainInputLikelihood as JU

    from physs_gp_tpu_torch.transforms.inputs import UncertainInputLikelihood

    m = np.array([[1.0, 2.0, 0.3], [0.5, -1.0, -0.2]])
    S = np.broadcast_to(np.diag([0.3, 0.4, 0.1]), (2, 3, 3)).copy()
    for hessian in (False, True):
        lik = UncertainInputLikelihood(Gaussian(positive_param(0.1, **F64)),
                                       positive_param(0.25, **F64), hessian=hessian)
        jlik = JU(base=JG(jpp(0.1)), input_var=jpp(0.25), hessian=hessian)
        mean, var = lik.transformed_moments(t_(m), t_(S))
        jmean, jvar = jlik.transformed_moments(jnp.asarray(m), jnp.asarray(S))
        assert rel(mean, jmean) <= TOL and rel(var, jvar) <= TOL
    np.testing.assert_allclose(var.numpy(), [0.3 + 0.25 * (4.0 + 0.4), 0.3 + 0.25 * (1.0 + 0.4)])
    assert lik.site_active_mask(t_(np.full((3, 2), np.nan))).all()
    model = mo.uin_model(torch.float64, "cpu")
    for _ in range(5):
        model.step_with_elbo(0.5)
    post = model.posterior()
    _, var_t = model.likelihood.transformed_moments(post.mean, torch.diag_embed(post.var))
    assert float(var_t.max()) > mo.UIN["noise"] ** 2 + 0.5 * mo.UIN["sx"] ** 2


def test_helpers_match_jax():
    from physs_gp_tpu.ops import gaussian as jg
    from physs_gp_tpu.ops import matrix as jmx
    from physs_gp_tpu.utils.params import Sigmoid as JSigmoid

    from physs_gp_tpu_torch.ops import gaussian, matrix
    from physs_gp_tpu_torch.utils.params import Sigmoid

    rng = np.random.default_rng(5)
    blocks = rng.normal(size=(4, 3, 3))
    A, B, x = rng.normal(size=(3, 3)), rng.normal(size=(2, 2)), rng.normal(size=(5, 6))
    M = rng.normal(size=(2, 6, 6))
    y, m, v = rng.normal(size=7), rng.normal(size=7), rng.uniform(0.1, 1, 7)
    u = rng.uniform(-3, 3, 9)

    @jax.jit
    def ref(blocks, A, B, x, M, y, m, v, u):
        s = JSigmoid(lo=-1.0, hi=2.0)
        return (jmx.to_block_diag_batched(blocks), jmx.get_block_diagonal(M, 3), jmx.kron_mv(A, B, x),
                jmx.project_psd(M, 0.1), jg.gaussian_expected_logpdf_diag(y, m, v, 0.3),
                jg.symmetrize_cov(M), s.forward(u), s.inverse(s.forward(u)))

    want = ref(*(jnp.asarray(a) for a in (blocks, A, B, x, M, y, m, v, u)))
    s = Sigmoid(lo=-1.0, hi=2.0)
    got = (matrix.to_block_diag_batched(t_(blocks)), matrix.get_block_diagonal(t_(M), 3),
           matrix.kron_mv(t_(A), t_(B), t_(x)), matrix.project_psd(t_(M), 0.1),
           gaussian.gaussian_expected_logpdf_diag(t_(y), t_(m), t_(v), torch.tensor(0.3, **F64)),
           gaussian.symmetrize_cov(t_(M)), s.forward(t_(u)), s.inverse(s.forward(t_(u))))
    for i, (g, w) in enumerate(zip(got, want)):
        assert rel(g, w) <= TOL, i
    assert rel(matrix.kron_mv(t_(A), t_(B), t_(x)), t_(x) @ matrix.kron(t_(A), t_(B)).T) <= 1e-12


def test_load_numpy_params_carries_every_new_leaf():
    """The JAX `.raw` leaves of a model with every new kind of leaf (nested
    sum / product parts, the Wiener family's P0, a `LinearMean`, then a
    `ConstantMean`, an uncertain-input likelihood, the misc kernels) walk
    into port models that start from other values, each leaf by its JAX key
    path."""
    from physs_gp_tpu import kernels as jk
    from physs_gp_tpu.likelihoods import Gaussian as JG
    from physs_gp_tpu.means.mean import ConstantMean as JC
    from physs_gp_tpu.models import StateSpaceGP as JS
    from physs_gp_tpu.transforms.inputs import UncertainInputLikelihood as JU

    from physs_gp_tpu_torch import kernels as pk
    from physs_gp_tpu_torch.transforms.inputs import UncertainInputLikelihood

    def raws(tree):
        return {jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]
                if jax.tree_util.keystr(p).endswith(".raw")}

    jper = jk.Periodic(lengthscales=jpp(0.7), variance=jpp(1.3), period=jpp(5.0), n_harmonics=2)
    jkern = (jk.Matern32(lengthscale=2.0, variance=0.4) + jper * jk.Matern52(lengthscale=3.0, variance=0.9)
             + jk.WienerVelocity(variance=jpp(0.2), P0=jpp(0.03)) + jk.IntegratedWiener(variance=jpp(0.6), P0=jpp(0.05), q=3)
             + jk.RQ(lengthscales=jpp(0.8), variance=jpp(1.1), alpha=jpp(1.5))
             + jk.ArcCosine(variance=jpp(0.5), weight_var=jpp(2.0), bias_var=jpp(0.3))
             + jk.Gibbs(variance=jpp(0.9), l_fn=None) + jk.SpectralMixture.init(2, 1)
             + jk.DeepKernel.init(jk.RBF(), [1, 3, 1]))
    t, Y = _data(8)
    jm = JS(t=jnp.asarray(t), Y=jnp.asarray(Y), kernel=jkern, likelihood=JG(jpp(0.07)),
            mean=_means("linear")[0])
    kw = F64
    pkern = (pk.Matern32(1.0, 1.0, **kw) + pk.Periodic(n_harmonics=2, **kw) * pk.Matern52(1.0, 1.0, **kw)
             + pk.WienerVelocity(**kw) + pk.IntegratedWiener(q=3, **kw) + pk.RQ(**kw) + pk.ArcCosine(**kw)
             + pk.Gibbs(**kw) + pk.SpectralMixture.init(2, 1, dtype=torch.float64)
             + pk.DeepKernel.init(pk.RBF(positive_param(1.0, **kw), positive_param(1.0, **kw)), [1, 3, 1],
                                  dtype=torch.float64))
    pm = StateSpaceGP(t_(t), t_(Y), pkern, Gaussian(positive_param(1.0, **kw)),
                      mean=LinearMean(param(t_([0.0])), param(torch.tensor(0.0, **kw))))
    flat = raws(jm)
    assert ".kernel.parts[1].parts[0].period.raw" in flat and ".mean.w.raw" in flat
    assert ".kernel.parts[8].layers[0][0].raw" in flat and ".kernel.parts[7].means.raw" in flat
    load_numpy_params(pm, flat)
    ports = {"".join(f"[{s}]" if s.isdigit() else f".{s}" for s in name.split(".")): p
             for name, p in pm.named_parameters()}
    assert set(ports) == set(flat)
    for key, value in flat.items():
        assert np.array_equal(ports[key].numpy(), value), key
    # a ConstantMean and an uncertain-input likelihood
    holder = torch.nn.Module()
    holder.mean = ConstantMean(param(torch.tensor(0.0, **kw)))
    holder.likelihood = UncertainInputLikelihood(Gaussian(positive_param(1.0, **kw)), positive_param(1.0, **kw))
    jholder = {"mean": JC(c=jparam(jnp.asarray(1.7))),
               "likelihood": JU(base=JG(jpp(0.02)), input_var=jpp(0.04))}
    flat = {"." + k.split("'")[1] + k.split("]", 1)[1]: v for k, v in raws(jholder).items()}
    load_numpy_params(holder, flat)
    assert float(holder.mean.c.value) == 1.7
    assert abs(float(holder.likelihood.input_var.value) - 0.04) <= 1e-15
    assert abs(float(holder.likelihood.base.variance.value) - 0.02) <= 1e-15

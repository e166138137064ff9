"""PyTorch port: the Markov-kernel zoo against the JAX package.

The same numpy inputs go through both packages in float64 (CPU): `_bessel_i`
and `Periodic` (its scalar form, state space, exact rotations and zero
noise); the Sum / Product combinators' `to_ss`, `transition_matrix` and
`noise_matrix` (the exact noiseless-factor composition of a product, zeros
when no factor is noisy, the stationary identity otherwise) and a
`StackedMarkov` over them; the quasi-periodic model's lml against JAX and
against the dense Gram of its own state space, and its `noise_matrix` at
dt = 1e-5 (PSD); the four Wiener kinds (scalar form, closed-form
discretisation, lml against the dense non-stationary Gram); the misc
kernels' Grams (the randomly initialised ones carry the JAX leaves across
by `load_numpy_params`); `AggregatedKernel`; the `matrix_exp` fallback of
`MarkovKernel.transition` against JAX `expm`. Values rtol 1e-9, the
quadrature against scipy 1e-8 (absolute 1e-14 for the tiny high orders).
JAX is imported inside the live cases only, so the `cuda` twin runs on the
card:

    python3 -m pytest --noconftest -m cuda tests/test_torch_markov_kernels.py
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import markov_outcome as mo  # noqa: E402

from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels import markov  # noqa: E402
from physs_gp_tpu_torch.kernels import (  # noqa: E402
    IntegratedWiener, Matern32, Matern52, Periodic, StackedMarkov, Wiener, WienerVelocity,
)
from physs_gp_tpu_torch.kernels.periodic import _bessel_i  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.models import StateSpaceGP  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")
TOL = 1e-9
DTS = np.array([0.0, 1e-5, 0.3, 1.0, 2.7])


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def rel(a, b):
    """max |a - b| / max |b| (max |a - b| when b is 0)."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) or 1.0))


def t_(x):
    return torch.from_numpy(np.array(x, np.float64))


def _jax():
    import jax.numpy as jnp

    from physs_gp_tpu.kernels import markov as jmarkov
    from physs_gp_tpu.utils.params import positive_param as jpp

    return jnp, jmarkov, lambda v: jpp(jnp.asarray(v, jnp.float64))


def _periodic_pair(J=3, ls=1.2, var=0.8, period=1.7):
    from physs_gp_tpu.kernels import Periodic as JP

    _, _, jpp = _jax()
    return (JP(lengthscales=jpp(ls), variance=jpp(var), period=jpp(period), n_harmonics=J),
            Periodic(positive_param(ls, **F64), positive_param(var, **F64), positive_param(period, **F64),
                     n_harmonics=J))


def _matern_pair(cls, ls, var):
    from physs_gp_tpu.kernels import matern as jm

    jcls = getattr(jm, cls.__name__)
    return jcls(lengthscale=ls, variance=var), cls(ls, var, **F64)


def test_bessel_i_matches_scipy_and_jax():
    from scipy.special import iv

    from physs_gp_tpu.kernels.periodic import _bessel_i as jbessel

    import jax

    jnp, _, _ = _jax()
    jb = jax.jit(lambda x: jbessel(np.arange(7), x))
    for x in (0.1, 1.0, 4.0):
        got = _bessel_i(range(7), torch.tensor(x, **F64))
        np.testing.assert_allclose(got.numpy(), iv(np.arange(7), x), rtol=1e-8, atol=1e-14)
        assert rel(got, jb(jnp.asarray(x))) <= TOL
    assert _bessel_i(range(3), torch.tensor(1.0, dtype=torch.float32)).dtype == torch.float32


def test_periodic_matches_jax():
    """Scalar form, state space, exact rotations (periodic: A(period) = I),
    zero noise, and the harmonic series against the exact kernel."""
    import jax

    jnp, jmarkov, _ = _jax()
    jk, pk = _periodic_pair(J=8)
    taus = np.linspace(0.0, 3.0, 25)
    jexact, jss, jA = jax.jit(lambda k, tau: (
        jax.vmap(lambda tt: k.k_scalar(jnp.zeros(1), tt[None]))(tau), jmarkov.to_ss(k),
        k.transition(tau)))(jk, jnp.asarray(taus))
    pexact = torch.stack([pk.k_scalar(torch.zeros(1, **F64), t_([tt])) for tt in taus])
    assert rel(pexact, jexact) <= TOL
    pss = markov.to_ss(pk)
    for f in ("F", "L", "Qc", "H", "Pinf", "minf"):
        assert rel(getattr(pss, f), getattr(jss, f)) <= TOL, f
    A = pk.transition(t_(taus))
    assert rel(A, jA) <= TOL
    approx = torch.einsum("oi,tij,jk,pk->t", pss.H, A, pss.Pinf, pss.H)
    np.testing.assert_allclose(approx.numpy(), pexact.numpy(), atol=1e-6)
    np.testing.assert_allclose(pk.transition(t_(1.7)).numpy(), np.eye(18), atol=1e-12)
    assert torch.count_nonzero(markov.noise_matrix(pk, t_(DTS))) == 0
    assert pk.is_noiseless and pk.state_dim == 18


def _combinators(which):
    """(JAX kernel, port kernel): sums and products of Periodic and Matérn."""
    jp, pp = _periodic_pair()
    jm1, pm1 = _matern_pair(Matern32, 4.0, 0.5)
    jm2, pm2 = _matern_pair(Matern52, 2.0, 1.3)
    if which == "sum":
        return jm1 + jp, pm1 + pp
    if which == "quasi_periodic":
        return jp * jm2, pp * pm2
    if which == "trend_qp":
        return jm1 + jp * jm2, pm1 + pp * pm2
    if which == "noisy_product":  # two noisy factors: the stationary identity
        return jm1 * jm2, pm1 * pm2
    jp2, pp2 = _periodic_pair(J=2, period=3.1)  # no noisy factor: zeros
    return jp * jp2, pp * pp2


def _jax_system(jk, dts):
    """(to_ss, A, Q) of a JAX kernel, in one compiled call."""
    import jax

    jnp, jmarkov, _ = _jax()
    return jax.jit(lambda k, dt: (jmarkov.to_ss(k), jmarkov.transition_matrix(k, dt),
                                  jmarkov.noise_matrix(k, dt)))(jk, jnp.asarray(dts))


@pytest.mark.parametrize("which", ["sum", "quasi_periodic", "trend_qp", "noisy_product", "periodic_product"])
def test_combinators_match_jax(which):
    jk, pk = _combinators(which)
    jss, jA, jQ = _jax_system(jk, DTS)
    pss = markov.to_ss(pk)
    for f in ("F", "L", "Qc", "H", "Pinf", "minf"):
        assert rel(getattr(pss, f), getattr(jss, f)) <= TOL, f
    dt = t_(DTS)
    assert rel(markov.transition_matrix(pk, dt), jA) <= TOL
    Q = markov.noise_matrix(pk, dt)
    assert rel(Q, jQ) <= TOL
    if which == "periodic_product":
        assert torch.count_nonzero(Q) == 0
    # the exact composition stays PSD at a tiny gap
    assert torch.linalg.eigvalsh(Q[1]).min() > -1e-12


def test_stacked_markov_over_combinators_matches_jax():
    from physs_gp_tpu.kernels import StackedMarkov as JStacked

    (j1, p1), (j2, p2) = _combinators("sum"), _combinators("quasi_periodic")
    jk, pk = JStacked(parts=[j1, j2]), StackedMarkov([p1, p2])
    jss, jA, jQ = _jax_system(jk, DTS)
    assert rel(markov.to_ss(pk).H, jss.H) <= TOL
    dt = t_(DTS)
    assert rel(markov.transition_matrix(pk, dt), jA) <= TOL
    assert rel(markov.noise_matrix(pk, dt), jQ) <= TOL


def _dense_lml(K, y, noise):
    K = K + noise * np.eye(len(y))
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
    return -0.5 * y @ alpha - np.log(np.diag(L)).sum() - len(y) / 2 * np.log(2 * np.pi)


def test_quasi_periodic_lml_matches_jax_and_dense():
    """`tests/test_kernels_extra.py::test_quasiperiodic_ssgp_matches_dense`:
    the Periodic x Matérn-5/2 product at T = 40 with 10 harmonics."""
    import jax

    from physs_gp_tpu.likelihoods import Gaussian as JG
    from physs_gp_tpu.models import StateSpaceGP as JS

    jnp, _, jpp = _jax()
    rng = np.random.default_rng(0)
    T, noise = 40, 0.05
    t = np.sort(rng.uniform(0, 6, T))
    y = np.sin(2 * np.pi * t / 2.0) + 0.1 * rng.normal(size=T)
    jp, pp = _periodic_pair(J=10, ls=1.5, var=1.0, period=2.0)
    jm, pm = _matern_pair(Matern52, 4.0, 1.0)
    pk = pp * pm
    model = StateSpaceGP(t_(t), t_(y)[:, None], pk, Gaussian(positive_param(noise, **F64)))
    lml = model.log_marginal_likelihood()
    jmodel = JS(t=jnp.asarray(t), Y=jnp.asarray(y)[:, None], kernel=jp * jm, likelihood=JG(jpp(noise)))
    assert rel(lml, jax.jit(lambda m: m.log_marginal_likelihood())(jmodel)) <= TOL
    ss = markov.to_ss(pk)
    tau = t_(np.abs(t[:, None] - t[None, :]).reshape(-1))
    A = markov.transition_matrix(pk, tau).reshape(T, T, ss.state_dim, -1)
    K = torch.einsum("oi,stij,jk,pk->st", ss.H, A, ss.Pinf, ss.H).detach().numpy()
    assert rel(lml, _dense_lml(K, y, noise)) <= 1e-7  # the JAX test's own tolerance


WIENERS = {"w": (Wiener, {}), "wv": (WienerVelocity, {}), "iw2": (IntegratedWiener, {"q": 2}),
           "iw3": (IntegratedWiener, {"q": 3})}


@pytest.mark.parametrize("name", WIENERS)
def test_wiener_kinds_match_jax(name):
    """Scalar form, A(dt), Q(dt) and to_ss against JAX; the lml against the
    dense non-stationary Gram propagated from t[0] with P0 (the JAX test's
    construction)."""
    from physs_gp_tpu import kernels as jkernels

    jnp, jmarkov, jpp = _jax()
    cls, extra = WIENERS[name]
    jk = getattr(jkernels, cls.__name__)(variance=jpp(0.7), P0=jpp(1e-4), **extra)
    pk = cls(positive_param(0.7, **F64), positive_param(1e-4, **F64), **extra)
    import jax

    x = np.array([[0.3, 1.7], [2.0, 0.5], [1.1, 1.1]])
    jks = jax.jit(jax.vmap(lambda a, b: jk.k_scalar(a[None], b[None])))(jnp.asarray(x[:, 0]),
                                                                      jnp.asarray(x[:, 1]))
    for (a, b), ref in zip(x, np.asarray(jks)):
        assert rel(pk.k_scalar(t_([a]), t_([b])), ref) <= TOL
    jss, jA, jQ = _jax_system(jk, DTS)
    assert rel(pk.transition(t_(DTS)), jA) <= TOL
    assert rel(markov.noise_matrix(pk, t_(DTS)), jQ) <= TOL
    assert rel(markov.to_ss(pk).Pinf, jss.Pinf) <= TOL
    rng = np.random.default_rng(1)
    T, noise = 30, 0.04
    t = np.sort(rng.uniform(0.1, 4, T))
    y = np.cumsum(rng.normal(size=T) * 0.3)
    lml = StateSpaceGP(t_(t), t_(y)[:, None], pk, Gaussian(positive_param(noise, **F64))).log_marginal_likelihood()
    ss = markov.to_ss(pk)
    H, P0 = ss.H.detach().numpy(), ss.Pinf.detach().numpy()
    K = np.zeros((T, T))
    for i in range(T):
        A0 = pk.transition(t_(t[i] - t[0])).detach().numpy()
        Pi = A0 @ P0 @ A0.T + pk.noise_cov(t_(t[i] - t[0])).detach().numpy()
        for j in range(i, T):
            Aij = pk.transition(t_(t[j] - t[i])).detach().numpy()
            K[i, j] = K[j, i] = (H @ Pi @ Aij.T @ H.T)[0, 0]
    assert rel(lml, _dense_lml(K, y, noise)) <= 1e-7  # the JAX test's own tolerance


@pytest.mark.parametrize("name", mo.MISC)
def test_misc_kernel_grams_match_jax(name):
    """K and K_diag on 15 points in 2-D; `sm` and `deep` start from the
    port's own draws and load the JAX leaves (`.kernel.means.raw`,
    `.kernel.layers[0][0].raw`, ...)."""
    import jax

    from physs_gp_tpu.kernels import RBF, RQ, ArcCosine, DeepKernel, Gibbs, SpectralMixture

    jnp, _, jpp = _jax()
    jk = {"rq": lambda: RQ(lengthscales=jpp(0.8), variance=jpp(1.0), alpha=jpp(1.5)),
          "sm": lambda: SpectralMixture.init(3, 2),
          "arccos": ArcCosine,
          "gibbs": lambda: Gibbs(variance=jpp(1.0), l_fn=lambda x: 0.5 + 0.3 * jnp.sum(x**2)),
          "deep": lambda: DeepKernel.init(RBF(), [2, 8, 2])}[name]()
    pk = mo.misc_kernel(name, torch.float64, "cpu")
    holder = torch.nn.Module()
    holder.kernel = pk
    leaves = {".kernel" + jax.tree_util.keystr(p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(jk)[0]}
    load_numpy_params(holder, {k: v for k, v in leaves.items() if k.endswith(".raw")})
    X = mo.batch_inputs()[0]
    jK, jd = jax.jit(lambda k, x: (k.K(x, x), k.K_diag(x)))(jk, jnp.asarray(X))
    K = pk.K(t_(X), t_(X))
    assert rel(K, jK) <= TOL
    assert rel(pk.K_diag(t_(X)), jd) <= TOL
    assert torch.linalg.eigvalsh(K).min() > -1e-7


def test_aggregated_kernel_matches_jax():
    """K, K_diag and cross_K over region indices; the pointwise
    reconstruction from box averages (the JAX test's RMSE gate)."""
    from physs_gp_tpu.kernels import RBF, AggregatedKernel

    jnp, _, jpp = _jax()
    _, _, lows, highs, Ya = mo.batch_inputs()
    nodes, w = mo.uniform_box_nodes(lows, highs, n_per_dim=8)
    jagg = AggregatedKernel(base=RBF(lengthscales=jpp(0.7), variance=jpp(1.0)), nodes=jnp.asarray(nodes),
                            weights=jnp.asarray(w))
    agg = mo.aggregated_kernel(torch.float64, "cpu")
    R = len(Ya)
    idx = np.arange(R)
    Xs = np.linspace(0.2, 3.8, 30)[:, None]
    import jax

    jK, jd, jc = jax.jit(lambda k, i, xs: (k.K(i, i), k.K_diag(i), k.cross_K(i, xs)))(
        jagg, jnp.asarray(idx), jnp.asarray(Xs))
    Krr = agg.K(t_(idx), t_(idx))
    assert rel(Krr, jK) <= TOL
    assert rel(agg.K_diag(t_(idx)), jd) <= TOL
    Kxr = agg.cross_K(t_(idx), t_(Xs))
    assert rel(Kxr, jc) <= TOL
    f_rec = Kxr.T @ torch.linalg.solve(Krr + 1e-4 * torch.eye(R, **F64), t_(Ya[:, 0]))
    assert float(torch.sqrt(torch.mean((f_rec - torch.sin(2 * t_(Xs[:, 0]))) ** 2))) < 0.1


class _NoClosedForm(torch.nn.Module, markov.MarkovKernel):
    """A Matérn-5/2 state space with no closed-form transition."""

    def __init__(self, base):
        super().__init__()
        self.base = base

    def to_ss(self):
        return self.base.to_ss()


def test_matrix_exp_fallback_matches_jax_expm():
    import jax

    from physs_gp_tpu.kernels import markov as jmarkov

    jnp, _, _ = _jax()
    jm, pm = _matern_pair(Matern52, 1.3, 0.9)
    A = _NoClosedForm(pm).transition(t_(DTS))
    F = jnp.asarray(markov.to_ss(pm).F.detach().numpy())
    ref, jQ = jax.jit(lambda k, f, dt: (lambda e: (e, jmarkov.stationary_noise(e, jmarkov.to_ss(k).Pinf)))(
        jax.vmap(lambda s: jax.scipy.linalg.expm(f * s))(dt)))(jm, F, jnp.asarray(DTS))
    assert rel(A, ref) <= TOL
    assert rel(A, pm.transition(t_(DTS))) <= TOL  # the closed form
    Q = _NoClosedForm(pm).stationary_noise(A)
    assert rel(Q, jQ) <= TOL
    assert rel(Q, pm.noise_cov(t_(DTS))) <= TOL  # the cancellation-free closed form


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernels_at_markov_shapes(dtype):
    """The card twin of `chip_smoke.py`'s `_check_markov_shapes`: every
    kernel the d = 30 path launches against its plain version at the
    path's shapes (`markov_outcome.kernel_cases`), at `chip_smoke.TOL`, all
    on the warp kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke

    from physs_gp_tpu_torch.ops.cuda import build

    build.reset_launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(12)
    for name, kind, got, plain, label in mo.kernel_cases(gen, dtype):
        r = float((got - plain).abs().max() / plain.abs().max())
        assert torch.isfinite(got).all() and r <= chip_smoke.TOL[dtype][kind], (name, label, r)
    assert not any(r["block"] for r in build.route_counts().values())

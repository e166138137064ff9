"""PyTorch port: the stacked-latent and vector-field paths against the JAX
package.

`ops/matrix.block_diag`, `kernels/markov.StackedMarkov` (`to_ss` against
`to_lgssm` on plain Markov parts, the Kronecker-lifted parts through their
own `to_lgssm`), `StackedHead` with None, number and `Param` coefficients,
`helmholtz_st_gp` / `helmholtz_st_predict` (conjugate and one CVI step),
`magnetic_field_gp` / `magnetic_field_predict` with and without the
potential block, `MixedValueHead`, `UnitLowerMixing` and `lmc_markov_gp`
(conjugate and Poisson CVI). The same numpy inputs go through the JAX
function (float64, CPU) and the port; lml, ELBO, means and gradients agree
to rtol 1e-9 and variances to 1e-7, relative to each output's largest
magnitude. The JAX raws are moved off their defaults and carried into the
port by `interop.load_numpy_params`.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.kernels import Matern32 as JM32  # noqa: E402
from physs_gp_tpu.kernels import Matern52 as JM52  # noqa: E402
from physs_gp_tpu.kernels.markov import StackedMarkov as JStacked  # noqa: E402
from physs_gp_tpu.kernels.multi_output import UnitLowerMixing as JUnitLower  # noqa: E402
from physs_gp_tpu.kernels.rbf import RBF as JRBF  # noqa: E402
from physs_gp_tpu.kernels.spatio_temporal import SpatioTemporalKernel as JSTKernel  # noqa: E402
from physs_gp_tpu.ops.lgssm import build_lgssm as jbuild_lgssm  # noqa: E402
from physs_gp_tpu.ops.matrix import block_diag as jblock_diag  # noqa: E402
from physs_gp_tpu.transforms import operators as jops  # noqa: E402
from physs_gp_tpu.utils import params as jparams  # noqa: E402
from physs_gp_tpu.zoo import helmholtz_st_predict as jhelmholtz_predict  # noqa: E402
from physs_gp_tpu.zoo import magnetic_field_predict as jmagnetic_predict  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.markov import StackedMarkov, to_ss  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32, Matern52  # noqa: E402
from physs_gp_tpu_torch.kernels.multi_output import UnitLowerMixing  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.kernels.spatio_temporal import SpatioTemporalKernel  # noqa: E402
from physs_gp_tpu_torch.ops.lgssm import build_lgssm  # noqa: E402
from physs_gp_tpu_torch.ops.matrix import block_diag  # noqa: E402
from physs_gp_tpu_torch.transforms import operators as pops  # noqa: E402
from physs_gp_tpu_torch.utils.params import param, positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.phi_ml import helmholtz_st_predict, magnetic_field_predict  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import make_vector_field_golden as mg  # noqa: E402
import vector_field_outcome as vf  # noqa: E402

from experiments_torch import helmholtz as hz  # noqa: E402

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")
TOL, TOL_VAR = 1e-9, 1e-7


def rel(a, b):
    """max |a - b| / max |b| over the entries of b (max |a - b| when b is
    0); NaNs must sit in the same places."""
    a, b = (x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in (a, b))
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    return float(np.nanmax(np.abs(a - b)) / (np.nanmax(np.abs(b)) or 1.0))


def t_(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# block_diag, StackedMarkov
# ---------------------------------------------------------------------------


def test_block_diag_matches_jax():
    """Rectangular blocks, and square blocks batched over broadcast axes."""
    rng = np.random.default_rng(0)
    blocks = [rng.normal(size=(2, 3)), rng.normal(size=(1, 1)), rng.normal(size=(4, 2))]
    assert rel(block_diag(*[t_(b) for b in blocks]), jblock_diag(*blocks)) == 0.0
    batched = [rng.normal(size=(5, 2, 2)), rng.normal(size=(1, 3, 3))]
    got = block_diag(*[t_(b) for b in batched])
    assert got.shape == (5, 5, 5)
    assert rel(got, jblock_diag(*batched)) == 0.0


def _latents():
    return ([JM32(lengthscale=0.7, variance=1.0), JM52(lengthscale=1.8, variance=0.6)],
            [Matern32(lengthscale=0.7, variance=1.0, **F64), Matern52(lengthscale=1.8, variance=0.6, **F64)])


def test_stacked_markov_matches_jax_and_its_two_routes_agree():
    """`to_ss`, `transition`, `noise_cov`, `state_dim`, `n_outputs` against
    the JAX kernel; on plain Markov parts `to_lgssm` (the parts' own
    systems) and the `to_ss` route give the same system."""
    jl, pl = _latents()
    jk, pk = JStacked(parts=jl), StackedMarkov(pl)
    t = np.sort(np.random.default_rng(1).uniform(0, 3, 6))
    dt = np.diff(t, prepend=t[0])
    jss, jA, jQ, jssm = jax.jit(lambda k, t, dt: (k.to_ss(), k.transition(dt), k.noise_cov(dt),
                                                  jbuild_lgssm(k, t)))(jk, jnp.asarray(t), jnp.asarray(dt))
    for name in ("F", "L", "Qc", "H", "Pinf", "minf"):
        assert rel(getattr(to_ss(pk), name), getattr(jss, name)) <= 1e-14, name
    assert rel(pk.transition(t_(dt)), jA) <= 1e-14
    assert rel(pk.noise_cov(t_(dt)), jQ) <= 1e-14
    assert (pk.state_dim, pk.n_outputs) == (jk.state_dim, jk.n_outputs) == (5, 2)
    ssm = build_lgssm(pk, t_(t))
    ss = to_ss(pk)
    A = torch.stack([pk.transition(t_(dt))[k] for k in range(6)])
    for got, want in ((ssm.A, A), (ssm.Q, pk.noise_cov(t_(dt))), (ssm.H, ss.H), (ssm.m0, ss.minf),
                      (ssm.P0, ss.Pinf)):
        assert rel(got, want) <= 1e-15
    for name in ("A", "Q", "H", "m0", "P0"):
        assert rel(getattr(ssm, name), getattr(jssm, name)) <= 1e-14, name


def _st_pair(Z):
    """(JAX, port) `SpatioTemporalKernel`s over Z with distinct hyperparameters."""
    jk = JSTKernel(k_time=JM32(lengthscale=0.9, variance=1.3),
                   k_space=JRBF(lengthscales=jparams.positive_param(jnp.array([0.6, 0.8])),
                                variance=jparams.positive_param(1.1)), Z=jnp.asarray(Z))
    pk = SpatioTemporalKernel(
        Matern32(lengthscale=0.9, variance=1.3, **F64),
        RBF(lengthscales=positive_param([0.6, 0.8], **F64), variance=positive_param(1.1, **F64)),
        t_(Z))
    return jk, pk


def test_stacked_markov_lifts_spatio_temporal_parts():
    """Kronecker-lifted parts compose block-diagonally through their own
    `to_lgssm`."""
    rng = np.random.default_rng(2)
    Z = rng.uniform(-1, 1, (3, 2))
    (ja, pa), (jb, pb) = _st_pair(Z), _st_pair(Z[:2])
    t = np.sort(rng.uniform(0, 2, 5))
    jssm = jax.jit(jbuild_lgssm)(JStacked(parts=[ja, jb]), jnp.asarray(t))
    pk = StackedMarkov([pa, pb])
    ssm = build_lgssm(pk, t_(t))
    assert pk.state_dim == 10 and ssm.A.shape == (5, 10, 10)
    for name in ("A", "Q", "H", "m0", "P0"):
        assert rel(getattr(ssm, name), getattr(jssm, name)) <= 1e-13, name


# ---------------------------------------------------------------------------
# StackedHead, MixedValueHead, UnitLowerMixing
# ---------------------------------------------------------------------------


def test_stacked_head_matches_jax_and_loads_its_coefficients():
    """Parts None, a head, (number, head) and (Param, head) over four ST
    latents: rows and the summed c² correction; the number and the Param's
    raw load through the JAX key paths `parts[2][0]` and `parts[3][0].raw`."""
    rng = np.random.default_rng(3)
    Z = rng.uniform(-1, 1, (3, 2))
    pts = rng.uniform(-1, 1, (4, 2))
    pairs = [_st_pair(Z) for _ in range(4)]
    jk, pk = JStacked(parts=[p[0] for p in pairs]), StackedMarkov([p[1] for p in pairs])

    def heads(ops, pts, PParam, gradop):
        def sh(**kw):
            return ops.SpatialHead(points=pts, correction=True, **kw)

        return ops.StackedHead(parts=[None, sh(s_op=gradop(0)), (-0.5, sh()), (PParam, sh(t_order=1))])

    jh = heads(jops, jnp.asarray(pts), jparams.param(0.3), jops.s_grad)
    ph = heads(pops, t_(pts), param(0.3, **F64), pops.s_grad)
    jrows, jcorr = jax.jit(lambda h, k: (h.rows(k), h.var_correction(k)))(jh, jk)
    assert rel(ph.rows(pk), jrows) <= TOL and rel(ph.var_correction(pk), jcorr) <= TOL
    assert ph.rows(pk)[:, :6].abs().max() == 0 and ph.correction and ph.points is ph.parts[1].points
    load_numpy_params(ph, {".parts[2][0]": np.asarray(2.0), ".parts[3][0].raw": np.asarray(-0.7)})
    jh2 = heads(jops, jnp.asarray(pts), jparams.param(-0.7), jops.s_grad)
    jh2 = jops.StackedHead(parts=jh2.parts[:2] + [(2.0, jh2.parts[2][1]), jh2.parts[3]])
    assert ph.parts[2][0] == 2.0 and ph.parts[3][0].value.item() == -0.7
    jrows, jcorr = jax.jit(lambda h, k: (h.rows(k), h.var_correction(k)))(jh2, jk)
    assert rel(ph.rows(pk), jrows) <= TOL and rel(ph.var_correction(pk), jcorr) <= TOL
    with pytest.raises(ValueError, match="at least one"):
        pops.StackedHead([None, None]).rows(pk)
    with pytest.raises(ValueError, match="static"):
        pops.StackedHead([pops.ScatteredSpatialHead(t_(rng.uniform(-1, 1, (2, 2, 2))))]).rows(pk)


def test_mixed_value_head_and_unit_lower_mixing_match_jax():
    """Rows of a Param, a plain and a unit-lower W over stacked Matérn
    latents; a point-free row head gets one zero correction per row beside
    a corrected head."""
    jl, pl = _latents()
    jk, pk = JStacked(parts=jl), StackedMarkov(pl)
    W = np.random.default_rng(4).normal(size=(3, 2))
    for jW, pW in ((jparams.param(jnp.asarray(W)), param(W, **F64)), (jnp.asarray(W), t_(W))):
        assert rel(pops.MixedValueHead(pW).rows(pk), jops.MixedValueHead(W=jW).rows(jk)) <= 1e-15
    assert rel(pops.MixedValueHead(t_(W), t_order=1).rows(pk),
               jops.MixedValueHead(W=jnp.asarray(W), t_order=1).rows(jk)) <= 1e-15
    ju, pu = JUnitLower.init(3, 2), UnitLowerMixing.init(3, 2, **F64)
    z = np.array([0.4, -1.2, 0.7])
    load_numpy_params(pu, {".z.raw": z})
    ju = JUnitLower(z=jparams.param(jnp.asarray(z)), P=3, L=2)
    assert rel(pu.value, ju.value) == 0.0 and pu.value[0, 1] == 0 and pu.value[1, 1] == 1
    with pytest.raises(ValueError, match="latent columns"):
        pops.MixedValueHead(t_(W[:, :1])).rows(pk)

    class Flagged(torch.nn.Module):
        correction = True

        def rows(self, kernel):
            return torch.ones(2, kernel.state_dim, **F64)

        def var_correction(self, kernel):
            return torch.full((2,), 0.5, **F64)

    obs = pops.StateObservation([pops.MixedValueHead(t_(W)), Flagged()])
    assert obs.H(pk).shape == (5, 5)
    assert torch.equal(obs.var_correction(pk), t_([0.0, 0.0, 0.0, 0.5, 0.5]))


# ---------------------------------------------------------------------------
# recipes
# ---------------------------------------------------------------------------


def _helmholtz_inputs(seed=0, T=6, Ns=4):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 3, T))
    Z = rng.uniform(-1, 1, (Ns, 2))
    Y = rng.normal(size=(T, 2 * Ns))
    Y[2, 1] = Y[4, Ns + 2] = np.nan
    return t, Z, Y, rng.uniform(-0.8, 0.8, (3, 2))


@pytest.mark.parametrize("parallel,sqrt", [(False, False), (True, True)], ids=["seq-cov", "par-sqrt"])
def test_helmholtz_st_gp_matches_jax(parallel, sqrt):
    """lml and `helmholtz_st_predict` (the off-site residual of both latents
    in the variance), raws moved off their defaults; the JAX side
    sequential, in the same form (the square-root form's relative jitter on
    Q, R and P0 moves this lml by 5.5e-9 in the JAX package itself)."""
    t, Z, Y, S = _helmholtz_inputs()
    jm = mg.shift_raws(mg.jax_helmholtz(t, Z, Y, sqrt=sqrt))
    lml, pred = jax.jit(lambda m, s: (m.log_marginal_likelihood(), jhelmholtz_predict(m, s)))(
        jm, jnp.asarray(S))
    pm = hz.build(t, Z, Y, torch.float64, "cpu", parallel=parallel, sqrt=sqrt)
    load_numpy_params(pm, mg.leaves(jm))
    with torch.no_grad():
        assert rel(pm.log_marginal_likelihood(), lml) <= TOL
        got = helmholtz_st_predict(pm, t_(S))
    assert got.mean.shape == (6, 6)
    assert rel(got.mean, pred.mean) <= TOL and rel(got.var, pred.var) <= TOL_VAR


def test_helmholtz_cvi_step_matches_jax():
    """`cvi=True`: one `step_with_elbo(1.0)`'s ELBO, then the prediction
    through the surrogate (q is the conjugate posterior after the step)."""
    t, Z, Y, S = _helmholtz_inputs(seed=1)
    jm = mg.shift_raws(mg.jax_helmholtz(t, Z, Y, cvi=True))
    jm1, elbo = jax.jit(lambda m: m.step_with_elbo(1.0))(jm)
    pred = jax.jit(jhelmholtz_predict)(jm1, jnp.asarray(S))
    pm = hz.build(t, Z, Y, torch.float64, "cpu", cvi=True)
    load_numpy_params(pm, mg.leaves(jm))
    pm, pelbo = pm.step_with_elbo(1.0)
    got = helmholtz_st_predict(pm, t_(S))
    assert rel(pelbo, elbo) <= TOL
    assert rel(pm.sites.Y, jm1.sites.Y) <= TOL
    assert rel(got.mean, pred.mean) <= TOL and rel(got.var, pred.var) <= TOL_VAR


@pytest.mark.parametrize("pot,parallel", [(False, False), (True, True)],
                         ids=["no-potential-seq", "potential-par"])
def test_magnetic_field_gp_matches_jax(pot, parallel):
    """lml and `magnetic_field_predict` (the −∂t block's residual scales by
    Var(f′)), with and without the potential block."""
    t, Z, Y, s_new = vf.magnetic_inputs(pot, T=7, Ns=3)
    jm = mg.shift_raws(mg.jax_magnetic(t, Z, Y, pot))
    lml, pred = jax.jit(lambda m, s: (m.log_marginal_likelihood(),
                                      jmagnetic_predict(m, s, include_potential=pot)))(
        jm, jnp.asarray(s_new))
    pm = vf.magnetic_model(t, Z, Y, pot, torch.float64, "cpu", parallel=parallel)
    load_numpy_params(pm, mg.leaves(jm))
    with torch.no_grad():
        assert rel(pm.log_marginal_likelihood(), lml) <= TOL
        got = magnetic_field_predict(pm, t_(s_new), include_potential=pot)
    assert got.mean.shape == (7, (4 if pot else 3) * 4)
    assert rel(got.mean, pred.mean) <= TOL and rel(got.var, pred.var) <= TOL_VAR
    with pytest.raises(ValueError, match="columns"):
        vf.magnetic_model(t, Z, Y[:, 1:], pot, torch.float64, "cpu")


def test_lmc_markov_gp_matches_jax():
    """Conjugate: the lml and its gradient by the mixing W and the noise
    raws; Poisson CVI with `UnitLowerMixing`: the ELBOs of two steps."""
    t, Y, counts, W = vf.lmc_inputs()
    jm = mg.shift_raws(mg.jax_lmc(t, Y, W))
    lml, grads = mg.lml_and_raw_grads(jm)
    pm = vf.lmc_model(t, Y, W, torch.float64, "cpu", parallel=True)
    load_numpy_params(pm, mg.leaves(jm))
    val = pm.log_marginal_likelihood()
    val.backward()
    assert rel(val, lml) <= TOL
    named = dict(pm.named_parameters())
    for key, g in grads.items():
        assert rel(named[vf._jax_name(key)].grad, g) <= TOL, key
    jc = mg.shift_raws(mg.jax_lmc_cvi(t, counts))
    pc = vf.lmc_cvi_model(t, counts, torch.float64, "cpu")
    load_numpy_params(pc, mg.leaves(jc))
    step = jax.jit(lambda m: m.step_with_elbo(0.8))
    for _ in range(2):
        jc, elbo = step(jc)
        pc, pelbo = pc.step_with_elbo(0.8)
        assert rel(pelbo, elbo) <= TOL
    assert type(pc).__name__ == "CVIGP" and type(pm).__name__ == "StateSpaceGP"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tria_above_the_kernel(monkeypatch, device):
    """`tria` at [2, 100, 200] (the Helmholtz square-root pre-arrays at
    D = 100, above the LQ kernel's d <= 80): the library QR, never the
    kernel's wrapper; L Lᵀ = B Bᵀ, diagonal >= 0, and a finite gradient.
    On the card each call counts once on the "lq" wrapper's "library"
    route; on the CPU nothing is counted."""
    from physs_gp_tpu_torch.ops import cuda as kernels
    from physs_gp_tpu_torch.ops import sqrt_kalman

    def refuse(B):
        raise AssertionError(f"batch_tria called at {tuple(B.shape)}")

    monkeypatch.setattr(sqrt_kalman, "batch_tria", refuse)
    B = torch.as_tensor(np.random.default_rng(5).normal(size=(2, 100, 200)), **F64).to(device)
    B.requires_grad_(True)
    kernels.reset_launch_counts()
    for full_rank in (False, True):
        L = sqrt_kalman.tria(B, assume_full_rank=full_rank)
        gram = B @ B.transpose(-1, -2)
        assert float((L @ L.transpose(-1, -2) - gram).abs().max() / gram.abs().max()) <= 1e-13
        assert torch.all(torch.diagonal(L, dim1=-2, dim2=-1) >= 0) and torch.all(torch.triu(L, 1) == 0)
        (g,) = torch.autograd.grad(L.sum(), B)
        assert torch.isfinite(g).all()
    on_card = torch.device(device).type == "cuda"
    assert kernels.route_counts("lq") == ({"lq": {"warp": 0, "block": 0, "library": 2}} if on_card else {})
    assert kernels.launch_counts("lq") == {"lq": 0}


def test_tria_above_the_kernel_takes_the_library_qr(monkeypatch):
    _tria_above_the_kernel(monkeypatch, "cpu")


@pytest.mark.cuda
def test_cuda_tria_above_the_kernel_takes_the_library_qr(monkeypatch, cuda):
    _tria_above_the_kernel(monkeypatch, cuda)

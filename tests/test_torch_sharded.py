"""PyTorch port: time-axis sharding against the JAX package's sharded path.

`parallel/sharded.py` (both forms, chunked and not, a time-varying H, the
composite dp x t mode), the runner's mesh branch and `_pad_amount`,
`StateSpaceGP(mesh=)` and its lml gradient, `CVIGP.init(mesh=)` with a step
and a `natgrad_scan`, and `matheron_state_samples_given(mesh=)` (fed the
JAX key's draws and held to the JAX package's unsharded samples for that
key). Each rank holds its segment of the series: its rows of every result
are held to the same rows of the JAX output, every result, site and input
array of a rank has its segment's rows, no global view is gathered on the
lml, gradient and step paths, and a segment's LGSSM equals the same rows
of the whole series' build bit for bit.

The JAX side runs the JAX package's own sharded functions on the conftest's
8-virtual-device mesh, on as many devices as the port has ranks; gradients
come from JAX's single-device `jax.grad` (which `tests/test_sharded.py`
holds equal to the sharded one). The port side runs 4 gloo CPU ranks, one
spawn for the module (`tests/sharded_ranks.py`, at most SPAWN_TIMEOUT_S
seconds, started by the first test and collected after its JAX side), fed
the same numpy inputs: the 2-rank cases run on the "t" dimension of a
(2, 2) mesh. Every rank's results are checked. Tolerances are `tests/test_sharded.py`'s: lml 1e-9, filtered
means 1e-7, covariances 1e-6, smoothed means 1e-6, smoothed covariances
1e-5, gradients 1e-8.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from physs_gp_tpu.kernels import Matern32 as JMatern32  # noqa: E402
from physs_gp_tpu.kernels import Matern52 as JMatern52  # noqa: E402
from physs_gp_tpu.likelihoods import Gaussian as JGaussian  # noqa: E402
from physs_gp_tpu.likelihoods import Poisson as JPoisson  # noqa: E402
from physs_gp_tpu.models import CVIGP as JCVIGP  # noqa: E402
from physs_gp_tpu.models import StateSpaceGP as JSSGP  # noqa: E402
from physs_gp_tpu.ops.lgssm import build_lgssm as jbuild_lgssm  # noqa: E402
from physs_gp_tpu.ops.runner import _pad_amount as jpad_amount  # noqa: E402
from physs_gp_tpu.ops.sampling import matheron_state_samples as jmatheron  # noqa: E402
from physs_gp_tpu.trainers.scan import natgrad_scan as jnatgrad_scan  # noqa: E402
from physs_gp_tpu.parallel.sharded import sharded_filter_smoother as jsharded  # noqa: E402
from physs_gp_tpu.parallel.sharded import sharded_sqrt_filter_smoother as jsharded_sqrt  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpositive  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32, Matern52  # noqa: E402
from physs_gp_tpu_torch.ops.lgssm import build_lgssm  # noqa: E402
from physs_gp_tpu_torch.ops.matrix import safe_cholesky, safe_cholesky_rel  # noqa: E402
from physs_gp_tpu_torch.ops.runner import _pad_amount  # noqa: E402
from physs_gp_tpu_torch.parallel.dryrun import RTOL  # noqa: E402
from physs_gp_tpu_torch.parallel.ranks import start_ranks  # noqa: E402
from physs_gp_tpu_torch.parallel.sharded import Segment  # noqa: E402

import sharded_ranks  # noqa: E402

F64 = dict(dtype=torch.float64)
SPAWN_TIMEOUT_S = 240.0
PASS_TOL = {"lml": (1e-9, 0.0), "fms": (1e-7, 1e-10), "fPs": (1e-6, 1e-10), "sms": (1e-6, 1e-9),
            "sPs": (1e-5, 1e-9)}
EQ_CASES = [(2, None), (4, 16), (4, None)]
GRAD_AT = 0.1  # the log-lengthscale of the gradient test
MATHERON_KEY = jax.random.PRNGKey(2)


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("t",))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lgssm(kernel, t):
    """The LGSSM arrays (numpy) of a port kernel over times t."""
    ssm = build_lgssm(kernel, torch.tensor(t, **F64))
    return {k: _np(getattr(ssm, k)) for k in ("A", "Q", "H", "m0", "P0")}


# ---------------------------------------------------------------------------
# inputs (numpy, from seeds; the LGSSMs as the port builds them)
# ---------------------------------------------------------------------------


def _pass_inputs(sqrt, tv_H=False):
    """The sharding tests' series: T = 128 on [0, 10], Matérn-5/2 (0.7, 1.2),
    noise 0.05, a missing value; with tv_H a random [T, 2, d] H."""
    rng = np.random.default_rng(4 if tv_H else 0)
    T = 128
    t = np.sort(rng.uniform(0, 10, T))
    a = _lgssm(Matern52(lengthscale=0.7, variance=1.2, **F64), t)
    if tv_H:
        p = 2
        H = rng.normal(size=(T, p, 3)) * 0.5
        y = np.einsum("tpd,d->tp", H, np.ones(3)) + 0.1 * rng.normal(size=(T, p))
        y[3, 0] = np.nan
    else:
        p, H = 1, a["H"]
        y = (np.sin(2 * t) + 0.1 * rng.normal(size=T))[:, None]
        y[5] = np.nan
    a.update(H=H, y=y, R=np.broadcast_to(0.05 * np.eye(p), (T, p, p)).copy())
    if sqrt:
        a.update({k: _np(safe_cholesky_rel(torch.tensor(a[k]))) for k in ("Q", "R", "P0")})
    return a


def _cvi_inputs():
    """Poisson counts on 102 times (not a multiple of 4: the runner pads)."""
    rng = np.random.default_rng(3)
    t = np.sort(rng.uniform(0, 12, 102))
    return t, rng.poisson(np.exp(np.sin(t))).astype(np.float64)[:, None]


def _loaded_sites():
    """Sites of the whole 102-step series in the JAX package's layout (Y
    [T, 1], V [T, 1, 1]), from a seed."""
    rng = np.random.default_rng(5)
    return {"site_Y": rng.normal(size=(102, 1)), "site_V": rng.uniform(0.5, 2.0, (102, 1, 1))}


def _predict_inputs():
    """10 new times over the CVI series' span and the draws of 2 samples on
    its augmented grid (112 steps, Matérn-3/2: d = 2)."""
    rng = np.random.default_rng(6)
    return {"t_new": np.sort(rng.uniform(0, 12, 10)), "eps_x": rng.normal(size=(112, 2, 2)),
            "eps_y": rng.normal(size=(2, 112, 1))}


def _composite_inputs(sqrt):
    """Two series of 32 steps (Matérn-3/2, noise 0.1, one missing value),
    batched; the square-root form takes jittered Cholesky factors."""
    B, T = 2, 32
    rng = np.random.default_rng(9)
    t = np.sort(rng.uniform(0, 10, (B, T)), axis=1)
    y = rng.normal(size=(B, T, 1))
    y[0, 5, 0] = np.nan
    ssms = [_lgssm(Matern32(lengthscale=1.0, **F64), t[b]) for b in range(B)]
    R = np.broadcast_to(0.1 * np.eye(1), (B, T, 1, 1)).copy()
    fac = (lambda x: _np(safe_cholesky(torch.tensor(x)))) if sqrt else (lambda x: x)
    a = {k: np.stack([s[k] for s in ssms]) for k in ("A", "Q", "m0", "P0")}
    a.update(Q=fac(a["Q"]), P0=fac(a["P0"]), H=ssms[0]["H"], R=fac(R), y=y)
    return a, t


def _matheron_inputs():
    """`tests/test_torch_sampling.py`'s series (T = 24, one missing value)
    and the S = 3 sets of prior and noise draws that MATHERON_KEY gives the
    JAX package's `matheron_state_samples`."""
    T, S = 24, 3
    t = np.sort(np.random.default_rng(2).uniform(0, 4.0, T))
    y = np.sin(1.3 * t) + 0.3 * np.random.default_rng(2).normal(size=T)
    y[5] = np.nan
    R = np.broadcast_to(0.1 * np.eye(1), (T, 1, 1)).copy()
    k_x, k_y = jax.random.split(MATHERON_KEY)
    eps_x = np.asarray(jax.random.normal(k_x, (T, S, 3), jnp.float64))
    eps_y = np.asarray(jax.random.normal(k_y, (S, T, 1), jnp.float64))
    return t, R, y[:, None], eps_x, eps_y


def _grad_inputs():
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(0, 5, 128))
    return t, np.sin(2 * t) + 0.1 * rng.normal(size=128)


def _cases():
    """The port's cases: (name, function of `sharded_ranks`, mesh, inputs)."""
    t, y = _grad_inputs()
    cvi_t, cvi_y = _cvi_inputs()
    mt, mR, my, ex, ey = _matheron_inputs()
    cases = [(f"pass {n} {chunk} {sqrt}", "case_pass", "t4" if n == 4 else "dp2 t2",
              dict(arrays=_pass_inputs(sqrt), sqrt=sqrt, chunk=chunk))
             for n, chunk in EQ_CASES for sqrt in (False, True)]
    cases += [("tvH", "case_pass", "t4", dict(arrays=_pass_inputs(False, tv_H=True), sqrt=False,
                                              chunk=8))]
    cases += [(f"grad {sqrt}", "case_grad", "t4",
               dict(t=t, y=y, log_ls=GRAD_AT, noise=0.05, sqrt=sqrt)) for sqrt in (False, True)]
    cases += [("cvi", "case_cvi", "t4", dict(t=cvi_t, y=cvi_y, sqrt=False))]
    cases += [("natgrad3", "case_cvi", "t4", dict(t=cvi_t, y=cvi_y, sqrt=False, steps=3))]
    cases += [("load", "case_load", "t4", dict(t=cvi_t, y=cvi_y, **_loaded_sites()))]
    cases += [("predict", "case_predict", "t4", dict(t=cvi_t, y=cvi_y, **_predict_inputs()))]
    for sqrt in (False, True):
        a, t2 = _composite_inputs(sqrt)
        cases += [(f"composite {sqrt}", "case_composite", "dp2 t2",
                   dict(arrays=a, sqrt=sqrt, t2=t2, y2=a["y"]))]
    cases += [(f"matheron {sqrt}", "case_matheron", "t4",
               dict(t=mt, R=mR, y=my, eps_x=ex, eps_y=ey, sqrt=sqrt, chunk=None))
              for sqrt in (False, True)]
    cases += [("dryrun", "case_dryrun", "t4", {})]
    return cases


@pytest.fixture(scope="module")
def port():
    """The 4 ranks' outputs: started here, collected by `port.wait()` (each
    rank's {case: output}, in rank order)."""
    return start_ranks(sharded_ranks.run_cases, 4, args=(_cases(),), device="cpu",
                       timeout=SPAWN_TIMEOUT_S)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _mine(x, out, dim=0):
    """The rank's rows [lo, hi) of a whole series' x (numpy) along `dim`."""
    return np.take(np.asarray(x), np.arange(out["lo"], out["hi"]), axis=dim)


# ---------------------------------------------------------------------------
# the sharded pass against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,chunk", EQ_CASES)
@pytest.mark.parametrize("sqrt", [False, True])
def test_sharded_pass_matches_jax(port, n, chunk, sqrt):
    """lml, filtered and smoothed moments of the sharded pass on n ranks
    equal the JAX package's sharded pass on n devices."""
    a = _pass_inputs(sqrt)
    fn = jsharded_sqrt if sqrt else jsharded
    mesh = _jmesh(n)
    f, s = jax.jit(lambda *x: fn(*x, mesh=mesh, axis="t", chunk_size=chunk))(
        *[jnp.asarray(a[k]) for k in ("A", "Q", "H", "R", "y", "m0", "P0")])
    want = {"lml": f.lml, "fms": f.ms, "fPs": f.Ps, "sms": s.ms, "sPs": s.Ps}
    for rank, out in enumerate(port.wait()):
        got = out[f"pass {n} {chunk} {sqrt}"]
        for k, (rtol, atol) in PASS_TOL.items():
            w = _np(want[k]) if k == "lml" else _mine(want[k], got)
            _close(got[k], w, rtol, atol, f"rank {rank}: {k}")


def test_sharded_time_varying_H(port):
    """A time-varying H [T, p, d] shards with the time axis (4 ranks, chunk
    8)."""
    a = _pass_inputs(False, tv_H=True)
    mesh = _jmesh(4)
    f, s = jax.jit(lambda *x: jsharded(*x, mesh=mesh, axis="t", chunk_size=8))(
        *[jnp.asarray(a[k]) for k in ("A", "Q", "H", "R", "y", "m0", "P0")])
    want = {"lml": f.lml, "fms": f.ms, "fPs": f.Ps, "sms": s.ms, "sPs": s.Ps}
    for rank, out in enumerate(port.wait()):
        got = out["tvH"]
        for k, (rtol, atol) in PASS_TOL.items():
            w = _np(want[k]) if k == "lml" else _mine(want[k], got)
            _close(got[k], w, rtol, atol, f"rank {rank}: {k}")


_JAX_GRAD = []


def _jax_grad():
    """JAX's single-device d lml / d log-lengthscale (computed once)."""
    if not _JAX_GRAD:
        t, y = _grad_inputs()

        def lml(log_ls):
            m = JSSGP(t=jnp.asarray(t), Y=jnp.asarray(y)[:, None],
                      kernel=JMatern52(lengthscale=jnp.exp(log_ls)),
                      likelihood=JGaussian(jpositive(0.05)))
            return m.log_marginal_likelihood()

        _JAX_GRAD.append(float(jax.jit(jax.grad(lml))(jnp.asarray(GRAD_AT))))
    return _JAX_GRAD[0]


@pytest.mark.parametrize("sqrt", [False, True])
def test_lml_gradient_every_rank(port, sqrt):
    """d lml / d log-lengthscale of `StateSpaceGP(mesh=)` in either form on
    every one of 4 ranks equals JAX's single-device gradient and the port's
    own."""
    want = _jax_grad()
    for rank, out in enumerate(port.wait()):
        got = out[f"grad {sqrt}"]
        _close(got["sharded"], want, 1e-8, 0.0, f"rank {rank}: against JAX")
        _close(got["sharded"], got["single"], 1e-8, 0.0, f"rank {rank}: against one device")


def test_cvi_step_with_mesh_matches_jax(port):
    """One Poisson `CVIGP.step_with_elbo` through the mesh-routed surrogate
    pass (T = 102, padded to the mesh) equals the JAX model on a 4-device
    mesh: ELBO and sites."""
    t, y = _cvi_inputs()
    model = JCVIGP.init(jnp.asarray(t), jnp.asarray(y), JMatern32(lengthscale=1.0, variance=1.0),
                        JPoisson(), mesh=_jmesh(4))
    m1, elbo = jax.jit(lambda m: m.step_with_elbo(0.5))(model)
    for rank, out in enumerate(port.wait()):
        got = out["cvi"]
        _close(got["elbo"], float(elbo), 1e-8, 0.0, f"rank {rank}: ELBO")
        _close(got["site_V"], _mine(m1.sites.V, got), 1e-6, 1e-10, f"rank {rank}: site V")
        _close(got["site_Y"], _mine(m1.sites.Y, got), 1e-6, 1e-10, f"rank {rank}: site Y")


def test_natgrad_scan_with_mesh_matches_jax(port):
    """Three `natgrad_scan` steps of the Poisson `CVIGP` with a 4-rank mesh
    (T = 102: the last rank's segment padded) equal the JAX package's
    single-device `natgrad_scan`: ELBOs rtol 1e-9, the rank's sites 1e-7."""
    t, y = _cvi_inputs()
    model = JCVIGP.init(jnp.asarray(t), jnp.asarray(y), JMatern32(lengthscale=1.0, variance=1.0),
                        JPoisson())
    m3, elbos = jax.jit(lambda m: jnatgrad_scan(m, 0.5, n_steps=3))(model)
    for rank, out in enumerate(port.wait()):
        got = out["natgrad3"]
        _close(got["elbo"], _np(elbos), 1e-9, 0.0, f"rank {rank}: ELBOs")
        _close(got["site_V"], _mine(m3.sites.V, got), 1e-7, 1e-12, f"rank {rank}: site V")
        _close(got["site_Y"], _mine(m3.sites.Y, got), 1e-7, 1e-12, f"rank {rank}: site Y")


@pytest.mark.parametrize("sqrt", [False, True])
def test_composite_dp_t_matches_jax(port, sqrt):
    """Composite dp x t on a 2 x 2 mesh: per-series lml and smoothed means
    equal the JAX composite pass; the kernel gradient of the composite
    objective is finite, non-zero and equal to the series run one by one."""
    a, _ = _composite_inputs(sqrt)
    fn = jsharded_sqrt if sqrt else jsharded
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "t"))
    f, s = jax.jit(lambda *x: fn(*x, mesh=mesh, axis="t", batch_axis="dp"))(
        *[jnp.asarray(a[k]) for k in ("A", "Q", "H", "R", "y", "m0", "P0")])
    for rank, out in enumerate(port.wait()):
        got = out[f"composite {sqrt}"]
        mine = slice(got["b0"], got["b0"] + got["Bl"])
        _close(got["lml"], _np(f.lml)[mine], 1e-8, 0.0, f"rank {rank}: lml")
        _close(got["sms"], _mine(_np(s.ms)[mine], got, 1), 1e-6, 1e-9,
               f"rank {rank}: smoothed means")
        assert np.all(np.isfinite(got["grad"])) and np.abs(got["grad"]).sum() > 0
        _close(got["value"], got["value_single"], 1e-9, 0.0, f"rank {rank}: value")
        _close(got["grad"], got["grad_single"], 1e-8, 0.0, f"rank {rank}: gradient")


@pytest.mark.parametrize("sqrt", [False, True])
def test_matheron_samples_with_mesh(port, sqrt):
    """`matheron_state_samples_given(mesh=)` on 4 ranks, fed the draws that
    MATHERON_KEY gives, equals the JAX package's unsharded
    `matheron_state_samples` for that key (its sequential form, which
    compiles in a third of the parallel one's time and gives the same
    samples; rtol 1e-9, as `tests/test_torch_sampling.py`), and the port's
    samples without the mesh. (The JAX package's own
    `matheron_state_samples(mesh=)` is no reference here: on the virtual CPU
    mesh its compiled program gives prior paths for a key that differ from
    its unsharded ones, 1.8 apart at T = 24 for key 2.)"""
    t, R, y, _, _ = _matheron_inputs()
    jssm = jbuild_lgssm(JMatern52(lengthscale=0.7, variance=1.3), jnp.asarray(t))
    want = np.asarray(jax.jit(lambda: jmatheron(MATHERON_KEY, jssm, jnp.asarray(R), jnp.asarray(y),
                                                3, parallel=False, sqrt=sqrt))())
    scale = np.max(np.abs(want))
    for rank, out in enumerate(port.wait()):
        got = out[f"matheron {sqrt}"]
        mine = _mine(want, got, 1)
        assert got["sharded"].shape == mine.shape, f"rank {rank}: {got['sharded'].shape}"
        assert np.max(np.abs(got["sharded"] - mine)) <= 1e-9 * scale, f"rank {rank}: against JAX"
        assert np.max(np.abs(got["sharded"] - _mine(got["single"], got, 1))) <= 1e-9 * scale, \
            f"rank {rank}"


def test_dryrun_checks_on_four_ranks(port):
    """The dryrun's checks (`parallel/dryrun.py`: lml value and gradient, a
    CVI step, three `natgrad_scan` steps, a config-5 step, the composite
    value and gradient, part 2's stacked series over the ("dp",) mesh)
    agree with each rank's single-device run."""
    for rank, out in enumerate(port.wait()):
        res = out["dryrun"]
        assert {"composite value", "composite grad", "config5 step", "dp-vmap elbos",
                "dp-vmap total"} <= set(res)
        for name, (got, ref) in res.items():
            assert np.all(np.isfinite(got)), f"rank {rank}: {name}"
            _close(got, ref, RTOL, 0.0, f"rank {rank}: {name}")


# ---------------------------------------------------------------------------
# what a rank holds and exchanges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,T,n", [(f"pass {n} {chunk} {sqrt}", 128, n)
                                      for n, chunk in EQ_CASES for sqrt in (False, True)]
                         + [("tvH", 128, 4), ("cvi", 102, 4), ("natgrad3", 102, 4)]
                         + [("load", 102, 4)])
def test_every_rank_holds_its_segment(port, case, T, n):
    """Every rank's inputs, results, sites and built LGSSM have its
    segment's rows: T / n (T = 102 on 4 ranks: 26, the last rank's 24 real
    rows of its padded 26), the segments tiling the series in rank order."""
    L = -(-T // n)
    his = []
    for rank, out in enumerate(port.wait()):
        got = out[case]
        k = rank if n == 4 else rank % 2  # n = 2: the "t" index on the (2, 2) mesh
        assert (got["lo"], got["hi"]) == (k * L, min((k + 1) * L, T)), f"rank {rank}"
        assert set(got["rows"]) == {got["hi"] - got["lo"]}, f"rank {rank}: rows {got['rows']}"
        his.append(got["hi"])
    assert his[-1] == T


def test_loading_the_whole_series_sites_keeps_the_rank_rows(port):
    """`load_numpy_params` of the whole series' sites into a meshed `CVIGP`
    keeps the rank's rows of them (T = 102 on 4 ranks)."""
    want = _loaded_sites()
    for rank, out in enumerate(port.wait()):
        got = out["load"]
        for k in ("site_Y", "site_V"):
            np.testing.assert_array_equal(got[k], _mine(want[k], got), err_msg=f"rank {rank}: {k}")


def test_outputs_to_a_user_gather_over_the_series(port):
    """With a mesh, a CVI model's `posterior()`, `predict_f` at new times
    and `sample_f_given` there (each rank holding its segment of the sites,
    the augmented grid sharded too) equal the model's without one on every
    rank: posterior and prediction rtol 1e-9, draws 1e-9 of their scale."""
    for rank, out in enumerate(port.wait()):
        got, ref = out["predict"]["sharded"], out["predict"]["single"]
        for k in ("post_mean", "post_var", "mean", "var"):
            assert got[k].shape == ref[k].shape, f"rank {rank}: {k}"
            _close(got[k], ref[k], 1e-9, 1e-12, f"rank {rank}: {k}")
        scale = np.max(np.abs(ref["draws"]))
        assert got["draws"].shape == ref["draws"].shape == (2, 10, 1)
        assert np.max(np.abs(got["draws"] - ref["draws"])) <= 1e-9 * scale, f"rank {rank}: draws"


def test_no_global_view_on_the_lml_gradient_and_step_paths(port):
    """Over an lml and its gradient (`StateSpaceGP(mesh=)`), a CVI step and
    three `natgrad_scan` steps, no rank gathers results ("results" 0
    bytes); the passes exchange their totals."""
    for rank, out in enumerate(port.wait()):
        for case in ("grad False", "grad True", "cvi", "natgrad3"):
            ex = out[case]["exchange"]
            assert ex.get("results", {"bytes": 0})["bytes"] == 0, f"rank {rank} {case}: {ex}"
            assert ex["totals"]["calls"] > 0, f"rank {rank} {case}: {ex}"


def _tv_model():
    """A spatio-temporal kernel (Matérn-3/2 x RBF over 3 sites, d = 6) and a
    `StateObservation` whose scattered head has 2 points a step: a
    time-varying H [T, 2, 6]; T = 30 times."""
    from physs_gp_tpu_torch.kernels.rbf import RBF
    from physs_gp_tpu_torch.kernels.spatio_temporal import SpatioTemporalKernel
    from physs_gp_tpu_torch.transforms.operators import ScatteredSpatialHead, StateObservation
    from physs_gp_tpu_torch.utils.params import positive_param

    rng = np.random.default_rng(7)
    T = 30
    t = torch.tensor(np.sort(rng.uniform(0, 5, T)), **F64)
    kern = SpatioTemporalKernel(k_time=Matern32(lengthscale=0.8, variance=1.1, **F64),
                                k_space=RBF(lengthscales=positive_param(0.6, **F64),
                                            variance=positive_param(1.0, **F64)),
                                Z=torch.tensor(rng.uniform(0, 1, (3, 2)), **F64))
    obs = StateObservation([ScatteredSpatialHead(torch.tensor(rng.uniform(0, 1, (T, 2, 2)), **F64))])
    return t, kern, obs


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("sqrt", [False, True])
def test_segment_lgssm_equals_rows_of_the_whole_build(n, sqrt):
    """`build_lgssm(seg=)` and `StateObservation.H(steps=)` on each of n
    segments of a 30-step series (the last one short) equal the same rows
    of the whole series' build bit for bit: A, Q, the time-varying H and
    its variance correction; in square-root form also the factors of Q
    that the runner takes per segment."""
    t, kern, obs = _tv_model()
    T = t.shape[0]
    whole = build_lgssm(kern, t)
    H, corr = obs.H(kern), obs.var_correction(kern)
    assert H.shape == (T, 2, 6)
    L = -(-T // n)
    for k in range(n):
        seg = Segment(T, k * L, min((k + 1) * L, T), L)
        rows = slice(seg.lo, seg.hi)
        part = build_lgssm(kern, t, seg)
        pairs = {"A": (part.A, whole.A[rows]), "Q": (part.Q, whole.Q[rows]),
                 "H": (obs.H(kern, rows), H[rows]),
                 "corr": (obs.var_correction(kern, rows), corr[rows]),
                 "m0": (part.m0, whole.m0), "P0": (part.P0, whole.P0)}
        if sqrt:
            pairs["Q factor"] = (safe_cholesky_rel(part.Q), safe_cholesky_rel(whole.Q)[rows])
        for name, (got, want) in pairs.items():
            assert got.shape == want.shape and torch.equal(got, want), f"segment {k}: {name}"


# ---------------------------------------------------------------------------
# the runner's padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,chunk,n", [(1001, 125, 8), (1000, 125, 8), (100, None, 8),
                                       (256, 64, 4), (257, 64, 4), (100, 30, 1), (30, 64, 1)])
def test_pad_amount_matches_jax(T, chunk, n):
    """`_pad_amount` equals the JAX package's, including the T = 1001,
    chunk 125, 8-shard edge, and leaves segments that divide by the chunk."""
    pad = _pad_amount(T, chunk, n_shards=n)
    assert pad == jpad_amount(T, chunk, n_shards=n)
    seg = (T + pad) // n
    assert (T + pad) % n == 0
    assert chunk is None or seg <= chunk or seg % chunk == 0

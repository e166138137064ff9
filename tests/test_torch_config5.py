"""PyTorch port: the config-5 CVI slice against the JAX package.

Module checks (Matérn-3/2 A and Q, RBF K_op, Kzz, the head rows of
StateObservation.H, conditional variance corrections, the Positive
bijector), then the whole slice: `build_config5(256, 64, float64)` on both
sides, the port's leaves loaded from the JAX model through
`interop.load_numpy_params`, 3 `natgrad_scan` steps at lr 0.5. ELBOs agree
to rtol 1e-9, final sites and the posterior to rtol 1e-7 (measured: ~1e-15
and ~4e-13). The committed golden file is checked against both packages.
The square-root slice (`sqrt=True`) is held to its own golden file with the
same tolerances; its reference run takes the TPU branch of the JAX
smoother's `_factor_psd` (the pivot-floored Cholesky without jitter), which
the port follows on every device. With `PHYSS_FUSED_COMBINE=1` the
covariance slice runs its scans through the fused combines and is held to
the same golden file at the same tolerances: fused and unfused are one
function.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.kernels import Matern32 as JMatern32  # noqa: E402
from physs_gp_tpu.kernels.rbf import RBF as JRBF  # noqa: E402
from physs_gp_tpu.trainers import natgrad_scan as jscan  # noqa: E402
from physs_gp_tpu.transforms import operators as jops  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpositive  # noqa: E402
from physs_gp_tpu.zoo.bench_configs import build_config5 as jbuild  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.trainers.scan import natgrad_scan as tscan  # noqa: E402
from physs_gp_tpu_torch.transforms import operators as tops  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.bench_configs import build_config5 as tbuild  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "config5_T256_golden.npz")
GOLDEN_SQRT = os.path.join(REPO, "tests", "data", "config5_sqrt_T256_golden.npz")
STEP0_ELBO = -199098.6309421814  # JAX, CPU, float64, both scan schedules
T, CHUNK = 256, 64


def _close(a, b, rtol, atol=0.0):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _jax_leaves(model):
    """The JAX model's parameter and data leaves by key path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(model)[0]:
        key = jax.tree_util.keystr(path)
        if key.endswith(".raw") or key in (".t", ".Y", ".kernel.Z", ".sites.Y", ".sites.V"):
            out[key] = np.asarray(leaf)
    return out


def _port_model(jmodel, sqrt=False):
    model = tbuild(T, CHUNK, dtype=torch.float64, sqrt=sqrt, device="cpu")
    load_numpy_params(model, _jax_leaves(jmodel))
    return model


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def test_positive_bijector_matches_jax():
    for v in (1e-3, 0.1, 0.5, 5.0):
        jp, tp = jpositive(jnp.asarray(v, jnp.float64)), positive_param(v, dtype=torch.float64)
        _close(tp.raw, jp.raw, 1e-14)
        _close(tp.value, jp.value, 1e-15)
    p = positive_param(1.0).fix()
    assert p.fixed and not p.raw.requires_grad


def test_matern32_transition_and_noise():
    dt = np.concatenate([[0.0], np.random.default_rng(0).exponential(0.4, 50)])
    jk = JMatern32(lengthscale=jnp.asarray(5.0), variance=jnp.asarray(1.3))
    tk = Matern32(lengthscale=5.0, variance=1.3, dtype=torch.float64)
    dtt = torch.from_numpy(dt)
    _close(tk.transition(dtt), jk.transition(jnp.asarray(dt)), 1e-13, 1e-15)
    _close(tk.noise_cov(dtt), jk.noise_cov(jnp.asarray(dt)), 1e-12, 1e-15)
    _close(tk.to_ss().Pinf, jk.to_ss().Pinf, 1e-13)


@pytest.mark.parametrize("kind", ["identity", ("grad", 0), ("grad", 1), ("grad2", 1), "laplacian"])
def test_rbf_k_op(kind):
    rng = np.random.default_rng(1)
    S, Z = rng.uniform(size=(7, 2)), rng.uniform(size=(16, 2))
    jk = JRBF(lengthscales=jpositive(jnp.asarray(0.5)), variance=jpositive(jnp.asarray(1.2)))
    tk = RBF(lengthscales=positive_param(0.5, dtype=torch.float64),
             variance=positive_param(1.2, dtype=torch.float64))
    _close(tk.K_op(torch.from_numpy(S), torch.from_numpy(Z), kind),
           jk.K_op(jnp.asarray(S), jnp.asarray(Z), kind), 1e-12, 1e-14)


def test_kzz_observation_rows_and_lgssm():
    jm = jbuild(64, None, dtype=jnp.float64)
    tm = tbuild(64, None, dtype=torch.float64, device="cpu")
    load_numpy_params(tm, _jax_leaves(jm))
    _close(tm.kernel.Kzz(), jax.jit(lambda m: m.kernel.Kzz())(jm), 1e-13)
    jH = jax.jit(lambda m: m.observation.H(m.kernel))(jm)
    _close(tm.observation.H(tm.kernel), jH, 1e-9, 1e-12)
    assert tm.observation.var_correction(tm.kernel) is None
    assert jm.observation.var_correction(jm.kernel) is None
    jl = jax.jit(lambda m: m.kernel.to_lgssm(m.t))(jm)
    tl = tm.kernel.to_lgssm(tm.t)
    for a, b in zip(tl, jl):
        _close(a, b, 1e-12, 1e-15)


@pytest.mark.parametrize("op", [None, "grad", "laplacian"])
def test_conditional_var_correction(op):
    jm = jbuild(8, None, dtype=jnp.float64)
    tm = tbuild(8, None, dtype=torch.float64, device="cpu")
    load_numpy_params(tm, _jax_leaves(jm))
    s = np.random.default_rng(2).uniform(size=(5, 2))
    jop = {None: None, "grad": jops.s_grad(0), "laplacian": jops.s_laplacian}[op]
    top = {None: None, "grad": tops.s_grad(0), "laplacian": tops.s_laplacian}[op]
    for t_order in (0, 1):
        ref = jax.jit(lambda k, x: k.conditional_var_correction(x, jop, t_order))(
            jm.kernel, jnp.asarray(s)
        )
        out = tm.kernel.conditional_var_correction(torch.from_numpy(s), top, t_order)
        _close(out, ref, 1e-8, 1e-10)


def test_operator_without_kind_raises():
    tm = tbuild(8, None, dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError):
        tm.kernel.spatial_weights(tm.kernel.Z, lambda k, s, z: k(s, z))


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------


def _port_run(jmodel, sqrt=False):
    model, elbos = tscan(_port_model(jmodel, sqrt), 0.5, n_steps=3)
    return model, elbos


def _check_against(model, elbos, ref):
    _close(elbos, ref["elbos"], 1e-9)
    _close(model.sites.Y, ref["site_Y"], 1e-7, 1e-12)
    _close(torch.diagonal(model.sites.V, dim1=-2, dim2=-1), ref["site_V_diag"], 1e-7)
    post = model.posterior()
    _close(post.mean, ref["post_mean"], 1e-7, 1e-9)
    _close(post.var, ref["post_var"], 1e-7)


def test_jax_reproduces_golden(monkeypatch):
    monkeypatch.setenv("PHYSS_INNER_SCAN", "blocked")
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    gold = np.load(GOLDEN)
    jm, je = jax.jit(lambda m: jscan(m, 0.5, n_steps=3))(jbuild(T, CHUNK, dtype=jnp.float64))
    post = jax.jit(lambda m: m.posterior())(jm)
    _close(je, gold["elbos"], 1e-12)
    _close(jm.sites.Y, gold["site_Y"], 1e-10, 1e-14)
    _close(post.mean, gold["post_mean"], 1e-10, 1e-12)
    _close(post.var, gold["post_var"], 1e-10)


def test_port_matches_golden_blocked_schedule(monkeypatch):
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    model, elbos = _port_run(jbuild(T, CHUNK, dtype=jnp.float64))
    _close(elbos[0], STEP0_ELBO, 1e-9)
    _check_against(model, elbos, dict(np.load(GOLDEN)))


def test_port_matches_golden_with_fused_combines(monkeypatch):
    from physs_gp_tpu_torch.ops import parallel_kalman as tpk

    calls = []
    fused_filter, fused_smooth = tpk.fc.fused_filtering_combine, tpk.fc.fused_smoothing_combine
    monkeypatch.setattr(tpk.fc, "fused_filtering_combine",
                        lambda ei, ej: calls.append("filter") or fused_filter(ei, ej))
    monkeypatch.setattr(tpk.fc, "fused_smoothing_combine",
                        lambda ej, ei: calls.append("smooth") or fused_smooth(ej, ei))
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    monkeypatch.setenv("PHYSS_FUSED_COMBINE", "1")
    model, elbos = _port_run(jbuild(T, CHUNK, dtype=jnp.float64))
    assert "filter" in calls and "smooth" in calls
    _close(elbos[0], STEP0_ELBO, 1e-9)
    _check_against(model, elbos, dict(np.load(GOLDEN)))


def test_port_matches_jax_default_schedule(monkeypatch):
    """JAX's associative scan (its CPU default) against the port's blocked
    scan."""
    monkeypatch.delenv("PHYSS_INNER_SCAN", raising=False)
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    j0 = jbuild(T, CHUNK, dtype=jnp.float64)
    jm, je = jax.jit(lambda m: jscan(m, 0.5, n_steps=3))(j0)
    post = jax.jit(lambda m: m.posterior())(jm)
    ref = {
        "elbos": je, "site_Y": jm.sites.Y,
        "site_V_diag": jnp.diagonal(jm.sites.V, axis1=-2, axis2=-1),
        "post_mean": post.mean, "post_var": post.var,
    }
    model, elbos = _port_run(j0)
    _close(elbos[0], STEP0_ELBO, 1e-9)
    _check_against(model, elbos, ref)


def test_jax_reproduces_sqrt_golden(monkeypatch):
    import functools

    from physs_gp_tpu.ops import matrix as jmatrix
    from physs_gp_tpu.ops import parallel_sqrt_kalman as jpsk
    from physs_gp_tpu.ops.pallas import batched_chol as jbc

    monkeypatch.setenv("PHYSS_INNER_SCAN", "blocked")
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    # `_factor_psd`'s TPU branch: the Pallas Cholesky, run in interpret mode
    chol = functools.partial(jbc.batch_cholesky.__wrapped__, interpret=True)
    monkeypatch.setattr(jpsk, "_factor_psd", lambda L: chol(jmatrix.symmetrize(L)))
    gold = np.load(GOLDEN_SQRT)
    j0 = jbuild(T, CHUNK, dtype=jnp.float64, sqrt=True)
    jm, je = jax.jit(lambda m: jscan(m, 0.5, n_steps=3))(j0)
    post = jax.jit(lambda m: m.posterior())(jm)
    _close(je, gold["elbos"], 1e-12)
    _close(jm.sites.Y, gold["site_Y"], 1e-10, 1e-14)
    _close(post.mean, gold["post_mean"], 1e-10, 1e-12)
    _close(post.var, gold["post_var"], 1e-10)


def test_port_matches_sqrt_golden(monkeypatch):
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    model, elbos = _port_run(jbuild(T, CHUNK, dtype=jnp.float64, sqrt=True), sqrt=True)
    _check_against(model, elbos, dict(np.load(GOLDEN_SQRT)))


def test_sqrt_slice_takes_no_fused_combine(monkeypatch):
    """The knob acts on the covariance-form scans only: with it set, the
    square-root slice (whose smoother scans in Gram form) calls neither fused
    combine and still gives the golden file's values."""
    from physs_gp_tpu_torch.ops import parallel_kalman as tpk

    calls = []
    monkeypatch.setattr(tpk.fc, "fused_filtering_combine", lambda *a: calls.append("filter"))
    monkeypatch.setattr(tpk.fc, "fused_smoothing_combine", lambda *a: calls.append("smooth"))
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    monkeypatch.setenv("PHYSS_FUSED_COMBINE", "1")
    model, elbos = _port_run(jbuild(T, CHUNK, dtype=jnp.float64, sqrt=True), sqrt=True)
    assert calls == []
    _check_against(model, elbos, dict(np.load(GOLDEN_SQRT)))


def test_build_config5_defaults_to_the_card():
    import inspect

    assert inspect.signature(tbuild).parameters["device"].default == "cuda"


def test_interop_rejects_unknown_paths():
    model = tbuild(8, None, dtype=torch.float64, device="cpu")
    with pytest.raises(KeyError):
        load_numpy_params(model, {".kernel.nope": np.zeros(())})
    with pytest.raises(ValueError):
        load_numpy_params(model, {".kernel.Z": np.zeros((3, 2))})


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['physs_gp_tpu'] = None\n"
        "import physs_gp_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert len(names) >= 25, names\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr

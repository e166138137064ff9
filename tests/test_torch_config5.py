"""PyTorch port: the config-5 CVI slice against the JAX package on the
blocked scan schedule (`config5_parity`): the committed golden file is
checked against both packages, unfused and with `PHYSS_FUSED_COMBINE=1`
(fused and unfused are one function); and the package-level checks (the
Positive bijector, the card as the default device, `load_numpy_params`
refusing unknown paths, the port importing without JAX).

The config-5 parity is split along its three JAX reference runs, so that
the test workers share them: the square-root slice is in
`test_torch_config5_sqrt.py`, the port against JAX's default associative
scan in `test_torch_config5_default.py`; those files also hold the module
checks (with a file's count of tests, the workers take it earlier).
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.trainers import natgrad_scan as jscan  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpositive  # noqa: E402
from physs_gp_tpu.zoo.bench_configs import build_config5 as jbuild  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.bench_configs import build_config5 as tbuild  # noqa: E402
from config5_parity import (CHUNK, GOLDEN, REPO, STEP0_ELBO, T, _check_against, _close,  # noqa: E402
                            _port_run)

torch.set_num_threads(1)


def test_positive_bijector_matches_jax():
    for v in (1e-3, 0.1, 0.5, 5.0):
        jp, tp = jpositive(jnp.asarray(v, jnp.float64)), positive_param(v, dtype=torch.float64)
        _close(tp.raw, jp.raw, 1e-14)
        _close(tp.value, jp.value, 1e-15)
    p = positive_param(1.0).fix()
    assert p.fixed and not p.raw.requires_grad


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

"""PyTorch port: the experiment drivers of `experiments_torch/` on the CPU.

- Every driver at `--quick --iters 2` writes the JAX driver's metric keys
  (`results/*.json`), all finite, with the device it ran on and its gates.
- No driver imports JAX, the JAX package, `experiments` or `scripts`.
- Parity with the JAX drivers, run live at `--quick --cpu` (float64): the
  three deterministic drivers (curl-free, Helmholtz, scattered sensors)
  give their metrics to rtol 1e-8; `ac.py --eval-sites` on the same sites
  gives the JAX driver's posterior moments and NLPD to rtol 1e-7 relative
  to each output's largest magnitude (measured: means 3.3e-8, variances
  2.2e-8, NLPD 1.1e-8; the JAX package's own covariance and square-root
  forms differ by 2.1e-6 on these sites).
- `ac.py --compare --quick --device cpu --iters 1` writes every key of the
  JAX record `results/ac_compare.json`, and its hardware gate, the
  "card" arms on the CPU against the CPU's float32 arm, reads 0.

The runs that meet the outcome gates are the card's (`results/torch/`).
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from experiments_torch import ac, curl_free, helmholtz, monotonic, pendulum, scattered_st  # noqa: E402

# driver -> the name of its result file (the JAX record's)
DRIVERS = {pendulum: "pendulum", monotonic: "monotonic", curl_free: "curl_free",
           helmholtz: "helmholtz_st", scattered_st: "scattered_st", ac: "ac"}
PARITY_RTOL = 1e-8
# `--eval-sites`: the largest difference over the largest value
AC_EVAL_RTOL = {"mean": 1e-9, "var": 1e-7, "rmse_extrap_physics_on": 1e-9,
                "nlpd_extrap_physics_on": 1e-9}


def _jax_driver(tmp_path, script, *extra):
    """The JAX package's driver at `--quick --cpu`; its result dict."""
    out = tmp_path / "jax"
    r = subprocess.run([sys.executable, os.path.join(REPO, "experiments", f"{script}.py"), "--quick",
                        "--cpu", *extra, "--out", str(out)],
                       cwd=REPO, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-3000:]
    (path,) = out.glob("*.json")
    return json.loads(path.read_text())


@pytest.mark.parametrize("driver", list(DRIVERS), ids=list(DRIVERS.values()))
def test_driver_writes_the_jax_metric_keys(tmp_path, driver):
    name = DRIVERS[driver]
    res = driver.main(["--quick", "--device", "cpu", "--iters", "2", "--out", str(tmp_path)])
    with open(os.path.join(REPO, "results", f"{name}.json")) as f:
        jax_keys = set(json.load(f)["metrics"])
    with open(tmp_path / f"{name}.json") as f:
        saved = json.load(f)
    assert saved["metrics"] == pytest.approx(res["metrics"])
    assert jax_keys <= set(saved["metrics"])
    assert all(math.isfinite(v) for v in saved["metrics"].values())
    assert saved["meta"]["device"] == {"platform": "cpu"}
    assert set(saved["meta"]["launches"]) >= {"bmm", "gj_solve", "lq", "chol"}
    assert set(saved["gates"]) and saved["ok"] == all(saved["gates"].values())
    if driver in (pendulum, monotonic, ac):
        assert saved["config"]["iters"] == 2


def test_drivers_import_without_jax():
    blocked = "".join(f"sys.modules[{m!r}] = None\n"
                      for m in ("jax", "physs_gp_tpu", "experiments", "scripts"))
    code = ("import sys\n" + blocked + "import " + ", ".join(
        f"experiments_torch.{d.__name__.rsplit('.', 1)[-1]}" for d in DRIVERS) + "\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        curl_free.main(["--quick", "--out", str(tmp_path)])


@pytest.mark.parametrize("driver", [curl_free, helmholtz, scattered_st],
                         ids=["curl_free", "helmholtz", "scattered_st"])
def test_deterministic_driver_matches_the_jax_driver(tmp_path, driver):
    script = driver.__name__.rsplit(".", 1)[-1]
    want = _jax_driver(tmp_path, script)["metrics"]
    got = driver.main(["--quick", "--device", "cpu", "--out", str(tmp_path / "port")])["metrics"]
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=PARITY_RTOL), k


def test_ac_eval_sites_matches_the_jax_driver(tmp_path):
    """The same sites (the port's own after 20 steps) through both drivers'
    `--eval-sites` in float64 covariance form."""
    sites = str(tmp_path / "sites.npz")
    ac.main(["--quick", "--device", "cpu", "--iters", "20", "--dump-sites", sites,
             "--out", str(tmp_path / "train")])
    port_npz, jax_npz = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    got = ac.main(["--quick", "--device", "cpu", "--eval-sites", sites, "--dump-moments", port_npz,
                   "--out", str(tmp_path / "port")])
    want = _jax_driver(tmp_path, "ac", "--eval-sites", sites, "--dump-moments", jax_npz)
    a, b = np.load(port_npz), np.load(jax_npz)
    np.testing.assert_array_equal(a["t_later"], b["t_later"])
    for k in ("mean", "var"):
        assert np.max(np.abs(a[k] - b[k])) / np.max(np.abs(b[k])) <= AC_EVAL_RTOL[k], k
    for k in ("rmse_extrap_physics_on", "nlpd_extrap_physics_on"):
        assert got["metrics"][k] == pytest.approx(want["metrics"][k], rel=AC_EVAL_RTOL[k]), k
    assert got["config"]["iters"] == 0 and got["metrics"]["rmse_extrap_physics_off"] is None


def test_ac_compare_writes_every_key(tmp_path):
    res = ac.main(["--compare", "--quick", "--device", "cpu", "--iters", "1",
                   "--out", str(tmp_path)])
    with open(tmp_path / "ac_compare.json") as f:
        saved = json.load(f)
    with open(os.path.join(REPO, "results", "ac_compare.json")) as f:
        jax = json.load(f)
    for part in ("config", "metrics", "meta"):
        assert set(jax[part]) <= set(saved[part]), part
    for part in ("precision_ladder", "cpu", "accel"):
        assert set(jax["metrics"][part]) <= set(saved["metrics"][part]), part
    assert saved["metrics"]["hardware_max_abs_mean_diff"] <= 1e-6
    assert saved["metrics"]["hardware_ok"] and saved["gates"]["hardware"]
    assert set(saved["meta"]["arms"]) == {"cpu", "card-eval", "cpu32-eval", "cpu-bigjit-eval",
                                          "accel"}
    assert saved["meta"]["arms"]["card-eval"]["backend"] == "cpu-fp32-sqrt"
    assert saved["ok"] == res["ok"] == all(saved["gates"].values())

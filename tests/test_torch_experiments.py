"""PyTorch port: the experiment drivers `experiments_torch/pendulum.py` and
`experiments_torch/monotonic.py` on the CPU at `--quick --iters 2`: they
write the JAX drivers' metric keys (`results/*.json`), all finite, with the
device they ran on, and import neither JAX nor the JAX package. The runs
that meet the gates are the card's (`results/torch/*.json`)."""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from experiments_torch import monotonic, pendulum  # noqa: E402


@pytest.mark.parametrize("driver", [pendulum, monotonic], ids=["pendulum", "monotonic"])
def test_driver_writes_the_jax_metric_keys(tmp_path, driver):
    name = driver.__name__.rsplit(".", 1)[-1]
    res = driver.main(["--quick", "--device", "cpu", "--iters", "2", "--out", str(tmp_path)])
    with open(os.path.join(REPO, "results", f"{name}.json")) as f:
        jax_keys = set(json.load(f)["metrics"])
    with open(tmp_path / f"{name}.json") as f:
        saved = json.load(f)
    assert saved["metrics"] == pytest.approx(res["metrics"])
    assert jax_keys <= set(saved["metrics"])
    assert all(math.isfinite(v) for v in saved["metrics"].values())
    assert saved["config"]["iters"] == 2 and saved["meta"]["device"] == {"platform": "cpu"}
    assert set(saved["gates"]) and saved["ok"] == all(saved["gates"].values())


def test_drivers_import_without_jax():
    code = ("import sys\nsys.modules['jax'] = None\nsys.modules['physs_gp_tpu'] = None\n"
            "sys.modules['experiments'] = None\n"
            "import experiments_torch.pendulum, experiments_torch.monotonic\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr

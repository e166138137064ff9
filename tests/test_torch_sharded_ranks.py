"""PyTorch port: the multi-rank launcher and dryrun of the time-sharded path
(`parallel/ranks.py`, `parallel/dryrun.py`), without JAX.

On the CPU: `dryrun_multichip(2, device="cpu")` on two gloo ranks (every
check equal to each rank's single-device run, rtol 1e-8), a rank that raises
fails the call with its traceback, a rank that hangs fails it within the
time limit, and without a card the default device raises instead of falling
back to the CPU; two calls in flight at once each fail with their own
rank's error, though the system hand both the same port. On the card (`cuda`-marked, skipped here):
`dryrun_multichip(2)`, two gloo ranks sharing cuda:0, against the unsharded
run on the card. Run the card case with

    python3 -m pytest --noconftest -m cuda tests/test_torch_sharded_ranks.py
"""
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from physs_gp_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from physs_gp_tpu_torch.parallel.ranks import start_ranks  # noqa: E402

import sharded_ranks  # noqa: E402

HANG_TIMEOUT_S = 8.0
REPO = Path(__file__).resolve().parents[1]


def test_dryrun_multichip_on_two_cpu_ranks():
    res = dryrun_multichip(2, device="cpu", timeout=240.0)
    assert {"lml value", "lml grad", "cvi step", "natgrad_scan 3", "config5 step", "dp-vmap elbos",
            "dp-vmap total"} <= set(res)


def test_a_failed_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        start_ranks(sharded_ranks.fail_on_rank, 2, args=(1,), device="cpu", timeout=240.0).wait()


def test_two_calls_in_flight_keep_apart(monkeypatch):
    """Two calls started together, one failing on rank 1 and one on rank 0,
    each fail with their own rank's error. A port the system has released
    may be handed out again before a rank binds it; here every port that
    Python's sockets report is one released port, so a launcher that took
    its rendezvous port from a released socket would give both calls the
    same one, and the second call's ranks would fail to bind it or meet
    the first call's ranks."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setattr(socket.socket, "getsockname", lambda self: ("127.0.0.1", port))
    calls = {bad: start_ranks(sharded_ranks.fail_on_rank, 2, args=(bad,), device="cpu",
                              timeout=240.0) for bad in (1, 0)}
    monkeypatch.undo()
    for bad, call in calls.items():
        with pytest.raises(RuntimeError, match=f"rank {bad} fails on purpose"):
            call.wait()


def test_a_hung_rank_fails_the_call_within_its_time_limit():
    """The call fails within its limit and names the hung rank 1 among the
    ranks without a result (on a loaded host rank 0 may not have started
    within the limit either)."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] gave no result"):
        start_ranks(sharded_ranks.hang_on_rank, 2, args=(1,), device="cpu",
                    timeout=HANG_TIMEOUT_S).wait()
    assert time.monotonic() - t0 < HANG_TIMEOUT_S + 10.0


def test_sharded_path_imports_without_jax():
    """The time-sharded path (`physs_gp_tpu_torch.parallel`), the rank
    bodies of its tests and `chip_smoke.py` import with JAX and the JAX
    package unavailable."""
    code = ("import sys\nsys.modules['jax'] = None\nsys.modules['physs_gp_tpu'] = None\n"
            "sys.path.insert(0, 'tests')\n"
            "import physs_gp_tpu_torch.parallel.sharded, physs_gp_tpu_torch.parallel.ranks\n"
            "import physs_gp_tpu_torch.parallel.dryrun, sharded_ranks, chip_smoke\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_the_default_device_needs_the_card():
    """`device` defaults to "cuda": without a card the dryrun raises rather
    than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA device"):
        dryrun_multichip(2)


@pytest.mark.cuda
def test_cuda_two_ranks_on_one_card_equal_the_unsharded_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = dryrun_multichip(2, device="cuda", timeout=300.0)
    assert "config5 step" in res

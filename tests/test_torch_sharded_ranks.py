"""PyTorch port: the multi-rank launcher and dryrun of the time-sharded path
(`parallel/ranks.py`, `parallel/dryrun.py`), without JAX.

On the CPU: `dryrun_multichip(2, device="cpu")` on two gloo ranks (every
check equal to each rank's single-device run, rtol 1e-8), a rank that raises
fails the call with its traceback, a rank that hangs fails it within the
time limit, and without a card the default device raises instead of falling
back to the CPU. On the card (`cuda`-marked, skipped here):
`dryrun_multichip(2)`, two gloo ranks sharing cuda:0, against the unsharded
run on the card. Run the card case with

    python3 -m pytest --noconftest -m cuda tests/test_torch_sharded_ranks.py
"""
import time

import pytest

torch = pytest.importorskip("torch")

from physs_gp_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from physs_gp_tpu_torch.parallel.ranks import start_ranks  # noqa: E402

import sharded_ranks  # noqa: E402

HANG_TIMEOUT_S = 8.0


def test_dryrun_multichip_on_two_cpu_ranks():
    res = dryrun_multichip(2, device="cpu", timeout=240.0)
    assert {"lml value", "lml grad", "cvi step", "natgrad_scan 3", "config5 step", "dp-vmap elbos",
            "dp-vmap total"} <= set(res)


def test_a_failed_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        start_ranks(sharded_ranks.fail_on_rank, 2, args=(1,), device="cpu", timeout=240.0).wait()


def test_a_hung_rank_fails_the_call_within_its_time_limit():
    """The call fails within its limit and names the hung rank 1 among the
    ranks without a result (on a loaded host rank 0 may not have started
    within the limit either)."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[(0, )?1\] gave no result"):
        start_ranks(sharded_ranks.hang_on_rank, 2, args=(1,), device="cpu",
                    timeout=HANG_TIMEOUT_S).wait()
    assert time.monotonic() - t0 < HANG_TIMEOUT_S + 10.0


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

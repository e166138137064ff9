"""PyTorch port: the Markov-kernel zoo and the prior mean against
`tests/data/markov_golden.npz` (made by `scripts/port/make_markov_golden.py`
from the JAX package), with no JAX in the process, so the `cuda` cases run
on the card too:

    python3 -m pytest --noconftest -m cuda tests/test_torch_markov_golden.py

Every configuration of `scripts/port/markov_outcome.anchors`, float64 on the
blocked scan schedule: a bare `Periodic`, `Matern32 + Periodic` (a Q block
that is exactly zero) and the quasi-periodic `Matern32 + Periodic *
Matern32` with a `LinearMean` in covariance and square-root form, the four
Wiener kinds, `StreamingGP` on `WienerVelocity` with a mean, `StateSpaceGP`
with a `ConstantMean`, 3 Poisson `CVIGP` steps with a mean, every flow's
`TransformedData`, 3 `UncertainInputLikelihood` CVI steps, and `BatchGP` on
the misc and aggregated kernels: lml, ELBO and means rtol 1e-9, variances
rtol 1e-7 (`markov_outcome.TOL`).
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import markov_outcome as mo  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gold():
    return np.load(mo.GOLDEN)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(res):
    for key, (got, want, tol) in res.items():
        r = mo.relerr(got, want)
        # NaN only where the reference has it (`TransformedData.Z` keeps NaN)
        assert np.all(np.isfinite(got) | np.isnan(want)) and r <= tol, (key, r, tol)


@pytest.mark.parametrize("cfg", mo.CONFIGS)
def test_port_matches_markov_golden(gold, cfg):
    _check(mo.anchors(gold, "cpu", (cfg,))[cfg])


def test_golden_file_is_small_and_complete(gold):
    assert os.path.getsize(mo.GOLDEN) < 200 * 2**10
    assert {k.split("::")[0] for k in gold.files} == set(mo.CONFIGS)


def test_full_model_runs_at_small_length(monkeypatch):
    """The full-length recipe at T = 200 (chunk 100, 8 scan blocks) on the
    CPU: both forms agree on the lml to 1e-9 in float64, predictions are
    finite with positive variances, the state is d = 30."""
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", mo.SCAN_BLOCKS)
    cov = mo.full_run("cpu", torch.float64, False, T=200, chunk=100, n_new=10)
    sqrt = mo.full_run("cpu", torch.float64, True, T=200, chunk=100, n_new=10)
    assert cov["finite"] and sqrt["finite"] and cov["state_dim"] == 30
    assert abs(cov["lml"] - sqrt["lml"]) <= 1e-9 * abs(cov["lml"])
    res = mo.cvi_full("cpu", torch.float64, T=200, chunk=100, steps=2)
    assert res["finite"] and res["elbos"][1] > res["elbos"][0]


def test_entry_points_need_the_card_unless_asked():
    """`device` defaults to "cuda" in the full-length recipes: without a card
    they raise rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        mo.full_run("cuda", torch.float32, False, T=100, chunk=50, n_new=10)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ("per_sum", "qp", "cvi"))
def test_cuda_port_matches_markov_golden(cuda, gold, cfg):
    """The card twins of the d = 16 and d = 30 state-space anchors: every
    launch on the warp kernels."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    kernels.reset_launch_counts()
    _check(mo.anchors(gold, "cuda", (cfg,))[cfg])
    counts, routes = kernels.launch_counts(), kernels.route_counts()
    assert counts["bmm"] > 0 and counts["gj_solve"] > 0, counts
    assert not any(r.get("block") for r in routes.values()), routes

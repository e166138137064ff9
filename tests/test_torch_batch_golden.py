"""PyTorch port: the batch GP family against `tests/data/batch_golden.npz`
(made by `scripts/port/make_batch_golden.py` from the JAX package), with no
JAX in the process, so the `cuda` cases run on the card too:

    python3 -m pytest --noconftest -m cuda tests/test_torch_batch_golden.py

Every configuration of `scripts/port/batch_outcome.anchors` (curl-free,
Helmholtz, `deriv_gp` with NaNs and joint samples, CG fed the JAX probes,
SVGP whitened and unwhitened with one natural-gradient step, the monotonic
batch-VI arm at its quick size for 5 steps, the batch LMC with a constant
mean), float64: values, predictions and gradients rtol 1e-9, CG 1e-8. The
card cases also take the factors of n <= 80 through the Cholesky kernel:
the SVGP factors (M = 10) on its warp route, the curl-free Gram (80) and
the monotonic arm's (M·P = 60) on its block route.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import batch_outcome as bo  # noqa: E402

from experiments_torch import curl_free as cf  # noqa: E402

torch.set_num_threads(1)
CONFIGS = bo.CONFIGS


@pytest.fixture(scope="module")
def gold():
    return np.load(bo.GOLDEN)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(res):
    for key, (got, want, tol) in res.items():
        r = bo.relerr(got, want)
        assert np.all(np.isfinite(got)) and r <= tol, (key, r, tol)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_port_matches_batch_golden(gold, cfg):
    _check(bo.anchor(gold, cfg, "cpu"))


def test_golden_file_is_small_and_complete(gold):
    assert os.path.getsize(bo.GOLDEN) < 2 * 2**20
    assert {k.split("::")[0] for k in gold.files} == set(CONFIGS) | {"mvf"}


def test_monotonic_arm_lands_on_a_jax_run(gold):
    """The batch-VI arm at full size (300 steps) violates no constraint and
    ends with its ELBO within 1e-4 and its `rmse_gap_vgp` within 10 % of
    every JAX float64 run that has locked into its limit cycle."""
    res = bo.monotonic_outcome("cpu", gold)
    assert res["ok"], res


def test_entry_points_need_the_card_unless_asked():
    """`device` defaults to "cuda": without a card the recipes raise rather
    than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    X, Y, _, _ = cf.inputs(quick=True)
    with pytest.raises((RuntimeError, AssertionError)):
        bo.curl_free_gp(X, Y)
    with pytest.raises((RuntimeError, AssertionError)):
        bo.SVGP.init(X, Y, X[:5], bo._rbf(1.0, 1.0, {}), bo.Gaussian())


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS)
def test_cuda_matches_batch_golden(cuda, gold, cfg):
    """The card twin: the same anchor with the Cholesky kernel on the
    routes `CHOL_ROUTES` names."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    kernels.reset_launch_counts()
    res = bo.anchor(gold, cfg, "cuda")
    routes = kernels.route_counts().get("chol", {})
    _check(res)
    assert all(routes.get(r) for r in bo.CHOL_ROUTES[cfg]), routes


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ["sw", "su", "cf", "mv"])
def test_cuda_chol_route_matches_plain(cuda, gold, cfg):
    """The same model on the card (Cholesky kernel) and on the CPU (its
    plain version): ELBO after a natural-gradient step, or lml."""
    out = {}
    for device in ("cpu", "cuda"):
        model, _ = bo.anchor_model(gold, cfg, device)
        with torch.no_grad():
            if cfg == "cf":
                out[device] = bo.numpy(model.log_marginal_likelihood())
            else:
                out[device] = bo.numpy(model.natural_gradient_update(0.5).elbo())
    assert bo.relerr(out["cuda"], out["cpu"]) <= 1e-9

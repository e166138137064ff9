"""PyTorch port: VecchiaGP, GPRN and LatentVariableGP against
`tests/data/vecchia_golden.npz` (made by `scripts/port/make_vecchia_golden.py`
from the JAX package), with no JAX imported at module level, so the `cuda`
cases run on the card too:

    python3 -m pytest --noconftest -m cuda tests/test_torch_vecchia_golden.py

Every configuration of `scripts/port/vecchia_outcome.anchors`, float64:
the Vecchia lml, gradient and predictions at N = 200, m = 12 (with missing
rows and a `ConstantMean` too), the GPRN ELBO, KL, gradient and `predict_f`
of each mixing on the golden file's draws, the LatentVariableGP objective,
gradient and `predict_f` in both modes: lml, ELBO, objective, gradients and
means rtol 1e-9, variances 1e-7. The JAX package is held to the same file
(in a test that imports it), the latents' two-branch separation is checked
on the CPU, and on a card the Gauss-Jordan solve at Vecchia's shape
[4096, 16, 16] with r = 2 is held to its plain version.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import vecchia_outcome as vo  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gold():
    return np.load(vo.GOLDEN)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(res):
    for key, (got, want, tol) in res.items():
        r = vo.relerr(got, want)
        assert np.all(np.isfinite(got)) and r <= tol, (key, r, tol)


@pytest.mark.parametrize("cfg", vo.CONFIGS)
def test_port_matches_vecchia_golden(gold, cfg):
    _check(vo.anchors(gold, "cpu", (cfg,))[cfg])


def test_golden_file_is_small_and_complete(gold):
    assert os.path.getsize(vo.GOLDEN) <= 150 * 2**10
    assert {k.split("::")[0] for k in gold.files} == set(vo.CONFIGS) | {"lvgp_fit"}


def test_jax_reproduces_vecchia_golden(gold):
    """Today's JAX package gives the golden file's values (rtol 1e-10)."""
    pytest.importorskip("jax")
    import make_vecchia_golden as mg

    mg.jax_setup()
    out = mg.compute()
    assert set(out) == set(gold.files)
    for key, val in out.items():
        np.testing.assert_allclose(val, gold[key], rtol=1e-10, atol=1e-300, err_msg=key)


def test_latents_separate_the_branches(gold):
    """The outcome of tests/test_input_transforms.py:78 in the port: from
    the JAX test's initial latents, 200 Adam steps separate the two
    branches (gap above twice the spread) and lower the objective by more
    than 10."""
    res = vo.lvgp_separation("cpu", gold)
    assert res["ok"], res


def test_full_size_recipes_run_small(monkeypatch):
    """The card's full-size recipes, at a small size on the CPU: finite
    values of the expected shapes, Adam lowers each objective, the float32
    copy's lml is close to float64's."""
    model, _, _, test = vo.vecchia_build("cpu", N=300, m=8)
    res32 = vo.vecchia_run(vo.vecchia_f32(model), "cpu", test, steps=3)
    res64 = vo.vecchia_run(model, "cpu", test, steps=3)
    assert res64["finite"] and res32["finite"] and res64["pred_shape"] == [vo.FULL_V["n_new"], 1]
    assert abs(res32["lml"] - res64["lml"]) <= vo.V_F32_GAP * abs(res64["lml"])
    assert vo.neighbours_agree("cpu", N=200)
    res = vo.gprn_full("cpu", torch.float64, "ldl", N=200, steps=3, n_new=20)
    assert res["finite"] and res["pred_shape"] == [20, vo.FULL_G["P"]]
    res = vo.lvgp_full("cpu", torch.float64, "additive", N=64, steps=3)
    assert res["finite"] and res["loss_last"] < res["loss_first"]


def test_entry_points_need_the_card_unless_asked():
    """`device` defaults to "cuda": without a card the entry points raise
    rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    X, Y, Z, _ = vo.gprn_inputs()
    kern = vo._rbf(1.0, 1.0, {})
    for build in (lambda: vo.VecchiaGP.init(X, Y[:, :1], kern),
                  lambda: vo.GPRN.init(X, Y, Z, kern, kern),
                  lambda: vo.LatentVariableGP.init(X, Y[:, :1], kern, vo.Gaussian())):
        with pytest.raises((RuntimeError, AssertionError)):
            build()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_gj_solve_at_the_vecchia_shape(cuda, dtype):
    """The Gauss-Jordan kernel at [4096, 16, 16] with r = 2, the masked
    covariances of Vecchia's conditioning sets (the first rows padded to
    the identity by `mask_covariance`), against its plain version; warp
    route."""
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import build
    from physs_gp_tpu_torch.ops.gaussian import mask_covariance

    gen = torch.Generator(device=cuda).manual_seed(0)
    n, d = 4096, 16
    A = torch.randn(n, d, 2 * d, generator=gen, device=cuda, dtype=dtype)
    C = A @ A.mT / (2 * d) + 0.05 * torch.eye(d, device=cuda, dtype=dtype)
    w = (torch.arange(d, device=cuda)[None, :] < torch.arange(n, device=cuda)[:, None]).to(dtype)
    Cm = mask_covariance(C, w)
    B = torch.randn(n, d, 2, generator=gen, device=cuda, dtype=dtype) * w[..., None]
    build.reset_launch_counts()
    X = bl.batch_solve(Cm, B)
    torch.cuda.synchronize()
    assert build.launch_counts()["gj_solve"] == 1 and build.route_counts()["gj_solve"]["block"] == 0
    ref = bl.gj_solve_plain(Cm, B)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert float((X - ref).abs().max() / ref.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", vo.CONFIGS)
def test_cuda_matches_vecchia_golden(cuda, gold, cfg):
    _check(vo.anchors(gold, cuda, (cfg,))[cfg])

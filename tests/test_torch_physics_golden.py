"""PyTorch port: the physics-informed path at the experiments' full sizes
against `tests/data/physics_golden.npz` (made by
`scripts/port/make_physics_golden.py` from the JAX package on the CPU).
Needs no JAX; `chip_smoke.py` holds the port to the same file on the card.

- Allen-Cahn at the experiment's full width (T = 56, Ns = 10, Nc = 12,
  n_mc = 32), 3 Gauss-Newton steps fed the JAX draws, in sequential
  covariance and square-root form. The block covariance S of the
  Monte-Carlo samples is numerically singular (the collocation heads are
  interpolated from the grid heads; smallest eigenvalue ~ -4e-16 of the
  largest), so its Cholesky factor is fixed only up to rounding in the
  near-null directions, and the collocation noise 1e-5 amplifies that. The
  tolerances are 10 times the JAX package's own gap between its CPU branch
  and its Gauss-Jordan / Pallas-Cholesky branch on the same anchor
  (`make_physics_golden.py --self-gap`, the larger of the two forms).
- The pendulum (40 data, 80 collocation points, n_mc = 16) and the
  monotonic model (30 data, 100 collocation points), 3 steps, and
  `ode_gp`'s lml and `predict_f`: ELBO and lml rtol 1e-9, sites and moments
  1e-7.
- The experiment's hardware gate on the JAX-trained Allen-Cahn sites: the
  float64 covariance posterior to 1e-7, and the float32 square-root
  posterior (PHYSS_KZZ_JITTER=1e-4 on both sides) within max |Δmean| < 0.02
  of the JAX CPU float32 one on the grid heads over the extrapolation
  window.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from experiments_torch import ac  # noqa: E402

from physs_gp_tpu_torch.approx.cvi import Sites  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern72  # noqa: E402
from physs_gp_tpu_torch.zoo.physics import monotonic_cvi_gp, nonlinear_ode_cvi_gp, ode_gp  # noqa: E402

torch.set_num_threads(1)

GOLDEN = os.path.join(REPO, "tests", "data", "physics_golden.npz")
F64 = dict(dtype=torch.float64, device="cpu")
# 10 x the JAX package's largest self-gap (`make_physics_golden.py
# --self-gap`: ELBOs 3.344e-08, sites Y 9.444e-08, site variances
# 5.848e-09, posterior mean 5.522e-08, var 1.707e-07)
AC_TOL = {"elbos": 3.3e-7, "sites_Y": 9.4e-7, "sites_Vdiag": 5.8e-8, "mean": 5.5e-7, "var": 1.7e-6}
TOL = {"elbos": 1e-9, "sites_Y": 1e-7, "sites_Vdiag": 1e-7, "mean": 1e-7, "var": 1e-7}


@pytest.fixture(scope="module")
def gold():
    return np.load(GOLDEN)


def rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    ok = np.isfinite(b)
    assert a.shape == b.shape and np.array_equal(np.isfinite(a), ok)
    return float(np.max(np.abs(a[ok] - b[ok])) / np.max(np.abs(b[ok])))


def _hold(model, elbos, g, key, tol):
    post = model.posterior()
    got = {"elbos": None, "sites_Y": model.sites.Y,
           "sites_Vdiag": torch.diagonal(model.sites.V, dim1=-2, dim2=-1),
           "mean": post.mean, "var": post.var}
    np.testing.assert_allclose(elbos, g[f"{key}_elbos"], rtol=tol["elbos"])
    for q, val in got.items():
        if val is not None:
            assert rel(val, g[f"{key}_{q}"]) <= tol[q], q


def _ac(g, dtype, sqrt):
    return ac.build(g["ac_t"], g["ac_Y"], g["ac_Z"], g["ac_coll"], ac.FULL["n_mc"], dtype, sqrt,
                    "cpu")


@pytest.fixture
def no_kzz_override(monkeypatch):
    monkeypatch.delenv("PHYSS_KZZ_JITTER", raising=False)


@pytest.mark.parametrize("form", ["cov", "sqrt"])
def test_allen_cahn_full_width_matches_golden(gold, form, no_kzz_override):
    model = _ac(gold, torch.float64, form == "sqrt")
    elbos = [float(model.step_with_elbo(0.3, hessian="gauss_newton", draws=torch.from_numpy(d))[1])
             for d in gold["ac_draws"]]
    _hold(model, elbos, gold, f"ac_{form}", AC_TOL)


def test_pendulum_and_monotonic_full_size_match_golden(gold, no_kzz_override):
    model = nonlinear_ode_cvi_gp(
        gold["pend_t_data"], gold["pend_y_data"], gold["pend_t_coll"],
        lambda f: f[..., 2] + 0.3 * f[..., 1] + 9.0 * torch.sin(f[..., 0]), n_heads=3,
        kernel=Matern72(1.0, 1.0, **F64), noise=0.03**2, coll_noise=1e-4, n_mc=16, device="cpu")
    elbos = [float(model.step_with_elbo(0.3, hessian="gauss_newton", draws=torch.from_numpy(d))[1])
             for d in gold["pend_draws"]]
    _hold(model, elbos, gold, "pend", TOL)
    model = monotonic_cvi_gp(gold["mono_t_data"], gold["mono_y_data"], gold["mono_t_coll"],
                             noise=0.15**2, device="cpu")
    elbos = [float(model.step_with_elbo(0.5)[1]) for _ in range(3)]
    _hold(model, elbos, gold, "mono", TOL)


def test_ode_gp_matches_golden(gold):
    model = ode_gp(gold["ode_t_data"], gold["ode_y_data"], gold["ode_t_coll"], [4.0, 0.4, 1.0],
                   kernel=Matern72(1.5, 1.0, **F64), noise=0.05**2, coll_noise=1e-6, device="cpu")
    with torch.no_grad():
        lml = float(model.log_marginal_likelihood())
        f = model.predict_f(torch.from_numpy(gold["ode_t_test"]))
    np.testing.assert_allclose(lml, float(gold["ode_lml"]), rtol=1e-9)
    assert rel(f.mean, gold["ode_f_mean"]) <= 1e-7 and rel(f.var, gold["ode_f_var"]) <= 1e-7


def test_hardware_gate_on_the_trained_sites(gold, monkeypatch):
    monkeypatch.delenv("PHYSS_KZZ_JITTER", raising=False)
    model = _ac(gold, torch.float64, False)
    model.sites = Sites(torch.from_numpy(gold["ac_trained_sites_Y"]),
                        torch.from_numpy(gold["ac_trained_sites_V"]))
    post = model.posterior()
    assert rel(post.mean, gold["ac_trained_f64_mean"]) <= 1e-7
    assert rel(post.var, gold["ac_trained_f64_var"]) <= 1e-7
    monkeypatch.setenv("PHYSS_KZZ_JITTER", "1e-4")
    model = _ac(gold, torch.float32, True)
    model.sites = Sites(torch.from_numpy(gold["ac_trained_sites_Y"]).float(),
                        torch.from_numpy(gold["ac_trained_sites_V"]).float())
    mean = model.posterior().mean.double().numpy()
    later, Ns = ac.extrapolation_rows(gold["ac_t"]), gold["ac_Z"].shape[0]
    assert np.max(np.abs(mean[later][:, :Ns] - gold["ac_trained_f32_mean"][later][:, :Ns])) < 0.02


def test_golden_inputs_are_the_experiments():
    """The stored Allen-Cahn inputs are `experiments_torch/ac.py`'s `inputs` at the full
    width (the chip run rebuilds them from it), and the file stays small."""
    g = np.load(GOLDEN)
    t, Y, Z, coll, F = ac.inputs(ac.FULL["T"], ac.FULL["Ns"], ac.FULL["Nc"])
    for name, x in (("t", t), ("Y", Y), ("Z", Z), ("coll", coll), ("F", F)):
        np.testing.assert_array_equal(g[f"ac_{name}"], x)
    assert g["ac_draws"].shape == (3, 32, 56, 34)
    assert os.path.getsize(GOLDEN) <= 2.5 * 2**20

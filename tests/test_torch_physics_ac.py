"""PyTorch port: the Allen-Cahn recipe (`zoo/physics.allen_cahn_gp`) against
the JAX package at a small width, in sequential covariance form (the
experiment's float64 arm) and sequential square-root form (its accelerator
arm); shared code and tolerances in `tests/physics_ac_parity.py`, the
parallel square-root form in `tests/test_torch_physics_ac_parallel.py`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import physics_ac_parity as pp  # noqa: E402

torch.set_num_threads(1)

FORMS = ["cov", "sqrt"]


@pytest.fixture(scope="module")
def reference():
    return pp.reference_runs(FORMS)


@pytest.mark.parametrize("form", FORMS)
def test_allen_cahn_steps_match_jax(reference, form):
    pp.check_form(reference, form)


def test_allen_cahn_shapes_and_heads():
    """Heads [Ns grid | Nc collocation | Nc operator rows], sites active on
    every head at every step (full-state-observed surrogate), d = 3 Ns."""
    model = pp.port_model("cov")
    ref = pp.jax_model("cov")
    assert model.Y.shape == (pp.T, pp.NS + 2 * pp.NC)
    assert torch.isfinite(model.sites.Y).all()
    H = model.observation.H(model.kernel)
    assert H.shape == (pp.NS + 2 * pp.NC, 3 * pp.NS)
    assert pp.rel(H, np.asarray(ref.observation.H(ref.kernel))) <= 1e-12
    assert model.likelihood.residual.n_mc == pp.N_MC and model.t.device.type == "cpu"

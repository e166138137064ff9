"""PyTorch port: config-5 hyperparameter training in square-root form against
the JAX package (T = 256, float64; the JAX smoother's `_factor_psd` on its
TPU branch, as the port runs it; the checks are `train_parity`'s)."""
import pytest

torch = pytest.importorskip("torch")

import train_parity as tp  # noqa: E402

torch.set_num_threads(1)

FORMS = ["c5_sqrt"]
jax_runs = tp.reference_runs(FORMS)
blocked = tp.blocked


@pytest.mark.parametrize("form", FORMS)
def test_objective_gradient_matches_jax(jax_runs, blocked, form):
    tp.check_gradient(jax_runs[form], form)


@pytest.mark.parametrize("form", FORMS)
def test_vb_ng_adam_scan_matches_jax(jax_runs, blocked, form):
    tp.check_vb_ng_adam_scan(jax_runs[form], form)


@pytest.mark.parametrize("form", FORMS)
def test_jax_reproduces_train_golden(jax_runs, form):
    tp.check_golden(jax_runs[form], form)

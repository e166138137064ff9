"""PyTorch port: hyperparameter training of the temporal Poisson model in both
forms against the JAX package (T = 256, float64; the checks are
`train_parity`'s)."""
import pytest

torch = pytest.importorskip("torch")

import train_parity as tp  # noqa: E402

torch.set_num_threads(1)

FORMS = ["t_cov", "t_sqrt"]
jax_runs = tp.reference_runs(FORMS)
blocked = tp.blocked


@pytest.mark.parametrize("form", FORMS)
def test_objective_gradient_matches_jax(blocked, form):
    tp.check_gradient(tp.golden_run(form), form)


@pytest.mark.parametrize("form", FORMS)
def test_vb_ng_adam_scan_matches_jax(blocked, form):
    tp.check_vb_ng_adam_scan(tp.golden_run(form), form)


@pytest.mark.parametrize("form", FORMS)
def test_vb_ng_adam_trainer_matches_jax(blocked, form):
    tp.check_vb_ng_adam_trainer(tp.golden_run(form), form)


@pytest.mark.slow
@pytest.mark.parametrize("form", FORMS)
def test_jax_reproduces_train_golden(jax_runs, form):
    tp.check_golden(jax_runs[form], form)

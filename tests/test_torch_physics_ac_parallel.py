"""PyTorch port: the Allen-Cahn recipe against the JAX package at a small
width in parallel square-root form (the JAX run with `_factor_psd` on its
TPU branch, which the port follows); shared code and tolerances in
`tests/physics_ac_parity.py`.
"""
import pytest

torch = pytest.importorskip("torch")
import physics_ac_parity as pp  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reference():
    return pp.reference_runs(["parallel sqrt"])


def test_allen_cahn_parallel_sqrt_steps_match_jax(reference):
    pp.check_form(reference, "parallel sqrt")

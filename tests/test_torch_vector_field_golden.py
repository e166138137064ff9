"""PyTorch port: the scattered-sensor and vector-field paths against
`tests/data/vector_field_golden.npz` (made by
`scripts/port/make_vector_field_golden.py` from the JAX package on the CPU,
float64, sequential covariance filters). Needs no JAX; `chip_smoke.py` holds
the port to the same file on the card.

- scattered: the experiment's full configuration (200 times, 516 rows, the
  JAX recipe's 12 k-means sites, d = 24, Ng = 4) in parallel covariance and
  square-root form and with PHYSS_FUSED_COMBINE=1, chunk 64 (T = 200 padded
  to 256): lml, the posterior mapped back with `unsort`, and
  `scattered_st_predict` at the 120 held-out rows (the square-root form
  against the JAX square-root run: its relative jitter on Q, R and P0
  moves the posterior by up to 2.1e-9 from the covariance form's);
- sparse: `sparse_st_gp(train_z=True)`: lml and its gradient by every raw;
- Helmholtz: the quick configuration (T = 16, Ns = 25, D = 100): lml and
  `helmholtz_st_predict` at 12 new sites in the sequential covariance and
  square-root forms (D = 100 is above the kernels: PyTorch's own
  factorisations), and one `cvi=True` step's ELBO and prediction;
- magnetic field with and without the potential block, sequential and
  parallel: lml and `magnetic_field_predict`;
- LMC: `lmc_markov_gp` lml, and two Poisson CVI steps' ELBOs.

lml, ELBO, means and gradients rtol 1e-9, variances 1e-7, relative to each
output's largest magnitude.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import vector_field_outcome as vf  # noqa: E402

torch.set_num_threads(1)

ANCHORS = ["scattered cov", "scattered sqrt", "scattered fused", "sparse", "helmholtz",
           "helmholtz sqrt", "helmholtz cvi", "magnetic without potential seq", "magnetic without potential par",
           "magnetic with potential seq", "magnetic with potential par", "lmc", "lmc cvi"]


@pytest.fixture(scope="module")
def results():
    return vf.anchors(np.load(vf.GOLDEN), "cpu")


def test_every_anchor_is_held(results):
    assert sorted(results) == sorted(ANCHORS)


@pytest.mark.parametrize("name", ANCHORS)
def test_anchor_matches_golden(results, name):
    for key, (got, want, tol) in results[name].items():
        assert got.shape == want.shape, key
        assert np.all(np.isfinite(got)), key
        assert vf.relerr(got, want) <= tol, (key, vf.relerr(got, want))

"""PyTorch port: config-5 hyperparameter training in square-root form against
the JAX package (T = 256, float64; the JAX smoother's `_factor_psd` on its
TPU branch, as the port runs it; the checks are `train_parity`'s), and the
backwards of the square-root path's factorisations: `tria`'s QR backward
against the library QR's, the Cholesky's against `jnp.linalg.cholesky`'s
on an indefinite member."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu_torch.ops import matrix as tmatrix  # noqa: E402

import train_parity as tp  # noqa: E402

torch.set_num_threads(1)

FORMS = ["c5_sqrt"]
jax_runs = tp.reference_runs(FORMS)
blocked = tp.blocked
_rel = tp.rel


@pytest.mark.parametrize("shape", [(7, 6, 3), (5, 64, 32), (3, 4, 2), (2, 3, 1), (4, 96, 32)])
def test_qr_backward_matches_the_library_qr(shape):
    """`tria`'s backward reference takes R from `torch.geqrf` and writes
    QR's backward with Q accumulated from the reflectors: R and its
    gradient equal `torch.linalg.qr`'s at the square-root path's shapes
    ([m, d] = [64, 32], [96, 32] with the regularising block, d <= 2)."""
    from physs_gp_tpu_torch.ops.sqrt_kalman import _QrR

    gen = torch.Generator().manual_seed(sum(shape))
    A = torch.randn(*shape, generator=gen, dtype=torch.float64, requires_grad=True)
    gR = torch.randn(*shape[:-2], shape[-1], shape[-1], generator=gen, dtype=torch.float64)
    R = _QrR.apply(A)
    (g,) = torch.autograd.grad(R, A, gR)
    _, R_lib = torch.linalg.qr(A, mode="reduced")
    (g_lib,) = torch.autograd.grad(R_lib, A, gR)
    assert torch.equal(R, R_lib)
    assert _rel(g, g_lib.numpy()) <= 1e-13
    small = A[:1, : min(6, shape[-2]), : min(3, shape[-1])].detach().requires_grad_(True)
    assert torch.autograd.gradcheck(_QrR.apply, (small,))


def test_cholesky_backward_is_nan_on_an_indefinite_member_as_in_jax():
    """The kernel Cholesky floors the pivots of an indefinite member; its
    backward recomputes through the library Cholesky, which, like the
    reference's `jnp.linalg.cholesky`, gives NaN there and the exact
    gradient elsewhere, with no error."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(3, 4, 4))
    A = X @ np.swapaxes(X, -1, -2) + 0.5 * np.eye(4)
    A[1] = np.diag([1.0, -1.0, 2.0, 3.0])
    ct = rng.normal(size=A.shape)
    a = torch.from_numpy(A).requires_grad_(True)
    L = tmatrix._cholesky_any(a, assume_psd=True)
    (g,) = torch.autograd.grad(L, a, torch.from_numpy(ct))
    _, vjp = jax.vjp(jnp.linalg.cholesky, jnp.asarray(A))
    (jg,) = vjp(jnp.asarray(ct))
    jg = np.asarray(jg)
    assert np.isnan(jg[1]).all() and torch.isnan(g[1]).all()
    assert _rel(g[[0, 2]], jg[[0, 2]]) <= 1e-12


@pytest.mark.parametrize("form", FORMS)
def test_objective_gradient_matches_jax(jax_runs, blocked, form):
    tp.check_gradient(jax_runs[form], form)


@pytest.mark.parametrize("form", FORMS)
def test_vb_ng_adam_scan_matches_jax(jax_runs, blocked, form):
    tp.check_vb_ng_adam_scan(jax_runs[form], form)


@pytest.mark.parametrize("form", FORMS)
def test_jax_reproduces_train_golden(jax_runs, form):
    tp.check_golden(jax_runs[form], form)

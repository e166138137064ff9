"""PyTorch port: `ops/matrix.py` against the JAX package.

Values of the routed solves and products, and the gradients of their
`torch.autograd.Function`s, against the JAX custom VJPs on the same numpy
inputs (float64). The JAX CPU path solves by Cholesky/LU while the port runs
the unpivoted Gauss-Jordan elimination of its batched kernels, so values
agree to rounding: rtol 1e-10 (1e-12 for products). `gradcheck` checks the
port's backward formulas against finite differences.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.ops import matrix as jm  # noqa: E402
from physs_gp_tpu_torch.ops import matrix as tm  # noqa: E402

torch.set_num_threads(1)


def _spd(rng, N, d, dom=3.0):
    A = rng.normal(size=(N, d, d))
    return A @ np.swapaxes(A, -1, -2) / d + dom * np.eye(d)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), dtype=torch.float64, requires_grad=grad)


def _vjp_jax(fn, args, cts):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return out, vjp(jax.tree_util.tree_map(jnp.asarray, cts))


def _vjp_torch(fn, args, cts):
    ts = [_t(a, grad=True) for a in args]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    ct_list = cts if isinstance(cts, tuple) else (cts,)
    grads = torch.autograd.grad(outs, ts, [_t(c) for c in ct_list])
    return out, grads


def _close(a, b, rtol, atol=1e-12):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("N,d,r", [(6, 5, 3), (40, 32, 65)])
def test_psd_solve_value_and_vjp(N, d, r):
    rng = np.random.default_rng(d)
    A, B, ct = _spd(rng, N, d), rng.normal(size=(N, d, r)), rng.normal(size=(N, d, r))
    jo, (jA, jB) = _vjp_jax(jm.psd_solve, (A, B), ct)
    to, (tA, tB) = _vjp_torch(tm.psd_solve, (A, B), ct)
    _close(to, jo, 1e-10)
    _close(tA, jA, 1e-9)
    _close(tB, jB, 1e-9)


@pytest.mark.parametrize("N,d,r", [(6, 5, 1), (40, 32, 32)])
def test_psd_solve_logdet_value_and_vjp(N, d, r):
    rng = np.random.default_rng(d + 1)
    A, B = _spd(rng, N, d), rng.normal(size=(N, d, r))
    cts = (rng.normal(size=(N, d, r)), rng.normal(size=(N,)))
    (jX, jld), (jA, jB) = _vjp_jax(jm.psd_solve_logdet, (A, B), cts)
    (tX, tld), (tA, tB) = _vjp_torch(tm.psd_solve_logdet, (A, B), cts)
    _close(tX, jX, 1e-10)
    _close(tld, jld, 1e-10)
    _close(tA, jA, 1e-9)
    _close(tB, jB, 1e-9)


@pytest.mark.parametrize("N,d", [(6, 5), (40, 32)])
def test_gen_solve_value_and_vjp(N, d):
    rng = np.random.default_rng(d + 2)
    A = np.eye(d) + 0.1 * rng.normal(size=(N, d, d))
    B, ct = rng.normal(size=(N, d, d)), rng.normal(size=(N, d, d))
    jo, (jA, jB) = _vjp_jax(jm.gen_solve, (A, B), ct)
    to, (tA, tB) = _vjp_torch(tm.gen_solve, (A, B), ct)
    _close(to, jo, 1e-10)
    _close(tA, jA, 1e-9)
    _close(tB, jB, 1e-9)


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("bshape", [(7, 6, 6), (1, 6, 6), (6, 6)])
def test_bmm_value_and_vjp(ta, tb, bshape):
    """Equal batches go to the batched kernel path; a broadcast or 2-D B to
    torch.matmul, with the cotangent summed back over the broadcast."""
    rng = np.random.default_rng(3)
    A, B, ct = rng.normal(size=(7, 6, 6)), rng.normal(size=bshape), rng.normal(size=(7, 6, 6))

    def jf(a, b):
        return jm.bmm(a, b, ta, tb)

    def tf(a, b):
        return tm.bmm(a, b, ta, tb)

    jo, (jA, jB) = _vjp_jax(jf, (A, B), ct)
    to, (tA, tB) = _vjp_torch(tf, (A, B), ct)
    _close(to, jo, 1e-12)
    _close(tA, jA, 1e-12)
    _close(tB, jB, 1e-12)


def test_bmm_of_transposed_views():
    """Views with unit stride along the second-last dim flip the transpose
    flag instead of being copied."""
    rng = np.random.default_rng(4)
    A, B = rng.normal(size=(5, 4, 6)), rng.normal(size=(5, 6, 3))
    At = _t(np.swapaxes(A, -1, -2).copy()).transpose(-1, -2)  # stride(-1) != 1
    _close(tm.bmm(At, _t(B)), A @ B, 1e-12)
    _close(tm.bmm(At, _t(B).transpose(-1, -2), tb=True), A @ B, 1e-12)


@pytest.mark.parametrize("name", ["psd_solve", "psd_solve_logdet", "gen_solve", "bmm"])
def test_gradcheck(name):
    rng = np.random.default_rng(5)
    N, d = 3, 4
    A = _t(_spd(rng, N, d) if name != "bmm" else rng.normal(size=(N, d, d)), grad=True)
    B = _t(rng.normal(size=(N, d, 2)), grad=True)
    fns = {
        "psd_solve": lambda a, b: tm.psd_solve(tm.symmetrize(a), b),
        "psd_solve_logdet": lambda a, b: tm.psd_solve_logdet(tm.symmetrize(a), b),
        "gen_solve": tm.gen_solve,
        "bmm": lambda a, b: tm.bmm(a, b, True, False),
    }
    assert torch.autograd.gradcheck(fns[name], (A, B))


def test_small_helpers_match_jax():
    rng = np.random.default_rng(6)
    A = _spd(rng, 4, 5)
    for n in (1, 2, 5):
        S = A[:, :n, :n]
        jL = jm.safe_cholesky(jnp.asarray(S))
        tL = tm.safe_cholesky(_t(S))
        _close(tL, jL, 1e-12)
        _close(tm.log_det_from_chol(tL), jm.log_det_from_chol(jL), 1e-12)
        Bn = rng.normal(size=(4, n, 2))
        _close(tm.cholesky_solve(tL, _t(Bn)), jm.cholesky_solve(jL, jnp.asarray(Bn)), 1e-11)
    _close(tm.mat_inv(_t(A)), jm.mat_inv(jnp.asarray(A)), 1e-10)
    _close(tm.add_jitter(_t(A)), jm.add_jitter(jnp.asarray(A)), 1e-15)
    _close(tm.add_jitter(_t(A).float()).double(), jm.add_jitter(jnp.asarray(A, jnp.float32)), 1e-6)
    Bk, Ck = rng.normal(size=(3, 3)), rng.normal(size=(6, 2, 2))
    _close(tm.kron(_t(Bk), _t(Ck)), jm.kron(jnp.asarray(Bk), jnp.asarray(Ck)), 1e-15)
    _close(tm.kron_lift(_t(Bk), _t(Ck)), jm.kron_lift(jnp.asarray(Bk), jnp.asarray(Ck)), 1e-15)
    assert tm.default_jitter(torch.float64) == jm.default_jitter(jnp.float64)
    assert tm.default_jitter(torch.float32) == jm.default_jitter(jnp.float32)


def test_tf32_is_off():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

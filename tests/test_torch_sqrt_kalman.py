"""PyTorch port: the square-root primitives, filter and smoother against JAX.

`tria`, `tria_sum` and `safe_cholesky_rel`: values and gradients through the
port's `autograd.Function`s against `jax.grad` of the JAX functions on the
CPU, float64, with zero and rank-deficient batch members (rtol 1e-8 for
gradients, whose backward passes recompute through QR on both sides; 1e-10
for values).

`parallel_sqrt_kalman_filter` and `parallel_sqrt_rts_smoother`: a random
d = 32, p = 32 LGSSM with NaN-masked observations, T = 256, chunk 64, both
packages on the blocked scan schedule with 8 blocks. Means, covariances,
factors and lml agree to rtol 1e-9; the smoothed factors Ls to 1e-9 with an
absolute 1e-10, since the JAX CPU branch of `_factor_psd` adds 1e-12 I that
the port (like the JAX TPU branch) does not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.ops import matrix as jm  # noqa: E402
from physs_gp_tpu.ops import parallel_sqrt_kalman as jpsk  # noqa: E402
from physs_gp_tpu.ops import sqrt_kalman as jsk  # noqa: E402
from physs_gp_tpu_torch.ops import matrix as tm  # noqa: E402
from physs_gp_tpu_torch.ops import parallel_sqrt_kalman as tpsk  # noqa: E402
from physs_gp_tpu_torch.ops import runner  # noqa: E402
from physs_gp_tpu_torch.ops import sqrt_kalman as tsk  # noqa: E402

torch.set_num_threads(1)

T, D, P, CHUNK = 256, 32, 32, 64


def _t(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


def _close(a, b, rtol, atol=0.0):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _batch(rng, N, d, m):
    """[N, d, m] with member 0 zero and member 1 of rank 2."""
    X = rng.normal(size=(N, d, m))
    X[0] = 0.0
    X[1] = rng.normal(size=(d, 2)) @ rng.normal(size=(2, m))
    return X


def _value_and_grads(jfn, tfn, *xs):
    """Values, and gradients of sum(f**2) + sum(f[:, 0]), on both sides."""
    def jloss(*a):
        L = jfn(*a)
        return jnp.sum(L ** 2) + jnp.sum(L[:, 0])

    jval = jfn(*[jnp.asarray(x) for x in xs])
    jgrads = jax.grad(jloss, argnums=tuple(range(len(xs))))(*[jnp.asarray(x) for x in xs])
    ts = [_t(x, grad=True) for x in xs]
    L = tfn(*ts)
    (torch.sum(L ** 2) + torch.sum(L[:, 0])).backward()
    return L, jval, [x.grad for x in ts], jgrads


@pytest.mark.parametrize("m,full_rank", [(7, False), (3, False), (9, True)])
def test_tria_values_and_grads(m, full_rank):
    rng = np.random.default_rng(m)
    B = _batch(rng, 10, 4, m)
    if full_rank:
        B[:2] = rng.normal(size=(2, 4, m))
    L, jL, g, jg = _value_and_grads(
        lambda b: jsk.tria(b, assume_full_rank=full_rank),
        lambda b: tsk.tria(b, assume_full_rank=full_rank), B,
    )
    _close(L, jL, 1e-10, 1e-13)
    _close(g[0], jg[0], 1e-8, 1e-10)
    if not full_rank:
        assert (L[0] == 0).all() and (g[0][0] == 0).all()


@pytest.mark.parametrize("with_y,plus_eye", [(True, False), (False, True), (True, True)])
def test_tria_sum_values_and_grads(with_y, plus_eye):
    rng = np.random.default_rng(int(with_y) + 2 * int(plus_eye))
    X = rng.normal(size=(12, 5, 5))
    X[0] = 0.0
    xs = [X]
    if with_y:
        Y = rng.normal(size=(12, 5, 3))
        Y[0] = 0.0
        xs.append(Y)
    L, jL, g, jg = _value_and_grads(
        lambda *a: jsk.tria_sum(*a, plus_eye=plus_eye) if len(a) > 1
        else jsk.tria_sum(a[0], plus_eye=plus_eye),
        lambda *a: tsk.tria_sum(*a, plus_eye=plus_eye) if len(a) > 1
        else tsk.tria_sum(a[0], plus_eye=plus_eye),
        *xs,
    )
    _close(L, jL, 1e-10, 1e-13)
    for a, b in zip(g, jg):
        _close(a, b, 1e-8, 1e-10)


def test_safe_cholesky_rel_values_and_grads():
    rng = np.random.default_rng(18)
    X = rng.normal(size=(14, 5, 7))
    A = X @ np.swapaxes(X, -1, -2) + 0.2 * np.eye(5)
    A[0] = 0.0  # Q at dt = 0: factors to sqrt(1e-30) I
    L, jL, g, jg = _value_and_grads(jm.safe_cholesky_rel, tm.safe_cholesky_rel, A)
    _close(L, jL, 1e-12, 1e-20)
    _close(g[0][1:], jg[0][1:], 1e-8, 1e-10)
    # a single [d, d] matrix runs as a batch of one
    _close(tm.safe_cholesky_rel(_t(A[3])), jm.safe_cholesky_rel(jnp.asarray(A[3])), 1e-12)


# ---------------------------------------------------------------------------
# filter and smoother
# ---------------------------------------------------------------------------


@pytest.fixture
def blocked_env(monkeypatch):
    monkeypatch.setenv("PHYSS_INNER_SCAN", "blocked")
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")


def _sqrt_lgssm(seed=0):
    rng = np.random.default_rng(seed)
    Qr = np.linalg.qr(rng.normal(size=(T, D, D)))[0]
    A = 0.95 * Qr + 0.02 * rng.normal(size=(T, D, D))
    A[0] = np.eye(D)
    G = rng.normal(size=(T, D, D)) / np.sqrt(D)
    Q = 0.1 * G @ np.swapaxes(G, -1, -2) + 0.01 * np.eye(D)
    Q[0] = 0.0
    H = rng.normal(size=(P, D)) / np.sqrt(D)
    Rd = 0.05 + 0.1 * rng.random(size=(T, P))
    y = rng.normal(size=(T, P))
    y[rng.random(T) < 0.1] = np.nan  # fully missing steps
    y[rng.random((T, P)) < 0.2] = np.nan  # partially missing steps
    m0 = rng.normal(size=D) * 0.1
    G0 = rng.normal(size=(D, D)) / np.sqrt(D)
    P0 = G0 @ G0.T + 0.5 * np.eye(D)
    factor = jax.jit(jm.safe_cholesky_rel)
    Qs, Rs, P0s = (np.array(factor(jnp.asarray(x))) for x in (Q, np.eye(P) * Rd[..., None], P0))
    return A, Qs, H, Rs, y, m0, P0s


def test_chunked_sqrt_filter_and_smoother(blocked_env):
    args = _sqrt_lgssm()
    jf = jax.jit(jpsk.parallel_sqrt_kalman_filter, static_argnames="chunk_size")(
        *[jnp.asarray(x) for x in args], chunk_size=CHUNK
    )
    tf = tpsk.parallel_sqrt_kalman_filter(*[_t(x) for x in args], chunk_size=CHUNK)
    for field in ("ms", "Ps", "lmls", "lml", "Pp"):
        _close(getattr(tf, field), getattr(jf, field), 1e-9, 1e-10)
    A, Qs = args[0], args[1]
    js = jax.jit(jpsk.parallel_sqrt_rts_smoother, static_argnames="chunk_size")(
        jnp.asarray(A), jnp.asarray(Qs), jf, chunk_size=CHUNK
    )
    ts = tpsk.parallel_sqrt_rts_smoother(_t(A), _t(Qs), tf, chunk_size=CHUNK)
    for field in ("ms", "Ps", "Gs", "Ls"):
        _close(getattr(ts, field), getattr(js, field), 1e-9, 1e-10)


def test_runner_takes_the_sqrt_path():
    """run_filter_smoother(sqrt=True) runs in parallel and in sequence, and
    the two agree (the sequential pass also ships the factors Ls)."""
    from physs_gp_tpu_torch.ops.lgssm import LGSSM

    A, Qs, H, Rs, y, m0, P0s = (_t(x) for x in _sqrt_lgssm(1))
    ssm = LGSSM(A=A[:64], Q=Qs[:64] @ Qs[:64].mT, H=H, m0=m0, P0=P0s @ P0s.T)
    R = Rs[:64] @ Rs[:64].mT
    f, s = runner.run_filter_smoother(ssm, R, y[:64], parallel=True, sqrt=True)
    assert f.Pp is None and s.Ls is not None
    assert torch.isfinite(s.Ps).all() and torch.isfinite(f.lml)
    _close(s.Ls @ s.Ls.mT, s.Ps, 1e-9, 1e-12)
    fq, sq = runner.run_filter_smoother(ssm, R, y[:64], parallel=False, sqrt=True)
    assert fq.Pp is None and sq.Ls is not None
    for a, b in [(fq.ms, f.ms), (fq.Ps, f.Ps), (fq.lml, f.lml), (sq.ms, s.ms), (sq.Ps, s.Ps),
                 (sq.Ls @ sq.Ls.mT, s.Ps)]:
        _close(a, b.detach().numpy(), 1e-9, 1e-10)

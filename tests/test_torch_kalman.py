"""PyTorch port: the parallel Kalman filter and smoother against JAX.

A random d = 32, p = 32 LGSSM with NaN-masked observations (whole rows and
single entries), T = 256, chunk 64. Both packages run the blocked scan
schedule with 8 blocks (PHYSS_INNER_SCAN=blocked, PHYSS_SCAN_BLOCKS=8, set
before JAX traces). Tolerance rtol 1e-9 on element fields, means,
covariances and lml (float64). With `PHYSS_FUSED_COMBINE=1` the port's scans
take the fused combines (their plain versions on the CPU) and are held to
the unfused port and to JAX at the same tolerance. The port's sequential
filter and smoother are held to JAX's at rtol 1e-10, and the parallel scans
to the sequential pass.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.ops import kalman as jk  # noqa: E402
from physs_gp_tpu.ops import parallel_kalman as jpk  # noqa: E402
from physs_gp_tpu_torch.ops import kalman as tk  # noqa: E402
from physs_gp_tpu_torch.ops import parallel_kalman as tpk  # noqa: E402
from physs_gp_tpu_torch.ops import runner  # noqa: E402

torch.set_num_threads(1)

T, D, P, CHUNK = 256, 32, 32, 64


@pytest.fixture
def blocked_env(monkeypatch):
    monkeypatch.setenv("PHYSS_INNER_SCAN", "blocked")
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")


def _lgssm(seed=0):
    rng = np.random.default_rng(seed)
    Qr = np.linalg.qr(rng.normal(size=(T, D, D)))[0]
    A = 0.95 * Qr + 0.02 * rng.normal(size=(T, D, D))
    A[0] = np.eye(D)
    G = rng.normal(size=(T, D, D)) / np.sqrt(D)
    Q = 0.1 * G @ np.swapaxes(G, -1, -2) + 0.01 * np.eye(D)
    Q[0] = 0.0
    H = rng.normal(size=(P, D)) / np.sqrt(D)
    Gr = rng.normal(size=(T, P, P)) / np.sqrt(P)
    R = 0.05 * Gr @ np.swapaxes(Gr, -1, -2) + 0.1 * np.eye(P)
    y = rng.normal(size=(T, P))
    y[rng.random(T) < 0.1] = np.nan  # fully missing steps
    y[rng.random((T, P)) < 0.2] = np.nan  # partially missing steps
    m0 = rng.normal(size=D) * 0.1
    G0 = rng.normal(size=(D, D)) / np.sqrt(D)
    P0 = G0 @ G0.T + 0.5 * np.eye(D)
    return A, Q, H, R, y, m0, P0


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _tt(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _close(a, b, rtol=1e-9, atol=1e-10):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


def _elems(seed=0):
    A, Q, H, R, y, m0, P0 = _lgssm(seed)
    Hs = np.broadcast_to(H, (T, P, D)).copy()
    mask = np.isfinite(y).astype(np.float64)
    je = jax.jit(jpk._build_filter_elements)(*_j(A, Q, Hs, R, y, mask, m0, P0))
    te = tpk._build_filter_elements(*_tt(A, Q, Hs, R, y, mask, m0, P0))
    return je, te


def test_build_filter_elements():
    je, te = _elems()
    for a, b in zip(te, je):
        _close(a, b)


def test_one_filtering_and_smoothing_combine():
    je, te = _elems()
    ji = jax.tree_util.tree_map(lambda x: x[:-1], je)
    jj = jax.tree_util.tree_map(lambda x: x[1:], je)
    ti = tpk._map(lambda x: x[:-1], te)
    tj = tpk._map(lambda x: x[1:], te)
    for a, b in zip(tpk._filtering_operator(ti, tj), jax.jit(jpk._filtering_operator_xla)(ji, jj)):
        _close(a, b)
    for a, b in zip(tpk._filtering_final(ti, tj), jax.jit(jpk._filtering_final)(ji, jj)):
        _close(a, b)
    rng = np.random.default_rng(1)
    E = rng.normal(size=(2, T, D, D)) * 0.2
    g = rng.normal(size=(2, T, D))
    Lr = rng.normal(size=(2, T, D, D))
    L = Lr @ np.swapaxes(Lr, -1, -2)
    jsm = [jpk._SmootherElems(*_j(E[k], g[k], L[k])) for k in range(2)]
    tsm = [tpk._SmootherElems(*_tt(E[k], g[k], L[k])) for k in range(2)]
    for a, b in zip(tpk._smoothing_operator(*tsm), jax.jit(jpk._smoothing_operator_xla)(*jsm)):
        _close(a, b)


@pytest.mark.parametrize("n", [256, 200])
def test_blocked_scan_matches_associative_scan(blocked_env, n):
    je, te = _elems()
    je = jax.tree_util.tree_map(lambda x: x[:n], je)
    te = tpk._map(lambda x: x[:n], te)
    ref = jax.jit(lambda e: jax.lax.associative_scan(jpk._filtering_operator_xla, e))(je)
    out, total = tpk.blocked_inclusive_scan(
        tpk._filtering_operator, te, tpk._ident_filter_elem(D, te.A)
    )
    for a, b in zip(out, ref):
        _close(a, b)
    for a, b in zip(total, ref):
        _close(a, b[-1])


def test_chunked_filter_and_smoother(blocked_env):
    A, Q, H, R, y, m0, P0 = _lgssm(2)
    jf = jax.jit(jpk.parallel_kalman_filter, static_argnames="chunk_size")(
        *_j(A, Q, H, R, y, m0, P0), chunk_size=CHUNK
    )
    tf = tpk.parallel_kalman_filter(*_tt(A, Q, H, R, y, m0, P0), chunk_size=CHUNK)
    _close(tf.ms, jf.ms)
    _close(tf.Ps, jf.Ps)
    _close(tf.lmls, jf.lmls)
    _close(tf.lml, jf.lml)
    _close(tf.Pp, jf.Pp)
    js = jax.jit(jpk.parallel_rts_smoother, static_argnames="chunk_size")(
        jnp.asarray(A), jnp.asarray(Q), jf, chunk_size=CHUNK
    )
    ts = tpk.parallel_rts_smoother(*_tt(A, Q), tf, chunk_size=CHUNK)
    _close(ts.ms, js.ms)
    _close(ts.Ps, js.Ps)
    _close(ts.Gs, js.Gs)


def test_unchunked_filter_matches_jax_default_schedule(monkeypatch):
    """The port's blocked schedule against JAX's associative scan."""
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    A, Q, H, R, y, m0, P0 = _lgssm(3)
    jf = jax.jit(jpk.parallel_kalman_filter)(*_j(A, Q, H, R, y, m0, P0))
    tf = tpk.parallel_kalman_filter(*_tt(A, Q, H, R, y, m0, P0))
    _close(tf.ms, jf.ms)
    _close(tf.Ps, jf.Ps)
    _close(tf.lml, jf.lml)
    js = jax.jit(jpk.parallel_rts_smoother)(jnp.asarray(A), jnp.asarray(Q), jf)
    ts = tpk.parallel_rts_smoother(*_tt(A, Q), tf)
    _close(ts.ms, js.ms)
    _close(ts.Ps, js.Ps)


def test_scan_blocks_must_be_power_of_two(monkeypatch):
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "6")
    _, te = _elems()
    with pytest.raises(ValueError):
        tpk.blocked_inclusive_scan(tpk._filtering_operator, te, tpk._ident_filter_elem(D, te.A))


# ---------------------------------------------------------------------------
# the fused combines inside the scans
# ---------------------------------------------------------------------------


def _port_pass(A, Q, H, R, y, m0, P0, chunk):
    f = tpk.parallel_kalman_filter(*_tt(A, Q, H, R, y, m0, P0), chunk_size=chunk)
    return f, tpk.parallel_rts_smoother(*_tt(A, Q), f, chunk_size=chunk)


@pytest.mark.parametrize("chunk", [CHUNK, None])
def test_fused_scans_match_unfused_and_jax(blocked_env, monkeypatch, chunk):
    monkeypatch.delenv("PHYSS_FUSED_COMBINE", raising=False)
    lg = _lgssm(4)
    A, Q = lg[:2]
    jf = jax.jit(jpk.parallel_kalman_filter, static_argnames="chunk_size")(*_j(*lg), chunk_size=chunk)
    js = jax.jit(jpk.parallel_rts_smoother, static_argnames="chunk_size")(
        jnp.asarray(A), jnp.asarray(Q), jf, chunk_size=chunk
    )
    uf, us = _port_pass(*lg, chunk)
    calls = []
    fused_filter, fused_smooth = tpk.fc.fused_filtering_combine, tpk.fc.fused_smoothing_combine
    monkeypatch.setattr(tpk.fc, "fused_filtering_combine",
                        lambda ei, ej: calls.append("filter") or fused_filter(ei, ej))
    monkeypatch.setattr(tpk.fc, "fused_smoothing_combine",
                        lambda ej, ei: calls.append("smooth") or fused_smooth(ej, ei))
    monkeypatch.setenv("PHYSS_FUSED_COMBINE", "1")
    ff, fs = _port_pass(*lg, chunk)
    # per chunk: L sequential combines + 3 Sklansky levels (8 blocks), + 1 for
    # the smoother's init; the distribute combines stay unfused
    n_chunks, L = (T // CHUNK, CHUNK // 8) if chunk else (1, T // 8)
    assert calls.count("filter") == n_chunks * (L + 3)
    assert calls.count("smooth") == n_chunks * (L + 4)
    for got, unfused, ref in ((ff, uf, jf), (fs, us, js)):
        for name in ("ms", "Ps", "lml", "lmls", "Pp", "Gs"):
            if hasattr(got, name) and getattr(got, name) is not None:
                _close(getattr(got, name), getattr(unfused, name).numpy())
                _close(getattr(got, name), getattr(ref, name))


# ---------------------------------------------------------------------------
# the sequential filter and smoother
# ---------------------------------------------------------------------------


def test_sequential_filter_and_smoother_match_jax():
    lg = _lgssm(5)
    A, Q = lg[:2]
    jf, js = jax.jit(jk.filter_smoother)(*_j(*lg))
    tf, ts = tk.filter_smoother(*_tt(*lg))
    assert tf.Pp is None and ts.Gs.shape == (T, D, D)
    for name in ("ms", "Ps", "lml", "lmls"):
        _close(getattr(tf, name), getattr(jf, name), rtol=1e-10, atol=1e-12)
    for name in ("ms", "Ps", "Gs"):
        _close(getattr(ts, name), getattr(js, name), rtol=1e-10, atol=1e-12)
    assert float(ts.Gs[-1].abs().max()) == 0.0


def test_masked_update_matches_jax():
    _, _, H, R, y, m0, P0 = _lgssm(6)
    k = int(np.argmax(np.isnan(y).any(1) & np.isfinite(y).any(1)))  # partially missing
    mask = np.isfinite(y[k]).astype(np.float64)
    ref = jax.jit(jk.masked_update)(*_j(m0, P0, H, R[k], y[k], mask))
    out = tk.masked_update(*_tt(m0, P0, H, R[k], y[k], mask))
    for a, b in zip(out, ref):
        _close(a, b, rtol=1e-11, atol=1e-13)


def test_parallel_matches_sequential_in_the_port(blocked_env):
    lg = _lgssm(7)
    pf, ps = _port_pass(*lg, CHUNK)
    sf, ss = tk.filter_smoother(*_tt(*lg))
    _close(pf.lml, sf.lml.numpy(), rtol=1e-9)
    _close(pf.ms, sf.ms.numpy(), rtol=1e-7, atol=1e-9)
    _close(pf.Ps, sf.Ps.numpy(), rtol=1e-7, atol=1e-9)
    _close(ps.ms, ss.ms.numpy(), rtol=1e-7, atol=1e-9)
    _close(ps.Ps, ss.Ps.numpy(), rtol=1e-7, atol=1e-9)
    _close(ps.Gs, ss.Gs.numpy(), rtol=1e-6, atol=1e-8)


def test_runner_takes_the_sequential_covariance_path():
    from physs_gp_tpu_torch.ops.lgssm import LGSSM

    A, Q, H, R, y, m0, P0 = _tt(*_lgssm(8))
    ssm = LGSSM(A=A, Q=Q, H=H, m0=m0, P0=P0)
    f, s = runner.run_filter_smoother(ssm, R, y, parallel=False, chunk_size=CHUNK)
    rf, rs = tk.filter_smoother(A, Q, H, R, y, m0, P0)
    assert torch.equal(f.ms, rf.ms) and torch.equal(s.Ps, rs.Ps) and f.Pp is None
    f1, _ = runner.run_filter(ssm, R, y, parallel=False)
    assert torch.equal(f1.lml, rf.lml)
    # the sequential square-root pass (first 32 steps) agrees with it
    n = 32
    short = LGSSM(A=A[:n], Q=Q[:n], H=H, m0=m0, P0=P0)
    fq, sq = runner.run_filter_smoother(short, R[:n], y[:n], parallel=False, sqrt=True)
    rf, rs = tk.filter_smoother(A[:n], Q[:n], H, R[:n], y[:n], m0, P0)
    assert sq.Ls is not None
    for a, b in [(fq.ms, rf.ms), (fq.Ps, rf.Ps), (fq.lml, rf.lml), (sq.ms, rs.ms), (sq.Ps, rs.Ps)]:
        _close(a, b, 1e-9, 1e-10)


# ---------------------------------------------------------------------------
# the runner's padding of a time-varying H
# ---------------------------------------------------------------------------


def _time_varying_h_lgssm(T=10, d=3, p=2, seed=0):
    rng = np.random.default_rng(seed)
    A = np.stack([np.eye(d) * 0.9 + 0.05 * rng.normal(size=(d, d)) for _ in range(T)])
    G = rng.normal(size=(T, d, d)) * 0.3
    Q = G @ np.swapaxes(G, -1, -2) + 0.1 * np.eye(d)
    H = rng.normal(size=(T, p, d))
    R = np.broadcast_to(0.5 * np.eye(p), (T, p, p)).copy()
    y = rng.normal(size=(T, p))
    return A, Q, H, R, y, np.zeros(d), np.eye(d)


@pytest.mark.parametrize("sqrt", [False, True])
def test_runner_pads_a_time_varying_h(sqrt):
    """T = 10 with chunk 4 pads two steps, and a [T, p, d] H repeats its last
    step there, as in the reference runner; chunk 5 needs no padding."""
    from physs_gp_tpu.ops import runner as jrunner
    from physs_gp_tpu.ops.lgssm import LGSSM as JLGSSM
    from physs_gp_tpu_torch.ops.lgssm import LGSSM

    A, Q, H, R, y, m0, P0 = _time_varying_h_lgssm()
    jf, js = jrunner.run_filter_smoother(
        JLGSSM(*_j(A, Q, H, m0, P0)), *_j(R, y), parallel=True, sqrt=sqrt, chunk_size=4)
    tA, tQ, tH, tR, ty, tm0, tP0 = _tt(A, Q, H, R, y, m0, P0)
    ssm = LGSSM(A=tA, Q=tQ, H=tH, m0=tm0, P0=tP0)
    tf, ts = runner.run_filter_smoother(ssm, tR, ty, parallel=True, sqrt=sqrt, chunk_size=4)
    assert tf.ms.shape == (10, 3) and ts.Ps.shape == (10, 3, 3)
    for got, ref in ((tf.lml, jf.lml), (tf.ms, jf.ms), (tf.Ps, jf.Ps), (ts.ms, js.ms), (ts.Ps, js.Ps)):
        _close(got, ref, rtol=1e-10, atol=1e-12)
    uf, us = runner.run_filter_smoother(ssm, tR, ty, parallel=True, sqrt=sqrt, chunk_size=5)
    for got, ref in ((uf.lml, tf.lml), (uf.ms, tf.ms), (uf.Ps, tf.Ps), (us.ms, ts.ms), (us.Ps, ts.Ps)):
        _close(got, ref.numpy(), rtol=1e-10, atol=1e-12)
    f1, _ = runner.run_filter(ssm, tR, ty, parallel=True, sqrt=sqrt, chunk_size=4)
    _close(f1.lml, jf.lml, rtol=1e-10, atol=1e-12)

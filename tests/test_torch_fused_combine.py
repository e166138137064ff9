"""PyTorch port: the fused filtering and smoothing combines against JAX.

The plain PyTorch versions (what the port runs on the CPU, and what the CUDA
kernels are held to on the card) against the JAX package's Pallas kernels in
interpret mode and against its einsum operators (`*_xla`), on the same numpy
inputs, float64: rtol 1e-8, atol 1e-10 per field (the reference's own
tolerance between its fused and einsum combines; the elimination orders
differ). Every batch holds an identity member and a chunk-first member
(A = 0, J = 0, eta = 0), alone and paired with each other: I + C_i J_j is
then exactly I. Gradients of the
port's `autograd.Function`s against `jax.grad` of the JAX fused combines:
rtol 1e-7, atol 1e-9. The `cuda` cases compare each CUDA kernel with its
plain version and skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from physs_gp_tpu_torch.ops import cuda as kernels  # noqa: E402
from physs_gp_tpu_torch.ops import parallel_kalman as tpk  # noqa: E402
from physs_gp_tpu_torch.ops.cuda import fused_combine as tfc  # noqa: E402

torch.set_num_threads(1)

FUSED = ("fused_filter", "fused_smooth")


@pytest.fixture
def jx():
    """The JAX package's fused combines and einsum operators, imported only
    by the tests that compare with them (the `cuda` cases run where JAX is
    not installed)."""
    pytest.importorskip("jax")
    import types

    from physs_gp_tpu.ops import parallel_kalman as jpk
    from physs_gp_tpu.ops.pallas import fused_combine as jfc

    return types.SimpleNamespace(pk=jpk, fc=jfc)


@pytest.fixture
def knobs_off(monkeypatch):
    monkeypatch.delenv("PHYSS_FUSED_COMBINE", raising=False)
    return monkeypatch


def _spd(rng, B, d, dom):
    A = rng.normal(size=(B, d, d))
    return A @ np.swapaxes(A, -1, -2) / d + dom * np.eye(d)


def _filter_fields(rng, B, d, special=(0, 1)):
    """(A, b, C, J, eta) as numpy; member special[0] is the identity element,
    member special[1] a chunk's first element."""
    i, f = special
    A = rng.normal(size=(B, d, d)) * 0.1
    b = rng.normal(size=(B, d))
    C = _spd(rng, B, d, 1.0) * 0.3
    J = _spd(rng, B, d, 1.0) * 0.3
    eta = rng.normal(size=(B, d))
    A[i], b[i], C[i], J[i], eta[i] = np.eye(d), 0.0, 0.0, 0.0, 0.0
    A[f], J[f], eta[f] = 0.0, 0.0, 0.0
    return A, b, C, J, eta


def _smoother_fields(rng, B, d, special=(0, 1)):
    """(E, g, L) as numpy; member special[0] is the identity element, member
    special[1] a last element (E = 0)."""
    i, f = special
    E = rng.normal(size=(B, d, d)) * 0.2
    g = rng.normal(size=(B, d))
    L = _spd(rng, B, d, 0.5)
    E[i], g[i], L[i] = np.eye(d), 0.0, 0.0
    E[f] = 0.0
    return E, g, L


def _t(fields, cls):
    return cls(*[torch.from_numpy(np.ascontiguousarray(x)) for x in fields])


def _j(fields, cls):
    import jax.numpy as jnp

    return cls(*[jnp.asarray(x) for x in fields])


def _assert_fields(out, ref, rtol=1e-8, atol=1e-10):
    for name, a, b in zip(out._fields, out, ref):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol, err_msg=name)


SHAPES = [(130, 9), (150, 11), (128, 4)]


@pytest.mark.parametrize("B,d", SHAPES)
def test_filter_plain_matches_pallas_interpret(jx, monkeypatch, B, d):
    monkeypatch.setattr(jx.fc, "_INTERPRET", True)
    rng = np.random.default_rng(B + d)
    fi, fj = _filter_fields(rng, B, d), _filter_fields(rng, B, d, special=(0, 2))
    out = tfc.fused_filter_plain(_t(fi, tpk._FilterElems), _t(fj, tpk._FilterElems))
    ji, jj = _j(fi, jx.pk._FilterElems), _j(fj, jx.pk._FilterElems)
    _assert_fields(out, jx.fc.fused_filtering_combine(ji, jj))
    _assert_fields(out, jx.pk._filtering_operator_xla(ji, jj))


@pytest.mark.parametrize("B,d", SHAPES)
def test_smooth_plain_matches_pallas_interpret(jx, monkeypatch, B, d):
    monkeypatch.setattr(jx.fc, "_INTERPRET", True)
    rng = np.random.default_rng(2 * B + d)
    fj, fi = _smoother_fields(rng, B, d), _smoother_fields(rng, B, d, special=(0, 2))
    out = tfc.fused_smooth_plain(_t(fj, tpk._SmootherElems), _t(fi, tpk._SmootherElems))
    jj, ji = _j(fj, jx.pk._SmootherElems), _j(fi, jx.pk._SmootherElems)
    _assert_fields(out, jx.fc.fused_smoothing_combine(jj, ji))
    _assert_fields(out, jx.pk._smoothing_operator_xla(jj, ji))


def test_plain_matches_einsum_operators_at_d32(jx):
    """d = 32, the main path's width, against the einsum operators only (the
    interpreter unrolls d steps and compiles slowly at d = 32)."""
    rng = np.random.default_rng(32)
    B, d = 16, 32
    fi, fj = _filter_fields(rng, B, d), _filter_fields(rng, B, d)
    out = tfc.fused_filter_plain(_t(fi, tpk._FilterElems), _t(fj, tpk._FilterElems))
    _assert_fields(out, jx.pk._filtering_operator_xla(
        _j(fi, jx.pk._FilterElems), _j(fj, jx.pk._FilterElems)))
    sj, si = _smoother_fields(rng, B, d), _smoother_fields(rng, B, d)
    out = tfc.fused_smooth_plain(_t(sj, tpk._SmootherElems), _t(si, tpk._SmootherElems))
    _assert_fields(out, jx.pk._smoothing_operator_xla(
        _j(sj, jx.pk._SmootherElems), _j(si, jx.pk._SmootherElems)))


def test_identity_and_first_element_members():
    """ident ∘ x = x up to the symmetrisation, and a first element (A = 0,
    J = 0, eta = 0) on the left gives A = 0 and J = 0 exactly."""
    rng = np.random.default_rng(1)
    B, d = 8, 7
    x = _t(_filter_fields(rng, B, d), tpk._FilterElems)
    ident = tpk._map(lambda v: v.expand((B,) + tuple(v.shape)), tpk._ident_filter_elem(d, x.A))
    out = tfc.fused_filtering_combine(ident, x)
    _assert_fields(out, [v.numpy() for v in x], rtol=1e-14, atol=1e-15)
    first = tpk._map(lambda v: v[1:2].expand((B,) + tuple(v.shape[1:])), x)
    out = tfc.fused_filtering_combine(first, x)
    assert float(out.A.abs().max()) == 0.0 and float(out.J.abs().max()) == 0.0
    assert torch.isfinite(torch.cat([v.reshape(-1) for v in out])).all()


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


def test_fused_filtering_gradient_matches_jax(jx, knobs_off):
    import jax
    import jax.numpy as jnp

    knobs_off.setattr(jx.fc, "_INTERPRET", True)
    knobs_off.setenv("PHYSS_FUSED_COMBINE", "1")
    rng = np.random.default_rng(4)
    B, d = 128, 4
    fi, fj = _filter_fields(rng, B, d), _filter_fields(rng, B, d)

    def jloss(a, b):
        o = jx.fc.fused_filtering_combine(a, b)
        return jnp.sum(o.b ** 2) + jnp.sum(o.C ** 2) + jnp.sum(o.eta * o.b)

    ref = jax.grad(jloss, argnums=(0, 1))(_j(fi, jx.pk._FilterElems), _j(fj, jx.pk._FilterElems))
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (*fi, *fj)]
    o = tpk._filtering_operator(tpk._FilterElems(*leaves[:5]), tpk._FilterElems(*leaves[5:]))
    assert o.A.grad_fn.name().startswith("_FusedCombine")
    loss = torch.sum(o.b ** 2) + torch.sum(o.C ** 2) + torch.sum(o.eta * o.b)
    grads = torch.autograd.grad(loss, leaves)
    for g, r in zip(grads, jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-7, atol=1e-9)


def test_fused_smoothing_gradient_matches_jax(jx, knobs_off):
    import jax
    import jax.numpy as jnp

    knobs_off.setattr(jx.fc, "_INTERPRET", True)
    knobs_off.setenv("PHYSS_FUSED_COMBINE", "1")
    rng = np.random.default_rng(5)
    B, d = 128, 4
    fj, fi = _smoother_fields(rng, B, d), _smoother_fields(rng, B, d)

    def jloss(a, b):
        o = jx.fc.fused_smoothing_combine(a, b)
        return jnp.sum(o.g ** 2) + jnp.sum(o.L ** 2) + jnp.sum(o.E * o.L)

    ref = jax.grad(jloss, argnums=(0, 1))(
        _j(fj, jx.pk._SmootherElems), _j(fi, jx.pk._SmootherElems))
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (*fj, *fi)]
    o = tpk._smoothing_operator(tpk._SmootherElems(*leaves[:3]), tpk._SmootherElems(*leaves[3:]))
    assert o.E.grad_fn.name().startswith("_FusedCombine")
    loss = torch.sum(o.g ** 2) + torch.sum(o.L ** 2) + torch.sum(o.E * o.L)
    grads = torch.autograd.grad(loss, leaves)
    for g, r in zip(grads, jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-7, atol=1e-9)


# ---------------------------------------------------------------------------
# the views the blocked scan passes
# ---------------------------------------------------------------------------


def _scan_views(elems, ident, B, L, l):
    """(carry, x[l]) as the blocked scan's first pass builds them: the
    identity expanded with batch stride 0 and a strided view of [L, B, ...]."""
    blocked = tpk._map(
        lambda x: x.reshape((B, L) + tuple(x.shape[1:])).transpose(0, 1), elems)
    carry = tpk._map(lambda x: x.expand((B,) + tuple(x.shape)), ident)
    return carry, tpk._map(lambda x: x[l], blocked)


def test_strided_and_broadcast_operands_match_contiguous_copies():
    rng = np.random.default_rng(6)
    B, L, d = 8, 5, 6
    elems = _t(_filter_fields(rng, B * L, d), tpk._FilterElems)
    carry, x = _scan_views(elems, tpk._ident_filter_elem(d, elems.A), B, L, 2)
    assert carry.A.stride(0) == 0 and x.A.stride(0) == L * d * d and x.b.stride(0) == L * d
    out = tfc.fused_filtering_combine(carry, x)
    ref = tfc.fused_filtering_combine(
        tpk._map(lambda v: v.contiguous(), carry), tpk._map(lambda v: v.contiguous(), x))
    for a, b in zip(out, ref):
        assert a.is_contiguous() and torch.equal(a, b)
    selems = _t(_smoother_fields(rng, B * L, d), tpk._SmootherElems)
    carry, x = _scan_views(selems, tpk._ident_smoother_elem(d, selems.E), B, L, 3)
    out = tfc.fused_smoothing_combine(carry, x)
    ref = tfc.fused_smoothing_combine(
        tpk._map(lambda v: v.contiguous(), carry), tpk._map(lambda v: v.contiguous(), x))
    for a, b in zip(out, ref):
        assert a.is_contiguous() and torch.equal(a, b)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_use_fused_combine_knobs(knobs_off):
    f64, f32 = torch.float64, torch.float32

    def use(shape, dtype, **kw):
        return tfc.use_fused_combine(shape, shape, dtype, **kw)

    assert not use((256, 32, 32), f32)  # off by default
    knobs_off.setenv("PHYSS_FUSED_COMBINE", "1")
    assert use((256, 32, 32), f32)
    assert use((128, 32, 32), f64, smoothing=True)
    assert use((25_000, 32, 32), f32)
    assert use((1, 3, 3), f64)  # no batch or TPU width gate
    assert not use((256, 2, 2), f64)
    assert not use((32, 32), f64)
    assert not use((4, 256, 32, 32), f64)
    assert not tfc.use_fused_combine((1, 32, 32), (256, 32, 32), f64)  # unequal shapes
    assert tfc.use_fused_combine(torch.Size((8, 5, 5)), (8, 5, 5), f64)
    # the filtering kernel holds d <= 56 in float64 and d <= 79 in float32
    assert use((8, 56, 56), f64) and not use((8, 57, 57), f64)
    assert use((8, 79, 79), f32) and not use((8, 80, 80), f32)
    # the smoothing kernel is smaller
    assert use((8, 75, 75), f64, smoothing=True)
    assert not use((8, 76, 76), f64, smoothing=True)


def test_operators_route_by_knob_and_shape(knobs_off):
    rng = np.random.default_rng(7)
    calls = []
    knobs_off.setattr(tpk.fc, "fused_filtering_combine",
                      lambda ei, ej: calls.append("filter") or tfc.fused_filter_plain(ei, ej))
    knobs_off.setattr(tpk.fc, "fused_smoothing_combine",
                      lambda ej, ei: calls.append("smooth") or tfc.fused_smooth_plain(ej, ei))

    def run(B, d):
        x = _t(_filter_fields(rng, B, d), tpk._FilterElems)
        s = _t(_smoother_fields(rng, B, d), tpk._SmootherElems)
        del calls[:]
        out = tpk._filtering_operator(x, x), tpk._smoothing_operator(s, s)
        ref = tpk._filtering_operator_unfused(x, x), tpk._smoothing_operator_unfused(s, s)
        for o, r in zip(out, ref):
            _assert_fields(o, [v.numpy() for v in r], rtol=1e-10, atol=1e-12)
        return list(calls)

    assert run(6, 5) == []  # knob unset
    knobs_off.setenv("PHYSS_FUSED_COMBINE", "1")
    assert run(6, 5) == ["filter", "smooth"]
    assert run(3, 57) == ["smooth"]  # the filtering kernel cannot hold d = 57 in float64
    # mismatched shapes (one element against a batch) stay unfused
    x = _t(_filter_fields(rng, 6, 5), tpk._FilterElems)
    del calls[:]
    tpk._filtering_operator(tpk._map(lambda v: v[:1], x), x)
    assert calls == []


def test_direct_call_raises_on_what_the_kernel_does_not_take():
    rng = np.random.default_rng(8)
    big = _t(_filter_fields(rng, 2, 57), tpk._FilterElems)
    with pytest.raises(ValueError, match="shared memory"):
        tfc.fused_filtering_combine(big, big)
    sbig = _t(_smoother_fields(rng, 2, 76), tpk._SmootherElems)
    with pytest.raises(ValueError, match="shared memory"):
        tfc.fused_smoothing_combine(sbig, sbig)
    small = _t(_filter_fields(rng, 2, 2), tpk._FilterElems)
    with pytest.raises(ValueError):
        tfc.fused_filtering_combine(small, small)
    x = _t(_filter_fields(rng, 4, 5), tpk._FilterElems)
    with pytest.raises(ValueError):
        tfc.fused_filtering_combine(x, tpk._map(lambda v: v[:3], x))
    with pytest.raises(ValueError):
        tfc.fused_filtering_combine(x, x._replace(b=x.b[:, :4]))


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("smoothing", [False, True])
def test_fused_plan(itemsize, smoothing):
    """d <= 32 takes the tiled route (128 threads, the same tiles at every d
    and N); larger d the block route (a thread per element, at most 256),
    within a block's shared memory wherever `fits` says the kernel does."""
    from physs_gp_tpu_torch.ops.cuda.build import SMEM_LIMIT

    dtype = {4: torch.float32, 8: torch.float64}[itemsize]
    pitch = 36 if itemsize == 4 else 34  # 32 columns at 16 (mod 32) bytes
    tiled = (5 * 32 * pitch + 2 * 32 if smoothing else 10 * 32 * pitch + 6 * 32) * itemsize
    for d in range(3, 81):
        for N in (1, 128, 256, 25_000):
            route, threads, smem = tfc.fused_plan(N, d, itemsize, smoothing)
            if d <= 32:
                assert (route, threads, smem) == ("tiled", 128, tiled)
            else:
                words = 5 * d * (d + 1) + d if smoothing else 9 * d * (d + 1) + 4 * d
                assert (route, threads, smem) == ("block", min(256, -(-d * d // 32) * 32), words * itemsize)
            assert threads % 32 == 0 and threads <= 256
            assert (smem <= SMEM_LIMIT) == tfc.fits(d, dtype, smoothing)
    assert tfc.fused_plan(256, 32, itemsize, smoothing)[2] <= (48 * 1024 if itemsize == 4 else 90 * 1024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fits_per_route(dtype):
    """The tiled route holds every 3 <= d <= 32 in both types; the block
    route's limits are filtering d <= 56 / 79, smoothing 75 / 107 (float64 /
    float32)."""
    for smoothing in (False, True):
        assert not tfc.fits(2, dtype, smoothing)
        assert all(tfc.fits(d, dtype, smoothing) for d in range(3, 33))
        assert all(tfc.fused_plan(1, d, dtype.itemsize, smoothing)[0] == "tiled" for d in range(3, 33))
    top = {(torch.float64, False): 56, (torch.float32, False): 79,
           (torch.float64, True): 75, (torch.float32, True): 107}
    for smoothing in (False, True):
        d = top[dtype, smoothing]
        assert tfc.fits(d, dtype, smoothing) and not tfc.fits(d + 1, dtype, smoothing)
        assert tfc.fused_plan(1, d, dtype.itemsize, smoothing)[0] == "block"


def test_cpu_path_counts_no_launch():
    rng = np.random.default_rng(9)
    kernels.reset_launch_counts(*FUSED)
    x = _t(_filter_fields(rng, 4, 5), tpk._FilterElems)
    s = _t(_smoother_fields(rng, 4, 5), tpk._SmootherElems)
    tfc.fused_filtering_combine(x, x)
    tfc.fused_smoothing_combine(s, s)
    assert kernels.launch_counts(*FUSED) == {"fused_filter": 0, "fused_smooth": 0}


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# max |kernel - plain| / max |plain| per field: the solve's tolerances
_CARD_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _card_close(out, ref, tol):
    for name, a, b in zip(out._fields, out, ref):
        err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        assert a.is_contiguous() and err <= tol, (name, err)


def _route(d):
    return "tiled" if d <= 32 else "block"


def _check_pair(ei, ej, sj, si, dtype, d, n_filter=1):
    """Both kernels against their plain versions on the card, each launch on
    the route its shape selects."""
    kernels.reset_launch_counts(*FUSED)
    _card_close(tfc.fused_filtering_combine(ei, ej), tfc.fused_filter_plain(ei, ej), _CARD_TOL[dtype])
    _card_close(tfc.fused_smoothing_combine(sj, si), tfc.fused_smooth_plain(sj, si), _CARD_TOL[dtype])
    torch.cuda.synchronize()
    assert kernels.launch_counts(*FUSED) == {"fused_filter": n_filter, "fused_smooth": 1}
    routes = kernels.route_counts(*FUSED)
    assert routes["fused_filter"][_route(d)] == n_filter and routes["fused_smooth"][_route(d)] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("B,d", [(256, 32), (300, 7), (5, 56), (2500, 32)])
def test_cuda_kernels_match_plain(cuda, dtype, B, d):
    rng = np.random.default_rng(B + d)
    to = lambda e: tpk._map(lambda v: v.to(cuda, dtype), e)  # noqa: E731
    ei, ej = (to(_t(_filter_fields(rng, B, d), tpk._FilterElems)) for _ in range(2))
    sj, si = (to(_t(_smoother_fields(rng, B, d), tpk._SmootherElems)) for _ in range(2))
    _check_pair(ei, ej, sj, si, dtype, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [3, 7, 31, 32, 33, 56])
@pytest.mark.parametrize("B", [1, 127, 128, 255, 256, 257, 25_000])
def test_cuda_kernels_match_plain_per_route(cuda, dtype, d, B):
    """The tiled route (d <= 32) and the block route (d = 33, 56) at the
    scans' batches, around them, and at full width; member 0 is the identity
    element and member 1 (or 0 at B = 1) a chunk's first / a last element."""
    rng = np.random.default_rng(1000 * d + B)
    to = lambda e: tpk._map(lambda v: v.to(cuda, dtype), e)  # noqa: E731
    sp = (0, min(1, B - 1))
    ei = to(_t(_filter_fields(rng, B, d, special=sp), tpk._FilterElems))
    ej = to(_t(_filter_fields(rng, B, d, special=sp[::-1] if B > 1 else sp), tpk._FilterElems))
    sj = to(_t(_smoother_fields(rng, B, d, special=sp), tpk._SmootherElems))
    si = to(_t(_smoother_fields(rng, B, d, special=sp), tpk._SmootherElems))
    _check_pair(ei, ej, sj, si, dtype, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_kernels_take_the_scan_views(cuda, dtype):
    rng = np.random.default_rng(10)
    B, L, d = 256, 3, 32
    kernels.reset_launch_counts(*FUSED)
    elems = tpk._map(lambda v: v.to(cuda, dtype), _t(_filter_fields(rng, B * L, d), tpk._FilterElems))
    carry, x = _scan_views(elems, tpk._ident_filter_elem(d, elems.A), B, L, 1)
    _card_close(tfc.fused_filtering_combine(carry, x), tfc.fused_filter_plain(carry, x), _CARD_TOL[dtype])
    _card_close(tfc.fused_filtering_combine(x, x), tfc.fused_filter_plain(x, x), _CARD_TOL[dtype])
    selems = tpk._map(lambda v: v.to(cuda, dtype), _t(_smoother_fields(rng, B * L, d), tpk._SmootherElems))
    carry, x = _scan_views(selems, tpk._ident_smoother_elem(d, selems.E), B, L, 2)
    _card_close(tfc.fused_smoothing_combine(carry, x), tfc.fused_smooth_plain(carry, x), _CARD_TOL[dtype])
    torch.cuda.synchronize()
    assert kernels.route_counts(*FUSED) == {"fused_filter": {"tiled": 2, "block": 0},
                                            "fused_smooth": {"tiled": 1, "block": 0}}


def _shifted(x):
    """x's values in a view that starts one element into its storage (off
    the 16-byte staging)."""
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


def _odd_rows(x):
    """x [N, d, d]'s values with an odd row stride."""
    N, r, c = x.shape
    wide = torch.zeros(N, r, c + 3 - c % 2, dtype=x.dtype, device=x.device)
    wide[..., :c] = x
    return wide[..., :c]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [7, 32, 33])
def test_cuda_kernels_take_unaligned_and_odd_strided_operands(cuda, dtype, d):
    """Operands that start mid-storage, have an odd row stride, or a
    stride-0 batch, beside aligned ones in the same launch: each operand is
    staged 16 bytes at a time or one element at a time on its own."""
    from physs_gp_tpu_torch.ops.cuda import build

    rng = np.random.default_rng(20 + d)
    B = 257
    to = lambda e: tpk._map(lambda v: v.to(cuda, dtype), e)  # noqa: E731
    ei, ej = (to(_t(_filter_fields(rng, B, d), tpk._FilterElems)) for _ in range(2))
    odd = tpk._FilterElems(A=_shifted(ei.A), b=_shifted(ei.b), C=_odd_rows(ei.C), J=ei.J[:1].expand(B, d, d),
                           eta=_shifted(ei.eta))
    assert not build.aligned16(odd.A) and not build.aligned16(odd.C)
    sj, si = (to(_t(_smoother_fields(rng, B, d), tpk._SmootherElems)) for _ in range(2))
    sodd = tpk._SmootherElems(E=_odd_rows(si.E), g=_shifted(si.g), L=_shifted(si.L))
    _check_pair(odd, ej, sj, sodd, dtype, d)
    _check_pair(ej, odd, sodd, sj, dtype, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [5, 32, 40])
def test_cuda_identity_and_first_element_members(cuda, dtype, d):
    """ident ∘ x = x up to the symmetrisation, and a first element (A = 0,
    J = 0, eta = 0) on the left gives A = 0 and J = 0 exactly: I + C_i J_j
    is then exactly I."""
    rng = np.random.default_rng(30 + d)
    B = 128
    x = tpk._map(lambda v: v.to(cuda, dtype), _t(_filter_fields(rng, B, d), tpk._FilterElems))
    ident = tpk._map(lambda v: v.expand((B,) + tuple(v.shape)), tpk._ident_filter_elem(d, x.A))
    kernels.reset_launch_counts(*FUSED)
    out = tfc.fused_filtering_combine(ident, x)
    _card_close(out, tfc.fused_filter_plain(ident, x), _CARD_TOL[dtype])
    sym = x._replace(C=0.5 * (x.C + x.C.mT), J=0.5 * (x.J + x.J.mT))
    _card_close(out, sym, _CARD_TOL[dtype])
    first = tpk._map(lambda v: v[1:2].expand((B,) + tuple(v.shape[1:])), x)
    out = tfc.fused_filtering_combine(first, x)
    torch.cuda.synchronize()
    assert float(out.A.abs().max()) == 0.0 and float(out.J.abs().max()) == 0.0
    assert torch.isfinite(torch.cat([v.reshape(-1) for v in out])).all()
    assert kernels.route_counts("fused_filter")["fused_filter"][_route(d)] == 2


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    rng = np.random.default_rng(11)
    x = tpk._map(lambda v: v.to(cuda), _t(_filter_fields(rng, 4, 5), tpk._FilterElems))
    with pytest.raises(ValueError, match="unit stride"):
        tfc.fused_filtering_combine(x, x._replace(A=x.A.transpose(-1, -2)))
    with pytest.raises(TypeError):
        tfc.fused_filtering_combine(x, x._replace(A=x.A.float()))
    with pytest.raises(ValueError):
        tfc.fused_filtering_combine(x, x._replace(A=x.A.cpu()))

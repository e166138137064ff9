"""PyTorch port: batched linear-algebra kernels against the Pallas kernels.

The plain PyTorch versions (what the port runs on the CPU, and what the CUDA
kernels are held to on the card) are compared with the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs, in float64:
rtol 1e-12 for products, 1e-10 for solves and log-determinants. Larger state
dimensions (64, 80) are checked against numpy.linalg. The product's launch
shape (`bmm_plan`) and the 16-byte staging rule (`build.aligned16`) are pure
Python and are held here for every (m, n, k) up to 80 in both types, as is
the solve's (`gj_plan`: a warp per system for d <= 32, a block above) for
every d up to 80. The `cuda` cases compare each CUDA kernel with its plain
version, on aligned, unaligned, strided and stride-0 operands and ragged
batches, and skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl  # noqa: E402
from physs_gp_tpu_torch.ops.cuda import build  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def jbl():
    """The JAX package's Pallas kernels, imported only by the tests that
    compare with them (the `cuda` cases run where JAX is not installed)."""
    return pytest.importorskip("physs_gp_tpu.ops.pallas.batched_linalg")


def _j(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


SHAPES = [(1, 7), (1, 32), (130, 7), (130, 32), (300, 7), (300, 32)]


def _spd(rng, N, d, dom=5.0):
    A = rng.normal(size=(N, d, d))
    return A @ np.swapaxes(A, -1, -2) / d + dom * np.eye(d)


def _icj(rng, N, d):
    """Identity-dominated I + C J, the filtering combine's system."""
    C = _spd(rng, N, d, 1.0) * 0.1
    J = _spd(rng, N, d, 1.0) * 0.1
    return np.eye(d) + C @ J


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("N,d", SHAPES)
def test_bmm_plain_matches_pallas(jbl, N, d, ta, tb):
    rng = np.random.default_rng(N * 100 + d)
    A = rng.normal(size=(N, d, d))
    B = rng.normal(size=(N, d, d))
    ref = jbl.batch_bmm(_j(A), _j(B), ta=ta, tb=tb, interpret=True)
    out = bl.batch_bmm(_t(A), _t(B), ta, tb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("N,d", [(1, 7), (300, 32)])
def test_batch_matmul_plain_matches_pallas(jbl, N, d):
    rng = np.random.default_rng(d)
    A = rng.normal(size=(N, d, d))
    B = rng.normal(size=(N, d, d))
    ref = jbl.batch_matmul(_j(A), _j(B), interpret=True)
    out = bl.batch_matmul(_t(A), _t(B))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("N,d", SHAPES)
def test_gj_solve_plain_matches_pallas(jbl, N, d):
    rng = np.random.default_rng(N + d)
    M = _icj(rng, N, d)
    R = rng.normal(size=(N, d, 2 * d + 1))
    ref = jbl.batch_solve(_j(M), _j(R), interpret=True)
    out = bl.batch_solve(_t(M), _t(R))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("N,d", SHAPES)
def test_gj_solve_logdet_plain_matches_pallas(jbl, N, d):
    rng = np.random.default_rng(7 * N + d)
    M = _spd(rng, N, d)
    R = rng.normal(size=(N, d, d))
    X_ref, ld_ref = jbl.batch_solve_logdet(_j(M), _j(R), interpret=True)
    X, ld = bl.batch_solve_logdet(_t(M), _t(R))
    np.testing.assert_allclose(X.numpy(), np.asarray(X_ref), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), rtol=1e-10)


@pytest.mark.parametrize("d", [64, 80])
def test_large_d_plain_matches_numpy(d):
    rng = np.random.default_rng(d)
    N = 5
    M = _spd(rng, N, d)
    R = rng.normal(size=(N, d, 3))
    A = rng.normal(size=(N, d, d))
    X = bl.batch_solve(_t(M), _t(R)).numpy()
    np.testing.assert_allclose(X, np.linalg.solve(M, R), rtol=1e-10, atol=1e-12)
    X2, ld = bl.batch_solve_logdet(_t(M), _t(R))
    np.testing.assert_allclose(X2.numpy(), np.linalg.solve(M, R), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ld.numpy(), np.linalg.slogdet(M)[1], rtol=1e-10)
    C = bl.batch_bmm(_t(A), _t(M), True, False).numpy()
    np.testing.assert_allclose(C, np.swapaxes(A, -1, -2) @ M, rtol=1e-12, atol=1e-12)


def test_cpu_path_counts_no_launch():
    bl.reset_launch_counts()
    x = torch.eye(3, dtype=torch.float64).expand(4, 3, 3)
    bl.batch_bmm(x, x)
    bl.batch_solve(x, x)
    bl.batch_solve_logdet(x, x)
    assert bl.launch_counts() == {"bmm": 0, "gj_solve": 0, "gj_solve_logdet": 0}
    assert build.route_counts("gj_solve", "gj_solve_logdet") == {}


def test_wrappers_reject_bad_operands():
    x = torch.zeros(2, 3, 3)
    with pytest.raises(ValueError):
        bl.batch_bmm(x, torch.zeros(2, 4, 3))
    with pytest.raises(ValueError):
        bl.batch_solve(torch.zeros(2, 3, 4), x)


# ---------------------------------------------------------------------------
# The launcher's choices, pure Python
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("m", [1, 3, 4, 7, 16, 31, 32, 33, 64, 65, 79, 80])
def test_bmm_plan_fits_the_card(m, itemsize):
    """Every (m, n, k) up to 80, every transpose, small and large batches:
    at least one product per block, whole warps within the kernel's launch
    bound, shared memory within what a block may use, and every tile of
    every product of the block reachable by the block's threads."""
    for n in range(1, 81):
        for k in (1, 2, 7, 31, 32, 33, 65, 80):
            for ta in (False, True):
                for tb in (False, True):
                    for N in (1, 128, 256, 25_000):
                        G, threads, smem = bl.bmm_plan(N, m, n, k, ta, tb, itemsize)
                        assert 1 <= G <= max(1, N)
                        assert 32 <= threads <= 512 and threads % 32 == 0
                        assert smem <= build.SMEM_LIMIT
                        ra, ca = (k, m) if ta else (m, k)
                        rb, cb = (n, k) if tb else (k, n)
                        words = build.ceil4(ra) * build.row_pitch(ca, itemsize) \
                            + build.ceil4(rb) * build.row_pitch(cb, itemsize)
                        assert smem == G * words * itemsize
                        if G > 1:  # grouped products leave every SM two blocks
                            assert -(-N // G) >= 2 * build.SM_COUNT and smem <= 48 * 1024


@pytest.mark.parametrize("itemsize", [4, 8])
def test_bmm_plan_groups_at_d32(itemsize):
    """d = 32: four products per 256-thread block in float32 at full width
    (the earlier 256 // (m n) gave 0 there), one per 64-thread block at the
    scan's batch so that 256 products reach every SM."""
    G, threads, smem = bl.bmm_plan(25_000, 32, 32, 32, False, True, itemsize)
    assert G == (4 if itemsize == 4 else 2) and threads == 64 * G
    assert bl.bmm_plan(256, 32, 32, 32, False, True, itemsize)[:2] == (1, 64)
    assert bl.bmm_plan(1, 80, 80, 80, False, False, itemsize)[:2] == (1, 416)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("d", [1, 2, 7, 16, 31, 32, 33, 48, 64, 79, 80])
def test_gj_plan_fits_the_card(d, itemsize):
    """Every system width up to 80, right-hand sides from none to past the
    warp kernel's 256, small and large batches: a warp per system with
    ceil(r / 32) warps (at least one) up to d = 32, a block per system
    above; whole warps within the launch bound of 256, shared memory within
    what a block may use (the wrapper refuses a block-kernel shape that
    needs more)."""
    for r in (0, 1, 2, 31, 32, 33, 64, 65, 96, 97, 128, 255, 256, 257, 300):
        for N in (1, 128, 256, 512, 25_000, 100_000):
            G, threads, smem = bl.gj_plan(N, d, r, itemsize)
            assert 32 <= threads <= 256 and threads % 32 == 0
            if d <= bl.WARP_D and r <= bl.WARP_R:
                wpm = max(1, -(-r // 32))
                assert 1 <= G <= max(1, N) and threads == 32 * wpm * G
                assert smem == G * (32 * 32 + 32) * itemsize <= build.SMEM_LIMIT
                if G > 1:  # grouped systems leave every SM two blocks
                    assert -(-N // G) >= 2 * build.SM_COUNT
            else:
                assert G == 1 and smem == (d * (d + r) + d + (d + r)) * itemsize
                assert smem <= build.SMEM_LIMIT or r > 2 * d + 1


@pytest.mark.parametrize("itemsize", [4, 8])
def test_gj_plan_at_the_main_shapes(itemsize):
    """The scan's inverse [256, 32, 32] (r = 32) and the square-root scan's
    [512, 32, 32] (r = 64) run one system a block, so that every SM gets
    work; full width packs 8 warps a block; d = 64 and 80 keep a block per
    system."""
    assert bl.gj_plan(256, 32, 32, itemsize)[:2] == (1, 32)
    assert bl.gj_plan(128, 32, 32, itemsize)[:2] == (1, 32)
    assert bl.gj_plan(512, 32, 64, itemsize)[:2] == (1, 64)
    assert bl.gj_plan(25_000, 32, 65, itemsize)[:2] == (2, 192)
    assert bl.gj_plan(25_000, 32, 1, itemsize)[:2] == (8, 256)
    assert bl.gj_plan(100_000, 32, 32, itemsize)[:2] == (8, 256)
    assert bl.gj_plan(2000, 64, 65, itemsize)[:2] == (1, 256)
    assert bl.gj_plan(1, 80, 80, itemsize)[:2] == (1, 256)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_row_pitch_alignment_and_banks(itemsize):
    for cols in range(1, 200):
        pitch = build.row_pitch(cols, itemsize)
        assert pitch >= build.ceil4(cols) and pitch - build.ceil4(cols) <= 16 // itemsize
        assert (pitch * itemsize) % 32 == 16  # rows 16-byte aligned, 4 banks apart


@pytest.mark.parametrize(
    "ptr,batch,row,itemsize,expected",
    [(4096, 1024, 32, 4, True), (4096, 0, 32, 4, True), (4100, 1024, 32, 4, False),
     (4096, 1023, 32, 4, False), (4096, 1024, 33, 4, False), (4096, 1024, 65, 4, False),
     (4096, 1024, 2, 8, True), (4104, 1024, 2, 8, False), (4096, 1024, 33, 8, False),
     (4096, 1025, 32, 8, False), (4096, 1056, 36, 4, True), (4112, 0, 0, 8, True)],
)
def test_vector_staging_only_for_16_byte_layouts(ptr, batch, row, itemsize, expected):
    assert build.layout_aligned16(ptr, batch, row, itemsize) is expected


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_aligned16_of_views(dtype):
    """The scan's operands: contiguous and stride-0 batches take 16-byte
    staging; a view that starts one element into its storage or has an odd
    row stride does not."""
    N, d = 5, 32
    base = torch.zeros(N * d * d + 4, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    assert build.aligned16(base[: N * d * d].view(N, d, d))
    assert build.aligned16(base[: d * d].view(1, d, d).expand(N, d, d))
    assert build.aligned16(torch.zeros(N, d, 2 * d, dtype=dtype)[..., d:])
    assert not build.aligned16(base[1: 1 + N * d * d].view(N, d, d))
    assert not build.aligned16(torch.zeros(N, d, d + 1, dtype=dtype)[..., :d])
    assert not build.aligned16(torch.zeros(N, d, 2 * d + 1, dtype=dtype)[..., d:2 * d])


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_CARD_TOL = {torch.float64: (1e-12, 1e-10), torch.float32: (1e-5, 1e-4)}


def _close(x, ref, rtol):
    err = (x - ref).abs().max() / ref.abs().max()
    assert float(err) <= rtol, float(err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,d", [(1, 80), (300, 7), (2500, 32)])
def test_cuda_kernels_match_plain(cuda, dtype, N, d):
    rng = np.random.default_rng(N + d)
    mm_tol, solve_tol = _CARD_TOL[dtype]
    A = _t(rng.normal(size=(N, d, d))).to(cuda, dtype)
    B = _t(rng.normal(size=(N, d, d))).to(cuda, dtype)
    for ta in (False, True):
        for tb in (False, True):
            _close(bl.batch_bmm(A, B, ta, tb), bl.bmm_plain(A, B, ta, tb), mm_tol)
    M = _t(_icj(rng, N, d)).to(cuda, dtype)
    S = _t(_spd(rng, N, d)).to(cuda, dtype)
    for r in (1, d, min(2 * d + 1, 80)):
        R = _t(rng.normal(size=(N, d, r))).to(cuda, dtype)
        _close(bl.batch_solve(M, R), bl.gj_solve_plain(M, R), solve_tol)
        X, ld = bl.batch_solve_logdet(S, R)
        Xp, ldp = bl.gj_solve_logdet_plain(S, R)
        _close(X, Xp, solve_tol)
        _close(ld, ldp, solve_tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_routing_of_views(cuda, dtype):
    """ops.matrix hands column slices, transposed views and broadcast
    batches to the kernels without copies; results match the CPU path."""
    from physs_gp_tpu_torch.ops import matrix

    rng = np.random.default_rng(0)
    N, d = 500, 32
    S = _t(_spd(rng, N, d))
    rhs = _t(rng.normal(size=(N, d, 2 * d + 1)))
    H = _t(rng.normal(size=(N, d, d)))
    eye = torch.eye(d, dtype=torch.float64).expand(N, d, d)

    def run(dev):
        s, r, h, e = (x.to(dev, dtype) for x in (S, rhs, H, eye))
        sol = matrix.psd_solve(s, r)
        X = matrix.bmm(sol[..., :d].transpose(-1, -2), h, tb=True)
        Vinv, ld = matrix.psd_solve_logdet(s, e)
        U = matrix.gen_solve(e + 0.1 * matrix.bmm(h, h, ta=True) / d, e)
        return [t.double().cpu() for t in (sol, X, Vinv, ld, U)]

    bl.reset_launch_counts()
    on_card = run(cuda)
    torch.cuda.synchronize()
    assert all(c > 0 for c in bl.launch_counts().values())
    tol = _CARD_TOL[dtype][1]
    for a, b in zip(on_card, run("cpu")):
        _close(a, b, tol)


def _operand_layouts(rng, N, rows, cols, dtype, dev):
    """The same [N, rows, cols] values in four layouts: contiguous, starting
    one element into the storage, with an odd row stride, and (member 0
    only) as a stride-0 batch."""
    return _layouts_of(_t(rng.normal(size=(N, rows, cols))).to(dev, dtype))


def _layouts_of(x):
    N, rows, cols = x.shape
    dtype, dev = x.dtype, x.device
    shifted = torch.zeros(x.numel() + 1, dtype=dtype, device=dev)
    shifted[1:] = x.reshape(-1)
    odd = torch.zeros(N, rows, cols + 3 - cols % 2, dtype=dtype, device=dev)
    odd[..., :cols] = x
    return {
        "contiguous": x,
        "shifted": shifted[1:].view(N, rows, cols),
        "odd row stride": odd[..., :cols],
        "stride-0 batch": x[:1].expand(N, rows, cols),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,m,n,k", [(1, 32, 32, 32), (255, 32, 32, 32), (257, 32, 32, 32),
                                     (1100, 32, 65, 32), (300, 7, 5, 9), (3, 80, 65, 80)])
def test_cuda_bmm_layouts_and_ragged_batches(cuda, dtype, N, m, n, k):
    """Unaligned, odd-strided and stride-0 operands and batches that do not
    fill the last block, in all four transpose cases."""
    rng = np.random.default_rng(N + m + n)
    tol = _CARD_TOL[dtype][0]
    for ta in (False, True):
        for tb in (False, True):
            As = _operand_layouts(rng, N, *((k, m) if ta else (m, k)), dtype, cuda)
            Bs = _operand_layouts(rng, N, *((n, k) if tb else (k, n)), dtype, cuda)
            assert build.aligned16(As["contiguous"]) or (m * k) % 4
            assert not build.aligned16(As["shifted"]) and not build.aligned16(As["odd row stride"])
            for la, lb in [("contiguous", "contiguous"), ("shifted", "contiguous"),
                           ("contiguous", "odd row stride"), ("stride-0 batch", "shifted"),
                           ("odd row stride", "stride-0 batch")]:
                A, B = As[la], Bs[lb]
                out = bl.batch_bmm(A, B, ta, tb)
                assert out.shape == (N, m, n) and out.is_contiguous()
                _close(out, bl.bmm_plain(A, B, ta, tb), tol)
    torch.cuda.synchronize()


def _solve_members(rng, N, d, dtype, dev):
    """SPD systems with, where the batch allows, member 0 all zero, member 1
    the identity and member 2 rank-deficient (a zero first row)."""
    M = _t(_spd(rng, N, d)).to(dev, dtype)
    if N >= 3:
        M[0] = 0.0
        M[1] = torch.eye(d, dtype=dtype, device=dev)
        M[2, 0] = 0.0
    return M


def _close_solve(X, Xp, tol):
    """Finite members against the plain solve; a member with a zero pivot
    (all-zero, rank-deficient) is non-finite in both, as on the TPU."""
    fin, finp = torch.isfinite(X).flatten(1).all(1), torch.isfinite(Xp).flatten(1).all(1)
    assert torch.equal(fin, finp)
    _close(X[fin], Xp[fin], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize(
    "N,d,r,rhs",
    [(256, 32, 32, "stride-0 identity"), (128, 32, 32, "stride-0 identity"),
     (512, 32, 64, "contiguous"), (25_000, 32, 65, "contiguous"), (25_000, 32, 1, "contiguous"),
     (1, 32, 32, "odd row stride"), (255, 32, 33, "shifted"), (257, 32, 97, "odd row stride"),
     (300, 7, 3, "shifted"), (300, 31, 31, "contiguous"), (40, 64, 65, "contiguous"),
     (3, 80, 80, "odd row stride")],
)
def test_cuda_gj_shapes_and_layouts(cuda, dtype, N, d, r, rhs):
    """The scan's and the full width's shapes, ragged batches, d = 7, 31, 32
    on the warp kernel and 64, 80 on the block kernel, with unaligned,
    odd-strided and stride-0 operands and all-zero, identity and
    rank-deficient members; the solve and the solve + logdet."""
    rng = np.random.default_rng(N + d + r)
    tol = _CARD_TOL[dtype][1]
    Ms = _layouts_of(_solve_members(rng, N, d, dtype, cuda))
    if rhs == "stride-0 identity":
        R = torch.eye(d, dtype=dtype, device=cuda).expand(N, d, d)
    else:
        R = _operand_layouts(rng, N, d, r, dtype, cuda)[rhs]
    build.reset_launch_counts()
    for layout in ("contiguous", "shifted", "odd row stride"):
        M = Ms[layout]
        X = bl.batch_solve(M, R)
        assert X.shape == (N, d, r) and X.is_contiguous()
        _close_solve(X, bl.gj_solve_plain(M, R), tol)
        X, ld = bl.batch_solve_logdet(M, R)
        Xp, ldp = bl.gj_solve_logdet_plain(M, R)
        _close_solve(X, Xp, tol)
        fin = torch.isfinite(ldp)
        assert torch.equal(torch.isfinite(ld), fin)
        assert torch.allclose(ld[fin], ldp[fin], rtol=tol, atol=tol)  # the identity's is 0
    torch.cuda.synchronize()
    route = "warp" if d <= 32 else "block"
    assert build.route_counts("gj_solve")["gj_solve"][route] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N", [1, 255, 257, 100_000])
def test_cuda_small_d_bmm_matches_plain(cuda, dtype, N):
    """The temporal model's products: every (m, n, k) in {1, 2}^3 (the
    state d = 1 or 2, one observation head) in all four transpose cases, on
    contiguous, unaligned, odd-strided and stride-0 operands, at the full
    width of a series and around a block."""
    rng = np.random.default_rng(N)
    tol = _CARD_TOL[dtype][0]
    build.reset_launch_counts()
    launches = 0
    for m in (1, 2):
        for n in (1, 2):
            for k in (1, 2):
                for ta in (False, True):
                    for tb in (False, True):
                        As = _operand_layouts(rng, N, *((k, m) if ta else (m, k)), dtype, cuda)
                        Bs = _operand_layouts(rng, N, *((n, k) if tb else (k, n)), dtype, cuda)
                        for la, lb in [("contiguous", "contiguous"), ("shifted", "odd row stride"),
                                       ("stride-0 batch", "contiguous")]:
                            A, B = As[la], Bs[lb]
                            out = bl.batch_bmm(A, B, ta, tb)
                            assert out.shape == (N, m, n) and out.is_contiguous()
                            _close(out, bl.bmm_plain(A, B, ta, tb), tol)
                            launches += 1
    torch.cuda.synchronize()
    assert bl.launch_counts()["bmm"] == launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N", [1, 255, 257, 100_000])
@pytest.mark.parametrize("d", [1, 2])
def test_cuda_small_d_solves_match_plain(cuda, dtype, N, d):
    """The temporal model's solves: d = 1 (the sites, the innovation
    covariance) and d = 2 (the square-root combine), with r = 1, 2, 4, 5, 6
    right-hand sides, on SPD and identity-dominated systems and, from N = 3
    on, all-zero, identity and singular members; both on the warp kernel."""
    rng = np.random.default_rng(N + d)
    tol = _CARD_TOL[dtype][1]
    build.reset_launch_counts()
    for r in (1, 2, 4, 5, 6):
        for M in (_solve_members(rng, N, d, dtype, cuda), _t(_icj(rng, N, d)).to(cuda, dtype)):
            R = _operand_layouts(rng, N, d, r, dtype, cuda)
            for layout in ("contiguous", "shifted"):
                _close_solve(bl.batch_solve(M, R[layout]), bl.gj_solve_plain(M, R[layout]), tol)
            X, ld = bl.batch_solve_logdet(M, R["odd row stride"])
            Xp, ldp = bl.gj_solve_logdet_plain(M, R["odd row stride"])
            _close_solve(X, Xp, tol)
            fin = torch.isfinite(ldp)
            assert torch.equal(torch.isfinite(ld), fin)
            assert torch.allclose(ld[fin], ldp[fin], rtol=tol, atol=tol)
    torch.cuda.synchronize()
    routes = build.route_counts("gj_solve", "gj_solve_logdet")
    assert routes["gj_solve"] == {"warp": 20, "block": 0}
    assert routes["gj_solve_logdet"] == {"warp": 10, "block": 0}

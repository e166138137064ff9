"""PyTorch port: the LQ, Cholesky and Gram + Cholesky kernels against Pallas.

The plain PyTorch versions (what the port runs on the CPU, and what the CUDA
kernels are held to on the card) are compared with the JAX package's Pallas
kernels run in interpret mode, on the same numpy inputs, in float64. Each
batch holds an all-zero matrix and a rank-deficient one beside full-rank
ones: rank 2 for the LQ, and for the Cholesky kernels rank 2 at d <= 7 and
rank d - 1 at d >= 32 (at d = 32 the pivot floor of the reference algorithm
does not keep a rank-2 Gram finite: the Pallas kernel returns NaN there).
Full-rank members agree to rtol 1e-10 (factor entries, normwise over the
batch member); every member's L Lᵀ agrees with the exact product to 1e-10
of the member's diagonal scale, or to 1e-6 for the floored pivots of
rank-deficient Cholesky inputs (the floor is eps_rel = 1e-14 of the row's
diagonal, and the elimination amplifies rounding noise through it). The
Cholesky and LQ launch shapes (`chol_plan`, `lq_plan`) are pure Python and
are held here for every d up to 80 (and m up to 160) in both types. The `cuda` cases compare each CUDA kernel
with its plain version, on aligned, unaligned, strided and stride-0 operands
and ragged batches, and skip without a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from physs_gp_tpu_torch.ops import cuda as kernels  # noqa: E402
from physs_gp_tpu_torch.ops.cuda import batched_chol as bc  # noqa: E402
from physs_gp_tpu_torch.ops.cuda import batched_qr as bq  # noqa: E402
from physs_gp_tpu_torch.ops.cuda import build  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def jqr():
    return pytest.importorskip("physs_gp_tpu.ops.pallas.batched_qr")


@pytest.fixture
def jchol():
    return pytest.importorskip("physs_gp_tpu.ops.pallas.batched_chol")


def _j(x):
    import jax.numpy as jnp

    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _factors(rng, N, d, m, rank=2):
    """[N, d, m] with member 0 all zero and member 1 of the given rank."""
    X = rng.normal(size=(N, d, m))
    X[0] = 0.0
    X[1] = rng.normal(size=(d, rank)) @ rng.normal(size=(rank, m))
    return X


def _chol_rank(d):
    return 2 if d <= 8 else d - 1


def _gram(X):
    return X @ np.swapaxes(X, -1, -2)


def _check_factor(L, ref_L, prod, full, tol_rank_def=1e-10):
    """L against the Pallas factor on full-rank members, and L Lᵀ against
    the exact product on every member."""
    assert np.isfinite(L).all()
    assert (np.triu(L, 1) == 0.0).all()
    assert (np.diagonal(L, axis1=1, axis2=2) >= 0.0).all()
    for b in full:
        err = np.abs(L[b] - ref_L[b]).max() / np.abs(ref_L[b]).max()
        assert err <= 1e-10, (b, err)
    scale = np.maximum(np.abs(np.diagonal(prod, axis1=1, axis2=2)).max(-1), 1.0)
    err = np.abs(_gram(L) - prod).max((-1, -2)) / scale
    tol = np.full(len(L), 1e-10)
    tol[1] = tol_rank_def
    assert (err <= tol).all(), err


@pytest.mark.parametrize("N,d,m", [(300, 5, 9), (130, 32, 64), (100, 64, 128)])
def test_tria_plain_matches_pallas(jqr, N, d, m):
    rng = np.random.default_rng(d + m)
    B = _factors(rng, N, d, m)
    ref = np.asarray(jqr.batch_tria(_j(B), interpret=True))
    L = bq.batch_tria(_t(B)).numpy()
    _check_factor(L, ref, _gram(B), full=range(2, N))
    assert (L[0] == 0.0).all()


@pytest.mark.parametrize("N,d", [(200, 7), (130, 32), (100, 64)])
def test_cholesky_plain_matches_pallas(jchol, N, d):
    rng = np.random.default_rng(d)
    A = _gram(_factors(rng, N, d, d + 3, _chol_rank(d)))
    A[2:] += 0.1 * np.eye(d)
    ref = np.asarray(jchol.batch_cholesky(_j(A), interpret=True))
    L = bc.batch_cholesky(_t(A)).numpy()
    _check_factor(L, ref, A, full=range(2, N), tol_rank_def=1e-6)
    assert (L[0] == ref[0]).all()  # sqrt(1e-30) on the diagonal
    np.testing.assert_allclose(L[2:], np.linalg.cholesky(A[2:]), rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize(
    "N,d,my,plus_eye",
    [(300, 5, 5, False), (300, 5, 5, True), (300, 5, 0, False), (300, 5, 0, True),
     (130, 32, 32, False), (130, 32, 0, True), (100, 64, 64, False)],
)
def test_chol_gram_plain_matches_pallas(jchol, N, d, my, plus_eye):
    rng = np.random.default_rng(d + my)
    X = _factors(rng, N, d, d, _chol_rank(d))
    Y = _factors(rng, N, d, my) if my else None
    if Y is not None:
        Y[1] = 0.0  # keep member 1 rank-deficient
    ref = np.asarray(jchol.batch_chol_gram(_j(X), _j(Y), plus_eye=plus_eye, interpret=True))
    L = bc.batch_chol_gram(_t(X), _t(Y), plus_eye=plus_eye).numpy()
    prod = _gram(X) + (0.0 if Y is None else _gram(Y)) + (np.eye(d) if plus_eye else 0.0)
    full = range(2, N) if not plus_eye else range(N)
    _check_factor(L, ref, prod, full=full, tol_rank_def=1e-10 if plus_eye else 1e-6)


def test_float32_plain_matches_float64():
    """The float32 plain versions at the main path's widths: L Lᵀ to 1e-5
    of the diagonal scale against the float64 product."""
    rng = np.random.default_rng(3)
    B = rng.normal(size=(64, 32, 64)) / 8
    A = _gram(B) + 0.1 * np.eye(32)
    Bf, Af = _t(B).float(), _t(A).float()
    for L, prod in [
        (bq.batch_tria(Bf), _gram(B)),
        (bc.batch_cholesky(Af), A),
        (bc.batch_chol_gram(Bf[..., :32], Bf[..., 32:]), _gram(B)),
    ]:
        err = np.abs(_gram(L.double().numpy()) - prod).max()
        assert err / np.abs(np.diagonal(prod, axis1=1, axis2=2)).max() <= 1e-5


def test_cpu_path_counts_no_launch():
    kernels.reset_launch_counts()
    x = torch.eye(3, dtype=torch.float64).expand(4, 3, 3)
    bq.batch_tria(x)
    bc.batch_cholesky(x)
    bc.batch_chol_gram(x, x, plus_eye=True)
    assert kernels.launch_counts() == {
        "bmm": 0, "gj_solve": 0, "gj_solve_logdet": 0, "lq": 0, "chol": 0, "chol_gram": 0,
        "fused_filter": 0, "fused_smooth": 0,
    }
    assert kernels.route_counts() == {}


def test_wrappers_reject_bad_operands():
    with pytest.raises(ValueError):
        bq.batch_tria(torch.zeros(2, 4, 3))
    with pytest.raises(ValueError):
        bc.batch_cholesky(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        bc.batch_chol_gram(torch.zeros(2, 3, 4), torch.zeros(2, 4, 4))


# ---------------------------------------------------------------------------
# The launcher's choices, pure Python
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("d", [1, 2, 7, 16, 31, 32, 33, 48, 64, 79, 80])
def test_chol_plan_fits_the_card(d, itemsize):
    """Every factor width up to 80, with and without the Gram, small and
    large batches: a warp per matrix up to d = 32 and a block per matrix
    above, threads within the launch bounds, shared memory within what a
    block may use, the tile wide enough for [X | Y] and for the factor."""
    for gram in (False, True):
        for mx in (range(1, 81) if gram else (d,)):
            for my in ((0, 1, 7, 32, 33, 80) if gram else (0,)):
                for N in (1, 128, 256, 25_000, 100_000):
                    G, threads, smem = bc.chol_plan(N, d, mx, my, gram, itemsize)
                    assert smem <= build.SMEM_LIMIT
                    if d <= bc.WARP_D:
                        assert 1 <= G <= min(8, max(1, N)) and threads == 32 * G
                        width = build.ceil4(mx) + build.ceil4(my) if gram else d
                        pitch = build.row_pitch(max(width, d), itemsize)
                        assert pitch >= build.ceil4(d) and pitch >= width
                        assert smem == G * (32 * pitch + 64) * itemsize
                        if G > 1:  # grouped matrices leave every SM two blocks
                            assert -(-N // G) >= 2 * build.SM_COUNT
                    else:
                        assert G == 1 and 32 <= threads <= 256 and threads % 32 == 0


@pytest.mark.parametrize("itemsize", [4, 8])
def test_chol_plan_at_the_main_shapes(itemsize):
    """d = 32: 8 (float32) or 4 (float64) matrices per block at full width,
    three such blocks to an SM; one warp per block at the scan's batch."""
    G, threads, smem = bc.chol_plan(25_000, 32, 32, 32, True, itemsize)
    assert G == (8 if itemsize == 4 else 4) and 3 * smem <= build.SMEM_LIMIT
    assert bc.chol_plan(256, 32, 32, 32, True, itemsize)[:2] == (1, 32)
    assert bc.chol_plan(100_000, 32, 32, 0, False, itemsize)[:2] == (8, 256)
    assert bc.chol_plan(500, 80, 80, 80, True, itemsize)[:2] == (1, 256)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("d", [1, 2, 7, 16, 31, 32, 33, 48, 64, 79, 80])
def test_lq_plan_fits_the_card(d, itemsize):
    """Every pre-array [d, m] up to d = 80, m = 160, small and large
    batches: a warp per matrix up to d = 32, m = 64 (a tile of 32 or 64
    columns), a block per matrix above; whole warps within the launch bound,
    shared memory within what a block may use."""
    for m in range(d, 161):
        for N in (1, 128, 256, 512, 25_000, 100_000):
            G, threads, smem = bq.lq_plan(N, d, m, itemsize)
            assert smem <= build.SMEM_LIMIT
            assert 32 <= threads <= 256 and threads % 32 == 0
            if d <= bq.WARP_D and m <= bq.WARP_M:
                mw = 32 if m <= 32 else 64
                per = 32 * build.row_pitch(mw, itemsize) + 2 * mw + 16 // itemsize
                assert build.row_pitch(mw, itemsize) >= mw
                assert 1 <= G <= min(8, max(1, N)) and threads == 32 * G
                assert smem == G * per * itemsize
                if G > 1:  # grouped matrices leave every SM two blocks
                    assert -(-N // G) >= 2 * build.SM_COUNT
            else:
                assert G == 1 and smem == (d * m + m + d + 2) * itemsize


@pytest.mark.parametrize("itemsize", [4, 8])
def test_lq_plan_at_the_main_shapes(itemsize):
    """The square-root scan's [512, 32, 64] and [256, 32, 64] run one matrix
    a block, so that every SM gets work; full width packs 8 (float32) or 4
    (float64) matrices a block, three blocks to an SM; d = 64 and 80 keep a
    block per matrix."""
    assert bq.lq_plan(512, 32, 64, itemsize)[:2] == (1, 32)
    assert bq.lq_plan(256, 32, 64, itemsize)[:2] == (1, 32)
    G, threads, smem = bq.lq_plan(25_000, 32, 64, itemsize)
    assert G == (8 if itemsize == 4 else 4) and 3 * smem <= build.SMEM_LIMIT
    assert bq.lq_plan(100_000, 32, 32, itemsize)[:2] == (8, 256)
    assert bq.lq_plan(2000, 64, 128, itemsize)[:2] == (1, 256)
    assert bq.lq_plan(500, 80, 160, itemsize)[:2] == (1, 256)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_CARD_TOL = {torch.float64: 1e-11, torch.float32: 2e-5}


def _close_gram(L, ref_prod, tol):
    """Normwise: max |L Lᵀ - ref| / max |ref| over the batch."""
    err = (L @ L.transpose(-1, -2) - ref_prod).abs().max() / ref_prod.abs().max()
    assert float(err) <= tol, float(err)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "dtype,N,d,m",
    [(torch.float64, 300, 7, 9), (torch.float64, 2500, 32, 64), (torch.float64, 40, 80, 160),
     (torch.float32, 300, 7, 9), (torch.float32, 2500, 32, 64)],
)
def test_cuda_kernels_match_plain(cuda, dtype, N, d, m):
    rng = np.random.default_rng(N + d)
    B = _t(_factors(rng, N, d, m)).to(cuda, dtype)
    tol = _CARD_TOL[dtype]
    L, Lp = bq.batch_tria(B), bq.tria_plain(B)
    assert torch.isfinite(L).all() and (L[0] == 0).all()
    _close_gram(L, Lp @ Lp.transpose(-1, -2), tol)
    assert float((L - Lp).abs().max() / Lp.abs().max()) <= 100 * tol
    X = _t(_factors(rng, N, d, d, _chol_rank(d))).to(cuda, dtype)
    Y = B[..., m - d:].clone()
    Y[1] = 0.0
    A = X @ X.transpose(-1, -2) + 0.1 * torch.eye(d, dtype=dtype, device=cuda)
    L, Lp = bc.batch_cholesky(A), bc.cholesky_plain(A)
    assert torch.isfinite(L).all()
    assert float((L - Lp).abs().max() / Lp.abs().max()) <= 100 * tol
    for Yk, plus_eye in [(Y, False), (None, True)]:
        L, Lp = bc.batch_chol_gram(X, Yk, plus_eye), bc.chol_gram_plain(X, Yk, plus_eye)
        assert torch.isfinite(L).all()
        _close_gram(L, Lp @ Lp.transpose(-1, -2), tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_empty_batch_counts_no_launch(cuda):
    kernels.reset_launch_counts()
    x = torch.zeros(0, 4, 4, device=cuda)
    assert bq.batch_tria(x).shape == (0, 4, 4)
    assert bc.batch_cholesky(x).shape == (0, 4, 4)
    assert bc.batch_chol_gram(x, x, plus_eye=True).shape == (0, 4, 4)
    assert not any(kernels.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_sqrt_routing_matches_cpu(cuda, dtype):
    """tria, tria_sum and safe_cholesky_rel on the card (strided and
    broadcast operands, zero members) against the CPU path."""
    from physs_gp_tpu_torch.ops import matrix, sqrt_kalman

    rng = np.random.default_rng(0)
    N, d = 500, 32
    G = _t(_factors(rng, N, d, d))
    U = _t(rng.normal(size=(d, d)))
    Q = _t(_gram(rng.normal(size=(N, d, d))))

    def run(dev):
        g, u, q = (x.to(dev, dtype) for x in (G, U, Q))
        eye = torch.eye(d, dtype=dtype, device=dev).expand(N, d, d)
        out = [
            sqrt_kalman.tria(torch.cat([g, eye], -1), assume_full_rank=True),
            sqrt_kalman.tria(g.transpose(-1, -2)),
            sqrt_kalman.tria_sum(g, u.expand(N, d, d)),
            sqrt_kalman.tria_sum(g[..., :d // 2], plus_eye=True),
            matrix.safe_cholesky_rel(q),
        ]
        return [x @ x.transpose(-1, -2) for x in out]

    kernels.reset_launch_counts()
    on_card = run(cuda)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["lq"] == 2 and counts["chol_gram"] == 2 and counts["chol"] == 1, counts
    for a, b in zip(on_card, run("cpu")):
        err = (a.cpu() - b).abs().max() / b.abs().max()
        assert float(err) <= 10 * _CARD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,d,mx,my", [(1, 32, 32, 32), (255, 32, 32, 32), (257, 32, 32, 32),
                                       (1100, 32, 16, 0), (2200, 31, 33, 7), (300, 7, 7, 9),
                                       (40, 48, 48, 48)])
def test_cuda_chol_layouts_and_ragged_batches(cuda, dtype, N, d, mx, my):
    """Gram + Cholesky and Cholesky on unaligned, odd-strided and stride-0
    operands and on batches that do not fill the last block."""
    rng = np.random.default_rng(N + d + mx)
    tol = _CARD_TOL[dtype]

    def layouts(cols):
        x = _t(rng.normal(size=(N, d, cols)) / np.sqrt(cols)).to(cuda, dtype)
        shifted = torch.zeros(x.numel() + 1, dtype=dtype, device=cuda)
        shifted[1:] = x.reshape(-1)
        odd = torch.zeros(N, d, cols + 3 - cols % 2, dtype=dtype, device=cuda)
        odd[..., :cols] = x
        return {"contiguous": x, "shifted": shifted[1:].view(N, d, cols),
                "odd row stride": odd[..., :cols], "stride-0 batch": x[:1].expand(N, d, cols)}

    Xs = layouts(mx)
    Ys = layouts(my) if my else None
    assert not build.aligned16(Xs["shifted"]) and not build.aligned16(Xs["odd row stride"])
    for lx, ly in [("contiguous", "contiguous"), ("shifted", "odd row stride"),
                   ("odd row stride", "stride-0 batch"), ("stride-0 batch", "shifted")]:
        X, Y = Xs[lx], None if Ys is None else Ys[ly]
        plus_eye = Y is None or mx + my < d
        L, Lp = bc.batch_chol_gram(X, Y, plus_eye), bc.chol_gram_plain(X, Y, plus_eye)
        assert L.is_contiguous() and torch.isfinite(L).all()
        assert (torch.triu(L, 1) == 0).all()
        assert float((L - Lp).abs().max() / Lp.abs().max()) <= 100 * tol
        _close_gram(L, Lp @ Lp.transpose(-1, -2), tol)
    A = layouts(d)["contiguous"]
    P = A @ A.transpose(-1, -2) + 0.1 * torch.eye(d, dtype=dtype, device=cuda)
    shifted = torch.zeros(P.numel() + 1, dtype=dtype, device=cuda)
    shifted[1:] = P.reshape(-1)
    for view in (P, torch.cat([P, P], -1)[..., d:], shifted[1:].view(N, d, d),
                 P[:1].expand(N, d, d)):
        L, Lp = bc.batch_cholesky(view), bc.cholesky_plain(view)
        assert float((L - Lp).abs().max() / Lp.abs().max()) <= 100 * tol
        assert (torch.triu(L, 1) == 0).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N,d,m", [(512, 32, 64), (256, 32, 64), (25_000, 32, 64), (1, 32, 64),
                                   (255, 32, 32), (257, 31, 63), (300, 7, 9), (300, 32, 40),
                                   (40, 64, 128), (3, 80, 160)])
def test_cuda_lq_layouts_and_ragged_batches(cuda, dtype, N, d, m):
    """The scan's and the full width's shapes, ragged batches, d = 7, 31, 32
    on the warp kernel and 64, 80 on the block kernel, on contiguous,
    unaligned, odd-strided and stride-0 pre-arrays with all-zero,
    rank-deficient and identity members."""
    rng = np.random.default_rng(N + d + m)
    tol = _CARD_TOL[dtype]
    x = _t(_factors(rng, N, d, m) if N > 1 else rng.normal(size=(N, d, m))).to(cuda, dtype)
    if N > 2:
        x[2] = 0.0
        x[2, :, :d] = torch.eye(d, dtype=dtype, device=cuda)
    shifted = torch.zeros(x.numel() + 1, dtype=dtype, device=cuda)
    shifted[1:] = x.reshape(-1)
    odd = torch.zeros(N, d, m + 3 - m % 2, dtype=dtype, device=cuda)
    odd[..., :m] = x
    views = {"contiguous": x, "shifted": shifted[1:].view(N, d, m),
             "odd row stride": odd[..., :m], "stride-0 batch": x[N - 1:].expand(N, d, m)}
    assert not build.aligned16(views["shifted"]) and not build.aligned16(views["odd row stride"])
    kernels.reset_launch_counts()
    for label, B in views.items():
        L, Lp = bq.batch_tria(B), bq.tria_plain(B)
        assert L.is_contiguous() and torch.isfinite(L).all(), label
        assert (torch.triu(L, 1) == 0).all() and (torch.diagonal(L, dim1=-2, dim2=-1) >= 0).all()
        if label != "stride-0 batch" and N > 1:
            assert (L[0] == 0).all()
            if N > 2:
                assert torch.equal(L[2], torch.eye(d, dtype=dtype, device=cuda))
        _close_gram(L, Lp @ Lp.transpose(-1, -2), tol)
        assert float((L - Lp).abs().max() / Lp.abs().max()) <= 100 * tol
    torch.cuda.synchronize()
    route = "warp" if d <= 32 and m <= 64 else "block"
    assert kernels.route_counts("lq")["lq"][route] == len(views)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("N", [1, 255, 257, 100_000])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_cuda_small_d_factors_match_plain(cuda, dtype, N, d):
    """The temporal model's factors: the LQ at d = 1, 2 with m = d .. 6
    columns ([H U, R^1/2] is [1, 3], the combine's stacked [G, I] [2, 4])
    and at d = 3 (the sequential square-root filter's update pre-array
    [[H Up, R^1/2], [Up, 0]] is [3, 3]), the Cholesky and the Gram +
    Cholesky at d = 1, 2 with all-zero and rank-deficient members (floored
    pivots), on contiguous, unaligned and stride-0 operands; all on the
    warp kernels."""
    rng = np.random.default_rng(N + d)
    tol = _CARD_TOL[dtype]
    kernels.reset_launch_counts()

    def views(x):
        shifted = torch.zeros(x.numel() + 1, dtype=dtype, device=cuda)
        shifted[1:] = x.reshape(-1)
        return {"contiguous": x, "shifted": shifted[1:].view(x.shape),
                "stride-0 batch": x[x.shape[0] - 1:].expand(x.shape)}

    rank = max(1, d - 1)
    n_lq = 0
    for m in range(d, 7):
        x = _t(_factors(rng, N, d, m, rank) if N > 1 else rng.normal(size=(N, d, m))).to(cuda, dtype)
        for label, B in views(x).items():
            L, Lp = bq.batch_tria(B), bq.tria_plain(B)
            assert torch.isfinite(L).all() and (torch.triu(L, 1) == 0).all(), (m, label)
            assert (torch.diagonal(L, dim1=-2, dim2=-1) >= 0).all()
            if label == "contiguous" and N > 1:
                assert (L[0] == 0).all()
            _close_gram(L, Lp @ Lp.transpose(-1, -2), tol)
            assert float((L - Lp).abs().max() / Lp.abs().max()) <= 100 * tol, (m, label)
            n_lq += 1
    if d > 2:
        torch.cuda.synchronize()
        assert kernels.route_counts("lq")["lq"] == {"warp": n_lq, "block": 0}
        return
    X = _t(_factors(rng, N, d, d + 1, rank) if N > 1 else rng.normal(size=(N, d, d + 1))).to(cuda, dtype)
    A = X @ X.transpose(-1, -2)
    if N > 2:
        A[2:] += 0.1 * torch.eye(d, dtype=dtype, device=cuda)
    keep = torch.ones(N, dtype=torch.bool, device=cuda)
    keep[: min(N, 2)] = N < 2  # the zero and the rank-deficient members: floored pivots
    for label, P in views(A).items():
        L, Lp = bc.batch_cholesky(P), bc.cholesky_plain(P)
        assert torch.isfinite(L).all() and (torch.triu(L, 1) == 0).all(), label
        k = keep if label != "stride-0 batch" else torch.ones_like(keep)
        assert float((L[k] - Lp[k]).abs().max() / Lp[k].abs().max()) <= 100 * tol, label
        _close_gram(L, Lp @ Lp.transpose(-1, -2), 1e-2 if dtype == torch.float32 else tol)
    n_gram = 0
    for mx in (1, 2):
        for my in (0, 1, 2):
            Xg = _t(_factors(rng, N, d, mx, 1) if N > 1 else rng.normal(size=(N, d, mx))).to(cuda, dtype)
            Y = _t(rng.normal(size=(N, d, my))).to(cuda, dtype) if my else None
            if Y is not None and N > 1:
                Y[:2] = 0.0
            for plus_eye in (False, True):
                for label, Xv in views(Xg).items():
                    L, Lp = bc.batch_chol_gram(Xv, Y, plus_eye), bc.chol_gram_plain(Xv, Y, plus_eye)
                    assert torch.isfinite(L).all() and (torch.triu(L, 1) == 0).all()
                    _close_gram(L, Lp @ Lp.transpose(-1, -2),
                                tol if plus_eye or dtype == torch.float64 else 1e-2)
                    n_gram += 1
    torch.cuda.synchronize()
    routes = kernels.route_counts("lq", "chol", "chol_gram")
    assert routes["lq"] == {"warp": n_lq, "block": 0}
    assert routes["chol"] == {"warp": 3, "block": 0}
    assert routes["chol_gram"] == {"warp": n_gram, "block": 0}


def _subnormal_tail(rng, d, m, dtype):
    """[3, d, m] whose row 1 has a tail (columns >= 1) so small that its
    Householder step's vᵀv is subnormal (entries 1e-160 in float64, 1e-20 in
    float32): row 0 is a multiple of e_0, so step 0 leaves that tail alone,
    and the rows below are full. The scattered square-root scans reach such
    tails in their rank-deficient information factors."""
    tiny = 1e-160 if dtype == torch.float64 else 1e-20
    B = rng.normal(size=(3, d, m))
    B[:, 0] = 0.0
    B[:, 0, 0] = 2.0
    B[:, 1, 1:] = tiny * rng.normal(size=(3, m - 1))
    return _t(B).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tria_plain_subnormal_tail_stays_finite(dtype):
    """A step whose vᵀv is subnormal reflects nothing (2 / vᵀv would
    overflow to inf and the rows below would turn NaN); L Lᵀ still equals
    B Bᵀ to rounding."""
    B = _subnormal_tail(np.random.default_rng(3), 7, 9, dtype)
    L = bq.tria_plain(B)
    assert torch.isfinite(L).all()
    _close_gram(L, B @ B.transpose(-1, -2), 1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d,m", [(7, 9), (24, 48), (40, 50)])
def test_cuda_tria_subnormal_tail_stays_finite(cuda, dtype, d, m):
    """Both LQ kernels (warp at d <= 32, block above) on a subnormal tail."""
    B = _subnormal_tail(np.random.default_rng(d), d, m, dtype).to(cuda)
    L = bq.batch_tria(B)
    assert torch.isfinite(L).all()
    _close_gram(L, B @ B.transpose(-1, -2), _CARD_TOL[dtype])
    _close_gram(L, bq.tria_plain(B) @ bq.tria_plain(B).transpose(-1, -2), _CARD_TOL[dtype])

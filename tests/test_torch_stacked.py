"""PyTorch port: independent CVI models stacked under `torch.func.vmap`
(`models/stacked.py`) against the JAX package's `jax.vmap` over models, and
the pieces that let `vmap` through (float64, CPU):

- the JAX dryrun's `jax.vmap(CVIGP.init)` at B = 4, T = 32, covariance and
  square-root, loaded through `interop.load_stacked_params`, against the
  port's stacked models after 1 and 3 `natural_gradient_update` steps:
  per-series ELBOs at rtol 1e-9, sites at 1e-7;
- a stacked config-5 (B = 2, T = 64; covariance, fused, square-root) and
  the temporal model against single port models, through `natgrad_scan`,
  with its NaN guard reverting one member alone;
- a stacked step calls each kernel op as often as one model's step;
- each of the eight kernel ops under `vmap` against a loop over the members
  (1e-14; on the CPU they agree bit for bit);
- the converted `autograd.Function`s' gradients under `torch.func.grad`
  against their eager gradients, and their eager backwards handing the
  kernel wrappers plain tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.kernels import Matern32 as JMatern32  # noqa: E402
from physs_gp_tpu.likelihoods import Poisson as JPoisson  # noqa: E402
from physs_gp_tpu.models import CVIGP as JCVIGP  # noqa: E402
from physs_gp_tpu_torch import trainers  # noqa: E402
from physs_gp_tpu_torch.interop import load_stacked_params  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32  # noqa: E402
from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson  # noqa: E402
from physs_gp_tpu_torch.models.cvi_gp import CVIGP  # noqa: E402
from physs_gp_tpu_torch.models.stacked import StackedCVIGP  # noqa: E402
from physs_gp_tpu_torch.zoo.bench_configs import build_config5, build_temporal  # noqa: E402

import train_parity as tp  # noqa: E402

torch.set_num_threads(1)
F64 = torch.float64
B, T = 4, 32


def _rel(a, b):
    return tp.rel(a, b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b))


def _series():
    """The JAX dryrun's part 2 data in float64: t [B, T], y [B, T, 1]."""
    rng = np.random.default_rng(0)
    tb = np.sort(rng.uniform(0, 10, (B, T)), axis=1)
    yb = rng.poisson(np.exp(np.sin(tb))).astype(np.float64)[..., None]
    return tb, yb


def _jax_leaves(model):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(model)[0]}


@pytest.mark.parametrize("sqrt", [False, True], ids=["cov", "sqrt"])
def test_stacked_models_match_jax_vmap(sqrt):
    tb, yb = _series()
    with pytest.MonkeyPatch.context() as mp:
        if sqrt:  # `_factor_psd` on its TPU branch, as the port runs it
            tp.ref.use_tpu_factor_branch(mp.setattr)
        jm = jax.vmap(lambda tt, yy: JCVIGP.init(
            tt, yy, JMatern32(lengthscale=jnp.asarray(1.0)), JPoisson(), parallel=True,
            sqrt=sqrt))(jnp.asarray(tb), jnp.asarray(yb))
        # the dryrun's `train_step`: one update, then the ELBO, one program
        jstep = jax.jit(jax.vmap(lambda m: (lambda m2: (m2, m2.elbo()))(
            m.natural_gradient_update(0.5))))
        runs = {}
        for n in range(1, 4):
            jm, jelbos = jstep(jm)
            if n in (1, 3):
                runs[n] = (np.asarray(jelbos), np.asarray(jm.sites.Y), np.asarray(jm.sites.V))

    models = [CVIGP.init(torch.zeros(T, dtype=F64), torch.zeros(T, 1, dtype=F64),
                         Matern32(lengthscale=1.0, variance=1.0, dtype=F64, device="cpu"),
                         Poisson(), parallel=True, sqrt=sqrt) for _ in range(B)]
    st = StackedCVIGP(models)
    leaves = _jax_leaves(jax.vmap(lambda tt, yy: JCVIGP.init(
        tt, yy, JMatern32(lengthscale=jnp.asarray(1.0)), JPoisson(), parallel=True,
        sqrt=sqrt))(jnp.asarray(tb), jnp.asarray(yb)))
    load_stacked_params(st, leaves)
    assert torch.equal(st.state["t"], torch.as_tensor(tb))
    for n in range(1, 4):
        st.natural_gradient_update(0.5)
        if n in (1, 3):
            elbos, sY, sV = runs[n]
            got = st.elbo()
            assert got.shape == (B,)
            for b in range(B):  # per series
                assert _rel(got[b], elbos[b]) <= 1e-9, (n, b)
                assert _rel(st.sites.Y[b], sY[b]) <= 1e-7, (n, b)
                assert _rel(st.sites.V[b], sV[b]) <= 1e-7, (n, b)


def test_stacked_params_refuse_a_wrong_batch():
    st = StackedCVIGP([build_temporal(8, None, dtype=F64, device="cpu") for _ in range(2)])
    with pytest.raises(ValueError):
        load_stacked_params(st, {".Y": np.zeros((3, 8, 1))})
    load_stacked_params(st, {".Y": np.ones((2, 8, 1))})
    assert torch.equal(st.state["Y"], torch.ones(2, 8, 1, dtype=F64))
    with pytest.raises(KeyError):
        load_stacked_params(st, {".kernel.nope": np.zeros(2)})


def _members(which, n, sqrt, T_=64):
    """n single port models of `which` with distinct data and parameters."""
    out = []
    for b in range(n):
        m = (build_config5 if which == "config5" else build_temporal)(
            T_, 16, dtype=F64, sqrt=sqrt, device="cpu")
        with torch.no_grad():
            m.Y = m.Y + b
            for p in m.parameters():
                p.mul_(1.0 + 0.05 * b)
        out.append(m)
    return out


@pytest.mark.parametrize("which,form", [("config5", "cov"), ("config5", "fused"),
                                        ("config5", "sqrt"), ("temporal", "cov"),
                                        ("temporal", "sqrt")])
def test_stacked_natgrad_scan_equals_single_models(monkeypatch, which, form):
    """B = 2 (config-5) or 3 (temporal) members, T = 64, chunk 16, 4 scan
    blocks: two `natgrad_scan` steps and the posterior equal each member's
    own run."""
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "4")
    monkeypatch.setenv("PHYSS_FUSED_COMBINE", "1" if form == "fused" else "0")
    n = 2 if which == "config5" else 3
    singles = _members(which, n, form == "sqrt")
    st, elbos = trainers.natgrad_scan(StackedCVIGP(_members(which, n, form == "sqrt")), 0.5,
                                      n_steps=2)
    assert elbos.shape == (2, n)
    post = st.posterior()
    for b, m in enumerate(singles):
        m, e = trainers.natgrad_scan(m, 0.5, n_steps=2)
        assert _rel(elbos[:, b], e) <= 1e-12
        assert _rel(st.sites.Y[b], m.sites.Y) <= 1e-12
        assert _rel(st.sites.V[b], m.sites.V) <= 1e-12
        p = m.posterior()
        assert _rel(post.mean[b], p.mean) <= 1e-12
        assert _rel(post.var[b], p.var) <= 1e-12


def test_stacked_nan_guard_reverts_one_member():
    """A member whose step goes non-finite keeps its sites; the others move."""
    models = _members("temporal", 3, False, T_=32)
    st = StackedCVIGP(models)
    with torch.no_grad():
        st.state["kernel.variance.raw"] = st.state["kernel.variance.raw"].clone()
        st.state["kernel.variance.raw"][1] = float("nan")
    before = st.sites
    st, elbos = trainers.natgrad_scan(st, 0.5, n_steps=1)
    assert torch.isnan(elbos[0, 1]) and torch.isfinite(elbos[0, [0, 2]]).all()
    assert torch.equal(st.sites.V[1], before.V[1])
    assert not torch.equal(st.sites.V[0], before.V[0])


def _count_kernel_calls(monkeypatch):
    """{kernel: calls} of each kernel's implementation (its plain version
    on the CPU, where a call is a launch on the card), filled as they run."""
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq
    from physs_gp_tpu_torch.ops.cuda import fused_combine as fc

    counts = {}
    for op in (bl.bmm_op, bl.gj_solve_op, bl.gj_solve_logdet_op, bq.lq_op, bc.chol_op,
               bc.chol_gram_op, fc.fused_filter_op, fc.fused_smooth_op):
        def plain(*args, _plain=op.plain, _name=op.op._name):
            counts[_name] = counts.get(_name, 0) + 1
            return _plain(*args)

        monkeypatch.setattr(op, "plain", plain)
    return counts


@pytest.mark.parametrize("form", ["cov", "fused", "sqrt"])
def test_stacked_step_calls_each_kernel_as_one_model_does(monkeypatch, form):
    """One stacked step calls each kernel as often as one model's step: the
    B members go into the kernel's batch, one call for all."""
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "4")
    monkeypatch.setenv("PHYSS_FUSED_COMBINE", "1" if form == "fused" else "0")
    single, *rest = _members("config5", 3, form == "sqrt", T_=32)
    counts = _count_kernel_calls(monkeypatch)
    single.step_with_elbo(0.5)
    one = dict(counts)
    counts.clear()
    StackedCVIGP(rest).step_with_elbo(0.5)
    assert one and counts == one


def _op_cases():
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq
    from physs_gp_tpu_torch.ops.cuda import fused_combine as fc
    from physs_gp_tpu_torch.ops import parallel_kalman as pk

    g = torch.Generator().manual_seed(7)

    def rnd(*s):
        return torch.randn(*s, generator=g, dtype=F64)

    def spd(*s):
        X = rnd(*s)
        return X @ X.transpose(-1, -2) + s[-1] * torch.eye(s[-1], dtype=F64)

    n, d = 5, 6
    filt = pk._FilterElems(rnd(3, n, d, d), rnd(3, n, d), spd(3, n, d, d), spd(3, n, d, d),
                           rnd(3, n, d))
    filt2 = pk._FilterElems(*(x.flip(0) for x in filt))
    smo = pk._SmootherElems(rnd(3, n, d, d), rnd(3, n, d), spd(3, n, d, d))
    smo2 = pk._SmootherElems(*(x.flip(0) for x in smo))
    return {
        "bmm": (lambda A, C: bl.batch_bmm(A, C, False, True), (rnd(3, n, d, 4), rnd(3, n, 5, 4))),
        "gj_solve": (bl.batch_solve, (spd(3, n, d, d), rnd(3, n, d, 3))),
        "gj_solve_logdet": (bl.batch_solve_logdet, (spd(3, n, d, d), rnd(3, n, d, 3))),
        "lq": (bq.batch_tria, (rnd(3, n, d, 2 * d),)),
        "chol": (bc.batch_cholesky, (spd(3, n, d, d),)),
        "chol_gram": (lambda X, Y: bc.batch_chol_gram(X, Y, plus_eye=True),
                      (rnd(3, n, d, 4), rnd(3, n, d, 3))),
        "fused_filter": (lambda a, b: tuple(fc.fused_filtering_combine(
            pk._FilterElems(*a), pk._FilterElems(*b))), (tuple(filt), tuple(filt2))),
        "fused_smooth": (lambda a, b: tuple(fc.fused_smoothing_combine(
            pk._SmootherElems(*a), pk._SmootherElems(*b))), (tuple(smo), tuple(smo2))),
    }


@pytest.mark.parametrize("kernel", ["bmm", "gj_solve", "gj_solve_logdet", "lq", "chol",
                                    "chol_gram", "fused_filter", "fused_smooth"])
def test_each_kernel_op_under_vmap_equals_a_loop(kernel):
    """Each op's vmap rule folds the members into its batch: equal to a loop
    over the members (1e-14; bit for bit on the CPU), also with the vmapped
    dimension inside the operand and with an operand shared by all members."""
    fn, args = _op_cases()[kernel]
    got = torch.func.vmap(fn)(*args)

    def member(b):
        return fn(*torch.utils._pytree.tree_map(lambda x: x[b], args))

    loop = [member(b) for b in range(3)]
    want = (torch.stack(loop) if isinstance(loop[0], torch.Tensor)
            else tuple(torch.stack(parts) for parts in zip(*loop)))
    for g_, w in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert (g_ - w).abs().max() <= 1e-14 * w.abs().max()
        assert torch.equal(g_, w)
    # vmapped dimension 1 of the first operand, the others shared
    first = args[0]
    moved = torch.utils._pytree.tree_map(lambda x: x.movedim(0, 1), first)
    got = torch.func.vmap(fn, in_dims=(1,) + (None,) * (len(args) - 1))(
        moved, *torch.utils._pytree.tree_map(lambda x: x[0], args[1:]))
    for g_, w in zip(torch.utils._pytree.tree_leaves(got),
                     torch.utils._pytree.tree_leaves(
                         fn(*torch.utils._pytree.tree_map(lambda x: x[2], args[:1]),
                            *torch.utils._pytree.tree_map(lambda x: x[0], args[1:])))):
        assert (g_[2] - w).abs().max() <= 1e-14 * w.abs().max()


def _function_cases():
    from physs_gp_tpu_torch.ops import matrix as mx
    from physs_gp_tpu_torch.ops import parallel_kalman as pk
    from physs_gp_tpu_torch.ops import sqrt_kalman as sk

    g = torch.Generator().manual_seed(11)

    def rnd(*s):
        return torch.randn(*s, generator=g, dtype=F64)

    def spd(*s):
        X = rnd(*s)
        return X @ X.transpose(-1, -2) + s[-1] * torch.eye(s[-1], dtype=F64)

    n, d = 4, 5
    filt = [rnd(n, d, d), rnd(n, d), spd(n, d, d), spd(n, d, d), rnd(n, d)]
    filt2 = [spd(n, d, d), rnd(n, d), spd(n, d, d), spd(n, d, d), rnd(n, d)]

    def fused(*leaves):
        return pk._FusedCombine.apply(pk.fc.fused_filtering_combine,
                                      pk._filtering_operator_unfused, pk._FilterElems, *leaves)

    return {
        "_Bmm": (lambda A, C: mx.bmm(A, C, ta=True), (rnd(n, d, 3), rnd(n, d, 4))),
        "_PsdSolve": (lambda A, C: mx._PsdSolve.apply(A, C), (spd(n, d, d), rnd(n, d, 2))),
        "_PsdSolveLogdet": (lambda A, C: mx._PsdSolveLogdet.apply(A, C),
                            (spd(n, d, d), rnd(n, d, 2))),
        "_GenSolve": (lambda A, C: mx._GenSolve.apply(A, C), (spd(n, d, d) + rnd(n, d, d),
                                                              rnd(n, d, 2))),
        "_KernelCholesky": (lambda A: mx._KernelCholesky.apply(A), (spd(n, d, d),)),
        "_QrR": (sk._qr_r, (rnd(n, 7, d),)),
        "_TriaCore": (lambda X: sk.tria(X), (rnd(n, d, 2 * d),)),
        "_CholGramCore": (lambda X, Y: sk.tria_sum(X, Y), (rnd(n, d, 3), rnd(n, d, 4))),
        "_FusedCombine": (fused, tuple(filt + filt2)),
    }


@pytest.mark.parametrize("function", ["_Bmm", "_PsdSolve", "_PsdSolveLogdet", "_GenSolve",
                                      "_KernelCholesky", "_QrR", "_TriaCore", "_CholGramCore",
                                      "_FusedCombine"])
def test_converted_functions_grad_under_torch_func(function):
    """`torch.func.grad` through each converted `autograd.Function` gives
    its eager backward's gradient."""
    fn, args = _function_cases()[function]
    g = torch.Generator().manual_seed(3)
    outs = fn(*args)
    weights = [torch.randn(o.shape, generator=g, dtype=F64)
               for o in torch.utils._pytree.tree_leaves(outs)]

    def loss(*xs):
        return sum(torch.sum(w * o) for w, o in zip(weights, torch.utils._pytree.tree_leaves(fn(*xs))))

    argnums = tuple(range(len(args)))
    got = torch.func.grad(loss, argnums=argnums)(*args)
    leaves = [a.detach().requires_grad_(True) for a in args]
    want = torch.autograd.grad(loss(*leaves), leaves)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-13 * b.abs().max()


@pytest.mark.parametrize("function", ["_Bmm", "_PsdSolve", "_PsdSolveLogdet", "_GenSolve",
                                      "_KernelCholesky", "_TriaCore", "_CholGramCore",
                                      "_FusedCombine"])
def test_eager_backward_hands_kernel_wrappers_plain_tensors(monkeypatch, function):
    """Outside a `torch.func` transform a kernel wrapper calls its launch
    code directly, which reads data pointers: the eager backwards (the
    recomputing ones among them) must not hand it functorch-wrapped
    tensors. The CPU's plain versions accept either, so the wrapper's
    operands are checked here."""
    from physs_gp_tpu_torch.ops.cuda import build

    call = build.KernelOp.__call__
    eager = []

    def checked(self, cpu, *args):
        if not build.transformed():
            eager.extend(torch._C._functorch.is_functorch_wrapped_tensor(a)
                         for a in torch.utils._pytree.tree_leaves(args) if isinstance(a, torch.Tensor))
        return call(self, cpu, *args)

    monkeypatch.setattr(build.KernelOp, "__call__", checked)
    fn, args = _function_cases()[function]
    leaves = [a.detach().requires_grad_(True) for a in args]
    outs = torch.utils._pytree.tree_leaves(fn(*leaves))
    grads = torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs])
    assert all(torch.isfinite(g).all() for g in grads)
    assert eager and not any(eager)

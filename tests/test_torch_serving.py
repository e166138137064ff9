"""PyTorch port: AOT predictor serving (`utils/serving`) and the kernels as
`torch.library` custom ops.

- Against JAX: the model of `tests/test_serving.py` (Matérn-3/2
  `StateSpaceGP`, sequential, float64, the same numpy inputs at T = 8) goes
  through the port's `export_predictor` -> disk -> `load_predictor` and
  through the JAX package's own pair; both programs are called at `ts` and
  `ts + 0.1` and agree to rtol 1e-10, for `predict_f` and `predict_y`.
- Config-5 round trip: `build_config5(8, 12)` after one `natgrad_scan` step,
  `PHYSS_SCAN_BLOCKS=4` (the export's size follows the number of chunks and
  scan levels, not T): the loaded program equals the live `predict_f` (rtol
  1e-12) at the example times and at new ones, and its graph holds the
  kernels as `torch.ops.physs_gp.*` nodes. Covariance form here; the
  square-root form's export (another 15 s) runs in the `cuda` twin and in
  `chip_smoke.py`'s float64 export anchor. The live config-5 `predict_f` is
  held to the JAX `CVIGP` by
  `tests/test_torch_predict.py::test_config5_predict_f_matches_jax`.
- `torch.library.opcheck` on each of the eight ops on small CPU inputs:
  schema, fake tensor, dynamic-shape tracing, with strided and stride-0
  broadcast operands; the dispatcher hands an op's implementation such
  views unchanged (the kernels read them in place).
- `export_fn` of a plain function: the kernel wrapper it calls becomes one
  `torch.ops.physs_gp.bmm` node.
- A fresh interpreter loads the bytes with only
  `physs_gp_tpu_torch.utils.serving` imported, calls the program, and never
  imports the port's model, kernel or likelihood classes.
- `cuda` twins of the round trip and of `opcheck` skip without a card.

The sequential model's exports are made once per module (a fixture); an
export takes 5-12 s on the CPU, a load 3-6 s.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from physs_gp_tpu_torch.kernels.matern import Matern32  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.models.ssgp import StateSpaceGP  # noqa: E402
from physs_gp_tpu_torch.ops import cuda as ops  # noqa: E402
from physs_gp_tpu_torch.ops.cuda import batched_chol as bc  # noqa: E402
from physs_gp_tpu_torch.ops.cuda.build import KernelOp  # noqa: E402
from physs_gp_tpu_torch.trainers.scan import natgrad_scan  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.utils.serving import export_predictor, load_predictor  # noqa: E402
from physs_gp_tpu_torch.zoo.bench_configs import build_config5  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
T_SEQ, N_NEW = 8, 4
PREDICTS = ["predict_f", "predict_y"]
FORMS = ["cov", "sqrt"]


def _series(T):
    """The inputs of `tests/test_serving.py::_model`."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 10, T))
    return t, np.sin(t)[:, None] + 0.05 * rng.normal(size=(T, 1))


def _ssgp(device="cpu"):
    t, y = _series(T_SEQ)
    kw = dict(dtype=F64, device=device)
    return StateSpaceGP(
        t=torch.tensor(t, **kw), Y=torch.tensor(y, **kw),
        kernel=Matern32(lengthscale=1.0, **kw),
        likelihood=Gaussian(positive_param(0.05 ** 2, **kw)),
    )


def _ts():
    return np.linspace(0.5, 9.5, N_NEW)


@pytest.fixture(scope="module")
def seq_blobs():
    """The port's artifacts of the sequential model, one per method."""
    model = _ssgp()
    ts = torch.tensor(_ts(), dtype=F64)
    return {p: export_predictor(model, ts, predict=p) for p in PREDICTS}


@pytest.mark.parametrize("predict", PREDICTS)
def test_round_trip_matches_the_jax_artifact(seq_blobs, predict, tmp_path):
    """JAX is imported here only: the `cuda` cases run where it is not installed."""
    jnp = pytest.importorskip("jax.numpy")
    from physs_gp_tpu.kernels import Matern32 as JMatern32
    from physs_gp_tpu.likelihoods import Gaussian as JGaussian
    from physs_gp_tpu.models import StateSpaceGP as JStateSpaceGP
    from physs_gp_tpu.utils import positive_param as jpositive
    from physs_gp_tpu.utils.serving import export_predictor as jexport
    from physs_gp_tpu.utils.serving import load_predictor as jload

    t, y = _series(T_SEQ)
    jm = JStateSpaceGP(t=jnp.asarray(t), Y=jnp.asarray(y), kernel=JMatern32(lengthscale=1.0),
                       likelihood=JGaussian(jpositive(0.05 ** 2)))
    jserve = jload(jexport(jm, jnp.asarray(_ts()), predict=predict))
    path = tmp_path / "predictor.pt2"
    path.write_bytes(seq_blobs[predict])
    serve = load_predictor(path.read_bytes())
    for shift in (0.0, 0.1):
        mean, var = serve(torch.tensor(_ts() + shift, dtype=F64))
        jmean, jvar = jserve(jnp.asarray(_ts() + shift))
        assert mean.shape == (N_NEW, 1) and bool((var > 0).all())
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-10)
        np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-10)


def test_a_fresh_process_serves_without_the_model_classes(seq_blobs, tmp_path):
    blob, out = tmp_path / "predictor.pt2", tmp_path / "served.npz"
    blob.write_bytes(seq_blobs["predict_f"])
    code = (
        "import sys, numpy as np, torch\n"
        "from physs_gp_tpu_torch.utils.serving import load_predictor\n"
        f"serve = load_predictor(open({str(blob)!r}, 'rb').read())\n"
        f"ts = torch.tensor(np.array({_ts().tolist()!r}) + 0.1, dtype=torch.float64)\n"
        "mean, var = serve(ts)\n"
        f"np.savez({str(out)!r}, mean=mean.numpy(), var=var.numpy())\n"
        "imported = [m for m in ('models', 'kernels', 'likelihoods')\n"
        "        if 'physs_gp_tpu_torch.' + m in sys.modules]\n"
        "assert not imported, imported\n"
        "assert 'jax' not in sys.modules\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr
    with torch.no_grad():
        live = _ssgp().predict_f(torch.tensor(_ts() + 0.1, dtype=F64))
    served = np.load(out)
    np.testing.assert_allclose(served["mean"], live.mean.numpy(), rtol=1e-12)
    np.testing.assert_allclose(served["var"], live.var.numpy(), rtol=1e-12)


def test_export_fn_of_a_function_names_the_kernel_op():
    """`export_fn` wraps a plain function; under the tracer the wrapper calls
    its op, which the program holds as one node."""
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.utils.serving import export_fn, load_fn

    A = torch.randn(3, 4, 5, dtype=F64)
    serve = load_fn(export_fn(lambda X: bl.batch_bmm(X, X, False, True) + 1.0, A))
    calls = [n.target for n in serve.graph.nodes if n.op == "call_function"]
    assert calls.count(torch.ops.physs_gp.bmm.default) == 1
    B = torch.randn(3, 4, 5, dtype=F64)
    torch.testing.assert_close(serve(B), B @ B.transpose(-1, -2) + 1.0, rtol=1e-12, atol=0.0)


# ---------------------------------------------------------------------------
# Config-5 round trip
# ---------------------------------------------------------------------------


def _config5_round_trip(form, device):
    """(graph's custom-op targets, [(loaded, live) moments]) of a config-5
    `predict_f` exported at 4 new times after one natgrad step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PHYSS_SCAN_BLOCKS", "4")
        model, _ = natgrad_scan(
            build_config5(8, 12, dtype=F64, sqrt=form == "sqrt", device=device), 0.5, n_steps=1)
        ts = torch.tensor(np.linspace(3.0, 97.0, 4), dtype=F64, device=device)
        blob = export_predictor(model, ts)
        serve = load_predictor(blob)
        pairs = []
        with torch.no_grad():
            for t in (ts, ts + 1.7):
                pairs.append((serve(t), model.predict_f(t)))
    targets = {str(n.target) for m in serve.modules() if isinstance(m, torch.fx.GraphModule)
               for n in m.graph.nodes if n.op == "call_function"}
    return targets, pairs


def _hold_round_trip(targets, pairs, form):
    want = {"bmm", "gj_solve", "chol"}
    want |= {"lq", "chol_gram"} if form == "sqrt" else {"gj_solve_logdet"}
    assert {f"physs_gp.{k}.default" for k in want} <= targets
    for (mean, var), live in pairs:
        assert mean.shape == (4, 32) and bool(torch.isfinite(mean).all())
        torch.testing.assert_close(mean, live.mean, rtol=1e-12, atol=0.0)
        torch.testing.assert_close(var, live.var, rtol=1e-12, atol=0.0)


def test_config5_round_trip_equals_the_live_predict_f():
    _hold_round_trip(*_config5_round_trip("cov", "cpu"), "cov")


# ---------------------------------------------------------------------------
# The eight kernels as custom ops
# ---------------------------------------------------------------------------


def _opcheck_cases(device):
    """(op name, label, args) on [3, d, d] operands, d = 4: contiguous, and
    column-slice and stride-0 broadcast views (the kernels read them in place)."""
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=gen, dtype=F64).to(device)

    def spd(n, d):
        X = r(n, d, d)
        return X @ X.transpose(-1, -2) + d * torch.eye(d, dtype=F64, device=device)

    N, d = 3, 4
    W = r(N, d, 3 * d)
    bcast = spd(1, d).expand(N, d, d)
    filt = [r(N, d, d), r(N, d), 0.1 * spd(N, d), 0.1 * spd(N, d), r(N, d)]  # A, b, C, J, eta
    smooth = [r(N, d, d), r(N, d), spd(N, d)]  # E, g, L
    return [
        ("bmm", "contiguous", (r(N, d, d), r(N, d, d), False, True)),
        ("bmm", "views", (W[:, :, 1:1 + d], r(1, d, d).expand(N, d, d), True, False)),
        ("gj_solve", "contiguous", (spd(N, d), r(N, d, 3))),
        ("gj_solve", "views", (bcast, W[:, :, 2:5])),
        ("gj_solve_logdet", "contiguous", (spd(N, d), r(N, d, 2))),
        ("gj_solve_logdet", "views", (bcast, W[:, :, 5:5 + d])),
        ("lq", "contiguous", (r(N, d, 2 * d),)),
        ("lq", "views", (W[:, :, 1:2 + 2 * d],)),
        ("chol", "contiguous", (spd(N, d), None)),
        ("chol", "views", (bcast, 1e-10)),
        ("chol_gram", "contiguous", (r(N, d, d), r(N, d, 2), True, None)),
        ("chol_gram", "views", (W[:, :, :3], W[:, :, 7:9], False, 1e-12)),
        ("fused_filter", "contiguous", (filt + [x.clone() for x in filt],)),
        ("fused_filter", "views", ([W[:, :, :d], *filt[1:], *filt[:2], bcast, *filt[3:]],)),
        ("fused_smooth", "contiguous", (smooth + [x.clone() for x in smooth],)),
        ("fused_smooth", "views", ([W[:, :, d:2 * d], *smooth[1:], *smooth[:2], bcast],)),
    ]


_CASES = [(name, label) for name, label, _ in _opcheck_cases("cpu")]


@pytest.mark.parametrize("name,label", _CASES, ids=[f"{n}-{lbl}" for n, lbl in _CASES])
def test_opcheck(name, label):
    args = next(a for n, lbl, a in _opcheck_cases("cpu") if (n, lbl) == (name, label))
    torch.library.opcheck(getattr(torch.ops.physs_gp, name).default, args)


_SEEN = []


def _probe(A):
    _SEEN.append((A.data_ptr(), A.stride()))
    return A.clone()


_PROBE = KernelOp("stride_probe", "(Tensor A) -> Tensor", _probe, _probe, lambda A: A.new_empty(A.shape))


def _hold_views_unchanged(device):
    """The dispatcher hands an op's implementation a column slice and a
    stride-0 batch as they are: no copy, the same strides."""
    W = torch.randn(4, 8, 16, dtype=F64, device=device)
    for view in (W[:, :, 3:11], W[:1].expand(4, 8, 16)):
        _SEEN.clear()
        torch.ops.physs_gp.stride_probe(view)
        assert _SEEN == [(view.data_ptr(), view.stride())]


def test_the_dispatcher_hands_views_unchanged():
    _hold_views_unchanged("cpu")


def test_every_kernel_has_its_op():
    assert set(ops.launch_counts()) == {n for n, _ in _CASES}
    # eps_rel and Y are optional in the schemas, plus_eye a flag
    assert "float? eps_rel" in str(torch.ops.physs_gp.chol.default._schema)
    assert "Tensor? Y, bool plus_eye" in str(torch.ops.physs_gp.chol_gram.default._schema)
    X = torch.randn(2, 3, 3, dtype=F64)
    torch.testing.assert_close(bc.batch_chol_gram(X, None, True), bc.chol_gram_plain(X, None, True))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
def test_cuda_config5_round_trip_equals_the_live_predict_f(cuda, form):
    _hold_round_trip(*_config5_round_trip(form, cuda), form)


@pytest.mark.cuda
def test_cuda_the_dispatcher_hands_views_unchanged(cuda):
    _hold_views_unchanged(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name,label", _CASES, ids=[f"{n}-{lbl}" for n, lbl in _CASES])
def test_cuda_opcheck(cuda, name, label):
    args = next(a for n, lbl, a in _opcheck_cases(cuda) if (n, lbl) == (name, label))
    torch.library.opcheck(getattr(torch.ops.physs_gp, name).default, args)

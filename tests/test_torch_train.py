"""PyTorch port: hyperparameter training against the JAX package.

Every case feeds the same numpy inputs to the JAX package (CPU, float64)
and to the port (CPU, float64), on the blocked scan schedule with 8 blocks.
The objective's gradient and the training loops on config-5 and the
temporal model are held to the reference runs of
`scripts/port/make_train_golden.py` in `test_torch_train_config5.py`,
`test_torch_train_config5_sqrt.py` and `test_torch_train_temporal.py`
(shared code in `train_parity.py`). Here:
- `trainable_mask` selects the JAX mask's leaves (20 on config-5, 2 on the
  temporal model); `AdamTrainer` (5 steps on a Gaussian `StateSpaceGP`
  and on the temporal CVIGP) matches the JAX trainer at rtol 1e-9, and
  `adam_scan` equals it; `NatGradTrainer` halves a diverging lr as the JAX
  trainer does; `lr_schedule`, `hessian="gauss_newton"`, the metrics, the
  checkpoints, the QR backward of `tria` and the Cholesky's backward on an
  indefinite input.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu import metrics as jmetrics  # noqa: E402
from physs_gp_tpu import trainers as jtrainers  # noqa: E402
from physs_gp_tpu.kernels import Matern32 as JMatern32  # noqa: E402
from physs_gp_tpu.likelihoods import Gaussian as JGaussian  # noqa: E402
from physs_gp_tpu.likelihoods import Poisson as JPoisson  # noqa: E402
from physs_gp_tpu.models import StateSpaceGP as JSSGP  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpositive  # noqa: E402
from physs_gp_tpu.utils.training import trainable_mask as jmask  # noqa: E402
from physs_gp_tpu.zoo import bench_configs as jzoo  # noqa: E402
from physs_gp_tpu_torch import trainers  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson  # noqa: E402
from physs_gp_tpu_torch.metrics import metrics  # noqa: E402
from physs_gp_tpu_torch.models.ssgp import StateSpaceGP  # noqa: E402
from physs_gp_tpu_torch.ops import matrix as tmatrix  # noqa: E402
from physs_gp_tpu_torch.utils import checkpoint  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.utils.training import trainable_mask, trainable_parameters  # noqa: E402
from physs_gp_tpu_torch.zoo import bench_configs as tzoo  # noqa: E402

import train_parity as tp  # noqa: E402

torch.set_num_threads(1)

_rel, _key, _jax_leaves = tp.rel, tp.jax_key, tp.jax_leaves
blocked = tp.blocked


@pytest.mark.parametrize("which,n", [("config5", 20), ("temporal", 2)])
def test_trainable_mask_matches_jax(which, n):
    jm = getattr(jzoo, f"build_{which}")(8, None, dtype=jnp.float64)
    jflat = {jax.tree_util.keystr(p): bool(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jmask(jm))[0]}
    tm = getattr(tzoo, f"build_{which}")(8, None, dtype=torch.float64, device="cpu")
    mask = trainable_mask(tm)
    assert sum(mask.values()) == n == sum(jflat.values())
    assert {_key(k) for k, v in mask.items() if v} == {k for k, v in jflat.items() if v}
    assert {_key(k) for k in mask} == {k for k in jflat if k.endswith(".raw")}
    assert len(trainable_parameters(tm)) == n


# ---------------------------------------------------------------------------
# the host-loop trainers
# ---------------------------------------------------------------------------


def _ssgp_pair():
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 6, 80))
    y = (np.sin(2 * t) + 0.1 * rng.normal(size=80))[:, None]
    jm = JSSGP(t=jnp.asarray(t), Y=jnp.asarray(y), kernel=JMatern32(lengthscale=2.0, variance=0.5),
               likelihood=JGaussian(jpositive(0.5)))
    tm = StateSpaceGP(t=torch.from_numpy(t), Y=torch.from_numpy(y),
                      kernel=Matern32(lengthscale=2.0, variance=0.5, dtype=torch.float64),
                      likelihood=Gaussian(positive_param(0.5, dtype=torch.float64)))
    return jm, tm


def _temporal_pair(T=64):
    jm = jzoo.build_temporal(T, None, dtype=jnp.float64)
    tm = tzoo.build_temporal(T, None, dtype=torch.float64, device="cpu")
    leaves = _jax_leaves(jm)
    leaves.pop(".kernel.Z", None)
    load_numpy_params(tm, leaves)
    return jm, tm


@pytest.mark.parametrize("which", ["ssgp", "temporal"])
def test_adam_trainer_matches_jax(blocked, which, monkeypatch):
    monkeypatch.setenv("PHYSS_INNER_SCAN", "blocked")
    jm, tm = _ssgp_pair() if which == "ssgp" else _temporal_pair()
    jm, jlosses = jtrainers.AdamTrainer(jm, 0.05).train(jm, 5)
    tm, losses = trainers.AdamTrainer(tm, 0.05).train(tm, 5)
    assert _rel(np.array(losses), np.array(jlosses)) <= 1e-9
    jraw = {k: v for k, v in _jax_leaves(jm).items() if k.endswith(".raw")}
    for name, p in tm.named_parameters():
        assert _rel(p, jraw[_key(name)]) <= 1e-9, name


def test_adam_scan_equals_adam_trainer(blocked):
    _, a = _temporal_pair()
    _, b = _temporal_pair()
    a, losses = trainers.adam_scan(a, 5, lr=0.05)
    b, blosses = trainers.AdamTrainer(b, 0.05).train(b, 5)
    assert losses.tolist() == blosses
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


def test_adam_trainer_takes_its_own_model():
    _, a = _temporal_pair(8)
    _, b = _temporal_pair(8)
    with pytest.raises(ValueError):
        trainers.AdamTrainer(a, 0.05).train(b, 1)
    # a seed makes a generator on the model's device (the NatGradTrainer's
    # at its first `train`, when it sees the model)
    assert trainers.AdamTrainer(a, seed=0).generator.device == a.t.device
    assert trainers.VB_NG_Adam(a, seed=0).adam.generator.initial_seed() == 0
    ng = trainers.NatGradTrainer(seed=0)
    assert ng.generator is None
    ng.train(a, [0.5])
    assert ng.generator.initial_seed() == 0


def test_natgrad_trainer_halves_a_diverging_lr(blocked, monkeypatch):
    """The JAX trainer with its solves on their TPU branch (the Pallas
    Gauss-Jordan kernels in interpret mode, the algorithm the port runs):
    at lr 1e12 the site precisions go indefinite and both accept the
    step's finite, negative site variances; at 1e308 they overflow, and
    both halve the lr to the same value and leave finite sites. (On the JAX
    CPU branch, a Cholesky solve, the indefinite precisions are NaN and the
    JAX trainer halves 1e12 four times.)"""
    import functools

    from physs_gp_tpu.ops.pallas import batched_linalg as jbl

    monkeypatch.setenv("PHYSS_INNER_SCAN", "blocked")
    monkeypatch.setattr(jbl, "_on_tpu_backend", lambda: True)
    for name in ("batch_solve", "batch_solve_logdet", "batch_bmm"):
        monkeypatch.setattr(jbl, name, functools.partial(getattr(jbl, name).__wrapped__, interpret=True))
    jm, tm = _temporal_pair(128)
    lrs_in, jlrs, lrs = [0.5, 1e12, 0.5, 1e308, 0.5], [], []
    jm = jtrainers.NatGradTrainer().train(jm, lrs_in, callback=lambda i, m, lr: jlrs.append(lr))
    tm = trainers.NatGradTrainer().train(tm, lrs_in, callback=lambda i, m, lr: lrs.append(lr))
    assert lrs == jlrs and lrs[1] == 1e12 and lrs[3] < 1e308
    assert torch.isfinite(tm.sites.V).all()
    assert _rel(tm.sites.Y, jm.sites.Y) <= 1e-9
    assert _rel(tm.sites.V, jm.sites.V) <= 1e-9


@pytest.mark.parametrize("kind", ["constant", "linear", "log"])
def test_lr_schedule_matches_jax(kind):
    assert trainers.lr_schedule(kind, 0.7, 9) == jtrainers.lr_schedule(kind, 0.7, 9)
    with pytest.raises(ValueError):
        trainers.lr_schedule("cosine", 0.7, 9)


def test_gauss_newton_hessian_equals_exact(blocked):
    """No ported likelihood supplies `natgrad_moments`, so any `hessian`
    takes the exact autograd gradient, as in the reference."""
    _, a = _temporal_pair()
    _, b = _temporal_pair()
    a, ea = trainers.natgrad_scan(a, 0.5, n_steps=2, hessian="exact")
    b, eb = trainers.natgrad_scan(b, 0.5, n_steps=2, hessian="gauss_newton")
    assert torch.equal(ea, eb) and torch.equal(a.sites.V, b.sites.V)
    assert torch.equal(a.sites.Y, b.sites.Y)


def test_nan_guard_reverts_a_diverged_step(blocked):
    _, tm = _temporal_pair()
    Y, V = tm.sites.Y.clone(), tm.sites.V.clone()
    tm, _ = trainers.natgrad_scan(tm, 1e308, n_steps=1)  # the precisions overflow
    assert torch.equal(tm.sites.V, V) and torch.equal(torch.isnan(tm.sites.Y), torch.isnan(Y))


# ---------------------------------------------------------------------------
# metrics, checkpoints, the Cholesky's backward
# ---------------------------------------------------------------------------


def test_metrics_match_jax():
    rng = np.random.default_rng(3)
    y = rng.poisson(2.0, size=(30, 1)).astype(np.float64)
    y[[2, 11]] = np.nan
    mean, var = rng.normal(size=(30, 1)), rng.uniform(0.05, 1.5, size=(30, 1))
    tt = [torch.from_numpy(x) for x in (y, mean, var)]
    jj = [jnp.asarray(x) for x in (y, mean, var)]
    assert _rel(metrics.rmse(tt[0], tt[1]), jmetrics.rmse(jj[0], jj[1])) <= 1e-13
    assert _rel(metrics.gaussian_nlpd(*tt), jmetrics.gaussian_nlpd(*jj)) <= 1e-13
    assert _rel(metrics.nlpd_quadrature(Poisson(), *tt),
                jmetrics.nlpd_quadrature(JPoisson(), *jj)) <= 1e-12
    for level in (0.5, 0.95):
        for a, b in zip(metrics.confidence_interval(tt[1], tt[2], level),
                        jmetrics.confidence_interval(jj[1], jj[2], level)):
            assert _rel(a, b) <= 1e-13


def test_checkpoint_round_trip_gives_the_same_elbo(tmp_path, blocked):
    model = tzoo.build_temporal(64, None, dtype=torch.float64, device="cpu")
    cb = checkpoint.CheckpointCallback(str(tmp_path / "run"), every=2)
    model, _ = trainers.VB_NG_Adam(model, adam_lr=0.05, ng_lr=0.5).train(model, 3, callback=cb)
    assert sorted(os.listdir(tmp_path)) == ["run_best.npz", "run_e0.npz", "run_e2.npz"]
    checkpoint.save_model(tmp_path / "final", model)
    fresh = checkpoint.load_model(tmp_path / "final", tzoo.build_temporal(64, None, dtype=torch.float64,
                                                                          device="cpu"))
    with torch.no_grad():
        assert torch.equal(fresh.elbo(), model.elbo())
    for (k, v), (_, w) in zip(model.state_dict().items(), fresh.state_dict().items()):
        assert torch.equal(torch.nan_to_num(v), torch.nan_to_num(w)), k


def test_checkpoint_rejects_another_model(tmp_path):
    checkpoint.save_model(tmp_path / "c5", tzoo.build_config5(16, None, dtype=torch.float64, device="cpu"))
    with pytest.raises(ValueError):
        checkpoint.load_model(tmp_path / "c5", tzoo.build_temporal(16, None, dtype=torch.float64,
                                                                  device="cpu"))
    checkpoint.save_model(tmp_path / "t16", tzoo.build_temporal(16, None, dtype=torch.float64, device="cpu"))
    with pytest.raises(ValueError):
        checkpoint.load_model(tmp_path / "t16", tzoo.build_temporal(32, None, dtype=torch.float64,
                                                                   device="cpu"))


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

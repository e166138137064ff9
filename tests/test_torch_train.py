"""PyTorch port: hyperparameter training against the JAX package.

Every case feeds the same numpy inputs to the JAX package (CPU, float64)
and to the port (CPU, float64), on the blocked scan schedule with 8 blocks.
The objective's gradient and the training loops on config-5 and the
temporal model are held to the reference runs of
`scripts/port/make_train_golden.py` in `test_torch_train_config5.py`,
`test_torch_train_config5_sqrt.py` and `test_torch_train_temporal.py`
(shared code in `train_parity.py`); those files also hold the light checks
(`trainable_mask`, `lr_schedule`, the metrics, a checkpoint of another
model, the QR and Cholesky backwards), so that the test workers take them
early. Here: `AdamTrainer` (5 steps on a Gaussian `StateSpaceGP` and on
the temporal CVIGP) matches the JAX trainer at rtol 1e-9, and `adam_scan`
equals it; `NatGradTrainer` halves a diverging lr as the JAX trainer does;
`hessian="gauss_newton"`, the NaN guard, a checkpoint round trip.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu import trainers as jtrainers  # noqa: E402
from physs_gp_tpu.kernels import Matern32 as JMatern32  # noqa: E402
from physs_gp_tpu.likelihoods import Gaussian as JGaussian  # noqa: E402
from physs_gp_tpu.models import StateSpaceGP as JSSGP  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpositive  # noqa: E402
from physs_gp_tpu.zoo import bench_configs as jzoo  # noqa: E402
from physs_gp_tpu_torch import trainers  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.models.ssgp import StateSpaceGP  # noqa: E402
from physs_gp_tpu_torch.utils import checkpoint  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo import bench_configs as tzoo  # noqa: E402

import train_parity as tp  # noqa: E402

torch.set_num_threads(1)

_rel, _key, _jax_leaves = tp.rel, tp.jax_key, tp.jax_leaves
blocked = tp.blocked


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
# checkpoints
# ---------------------------------------------------------------------------


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

"""PyTorch port: the nonlinear-dynamics path (`ops/ekf`, `NonlinearSSGP`,
`zoo/dynamics`, `models/wrappers`, `config`) against the JAX package.

Live cases feed the same numpy inputs to both packages at small sizes
(float64, rtol 1e-9): the sequential EKF / EKS, the lml's gradient by the
pendulum's damping against `jax.grad`, the model wrappers and the default
factories. The golden cases hold the port to
`tests/data/dynamics_golden.npz` (`scripts/port/make_dynamics_golden.py`):
the pendulum and Lorenz models by both methods, the Lotka-Volterra and
latent-force recipes and the Euler-Maruyama path on the JAX draws. JAX is
imported only inside the live cases, so the `cuda` twins run on the card:

    python3 -m pytest --noconftest -m cuda tests/test_torch_dynamics.py
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
import dynamics_outcome as do  # noqa: E402

from physs_gp_tpu_torch.ops import ekf  # noqa: E402
from physs_gp_tpu_torch.utils.training import trainable_parameters  # noqa: E402

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")
T_LIVE = 40


@pytest.fixture(scope="module")
def gold():
    return np.load(do.GOLDEN)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(res):
    for key, (got, want, tol) in res.items():
        r = do.relerr(got, want)
        assert r <= tol, (key, r, tol)


def _jax_pendulum(t, y, c, **kw):
    sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
    import make_dynamics_golden as ref

    return ref.jax_pendulum(t, y, c, **kw)


def test_ekf_filter_smoother_and_damping_gradient_match_jax():
    """`ekf_filter` / `ekf_smoother` on the pendulum (T = 40, 4 substeps):
    lml, filtered and smoothed moments and gains; and d lml / d damping
    through the EKF (the `test_ekf_learns_damping` pattern), the port's
    autograd against `jax.grad`."""
    import jax

    t, y, _ = do.pendulum_inputs(T_LIVE, c=0.3, noise_sd=0.02)

    def jax_run(c):
        f, s = _jax_pendulum(t, y, c).filter_smooth()
        return f.lml, (f, s)

    (_, (f, s)), grad = jax.jit(jax.value_and_grad(jax_run, has_aux=True))(1.0)
    c = torch.tensor(1.0, **F64, requires_grad=True)
    f2, s2 = do.pendulum_model(t, y, c, device="cpu").filter_smooth()
    f2.lml.backward()
    for got, want in ((f2.lml, f.lml), (f2.ms, f.ms), (f2.Ps, f.Ps), (s2.ms, s.ms),
                      (s2.Ps, s.Ps), (s2.Gs, s.Gs), (c.grad, grad)):
        assert do.relerr(do.numpy(got), np.asarray(want)) <= 1e-9


def test_affine_offsets_match_the_sequential_recurrence():
    """The iterated smoother's offsets c_k = A_k c_{k-1} + b_k by the
    parallel affine scan against the sequential loop (float64, 1e-12)."""
    rng = np.random.default_rng(0)
    T, d = 300, 3
    A = torch.as_tensor(np.eye(d) + 0.05 * rng.normal(size=(T, d, d)), **F64)
    b = torch.as_tensor(rng.normal(size=(T, d)), **F64)
    c, seq = torch.zeros(d, **F64), []
    for k in range(T):
        c = A[k] @ c + b[k]
        seq.append(c)
    got = ekf.affine_offsets(A, b)
    assert do.relerr(do.numpy(got), do.numpy(torch.stack(seq))) <= 1e-12


def test_iterated_parallel_approaches_the_sequential_smoother():
    """`tests/test_ekf.py`'s gate in the port: the iterated parallel EKS
    (8 passes) ends within 2e-2 of the sequential EKS on the pendulum."""
    t, y, _ = do.pendulum_inputs(96)
    with torch.no_grad():
        seq = do.pendulum_model(t, y, do.PEND["c"], device="cpu").posterior_states()[0]
        par = do.pendulum_model(t, y, do.PEND["c"], device="cpu", method="iterated_parallel",
                                n_iters=8).posterior_states()[0]
    assert float(torch.max(torch.abs(par[:, 0] - seq[:, 0]))) < 2e-2


@pytest.mark.parametrize("cfg", ["pend", "lorenz", "lv", "lfm", "em"])
def test_port_matches_dynamics_golden(gold, cfg):
    _check(do.anchors(gold, "cpu", (cfg,))[cfg])


def test_lorenz_iterated_smoother_with_the_fused_knob(gold, monkeypatch):
    """`PHYSS_FUSED_COMBINE=1` sends the d = 3 scans of the Lorenz iterated
    smoother to the fused combines (their plain versions here): the same
    golden moments."""
    from physs_gp_tpu_torch.ops.cuda import fused_combine as fc

    calls = {"filter": 0, "smooth": 0}

    def counted(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    monkeypatch.setenv("PHYSS_FUSED_COMBINE", "1")
    monkeypatch.setattr(fc, "fused_filtering_combine", counted("filter", fc.fused_filtering_combine))
    monkeypatch.setattr(fc, "fused_smoothing_combine", counted("smooth", fc.fused_smoothing_combine))
    res = do.anchors(gold, "cpu", ("lorenz::ieks",))["lorenz::ieks"]
    assert res and all(k.startswith("ieks::") for k in res), sorted(res)
    _check(res)
    assert calls["filter"] > 0 and calls["smooth"] > 0, calls


def test_nonlinear_ssgp_has_no_trainable_parameters():
    """The reference's params are plain arrays, so its trainable mask is
    empty; the port's too, and an L-BFGS run leaves the model as it was."""
    from physs_gp_tpu_torch.trainers import LBFGSTrainer

    t, y, _ = do.pendulum_inputs(12)
    model = do.pendulum_model(t, y, do.PEND["c"], device="cpu")
    assert trainable_parameters(model) == []
    _, losses = LBFGSTrainer(model).train(model, 1)
    assert losses[0] == float(model.get_objective().detach())


def test_euler_maruyama_sample_draws_from_its_generator():
    """`euler_maruyama_sample` is its `_given` layer on the generator's
    draws [T - 1, n_substeps, w]."""
    t = torch.linspace(0, 2, 30, **F64)
    args = (lambda x: -x, torch.eye(1, **F64), torch.tensor([[1.6]], **F64), torch.zeros(1, **F64), t)
    x = ekf.euler_maruyama_sample(*args, torch.Generator().manual_seed(3), n_substeps=2)
    eps = torch.randn(29, 2, 1, generator=torch.Generator().manual_seed(3), **F64)
    assert torch.equal(x, ekf.euler_maruyama_sample_given(*args, eps, n_substeps=2))
    with pytest.raises(TypeError):
        ekf.euler_maruyama_sample(*args, None)


def test_recipes_need_the_card_unless_asked():
    """`device` defaults to "cuda": without a card the recipes raise rather
    than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from physs_gp_tpu_torch.config import default_kernel
    from physs_gp_tpu_torch.zoo import dynamics

    t, y, _ = do.lfm_inputs(20)
    for build in (lambda: dynamics.latent_force_gp(t, y), lambda: dynamics.lorenz_gp(t, y),
                  lambda: dynamics.lotka_volterra_gp(t, np.stack([y, y], 1)),
                  lambda: dynamics.dynamic_covariance_gp(t, np.stack([y, y], 1)), default_kernel):
        with pytest.raises((RuntimeError, AssertionError)):
            build()


def test_multiobjective_and_latent_predictor_match_jax():
    """`tests/test_dynamics.py`'s wrapper gate: the summed objective of a
    model listed twice, and the derivative head's predictions, against the
    JAX package's."""
    import jax
    import jax.numpy as jnp

    from physs_gp_tpu.kernels import Matern52 as JMatern52
    from physs_gp_tpu.likelihoods.gaussian import IndependentGaussian as JIG
    from physs_gp_tpu.models import LatentPredictor as JLP
    from physs_gp_tpu.models import StateSpaceGP as JSS
    from physs_gp_tpu.transforms import DerivativeHead as JDH
    from physs_gp_tpu.transforms import StateObservation as JSO
    from physs_gp_tpu.transforms import ValueHead as JVH
    from physs_gp_tpu.utils.params import positive_param as jpp
    from physs_gp_tpu_torch.kernels.matern import Matern52
    from physs_gp_tpu_torch.likelihoods.gaussian import IndependentGaussian
    from physs_gp_tpu_torch.models import LatentPredictor, MultiObjectiveModel, StateSpaceGP
    from physs_gp_tpu_torch.transforms.operators import DerivativeHead, StateObservation, ValueHead
    from physs_gp_tpu_torch.utils.params import positive_param

    rng = np.random.default_rng(3)
    t = np.sort(rng.uniform(0, 4, 40))
    Y = np.stack([np.sin(2 * t) + 0.05 * rng.normal(size=40), np.full(40, np.nan)], 1)
    jm = JSS(t=jnp.asarray(t), Y=jnp.asarray(Y), kernel=JMatern52(lengthscale=0.7),
             likelihood=JIG(variances=[jpp(0.0025), jpp(1.0).fix()]),
             observation=JSO(heads=[JVH(), JDH(order=1)]))
    m = StateSpaceGP(t=torch.as_tensor(t, **F64), Y=torch.as_tensor(Y, **F64),
                     kernel=Matern52(lengthscale=0.7, **F64),
                     likelihood=IndependentGaussian([positive_param(0.0025, **F64),
                                                     positive_param(1.0, **F64).fix()]),
                     observation=StateObservation([ValueHead(), DerivativeHead(order=1)]))
    mo = MultiObjectiveModel([m, m])
    objective, want = jax.jit(lambda mm, tt: (mm.get_objective(), JLP(base=mm, head=1).predict_f(tt)))(
        jm, jnp.asarray(t))
    assert abs(float(mo.get_objective()) - 2 * float(objective)) <= 1e-9 * abs(2 * float(objective))
    got = LatentPredictor(m, head=1).predict_f(torch.as_tensor(t, **F64))
    assert do.relerr(do.numpy(got.mean), np.asarray(want.mean)) <= 1e-9
    assert do.relerr(do.numpy(got.var), np.asarray(want.var)) <= 1e-9
    assert np.corrcoef(do.numpy(got.mean)[:, 0], 2 * np.cos(2 * t))[0, 1] > 0.98


def test_config_defaults_match_jax():
    import jax.numpy as jnp

    from physs_gp_tpu import config as jconfig
    from physs_gp_tpu_torch import config

    X = np.linspace(0, 3, 7)[:, None]
    want = jconfig.Defaults.kernel().K(jnp.asarray(X), jnp.asarray(X))
    got = config.Defaults.kernel(device="cpu").K(torch.as_tensor(X, **F64), torch.as_tensor(X, **F64))
    assert do.relerr(do.numpy(got), np.asarray(want)) <= 1e-12
    lik = config.Defaults.likelihood(device="cpu")
    assert float(lik.variance.value) == float(jconfig.Defaults.likelihood().variance.value)


@pytest.mark.cuda
def test_cuda_lorenz_iterated_smoother_matches_golden(cuda, gold):
    """The card twin at d = 3: the iterated smoother's scans on the `bmm`
    and `gj_solve` kernels, the sequential EKS's Cholesky on `chol`."""
    from physs_gp_tpu_torch.ops import cuda as kernels

    kernels.reset_launch_counts()
    _check(do.anchors(gold, "cuda", ("lorenz",))["lorenz"])
    counts = kernels.launch_counts()
    assert counts["bmm"] > 0 and counts["gj_solve"] > 0 and counts["chol"] > 0, counts

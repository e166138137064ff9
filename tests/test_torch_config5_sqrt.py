"""PyTorch port: the square-root config-5 CVI slice (`sqrt=True`) against
`tests/data/config5_sqrt_T256_golden.npz`, with the same tolerances as the
covariance slice (`config5_parity`): the JAX package reproduces the golden
file, the port matches it, and with `PHYSS_FUSED_COMBINE=1` the slice takes
no fused combine and still matches. The reference run takes the TPU branch
of the JAX smoother's `_factor_psd` (the pivot-floored Cholesky without
jitter), which the port follows on every device.

Module checks against the JAX package: RBF's closed-form operator
cross-covariances `K_op`, and the head rows of `StateObservation.H` over
Matérn, sum, Wiener and periodic kernels (`derivative_row`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from physs_gp_tpu.kernels import Matern32 as JMatern32  # noqa: E402
from physs_gp_tpu.kernels.periodic import Periodic as JPeriodic  # noqa: E402
from physs_gp_tpu.kernels.rbf import RBF as JRBF  # noqa: E402
from physs_gp_tpu.kernels.wiener import WienerVelocity as JWienerVelocity  # noqa: E402
from physs_gp_tpu.trainers import natgrad_scan as jscan  # noqa: E402
from physs_gp_tpu.transforms import operators as jops  # noqa: E402
from physs_gp_tpu.utils.params import positive_param as jpositive  # noqa: E402
from physs_gp_tpu.zoo.bench_configs import build_config5 as jbuild  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32  # noqa: E402
from physs_gp_tpu_torch.kernels.periodic import Periodic  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.kernels.wiener import WienerVelocity  # noqa: E402
from physs_gp_tpu_torch.transforms import operators as tops  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from config5_parity import CHUNK, GOLDEN_SQRT, T, _check_against, _close, _port_run  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["identity", ("grad", 0), ("grad", 1), ("grad2", 1), "laplacian"])
def test_rbf_k_op(kind):
    rng = np.random.default_rng(1)
    S, Z = rng.uniform(size=(7, 2)), rng.uniform(size=(16, 2))
    jk = JRBF(lengthscales=jpositive(jnp.asarray(0.5)), variance=jpositive(jnp.asarray(1.2)))
    tk = RBF(lengthscales=positive_param(0.5, dtype=torch.float64),
             variance=positive_param(1.2, dtype=torch.float64))
    _close(tk.K_op(torch.from_numpy(S), torch.from_numpy(Z), kind),
           jk.K_op(jnp.asarray(S), jnp.asarray(Z), kind), 1e-12, 1e-14)


def _pp(v):
    return positive_param(v, dtype=torch.float64)


def _head_kernels(name):
    """(JAX kernel, port kernel) of the Markov kernels the heads read."""
    if name == "matern_sum":
        return (JMatern32(lengthscale=jnp.asarray(2.0), variance=jnp.asarray(1.3))
                + JMatern32(lengthscale=jnp.asarray(0.5), variance=jnp.asarray(0.4)),
                Matern32(2.0, 1.3, dtype=torch.float64) + Matern32(0.5, 0.4, dtype=torch.float64))
    if name == "wiener_velocity":
        return JWienerVelocity(variance=jpositive(jnp.asarray(0.7))), WienerVelocity(_pp(0.7), _pp(1e-6))
    per = dict(lengthscales=0.8, variance=0.9, period=3.0)
    return (JMatern32(lengthscale=jnp.asarray(2.0), variance=jnp.asarray(1.3))
            + JPeriodic(**{k: jpositive(jnp.asarray(v)) for k, v in per.items()}, n_harmonics=4),
            Matern32(2.0, 1.3, dtype=torch.float64)
            + Periodic(_pp(0.8), _pp(0.9), _pp(3.0), n_harmonics=4))


@pytest.mark.parametrize("name", ["matern_sum", "wiener_velocity", "trend_periodic"])
def test_head_rows_over_markov_kernels_match_jax(name):
    """`derivative_row` composes over sums and reads any other Markov
    kernel's state as (f, f', ...): the value, derivative and linear-operator
    heads' rows over a sum of Matérns, `WienerVelocity` and a trend +
    periodic kernel are the JAX package's (`Matern32 + Matern32` gives
    [1, 0, 1, 0] for the value head)."""
    jk, tk = _head_kernels(name)
    heads = [tops.ValueHead(), tops.DerivativeHead(1), tops.LinearOperatorHead([0.5, 2.0])]
    jheads = [jops.ValueHead(), jops.DerivativeHead(order=1), jops.LinearOperatorHead(coeffs=[0.5, 2.0])]
    H = tops.StateObservation(heads).H(tk)
    _close(H, jops.StateObservation(heads=jheads).H(jk), 1e-12, 1e-15)
    if name == "matern_sum":
        _close(H[0], [1.0, 0.0, 1.0, 0.0], 0.0)


def test_jax_reproduces_sqrt_golden(monkeypatch):
    import functools

    from physs_gp_tpu.ops import matrix as jmatrix
    from physs_gp_tpu.ops import parallel_sqrt_kalman as jpsk
    from physs_gp_tpu.ops.pallas import batched_chol as jbc

    monkeypatch.setenv("PHYSS_INNER_SCAN", "blocked")
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    # `_factor_psd`'s TPU branch: the Pallas Cholesky, run in interpret mode
    chol = functools.partial(jbc.batch_cholesky.__wrapped__, interpret=True)
    monkeypatch.setattr(jpsk, "_factor_psd", lambda L: chol(jmatrix.symmetrize(L)))
    gold = np.load(GOLDEN_SQRT)
    j0 = jbuild(T, CHUNK, dtype=jnp.float64, sqrt=True)
    jm, je = jax.jit(lambda m: jscan(m, 0.5, n_steps=3))(j0)
    post = jax.jit(lambda m: m.posterior())(jm)
    _close(je, gold["elbos"], 1e-12)
    _close(jm.sites.Y, gold["site_Y"], 1e-10, 1e-14)
    _close(post.mean, gold["post_mean"], 1e-10, 1e-12)
    _close(post.var, gold["post_var"], 1e-10)


def test_port_matches_sqrt_golden(monkeypatch):
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    model, elbos = _port_run(jbuild(T, CHUNK, dtype=jnp.float64, sqrt=True), sqrt=True)
    _check_against(model, elbos, dict(np.load(GOLDEN_SQRT)))


def test_sqrt_slice_takes_no_fused_combine(monkeypatch):
    """The knob acts on the covariance-form scans only: with it set, the
    square-root slice (whose smoother scans in Gram form) calls neither fused
    combine and still gives the golden file's values."""
    from physs_gp_tpu_torch.ops import parallel_kalman as tpk

    calls = []
    monkeypatch.setattr(tpk.fc, "fused_filtering_combine", lambda *a: calls.append("filter"))
    monkeypatch.setattr(tpk.fc, "fused_smoothing_combine", lambda *a: calls.append("smooth"))
    monkeypatch.setenv("PHYSS_SCAN_BLOCKS", "8")
    monkeypatch.setenv("PHYSS_FUSED_COMBINE", "1")
    model, elbos = _port_run(jbuild(T, CHUNK, dtype=jnp.float64, sqrt=True), sqrt=True)
    assert calls == []
    _check_against(model, elbos, dict(np.load(GOLDEN_SQRT)))

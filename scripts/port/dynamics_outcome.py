"""The nonlinear-dynamics and volatility path of the PyTorch port: its inputs,
models, float64 anchors against the golden file, the outcome gates of the
JAX package's own tests, and the runs at length.

- anchors (`anchor`): the pendulum `NonlinearSSGP` of `tests/test_ekf.py`
  at T = 256 (sequential EKF / EKS and 8 iterated parallel EKS passes, the
  lml's gradient by the damping), `lorenz_gp` at T = 256 (sequential and 8
  parallel passes, d = 3), `lotka_volterra_gp` and `latent_force_gp`
  (T = 128), `euler_maruyama_sample_given` on the JAX draws,
  `correlation_cholesky`, a `BatchGP` over `LMC.init_drd`, `HetGaussian`'s
  ELL, `dynamic_covariance_gp` (P = 2, T = 64, n_mc = 16, 5 Gauss-Newton
  steps at lr 0.3 on the two JAX draw sets), `LBFGSTrainer` (10 iterations
  on `tests/test_trainers_metrics.py`'s `_model()`), `VB_NG_LBFGS` (3 epochs
  on its Poisson CVIGP, 2 on config-5 at T = 256, held to the golden file's
  L-BFGS over the trainable leaves, `trainable::`, where the reference's
  own run moves the sites or cannot start: `trainers/extra.py`);
- outcome gates (`outcome`): the JAX tests' gates on their own data
  (Lotka-Volterra RMSE, Lorenz hidden-state correlations by both methods,
  the latent force's correlation, the dynamic-correlation path);
- at length (`ieks_at_length`, `dynamic_covariance_wide`,
  `config5_vb_ng_lbfgs`): `lorenz_gp` at T = 20 000 (dt 0.0002) by the
  iterated parallel EKS, the dynamic-correlation model at P = 5 over T = 2520, `VB_NG_LBFGS`
  on config-5 at T = 100 000.

The numpy inputs here are shared by `make_dynamics_golden.py` (the JAX
side), `tests/test_torch_lbfgs.py`, `tests/test_torch_dynamics.py`,
`tests/test_torch_dynamic_covariance.py` and `chip_smoke.py`.

    python3 scripts/port/dynamics_outcome.py [--device cuda]

runs the outcome gates, prints one JSON line and exits non-zero if one
fails; with `--jacobians` it times the sequential EKF loops with each
Jacobian routine instead (`jacobian_routines`).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32  # noqa: E402
from physs_gp_tpu_torch.kernels.multi_output import LMC  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.likelihoods.dynamic_covariance import correlation_cholesky  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.likelihoods.het_gaussian import HetGaussian  # noqa: E402
from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson  # noqa: E402
from physs_gp_tpu_torch.models import CVIGP, BatchGP, NonlinearSSGP, StateSpaceGP  # noqa: E402
from physs_gp_tpu_torch.ops.ekf import ekf_filter, euler_maruyama_sample_given  # noqa: E402
from physs_gp_tpu_torch.trainers import LBFGSTrainer, VB_NG_LBFGS  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.bench_configs import build_config5  # noqa: E402
from physs_gp_tpu_torch.zoo.dynamics import (  # noqa: E402
    dynamic_covariance_gp,
    latent_force_gp,
    lorenz_gp,
    lotka_volterra_gp,
)

GOLDEN = os.path.join(REPO, "tests", "data", "dynamics_golden.npz")
TOL = {"value": 1e-9, "lbfgs": 1e-8}
SCAN_BLOCKS = "8"  # the blocked scan schedule of the anchors, both packages
PEND = dict(c=0.25, w2=9.0, noise_sd=0.05)
IEKS_ITERS = 8  # the anchors' iterated-smoother passes
T_ANCHOR = {"pend": 256, "lorenz": 256, "lv": 128, "lfm": 128}
EM = dict(lam=1.0, var=0.8, T=200, t_max=10.0, n_substeps=2, seed=0)
DC = dict(T=64, P=2, n_mc=16, steps=5, lr=0.3)
LBFGS_ITERS, VBP_EPOCHS, VBC5_EPOCHS, VB_NG_LR = 10, 3, 2, 0.8
C5_T, C5_CHUNK, C5_NG_LR = 256, 64, 0.5
# the runs at length
# the Lorenz test's 4 time units at 10x its sampling: over 40 time units
# (dt 0.002) the iterated smoother from the noise-free propagation of m0
# diverges in both packages (ROADMAP queue 3, item 14)
LORENZ_LONG = dict(T=20_000, dt=0.0002, chunk=5_000, n_iters=5)
DC_WIDE = dict(T=2520, P=5, steps=20)
C5_FULL = dict(T=100_000, chunk=25_000, epochs=2)
CONFIGS = ("pend", "lorenz", "lv", "lfm", "em", "cc", "drd", "het", "dc", "lbfgs", "vbp", "vbc5")


def _kw(dtype, device):
    return dict(dtype=dtype, device=device)


def numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def relerr(got, want):
    """max |got - want| / max |want| (NaNs in the same places)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.array_equal(np.isnan(got), np.isnan(want)):
        return float("inf")
    return float(np.nanmax(np.abs(got - want)) / (np.nanmax(np.abs(want)) or 1.0))


def _corr(a, b):
    return float(np.corrcoef(a, b)[0, 1])


# ---------------------------------------------------------------------------
# inputs (numpy): the JAX tests' data generators
# ---------------------------------------------------------------------------


def pendulum_inputs(T=256, c=PEND["c"], w2=PEND["w2"], t_max=6.0, noise_sd=PEND["noise_sd"],
                    seed=1):
    """`tests/test_ekf.py::_make_pendulum_data`: (t, y, truth [2, T])."""
    from scipy.integrate import solve_ivp

    rng = np.random.default_rng(seed)
    sol = solve_ivp(lambda s, x: [x[1], -c * x[1] - w2 * np.sin(x[0])], (0, t_max), [1.4, 0.0],
                    dense_output=True, rtol=1e-9)
    t = np.linspace(1e-3, t_max, T)
    return t, sol.sol(t)[0] + noise_sd * rng.normal(size=T), sol.sol(t)


def lv_inputs(T=500):
    """`tests/test_dynamics.py`'s Lotka-Volterra data: (t, y [T, 2], truth
    [T, 2]); the anchor takes the first rows."""
    from scipy.integrate import solve_ivp

    a, b, d_, g = 1.0, 0.1, 0.075, 1.5
    sol = solve_ivp(lambda s, x: [a * x[0] - b * x[0] * x[1], d_ * x[0] * x[1] - g * x[1]],
                    (0, 20), [10.0, 5.0], dense_output=True, rtol=1e-9)
    rng = np.random.default_rng(0)
    t = np.linspace(0.01, 20, 500)
    truth = sol.sol(t).T
    y = truth + 0.2 * rng.normal(size=(500, 2))
    return t[:T], y[:T], truth[:T]


def lorenz_inputs(T=2000, dt=0.002):
    """`tests/test_dynamics.py`'s Lorenz data over T steps of dt (T = 2000,
    dt = 0.002 is the test's): (t, y [T], truth [3, T])."""
    from scipy.integrate import solve_ivp

    s_, r_, b_ = 10.0, 28.0, 8.0 / 3.0
    t_max = dt * T
    sol = solve_ivp(lambda s, x: [s_ * (x[1] - x[0]), x[0] * (r_ - x[2]) - x[1],
                                  x[0] * x[1] - b_ * x[2]],
                    (0, t_max), [1.0, 1.0, 1.0], dense_output=True, rtol=1e-10)
    rng = np.random.default_rng(1)
    t = np.linspace(dt, t_max, T)
    truth = sol.sol(t)
    return t, truth[0] + 0.5 * rng.normal(size=T), truth


def lfm_inputs(T=400):
    """`tests/test_dynamics.py`'s latent-force data: (t, y, u_true); the
    anchor takes the first rows."""
    rng = np.random.default_rng(2)
    t = np.linspace(0.01, 10, 400)
    u_true = np.sin(1.5 * t)
    x = np.zeros_like(t)
    for i in range(1, len(t)):
        x[i] = x[i - 1] + (t[i] - t[i - 1]) * (-x[i - 1] + u_true[i - 1])
    y = x + 0.02 * rng.normal(size=len(t))
    return t[:T], y[:T], u_true[:T]


def dc_inputs(T=200, P=2, seed=2):
    """`tests/test_dynamic_covariance.py`'s data: 2 outputs whose correlation
    swings as 0.8 sin(0.6 t): (t, Y [T, P], rho [T])."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 10, T)
    rho = 0.8 * np.sin(0.6 * t)
    Y = np.empty((T, P))
    for k in range(T):
        C = np.array([[1.0, rho[k]], [rho[k], 1.0]])
        Y[k] = np.linalg.cholesky(C) @ rng.normal(size=P)
    return t, Y, rho


def _np_correlation_cholesky(z, P):
    rows, cols = np.tril_indices(P, -1)
    Z = np.zeros(z.shape[:-1] + (P, P))
    Z[..., rows, cols] = z
    L = np.zeros_like(Z)
    L[..., 0, 0] = 1.0
    for i in range(1, P):
        rem = np.ones(z.shape[:-1])
        for j in range(i):
            L[..., i, j] = Z[..., i, j] * np.sqrt(np.maximum(rem, 1e-30))
            rem = rem - L[..., i, j] ** 2
        L[..., i, i] = np.sqrt(np.maximum(rem, 1e-30))
    return L


def dc_wide_inputs(T=DC_WIDE["T"], P=DC_WIDE["P"], seed=5):
    """Daily returns of P assets over T trading days whose Q = P(P-1)/2
    partial correlations drift smoothly (random phases and periods of 100 to
    1000 days) and whose volatilities differ: (t in years, Y [T, P])."""
    rng = np.random.default_rng(seed)
    Q = P * (P - 1) // 2
    t = np.arange(T) / 252.0
    period = rng.uniform(100, 1000, Q) / 252.0
    z = 0.7 * np.sin(2 * np.pi * t[:, None] / period + rng.uniform(0, 2 * np.pi, Q))
    L = _np_correlation_cholesky(z, P) * rng.uniform(0.5, 2.0, P)[:, None]
    return t, np.einsum("tij,tj->ti", L, rng.normal(size=(T, P)))


def em_inputs():
    """The Ornstein-Uhlenbeck SDE of `tests/test_ekf.py` on a short grid."""
    return np.linspace(0, EM["t_max"], EM["T"])


def cc_inputs(P=4, seed=0):
    rng = np.random.default_rng(seed)
    return np.tanh(rng.normal(size=(7, P * (P - 1) // 2)))


def drd_inputs(seed=6):
    """A 3-output LMC with `init_drd` mixing (3 RBF latents) at 15 points."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 3, (15, 1))
    Y = np.stack([np.sin(2 * X[:, 0]), np.cos(X[:, 0]), X[:, 0] - 1.5], 1)
    return X, Y + 0.1 * rng.normal(size=Y.shape)


def het_inputs(T=30, seed=7):
    """y [T] with 2 NaNs, joint head moments m [T, 2], S [T, 2, 2]."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=T)
    y[[3, 11]] = np.nan
    m = 0.3 * rng.normal(size=(T, 2))
    B = 0.3 * rng.normal(size=(T, 2, 2))
    return y, m, B @ np.swapaxes(B, -1, -2) + 0.05 * np.eye(2)


def lbfgs_inputs(seed=0, T=80):
    """`tests/test_trainers_metrics.py::_model`'s data."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 6, T))
    return t, np.sin(2 * t) + 0.1 * rng.normal(size=T)


def poisson_inputs(T=60):
    """`tests/test_trainers_metrics.py::test_vb_ng_lbfgs_on_poisson`'s data."""
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(0, 6, T))
    return t, rng.poisson(np.exp(1.1 * np.sin(t))) * 1.0


# ---------------------------------------------------------------------------
# port models
# ---------------------------------------------------------------------------


def pendulum_drift(params, x):
    c, w2 = params
    return torch.stack([x[1], -c * x[1] - w2 * torch.sin(x[0])])


def pendulum_model(t, y, c, dtype=torch.float64, device="cuda", **kw):
    """`tests/test_ekf.py::_pendulum_model`; `c` a number or a tensor."""
    tk = _kw(dtype, device)
    T = len(t)
    return NonlinearSSGP(
        t=torch.as_tensor(t, **tk), Y=torch.as_tensor(y, **tk)[:, None],
        params=(torch.as_tensor(c, **tk), torch.as_tensor(PEND["w2"], **tk)),
        L=torch.tensor([[0.0], [1.0]], **tk), Qc=torch.tensor([[0.1]], **tk),
        m0=torch.tensor([1.4, 0.0], **tk), P0=0.1 * torch.eye(2, **tk),
        R=(PEND["noise_sd"] ** 2 * torch.eye(1, **tk)).expand(T, 1, 1),
        drift=pendulum_drift, obs_fn=lambda p, x: x[:1], n_substeps=4, **kw,
    )


def recipe(cfg, T, dtype=torch.float64, device="cuda", **kw):
    """The zoo recipe of `cfg` on its data's first T rows, as the JAX tests
    build it; returns (model, truth)."""
    tk = _kw(dtype, device)
    if cfg == "lv":
        t, y, truth = lv_inputs(T)
        return lotka_volterra_gp(t, y, q=0.01, noise=0.2, **tk, **kw), truth
    if cfg == "lorenz":
        t, y, truth = lorenz_inputs(max(T, 2000))
        return lorenz_gp(t[:T], y[:T], q=0.5, noise=0.5, **tk, **kw), truth[:, :T]
    t, y, u = lfm_inputs(T)
    return latent_force_gp(t, y, force_lengthscale=2.0, force_variance=1.0, damping=1.0,
                           noise=0.02, **tk, **kw), u


def dc_model(T=DC["T"], dtype=torch.float64, device="cuda", **kw):
    t, Y, rho = dc_inputs(T)
    k = dict(dtype=dtype, device=device)
    return dynamic_covariance_gp(t, Y, n_mc=DC["n_mc"],
                                 k_latent=lambda: Matern32(lengthscale=2.0, variance=0.5, **k),
                                 **k, **kw), rho


def lbfgs_model(dtype=torch.float64, device="cuda", T=80):
    tk = _kw(dtype, device)
    t, y = lbfgs_inputs(T=T)
    return StateSpaceGP(t=torch.as_tensor(t, **tk), Y=torch.as_tensor(y, **tk)[:, None],
                        kernel=Matern32(lengthscale=2.0, variance=0.5, **tk),
                        likelihood=Gaussian(positive_param(0.5, **tk)))


def poisson_model(dtype=torch.float64, device="cuda"):
    tk = _kw(dtype, device)
    t, y = poisson_inputs()
    return CVIGP.init(torch.as_tensor(t, **tk), torch.as_tensor(y, **tk)[:, None],
                      Matern32(lengthscale=2.0, **tk), Poisson())


def drd_model(dtype=torch.float64, device="cuda"):
    tk = _kw(dtype, device)
    X, Y = drd_inputs()
    latents = [RBF(lengthscales=positive_param(ls, **tk), variance=positive_param(1.0, **tk))
               for ls in (0.5, 1.0, 2.0)]
    return BatchGP(X, Y, LMC.init_drd(latents, scales=[1.0, 2.0, 0.5], **tk),
                   Gaussian(positive_param(0.01, **tk)), **tk)


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------


def flat(gold, cfg):
    """The JAX leaves `<cfg>::flat::<key path>` of the golden file."""
    pre = f"{cfg}::flat::"
    return {k[len(pre):]: gold[k] for k in gold.files if k.startswith(pre)}


def _states(prefix, f, s):
    return {f"{prefix}lml": f.lml, f"{prefix}fms": f.ms, f"{prefix}fPs": f.Ps,
            f"{prefix}sms": s.ms, f"{prefix}sPs": s.Ps}


def anchor(gold, cfg, device):
    """{output: (port value, golden value, tolerance)} of one configuration,
    float64 on `device`. `cfg::part` runs a part of it: `pend::ekf` (the
    EKF's moments and gradient), `pend::ieks` (the iterated smoother's
    moments, without its gradient), `lorenz::ieks` (the iterated smoother
    alone). The iterated smoothers and the config-5 model run the
    blocked scan schedule with SCAN_BLOCKS blocks, as the golden runs."""
    cfg, _, part = cfg.partition("::")
    f64 = torch.float64
    tk = _kw(f64, device)
    got = {}
    kind = "lbfgs" if cfg in ("lbfgs", "vbp", "vbc5") else "value"
    if cfg == "pend":
        t, y, _ = pendulum_inputs(T_ANCHOR["pend"])
        if part in ("", "ekf"):
            # the EKF's gradient from its filter alone (eager in grad mode),
            # its moments without grad mode (replayed graphs on the card)
            c = torch.tensor(PEND["c"], **tk, requires_grad=True)
            model = pendulum_model(t, y, c, device=device)
            ekf_filter(model._ssm(), model.t, model.R, model.Y,
                       n_substeps=model.n_substeps).lml.backward()
            got["ekf::grad_c"] = c.grad
            with torch.no_grad():
                got.update(_states("ekf::", *model.filter_smooth()))
        if part in ("", "ieks"):
            # `pend::ieks`: the iterated smoother's moments alone, without
            # grad mode; `pend` also its gradient by the damping
            c = torch.tensor(PEND["c"], **tk, requires_grad=not part)
            with torch.set_grad_enabled(not part):
                f, s = pendulum_model(t, y, c, device=device, method="iterated_parallel",
                                      n_iters=IEKS_ITERS).filter_smooth()
            got.update(_states("ieks::", f, s))
            if not part:
                f.lml.backward()
                got["ieks::grad_c"] = c.grad
    elif cfg == "lorenz":
        for method, pre in (("ekf", "ekf::"), ("iterated_parallel", "ieks::")):
            if part and not pre.startswith(part):
                continue
            with torch.no_grad():
                model, _ = recipe("lorenz", T_ANCHOR["lorenz"], device=device, method=method,
                                  n_iters=IEKS_ITERS)
                got.update(_states(pre, *model.filter_smooth()))
    elif cfg in ("lv", "lfm"):
        with torch.no_grad():
            model, _ = recipe(cfg, T_ANCHOR[cfg], device=device)
            f, s = model.filter_smooth()
        got.update(lml=f.lml, sms=s.ms)
    elif cfg == "em":
        lam, var = EM["lam"], EM["var"]
        got["xs"] = euler_maruyama_sample_given(
            lambda x: -lam * x, torch.eye(1, **tk), torch.tensor([[2 * var * lam]], **tk),
            torch.zeros(1, **tk), torch.as_tensor(em_inputs(), **tk),
            torch.as_tensor(gold["em::eps"], **tk), n_substeps=EM["n_substeps"])
    elif cfg == "cc":
        got["L"] = correlation_cholesky(torch.as_tensor(cc_inputs(), **tk), 4)
    elif cfg == "drd":
        model = drd_model(device=device)
        load_numpy_params(model, flat(gold, "drd"))
        X = torch.as_tensor(drd_inputs()[0], **tk)
        got["K"] = model.kernel.K(X, X)
        got["lml"] = model.log_marginal_likelihood()
    elif cfg == "het":
        y, m, S = (torch.as_tensor(a, **tk) for a in het_inputs())
        lik = HetGaussian()
        got["ell_blocks"] = lik.expected_log_lik_blocks(y, m, S)
        got["ell_diag"] = lik.expected_log_lik(y, m, torch.diagonal(S, dim1=-2, dim2=-1))
    elif cfg == "dc":
        model, _ = dc_model(device=device)
        draws = (torch.as_tensor(gold["dc::eps_ell"], **tk), torch.as_tensor(gold["dc::eps_ng"], **tk))
        with torch.no_grad():
            _, m, S = model._surrogate_pass()
            got["ell"] = model._ell_data(m, S, draws)
            got["g1"], got["g2"] = model.likelihood.natgrad_moments(model.Y, m, S, draws=draws)
            elbos = []
            for _ in range(DC["steps"]):
                model, e = model.step_with_elbo(DC["lr"], hessian="gauss_newton", draws=draws)
                elbos.append(e)
            got["elbos"] = torch.stack(elbos)
            got["post_mean"] = model.posterior().mean
    elif cfg == "lbfgs":
        model = lbfgs_model(device=device)
        tr = LBFGSTrainer(model)
        _, losses = tr.train(model, LBFGS_ITERS)
        got["losses"] = np.array(losses)
        for name, p in model.named_parameters():
            got["raw::" + jax_key(name)] = p
    elif cfg == "vbp":
        model = poisson_model(device=device)
        _, losses = VB_NG_LBFGS(model, ng_lr=VB_NG_LR).train(model, VBP_EPOCHS)
        got["trainable::losses"] = np.array(losses)
        # the reference's own run: its second L-BFGS step moves the sites
        # (module docstring of trainers/extra.py), so only the losses before
        # that step compare
        got["losses"] = np.array(losses[:2])
        for name, p in model.named_parameters():
            got["trainable::raw::" + jax_key(name)] = p
    elif cfg == "vbc5":
        model = build_config5(C5_T, C5_CHUNK, dtype=f64, device=device)
        _, losses = VB_NG_LBFGS(model, ng_lr=C5_NG_LR).train(model, VBC5_EPOCHS)
        # the reference's own VB_NG_LBFGS cannot start on config-5 (its
        # optax state maps every leaf, and config-5 has Python float leaves)
        got["trainable::losses"] = np.array(losses)
    want = {k: gold[f"{cfg}::{k}"] for k in got}
    if cfg == "vbp":
        want["losses"] = want["losses"][:2]
    return {k: (numpy(v), want[k], TOL[kind]) for k, v in got.items()}


def jax_key(name: str) -> str:
    """A port parameter name as the JAX key path: `likelihood.variances.3.raw`
    -> `.likelihood.variances[3].raw`."""
    return "".join(f"[{p}]" if p.isdigit() else f".{p}" for p in name.split("."))


def anchors(gold, device, configs=CONFIGS):
    """{config: anchor(gold, config, device)} on the blocked schedule."""
    old = os.environ.get("PHYSS_SCAN_BLOCKS")
    os.environ["PHYSS_SCAN_BLOCKS"] = SCAN_BLOCKS
    try:
        return {cfg: anchor(gold, cfg, device) for cfg in configs}
    finally:
        if old is None:
            del os.environ["PHYSS_SCAN_BLOCKS"]
        else:
            os.environ["PHYSS_SCAN_BLOCKS"] = old


# ---------------------------------------------------------------------------
# outcome gates: the JAX tests' own, on their own data
# ---------------------------------------------------------------------------


def lv_outcome(device, dtype=torch.float64):
    model, truth = recipe("lv", 500, dtype, device)
    with torch.no_grad():
        ms, _ = model.posterior_states()
    rmse = float(np.sqrt(np.mean((numpy(ms) - truth) ** 2)))
    return {"rmse": rmse, "ok": rmse < 0.2}


def lorenz_outcome(device, method="ekf", dtype=torch.float64):
    model, truth = recipe("lorenz", 2000, dtype, device, method=method)
    with torch.no_grad():
        ms = numpy(model.posterior_states()[0])
    cy, cz = _corr(ms[:, 1], truth[1]), _corr(ms[:, 2], truth[2])
    return {"corr_y": cy, "corr_z": cz, "ok": cy > 0.95 and cz > 0.95}


def lfm_outcome(device, dtype=torch.float64):
    model, u = recipe("lfm", 400, dtype, device)
    with torch.no_grad():
        ms = numpy(model.posterior_states()[0])
    c = _corr(ms[50:, 1], u[50:])
    return {"corr": c, "ok": c > 0.95}


def dc_outcome(device, dtype=torch.float64, steps=150):
    """150 Gauss-Newton CVI steps at lr 0.3 on the frozen draws, as the JAX
    test: the fitted correlation path against the truth. The surrogate
    runs the parallel scans: the JAX test's sequential ones give the same
    posterior through a host loop of T steps."""
    model, rho = dc_model(200, dtype, device, parallel=True)
    elbos = []
    with torch.no_grad():
        for _ in range(steps):
            model, e = model.step_with_elbo(0.3, hessian="gauss_newton")
            elbos.append(e)
        rho_hat = numpy(model.likelihood.correlation_path(model.posterior().mean))[:, 1, 0]
    elbos = numpy(torch.stack(elbos))
    corr = _corr(rho_hat, rho)
    rmse = float(np.sqrt(np.mean((rho_hat - rho) ** 2)))
    ok = bool(np.isfinite(elbos[-1]) and elbos[-1] > elbos[0] and corr > 0.9 and rmse < 0.25)
    return {"corr": corr, "rmse": rmse, "elbo_first": float(elbos[0]),
            "elbo_last": float(elbos[-1]), "ok": ok}


OUTCOMES = {
    "lv": lv_outcome,
    "lorenz_ekf": lambda device: lorenz_outcome(device, "ekf"),
    "lorenz_ieks": lambda device: lorenz_outcome(device, "iterated_parallel"),
    "lfm": lfm_outcome,
    "dc": dc_outcome,
}


def outcome(device, names=tuple(OUTCOMES)):
    """{gate: its figures, its wall time and ok}."""
    out = {}
    for name in names:
        t0 = time.perf_counter()
        res = OUTCOMES[name](device)
        _sync(device)
        res["seconds"] = time.perf_counter() - t0
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# at length
# ---------------------------------------------------------------------------


def _sync(device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _reset_peak(device):
    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(device):
    return torch.cuda.max_memory_allocated() / 2**30 if str(device).startswith("cuda") else None


def ieks_at_length(device, dtype, T=LORENZ_LONG["T"], dt=LORENZ_LONG["dt"],
                   chunk=LORENZ_LONG["chunk"], n_iters=LORENZ_LONG["n_iters"]):
    """`lorenz_gp` at T steps of dt by the iterated parallel EKS (chunked),
    with its first reference trajectory timed apart from the passes, and
    the largest change of the smoothed means between the last two
    passes."""
    from physs_gp_tpu_torch.ops.ekf import iterated_parallel_ekf_smoother, propagate_mean

    t, y, truth = lorenz_inputs(T, dt)
    model = lorenz_gp(t, y, q=0.5, noise=0.5, dtype=dtype, device=device)
    ssm = model._ssm()
    _reset_peak(device)
    with torch.no_grad():
        _sync(device)
        t0 = time.perf_counter()
        m_ref = propagate_mean(ssm, model.t, model.n_substeps)
        _sync(device)
        t1 = time.perf_counter()
        args = (ssm, model.t, model.R, model.Y)
        kw = dict(n_substeps=model.n_substeps, chunk_size=chunk)
        _, s_prev = iterated_parallel_ekf_smoother(*args, n_iters=n_iters - 1, m_ref=m_ref, **kw)
        f, s = iterated_parallel_ekf_smoother(*args, n_iters=1, m_ref=s_prev.ms, **kw)
        _sync(device)
        t2 = time.perf_counter()
    ms = numpy(s.ms)
    return {
        "T": T, "dt": dt, "chunk": chunk, "n_iters": n_iters, "dtype": str(dtype).split(".")[-1],
        "first_propagation_s": t1 - t0, "passes_s": t2 - t1, "wall_s": t2 - t0,
        "peak_gib": _peak_gib(device), "lml": float(f.lml),
        "last_change": float(torch.max(torch.abs(s.ms - s_prev.ms))),
        "corr_y": _corr(ms[:, 1], truth[1]), "corr_z": _corr(ms[:, 2], truth[2]),
        "finite": bool(torch.isfinite(f.lml)),
    }


def dynamic_covariance_wide(device, dtype=torch.float64, T=DC_WIDE["T"], P=DC_WIDE["P"],
                            steps=DC_WIDE["steps"]):
    """`dynamic_covariance_gp` at P outputs (Q = P(P-1)/2 Matérn-3/2 latents,
    d = 2Q) over T steps, parallel scans: `steps` Gauss-Newton CVI steps at
    lr 0.3 with fresh draws."""
    t, Y = dc_wide_inputs(T, P)
    model = dynamic_covariance_gp(t, Y, n_mc=32, parallel=True, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    _reset_peak(device)
    walls, elbos = [], []
    with torch.no_grad():
        for _ in range(steps):
            _sync(device)
            t0 = time.perf_counter()
            model, e = model.step_with_elbo(0.3, hessian="gauss_newton", generator=gen)
            _sync(device)
            walls.append(time.perf_counter() - t0)
            elbos.append(float(e))
    return {"T": T, "P": P, "d": P * (P - 1), "steps": steps, "step_s": walls,
            "step_median_s": float(np.median(walls)), "peak_gib": _peak_gib(device),
            "elbo_first": elbos[0], "elbo_last": elbos[-1],
            "finite": bool(np.all(np.isfinite(elbos)))}


def config5_vb_ng_lbfgs(device, dtype=torch.float32, T=C5_FULL["T"], chunk=C5_FULL["chunk"],
                        epochs=C5_FULL["epochs"]):
    """`VB_NG_LBFGS.train` on config-5 at full width, one epoch a call: per
    epoch its wall and the L-BFGS step's line-search trials."""
    model = build_config5(T, chunk, dtype=dtype, device=device)
    tr = VB_NG_LBFGS(model, ng_lr=C5_NG_LR)
    _reset_peak(device)
    rows, losses = [], []
    for _ in range(epochs):
        _sync(device)
        t0 = time.perf_counter()
        model, ls = tr.train(model, 1)
        _sync(device)
        losses.extend(ls)
        rows.append({"epoch_s": time.perf_counter() - t0,
                     "trials": tr.lbfgs.linesearch_steps[-1], "loss": ls[-1]})
    return {"T": T, "chunk": chunk, "dtype": str(dtype).split(".")[-1], "epochs": rows,
            "peak_gib": _peak_gib(device), "losses": losses,
            "ok": bool(np.all(np.isfinite(losses)) and losses[-1] <= losses[0])}


def jacobian_routines(device):
    """The sequential EKF loops' Jacobians by `ops/ekf._value_and_jac` (one
    batched reverse pass) against `torch.func.jacfwd` (`_value_and_jacfwd`,
    the iterated smoother's) in their place: the Lorenz EKS (filter and
    smoother) at T = 2000, float64, without grad mode (graphs on the card),
    and the pendulum EKF's lml and its gradient by the damping at T = 256
    (grad mode, eager). Runs in the order reverse, jacfwd, jacfwd, reverse;
    returns {routine: {run: [seconds, seconds]}}."""
    from physs_gp_tpu_torch.ops import ekf

    reverse = ekf._value_and_jac
    routines = {"reverse": reverse, "jacfwd": lambda fn, x, n_out: ekf._value_and_jacfwd(fn, x)}
    t, y, _ = pendulum_inputs(T_ANCHOR["pend"])
    out = {name: {"lorenz_eks_T2000_s": [], "pendulum_grad_T256_s": []} for name in routines}

    def lorenz():
        with torch.no_grad():
            recipe("lorenz", 2000, device=device)[0].filter_smooth()

    def pendulum():
        c = torch.tensor(PEND["c"], **_kw(torch.float64, device), requires_grad=True)
        model = pendulum_model(t, y, c, device=device)
        ekf.ekf_filter(model._ssm(), model.t, model.R, model.Y,
                       n_substeps=model.n_substeps).lml.backward()

    try:
        for name in ("reverse", "jacfwd", "jacfwd", "reverse"):
            ekf._value_and_jac = routines[name]
            for key, fn in (("lorenz_eks_T2000_s", lorenz), ("pendulum_grad_T256_s", pendulum)):
                _sync(device)
                t0 = time.perf_counter()
                fn()
                _sync(device)
                out[name][key].append(time.perf_counter() - t0)
    finally:
        ekf._value_and_jac = reverse
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jacobians", action="store_true",
                    help="time the sequential loops' two Jacobian routines instead")
    args = ap.parse_args()
    if args.jacobians:
        print(json.dumps(jacobian_routines(args.device)))
        return 0
    res = outcome(args.device)
    print(json.dumps(res))
    return 0 if all(r["ok"] for r in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

"""The batch (dense) GP family of the PyTorch port: its inputs, models,
float64 anchors against the golden file, the outcome gates of two
experiments, and the dense-scale runs.

- anchors (`anchors`): `curl_free_gp` and `helmholtz_gp` at N = 40,
  `deriv_gp` with NaN masking, `BatchGP(solver="cg")` fed the JAX probes,
  `SVGP` whitened and unwhitened (one natural-gradient step at lr 1), the
  monotonic experiment's batch-VI arm (`deriv_vgp`) at its quick size for
  5 steps, and a batch `LMC` with a constant mean;
- outcome gates (`outcome`): `experiments_torch/curl_free.py`'s run at full
  size (float32: RMSE below the independent-RBF baseline's) and the batch-VI arm
  of `experiments/monotonic.py` at full size (float64, Z = 50, 300 steps:
  no violation, the ELBO within `MV_ELBO_RTOL` and `rmse_gap_vgp` within
  10 % of every JAX float64 run that has locked into its limit cycle:
  `locked_runs`);
- dense scale (`dense_scale`, `curl_free_gram`): `BatchGP` with RBF
  (`scripts/profile/bench_cg.py`'s model) by Cholesky and by CG, and a
  curl-free Gram at N = 4096.

The numpy inputs here are shared by `make_batch_golden.py` (the JAX side),
`tests/test_torch_batch_golden.py` and `chip_smoke.py`.

    python3 scripts/port/batch_outcome.py [--device cuda]

runs both outcome gates, prints one JSON line and exits non-zero if a gate
fails.
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

from experiments_torch import curl_free as cf  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern72  # noqa: E402
from physs_gp_tpu_torch.kernels.multi_output import LMC  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.likelihoods.nongaussian import Probit  # noqa: E402
from physs_gp_tpu_torch.means.mean import ConstantMean  # noqa: E402
from physs_gp_tpu_torch.models.batch_gp import BatchGP  # noqa: E402
from physs_gp_tpu_torch.models.svgp import SVGP  # noqa: E402
from physs_gp_tpu_torch.ops import cg  # noqa: E402
from physs_gp_tpu_torch.utils.params import param, positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.diff import deriv_gp, deriv_vgp  # noqa: E402
from physs_gp_tpu_torch.zoo.phi_ml import curl_free_gp, helmholtz_gp  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "data", "batch_golden.npz")
CF_NOISE = cf.NOISE  # the curl-free experiment's; the batch Helmholtz anchor's too
MV_NOISE, MV_GAP, MV_DATA = 0.15, (1.2, 2.8), 30  # experiments/monotonic.py
CF_RESULTS = {"rmse": 0.04580618981095386, "rmse_independent_gp": 0.060002433828965064}  # results/curl_free.json (quick, JAX)
MV_RESULTS = {"rmse_gap_vgp": 0.0697563795690978, "deriv_violation_rate_vgp": 0.0}  # results/monotonic.json
MV_STEPS_ANCHOR = 5
# The arm's natural-gradient steps at lr 0.5 against a Probit of nu = 0.01
# do not converge: they amplify rounding, and a run either wanders or locks
# into a cycle of four ELBOs (-14.3963, -14.3759, -14.3546, -14.3074). The
# golden file (`mvf::`) holds the JAX package's float64 run as
# results/monotonic.json made it (no move, still wandering at step 300) and
# three with q_mu's start moved by these amounts (locked), with every
# step's ELBO. A run is locked when each of its last MV_TAIL ELBOs is
# within MV_LOCK (relative) of the one four steps before.
MV_STEPS, MV_PERTURB = 300, (0.0, 1e-15, 1e-13, -1e-13)
MV_TAIL, MV_LOCK = 20, 1e-4
MV_ELBO_RTOL, MV_RMSE_RTOL = 1e-4, 0.1  # the port's end against each locked run's
# CG's iterates amplify the summation-order differences between two
# libraries once they near convergence on a clustered spectrum (an RBF Gram
# of cond 48: 1e-14 apart after 10 steps, 6e-8 after 20, 8e-6 after 25),
# and a column frozen at tol 1e-6 keeps what it had: at noise 0.1 the JAX
# package and the port end 1.5e-8 apart in the lml's gradient. At noise 0.5
# (cond ~10) CG meets tol within 20 steps and they agree to 3e-11.
CG_N, CG_LS, CG_NOISE, CG_PROBES = 40, 0.5, 0.5, 32
# The SVGP anchors' inducing Gram (10 points on [-1, 1], lengthscale 0.3)
# has cond 1e3; at 12 points and lengthscale 0.5 (cond 7e8) the KL of an
# unwhitened q differs by 4e-8 between a LAPACK and the port's Cholesky.
SVGP_Z, SVGP_LS = 10, 0.3
TOL = {"value": 1e-9, "cg": 1e-8}
DENSE_SIZES = (2048, 4096, 8192)
DENSE_GAP = 3e-3  # CG's lml against Cholesky's, relative
CF_GRAM_N = 4096
TIMED_CALLS = 5  # the dense-scale walls: the median of these after one warm-up call


def _kw(dtype, device):
    return dict(dtype=dtype, device=device)


def numpy(x):
    return x.detach().double().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rmse(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _rbf(ls, var, kw):
    return RBF(lengthscales=positive_param(ls, **kw), variance=positive_param(var, **kw))


# ---------------------------------------------------------------------------
# inputs (numpy), made as the experiments make them
# ---------------------------------------------------------------------------


def helmholtz_inputs(n=40, seed=1):
    """A 2-D field ∇φ + rot ψ (φ = sin x cos y, ψ = cos(0.8 x) sin(0.6 y))
    at n points with noise 0.05, one component missing at 4 points; 10 new
    points."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 2))
    x, y = X[:, 0], X[:, 1]
    rot = np.stack([0.6 * np.cos(0.8 * x) * np.cos(0.6 * y), 0.8 * np.sin(0.8 * x) * np.sin(0.6 * y)], 1)
    Y = cf.field(X) + rot + 0.05 * rng.normal(size=(n, 2))
    Y[:4, 1] = np.nan
    return X, Y, rng.uniform(-1.8, 1.8, (10, 2))


def deriv_inputs(n=20, seed=2):
    """(X [n, 2] = (t, s), Y [n, 3] = [f, ∂t f, ∂s f] of f = sin(t) cos(s)
    with noise 0.05 and about 20 % of the entries NaN, Xs [8, 2])."""
    rng = np.random.default_rng(seed)
    X = np.column_stack([rng.uniform(0, 3, n), rng.uniform(-1, 1, n)])
    t, s = X[:, 0], X[:, 1]
    Y = np.stack([np.sin(t) * np.cos(s), np.cos(t) * np.cos(s), -np.sin(t) * np.sin(s)], 1)
    Y = Y + 0.05 * rng.normal(size=Y.shape)
    Y[rng.uniform(size=Y.shape) < 0.2] = np.nan
    return X, Y, np.column_stack([rng.uniform(0, 3, 8), rng.uniform(-1, 1, 8)])


def bench_inputs(n, seed=0):
    """`scripts/profile/bench_cg.py`'s data: X [n, 2] on [-2, 2]², y =
    sin(x0) cos(1.3 x1) + 0.1 noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 2))
    f = np.sin(X[:, 0]) * np.cos(1.3 * X[:, 1])
    return X, (f + 0.1 * rng.normal(size=n))[:, None]


def svgp_inputs(seed=3):
    """(X [30, 1], Y [30, 1] of sin(3x) with noise 0.1 and one NaN, Z
    [SVGP_Z, 1], Xs [9, 1])."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-1, 1, 30))[:, None]
    Y = np.sin(3 * X) + 0.1 * rng.normal(size=X.shape)
    Y[7] = np.nan
    return X, Y, np.linspace(-1, 1, SVGP_Z)[:, None], np.linspace(-0.9, 0.9, 9)[:, None]


def monotonic_truth(t):
    return 2.0 / (1.0 + np.exp(-3.0 * (t - 2.0))) + 0.1 * t


def monotonic_inputs(quick: bool, seed=0):
    """The batch-VI arm's (X [N, 1], Y [N, 2] = [y, probit 1 on f'], Z,
    t_test, in_gap, truth), made as `experiments/monotonic.py` makes them."""
    rng = np.random.default_rng(seed)
    n_coll = 40 if quick else 100
    t_pool = rng.uniform(0, 4, 4 * MV_DATA)
    t_data = np.sort(t_pool[(t_pool < MV_GAP[0]) | (t_pool > MV_GAP[1])][:MV_DATA])
    y_data = monotonic_truth(t_data) + MV_NOISE * rng.normal(size=t_data.size)
    t_coll = np.linspace(0, 4, n_coll)
    t_test = np.linspace(0.05, 3.95, 120)
    t_all = np.concatenate([t_data, t_coll])
    Y = np.full((t_all.shape[0], 2), np.nan)
    Y[:MV_DATA, 0] = y_data
    Y[MV_DATA:, 1] = 1.0  # f' >= 0 pseudo-observations
    in_gap = (t_test > MV_GAP[0]) & (t_test < MV_GAP[1])
    Z = np.linspace(0, 4, 30 if quick else 50)[:, None]
    return t_all[:, None], Y, Z, t_test, in_gap, monotonic_truth(t_test)


def lmc_inputs(seed=4):
    """(X [20, 1], Y [20, 3] of three mixed sinusoids with noise 0.05 and
    NaNs, Xs [6, 1])."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0, 4, 20))[:, None]
    g = np.column_stack([np.sin(2 * X[:, 0]), np.cos(0.7 * X[:, 0])])
    Y = g @ np.array([[1.0, 0.3, -0.5], [0.2, 1.0, 0.8]]) + 0.3 + 0.05 * rng.normal(size=(20, 3))
    Y[rng.uniform(size=Y.shape) < 0.15] = np.nan
    return X, Y, np.linspace(0.2, 3.8, 6)[:, None]


# ---------------------------------------------------------------------------
# port models
# ---------------------------------------------------------------------------


def cg_model(X, Y, dtype, device, ls=CG_LS, noise=CG_NOISE, solver="cg"):
    kw = _kw(dtype, device)
    return BatchGP(X, Y, _rbf([ls, ls], 1.0, kw), Gaussian(positive_param(noise, **kw)),
                   solver=solver, **kw)


def svgp_model(X, Y, Z, whiten, dtype, device):
    kw = _kw(dtype, device)
    return SVGP.init(X, Y, Z, _rbf(SVGP_LS, 1.0, kw), Gaussian(positive_param(0.01, **kw)),
                     whiten=whiten, **kw)


def monotonic_model(X, Y, Z, dtype, device):
    kw = _kw(dtype, device)
    return deriv_vgp(X, Y, time_diff=1, space_diff=None, kernel=Matern72(1.0, 1.0, **kw),
                     liks=[Gaussian(variance=positive_param(MV_NOISE**2, **kw)), Probit(nu=1e-2)],
                     Z=Z, whiten=False, **kw)


def lmc_model(X, Y, dtype, device):
    kw = _kw(dtype, device)
    kern = LMC.init([_rbf(0.8, 1.0, kw), _rbf(2.0, 1.0, kw)], P=3, **kw)
    return BatchGP(X, Y, kern, Gaussian(positive_param(0.01, **kw)),
                   mean=ConstantMean(param(0.0, **kw)), **kw)


def inputs(gold, cfg):
    return {k.split("::")[2]: gold[k] for k in gold.files if k.startswith(f"{cfg}::in::")}


def flat(gold, cfg):
    return {k.split("::", 2)[2]: gold[k] for k in gold.files if k.startswith(f"{cfg}::flat::")}


def _jax_name(key):
    """`.kernel.parts[0].base.variance.raw` -> `kernel.parts.0.base.variance.raw`."""
    return key[1:].replace("[", ".").replace("]", "")


CONFIGS = ("cf", "hz", "dg", "cg", "sw", "su", "mv", "lmc")
# the Cholesky kernel's routes each anchor must take: its factors of n <= 80
# (the Grams of 60-80, M·P = 60 and the joint covariance of 24 on the block
# and warp kernels, M = 10 on the warp kernel); CG factors nothing
CHOL_ROUTES = {"cf": ("block",), "hz": ("block",), "dg": ("block", "warp"), "cg": (),
               "sw": ("warp",), "su": ("warp",), "mv": ("block",), "lmc": ("block",)}


def anchor_model(gold, cfg, device):
    """The port model of one configuration in float64 on `device`, built
    from the golden inputs and loaded with the JAX leaves; and its inputs."""
    f64 = torch.float64
    kw = _kw(f64, device)
    x = inputs(gold, cfg)
    if cfg == "cf":
        model = curl_free_gp(x["X"], x["Y"], noise=CF_NOISE**2, **kw)
    elif cfg == "hz":
        model = helmholtz_gp(x["X"], x["Y"], noise=CF_NOISE**2, **kw)
    elif cfg == "dg":
        model = deriv_gp(x["X"], x["Y"], time_diff=1, space_diff=1, noise=0.05**2, **kw)
    elif cfg == "cg":
        model = cg_model(x["X"], x["Y"], f64, device)
    elif cfg in ("sw", "su"):
        model = svgp_model(x["X"], x["Y"], x["Z"], cfg == "sw", f64, device)
    elif cfg == "mv":
        model = monotonic_model(x["X"], x["Y"], x["Z"], f64, device)
    else:
        model = lmc_model(x["X"], x["Y"], f64, device)
    load_numpy_params(model, flat(gold, cfg))
    return model, x


def anchor(gold, cfg, device):
    """{output: (port value, golden value, tolerance)} of one configuration:
    an exact GP's lml, its gradient by raw, predict_f and predict_y (and
    `deriv_gp`'s joint samples); CG's lml, gradient and predict_f on the JAX
    probes; an SVGP's ELBO, one natural-gradient step at lr 1, q and
    predict_f after it; the monotonic arm's ELBOs over MV_STEPS_ANCHOR steps
    at lr 0.5 and predict_f."""
    out = {}
    model, x = anchor_model(gold, cfg, device)
    kind = "cg" if cfg == "cg" else "value"

    def hold(key, got):
        out[key] = (numpy(got), gold[f"{cfg}::{key}"], TOL[kind])

    def lml_and_grads(**kw):
        lml = model.log_marginal_likelihood(**kw)
        lml.backward()
        hold("lml", lml)
        grads = {name: p.grad for name, p in model.named_parameters() if p.grad is not None}
        for key in gold.files:
            if key.startswith(f"{cfg}::grad::"):
                hold(key.split("::", 1)[1], grads[_jax_name(key.split("::")[2])])

    if cfg == "cg":
        lml_and_grads(probes=torch.as_tensor(x["probes"], device=device))
    elif cfg in ("cf", "hz", "dg", "lmc"):
        lml_and_grads()
    with torch.no_grad():
        if cfg in ("sw", "su"):
            hold("elbo0", model.elbo())
            hold("elbo1", model.natural_gradient_update(1.0).elbo())
            hold("q_mu", model.q_mu.raw)
            hold("q_sqrt", model.q_sqrt.raw)
        if cfg == "mv":
            hold("elbos", torch.stack([model.natural_gradient_update(0.5).elbo()
                                       for _ in range(MV_STEPS_ANCHOR)]))
        f = model.predict_f(x["t_test"] if cfg == "mv" else x["Xs"])
        hold("f_mean", f.mean)
        hold("f_var", f.var)
        if cfg in ("cf", "hz", "dg", "lmc"):
            y = model.predict_y(x["Xs"])
            hold("y_mean", y.mean)
            hold("y_var", y.var)
        if cfg == "dg":
            hold("samples", model.sample_f_given(x["Xs"], torch.as_tensor(x["eps"], device=device)))
    return out


def anchors(gold, device, configs=CONFIGS):
    """{config: anchor(gold, config, device)}."""
    return {cfg: anchor(gold, cfg, device) for cfg in configs}


def relerr(got, want):
    """max |got - want| / max |want| (NaNs in the same places)."""
    if got.shape != want.shape or not np.array_equal(np.isnan(got), np.isnan(want)):
        return float("inf")
    return float(np.nanmax(np.abs(got - want)) / (np.nanmax(np.abs(want)) or 1.0))


# ---------------------------------------------------------------------------
# outcome gates
# ---------------------------------------------------------------------------


def monotonic_run(model, steps, t_test, in_gap, truth):
    """`steps` natural-gradient steps at lr 0.5, then the gap RMSE of f,
    the violation rate of f' on the test grid and the ELBO."""
    for _ in range(steps):
        model.natural_gradient_update(0.5)
    mean = numpy(model.predict_f(t_test).mean)
    return {"rmse_gap_vgp": rmse(mean[in_gap, 0], truth[in_gap]),
            "deriv_violation_rate_vgp": float(np.mean(mean[:, 1] < -1e-3)),
            "elbo": float(numpy(model.elbo()))}


def locked_runs(gold):
    """[runs] bool: the JAX runs of `mvf::` whose ELBO has locked into a
    cycle of period 4 over the last MV_TAIL steps."""
    tr = gold["mvf::elbo_trace"]
    drift = np.abs(tr[:, 4:] - tr[:, :-4]) / np.abs(tr[:, 4:])
    return np.max(drift[:, -MV_TAIL:], 1) <= MV_LOCK


def monotonic_outcome(device, gold=None):
    """The batch-VI arm of `experiments/monotonic.py` at full size, float64,
    against the JAX package's locked runs in the golden file (`mvf::`): no
    violation, and the ELBO and `rmse_gap_vgp` at step MV_STEPS within
    MV_ELBO_RTOL and MV_RMSE_RTOL of each."""
    gold = np.load(GOLDEN) if gold is None else gold
    locked = locked_runs(gold)
    X, Y, Z, t_test, in_gap, truth = monotonic_inputs(quick=False)
    t0 = time.perf_counter()
    with torch.no_grad():
        m = monotonic_model(X, Y, Z, torch.float64, device)
        res = monotonic_run(m, MV_STEPS, t_test, in_gap, truth)
    refs = {k: gold[f"mvf::{k}"][locked] for k in ("rmse_gap_vgp", "elbo")}
    res.update(steps=MV_STEPS, M=int(m._M), seconds=time.perf_counter() - t0,
               jax_locked=locked.tolist(), jax_rmse_gap_vgp=gold["mvf::rmse_gap_vgp"].tolist(),
               jax_elbo=gold["mvf::elbo"].tolist())
    res["ok"] = bool(locked.any() and res["deriv_violation_rate_vgp"] == 0.0
                     and np.all(np.abs(res["elbo"] - refs["elbo"]) <= MV_ELBO_RTOL * np.abs(refs["elbo"]))
                     and np.all(np.abs(res["rmse_gap_vgp"] - refs["rmse_gap_vgp"])
                                <= MV_RMSE_RTOL * refs["rmse_gap_vgp"]))
    return res


def outcome(device):
    metrics, seconds = cf.run(device, torch.float32)
    curl_free = {**metrics, "seconds": seconds, "ok": all(cf.gates(metrics).values())}
    res = {"curl_free": curl_free, "monotonic_vgp": monotonic_outcome(device),
           "reference": {"curl_free_quick_jax": CF_RESULTS, "monotonic": MV_RESULTS}}
    res["ok"] = res["curl_free"]["ok"] and res["monotonic_vgp"]["ok"]
    return res


# ---------------------------------------------------------------------------
# dense scale
# ---------------------------------------------------------------------------


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak_gib(device):
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated() / 2**30


def _reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _timed(fn, device, calls=TIMED_CALLS):
    """fn's last result, the median wall of `calls` calls after one warm-up
    call, the walls, and the peak GiB over the timed calls. The callers'
    `fn` clears the CG step record first (`_lml`), so that `cg.steps_run()`
    reads the last call."""
    fn()
    _reset_peak(device)
    walls = []
    for _ in range(calls):
        out = None  # the peak holds one call's result, not two
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        walls.append(time.perf_counter() - t0)
    return out, float(np.median(walls)), walls, _peak_gib(device)


def dense_scale(device, sizes=DENSE_SIZES, dtype=torch.float32):
    """Per n: the lml alone and the lml with its gradient by every
    hyperparameter, by Cholesky and by CG (median wall of TIMED_CALLS calls
    after a warm-up and every wall, peak GiB, the CG solves' steps), and
    CG's relative lml gap to Cholesky's."""
    rows = []
    for n in sizes:
        X, Y = bench_inputs(n)
        row, lml = {"n": n}, {}
        for solver in ("cholesky", "cg"):
            m = cg_model(X, Y, dtype, device, ls=0.7, noise=0.01, solver=solver)
            with torch.no_grad():
                val, wall, walls, peak = _timed(lambda: _lml(m), device)
            row[f"{solver}_lml_s"], row[f"{solver}_lml_walls_s"] = wall, walls
            row[f"{solver}_lml_peak_gib"] = peak
            if solver == "cg":
                row["cg_lml_steps"] = [s[-1] for s in cg.steps_run()]
            lml[solver] = float(val)
            _, wall, walls, peak = _timed(lambda: _lml_backward(m), device)
            row[f"{solver}_lml_grad_s"], row[f"{solver}_lml_grad_walls_s"] = wall, walls
            row[f"{solver}_lml_grad_peak_gib"] = peak
            if solver == "cg":
                row["cg_lml_grad_steps"] = [s[-1] for s in cg.steps_run()]
            row[f"lml_{solver}"] = lml[solver]
            row[f"{solver}_finite"] = bool(np.isfinite(lml[solver]) and all(
                torch.isfinite(p.grad).all() for p in m.parameters()))
            del m
        row["lml_rel_gap"] = abs(lml["cg"] - lml["cholesky"]) / abs(lml["cholesky"])
        rows.append(row)
    return rows


def curl_free_gram(device, n=CF_GRAM_N, dtype=torch.float32):
    """The curl-free Gram [2n, 2n] (nested autodiff over all n² pairs): its
    build's wall and peak, then the lml with its gradient by Cholesky
    (median walls of TIMED_CALLS calls after a warm-up, and every wall)."""
    rng = np.random.default_rng(5)
    X = rng.uniform(-2, 2, (n, 2))
    Y = cf.field(X) + CF_NOISE * rng.normal(size=X.shape)
    m = curl_free_gp(X, Y, noise=CF_NOISE**2, dtype=dtype, device=device)
    with torch.no_grad():
        K, build_s, build_walls, build_peak = _timed(lambda: m.kernel.K(m.X, m.X), device)
    shape = tuple(K.shape)
    del K
    lml, wall, walls, peak = _timed(lambda: _lml_backward(m), device)
    return {"n": n, "gram": shape, "build_s": build_s, "build_walls_s": build_walls,
            "build_peak_gib": build_peak, "lml": lml, "lml_grad_s": wall, "lml_grad_walls_s": walls,
            "lml_grad_peak_gib": peak,
            "finite": bool(np.isfinite(lml) and all(torch.isfinite(p.grad).all()
                                                    for p in m.parameters()))}


def _lml(m):
    cg.reset_steps()
    return m.log_marginal_likelihood()


def _lml_backward(m):
    """The lml with a fresh gradient in every parameter's `.grad`."""
    m.zero_grad(set_to_none=True)
    lml = _lml(m)
    lml.backward()
    return float(lml.detach())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("batch_outcome: no CUDA device", file=sys.stderr)
        return 1
    res = outcome(args.device)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

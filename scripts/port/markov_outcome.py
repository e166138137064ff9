"""The Markov-kernel zoo and the prior mean in the PyTorch port: shared
numpy inputs, port models, float64 anchors against the golden file, and the
trend + quasi-periodic model at full length.

- anchors (`anchor`), against `tests/data/markov_golden.npz` (made by
  `make_markov_golden.py` from the JAX package on the CPU), at T = 256
  irregular hours on the blocked scan schedule (8 blocks), both forms
  (`cov`, `sqrt`) where a state-space model runs:
  `per` (a bare `Periodic`, d = 14, Q = 0), `per_sum` (`Matern32 +
  Periodic`: the Periodic block of Q is exactly zero), `qp` (`Matern32 +
  Periodic * Matern32`, d = 30, with a `LinearMean`; the port model starts
  from other values and loads the JAX leaves): lml, smoothed means and
  variances, `predict_f` at 40 new times (before, inside and after the
  data); `wiener` (the four Wiener kinds' lml, loaded leaves, and
  `predict_f` of `WienerVelocity` before t[0]); `stream` (`StreamingGP` on
  `WienerVelocity` with a `LinearMean`, anchored at t[0], three segments
  and a forecast); `const` (`StateSpaceGP` with a `ConstantMean`); `cvi`
  (3 Poisson `CVIGP` steps on the d = 30 kernel with a `ConstantMean`:
  ELBOs, posterior, `predict_f`); `flows` (`TransformedData` for each
  flow: Z, the lml correction, `to_data_space`); `uin` (3
  `UncertainInputLikelihood` CVI steps); `batch` (`BatchGP` lml on
  `AggregatedKernel` and on each misc kernel, the random ones loaded from
  the JAX leaves). Tolerances: lml, ELBO and means rtol 1e-9, variances
  1e-7.
- at length (`full_run`, `cvi_full`): hourly data over T = 100 000 hours
  (2 % missing), y = exp(trend + a daily cycle whose amplitude drifts over
  weeks + noise), `Matern32(720, 0.5) + Periodic(24, 1.0, 1.0, J = 6) *
  Matern32(336, 1.0)` (d = 30), `Gaussian(0.05)`, a `LinearMean`, fitted on
  `TransformedData(Y, LogTransform()).Z`, parallel at chunk 25 000: lml +
  the log-Jacobian correction, `predict_f` at 1000 new times (the last 200
  past the data) and `to_data_space`; and a Poisson `CVIGP` with a
  `ConstantMean` on counts of the same structure, 3 `natgrad_scan` steps.

The numpy inputs here are shared by `make_markov_golden.py` (the JAX side),
`tests/test_torch_markov_kernels.py`, `tests/test_torch_means_flows.py`,
`tests/test_torch_markov_golden.py` and `chip_smoke.py`.

    python3 scripts/port/markov_outcome.py [--device cuda]

runs the full-length model in both forms and types and prints one JSON line.
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

from physs_gp_tpu_torch.data.transformed import (  # noqa: E402
    AffineTransform, BoxCoxTransform, CompositeFlow, ExpTransform, LogTransform, ReverseFlow,
    SoftplusTransform, SquareTransform, TransformedData,
)
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels import (  # noqa: E402
    RQ, AggregatedKernel, ArcCosine, DeepKernel, Gibbs, IntegratedWiener, Matern32, Matern52,
    Periodic, SpectralMixture, Wiener, WienerVelocity, uniform_box_nodes,
)
from physs_gp_tpu_torch.kernels.markov import to_ss  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson  # noqa: E402
from physs_gp_tpu_torch.means.mean import ConstantMean, LinearMean  # noqa: E402
from physs_gp_tpu_torch.models import CVIGP, BatchGP, StateSpaceGP, StreamingGP  # noqa: E402
from physs_gp_tpu_torch.trainers.scan import natgrad_scan  # noqa: E402
from physs_gp_tpu_torch.transforms import DerivativeHead, StateObservation, ValueHead  # noqa: E402
from physs_gp_tpu_torch.transforms.inputs import UncertainInputLikelihood  # noqa: E402
from physs_gp_tpu_torch.utils.params import param, positive_param  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "data", "markov_golden.npz")
TOL = {"value": 1e-9, "var": 1e-7}
SCAN_BLOCKS = "8"  # the blocked scan schedule of the anchors, both packages
T_ANCHOR, N_NEW = 256, 40
# the model: Matern32(ls, var) trend + Periodic(period, ls, var, J) x Matern32(ls, var)
PER = dict(period=24.0, ls=1.0, var=1.0, J=6)
TREND_ANCHOR, ENV_ANCHOR = (48.0, 0.5), (96.0, 1.0)  # the anchors' Matérn (ls, var)
TREND_FULL, ENV_FULL = (720.0, 0.5), (336.0, 1.0)
NOISE = 0.05
MEAN_W, MEAN_B = 2e-6, 2.0  # the LinearMean: the data's trend slope and level
CONST_C = 1.0  # the Poisson model's ConstantMean (log-rate)
FULL = dict(T=100_000, chunk=25_000, n_new=1000, n_forecast=200, cvi_steps=3, cvi_lr=0.5)
WIENER = dict(T=128, variance=0.7, P0=1e-2, noise=0.04)
WIENER_KINDS = (("w", Wiener, {}), ("wv", WienerVelocity, {}), ("iw2", IntegratedWiener, {"q": 2}),
                ("iw3", IntegratedWiener, {"q": 3}))
STREAM_SEGMENTS = ((0, 50), (50, 100), (100, 128))
CVI = dict(steps=3, lr=0.5)
UIN = dict(T=60, sx=0.15, noise=0.05, steps=3, lr=0.5)
FLOWS = ("log", "affine", "boxcox", "exp", "softplus", "square", "reverse_softplus", "composite")
MISC = ("rq", "sm", "arccos", "gibbs", "deep")
CONFIGS = ("per", "per_sum", "qp", "wiener", "stream", "const", "cvi", "flows", "uin", "batch")
FORMS = ("cov", "sqrt")


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


# ---------------------------------------------------------------------------
# inputs (numpy)
# ---------------------------------------------------------------------------


def hourly_series(t, seed=0, nan_frac=0.02):
    """(y > 0, counts) at the hours t: log y = level + trend + a daily cycle
    whose amplitude drifts over weeks + noise; counts ~ Poisson(exp(the same
    latent without the level's offset)); a fraction `nan_frac` of y missing."""
    rng = np.random.default_rng(seed)
    t = np.asarray(t, float)
    trend = MEAN_B + MEAN_W * t + 0.4 * np.sin(2 * np.pi * t / (24 * 365)) + 0.2 * np.sin(2 * np.pi * t / 2000)
    amp = 0.6 + 0.25 * np.sin(2 * np.pi * t / (24 * 7 * 3))
    cycle = amp * (np.sin(2 * np.pi * t / 24) + 0.3 * np.cos(4 * np.pi * t / 24))
    logy = trend + cycle + 0.1 * rng.normal(size=t.shape)
    y = np.exp(logy)
    y[rng.uniform(size=t.shape) < nan_frac] = np.nan
    counts = rng.poisson(np.exp(CONST_C + (trend - MEAN_B) + cycle)).astype(float)
    return y[:, None], counts[:, None]


def anchor_inputs(T=T_ANCHOR, seed=0):
    """(t [T] irregular sorted hours, Z = log y [T, 1] with NaN, counts [T, 1],
    t_new [N_NEW]: 8 before t[0], 24 inside, 8 after t[-1])."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, float(T), T))
    y, counts = hourly_series(t, seed + 1)
    t_new = np.sort(np.concatenate([rng.uniform(-6.0, t[0], 8), rng.uniform(t[0], t[-1], N_NEW - 16),
                                    t[-1] + rng.uniform(0.0, 30.0, 8)]))
    return t, np.log(y), counts, t_new


def full_inputs(T=FULL["T"], seed=0):
    """(t = arange(T) hours, y [T, 1] positive with 2 % NaN, counts [T, 1])."""
    t = np.arange(T, dtype=float)
    y, counts = hourly_series(t, seed)
    return t, y, counts


def new_times(T, n=FULL["n_new"], seed=3):
    """n new times: four fifths inside [0, T - 1], the last fifth
    (FULL["n_forecast"] of FULL["n_new"]) past T - 1."""
    n_forecast = n * FULL["n_forecast"] // FULL["n_new"]
    rng = np.random.default_rng(seed)
    inside = np.sort(rng.uniform(0.0, T - 1.0, n - n_forecast))
    return np.concatenate([inside, (T - 1.0) + np.arange(1, n_forecast + 1) * 1.5])


def wiener_inputs(T=WIENER["T"], seed=1):
    """(t [T] in [0.1, 4], y [T, 1] a random walk, t_new [10], 3 before t[0])."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.1, 4.0, T))
    y = np.cumsum(rng.normal(size=T) * 0.3)[:, None]
    t_new = np.sort(np.concatenate([[0.0, 0.05, t[0] - 0.01], rng.uniform(t[0], 4.5, 7)]))
    return t, y, t_new


def flow_inputs(seed=0):
    """(Y [64, 1] positive with one NaN, z_mean [16], z_var [16])."""
    rng = np.random.default_rng(seed)
    Y = rng.uniform(0.4, 3.0, (64, 1))
    Y[7, 0] = np.nan
    return Y, rng.uniform(0.3, 1.5, 16), rng.uniform(0.01, 0.2, 16)


def uin_inputs(T=UIN["T"], seed=0):
    """`tests/test_input_transforms.py`'s data: (t [T], Y [T, 2]: y at
    jittered inputs and a NaN derivative column)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 6, T))
    t_noisy = t + UIN["sx"] * rng.normal(size=T)
    y = np.sin(1.5 * t_noisy) + 0.05 * rng.normal(size=T)
    return t, np.stack([y, np.full(T, np.nan)], axis=1)


def batch_inputs(seed=2):
    """(X [15, 2], Y [15, 1]) for the misc kernels and the aggregated
    model's (lows, highs [16, 1], Y [16, 1])."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (15, 2))
    Y = (np.sin(2 * X[:, 0]) * np.cos(X[:, 1]) + 0.1 * rng.normal(size=15))[:, None]
    R = 16
    lows = np.linspace(0, 4, R + 1)[:-1][:, None]
    highs = lows + 4.0 / R
    ya = np.array([np.mean(np.sin(2 * np.linspace(lo[0], hi[0], 200))) for lo, hi in zip(lows, highs)])
    return X, Y, lows, highs, (ya + 0.01 * rng.normal(size=R))[:, None]


def gibbs_lengthscale(x):
    return 0.5 + 0.3 * torch.sum(x**2)


# ---------------------------------------------------------------------------
# port models
# ---------------------------------------------------------------------------


def _pp(v, dtype, device):
    return positive_param(v, dtype=dtype, device=device)


def periodic(dtype, device, J=PER["J"], period=PER["period"], ls=PER["ls"], var=PER["var"]):
    return Periodic(_pp(ls, dtype, device), _pp(var, dtype, device), _pp(period, dtype, device),
                    n_harmonics=J)


def kernel(name, dtype, device, trend=TREND_ANCHOR, env=ENV_ANCHOR, J=PER["J"]):
    """`per`, `per_sum` or `qp` (the full model's structure)."""
    kw = _kw(dtype, device)
    if name == "per":
        return periodic(dtype, device, J)
    if name == "per_sum":
        return Matern32(*trend, **kw) + periodic(dtype, device, J)
    return Matern32(*trend, **kw) + periodic(dtype, device, J) * Matern32(*env, **kw)


def linear_mean(dtype, device, w=MEAN_W, b=MEAN_B):
    return LinearMean(param(torch.tensor([w], **_kw(dtype, device))),
                      param(torch.tensor(b, **_kw(dtype, device))))


def constant_mean(dtype, device, c=CONST_C):
    return ConstantMean(param(torch.tensor(c, **_kw(dtype, device))))


def _tensors(dtype, device, *arrays):
    return [torch.as_tensor(np.asarray(a), **_kw(dtype, device)) for a in arrays]


def ss_model(t, Y, kern, dtype, device, sqrt=False, mean=None, parallel=True, chunk_size=None,
             noise=NOISE):
    t, Y = _tensors(dtype, device, t, Y)
    return StateSpaceGP(t, Y, kern, Gaussian(_pp(noise, dtype, device)), mean=mean,
                        parallel=parallel, sqrt=sqrt, chunk_size=chunk_size)


def flow(name):
    return {
        "log": lambda: LogTransform(shift=0.3), "affine": lambda: AffineTransform(scale=2.5, loc=-1.0),
        "boxcox": lambda: BoxCoxTransform(lam=0.4), "exp": ExpTransform, "softplus": SoftplusTransform,
        "square": SquareTransform, "reverse_softplus": lambda: ReverseFlow(SoftplusTransform()),
        "composite": lambda: CompositeFlow((LogTransform(shift=0.1), AffineTransform(scale=0.7))),
    }[name]()


def uin_model(dtype, device, input_var=UIN["sx"] ** 2):
    t, Y = uin_inputs()
    lik = UncertainInputLikelihood(Gaussian(_pp(UIN["noise"] ** 2, dtype, device).fix()),
                                   input_var=_pp(input_var, dtype, device).fix())
    obs = StateObservation(heads=[ValueHead(), DerivativeHead(order=1)])
    t, Y = _tensors(dtype, device, t, Y)
    return CVIGP.init(t, Y, Matern52(1.0, 1.0, **_kw(dtype, device)), lik, observation=obs)


def misc_kernel(name, dtype, device):
    """The misc kernels; `sm` and `deep` start from seeded draws, to be
    replaced by the JAX leaves."""
    kw = _kw(dtype, device)
    if name == "rq":
        return RQ(0.8, 1.0, 1.5, **kw)
    if name == "sm":
        return SpectralMixture.init(3, 2, dtype=dtype, device=device)
    if name == "arccos":
        return ArcCosine(**kw)
    if name == "gibbs":
        return Gibbs(1.0, gibbs_lengthscale, **kw)
    return DeepKernel.init(RBF(_pp(1.0, dtype, device), _pp(1.0, dtype, device)), [2, 8, 2],
                           dtype=dtype, device=device)


def aggregated_kernel(dtype, device):
    _, _, lows, highs, _ = batch_inputs()
    nodes, w = uniform_box_nodes(lows, highs, n_per_dim=8)
    base = RBF(_pp(0.7, dtype, device), _pp(1.0, dtype, device))
    nodes, w = _tensors(dtype, device, nodes, w)
    return AggregatedKernel(base, nodes, w)


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------


def flat(gold, cfg):
    """The JAX leaves `<cfg>::flat::<key path>` of the golden file."""
    pre = f"{cfg}::flat::"
    return {k[len(pre):]: gold[k] for k in gold.files if k.startswith(pre)}


def _moments(pre, model, t_new):
    post = model.posterior()
    f = model.predict_f(t_new)
    return {f"{pre}post_mean": post.mean, f"{pre}post_var": post.var,
            f"{pre}pred_mean": f.mean, f"{pre}pred_var": f.var}


def anchor(gold, cfg, device):
    """{output: (port value, golden value, tolerance)} of one configuration,
    float64 on `device`, on the blocked scan schedule."""
    f64 = torch.float64
    kw = _kw(f64, device)
    got = {}
    with torch.no_grad():
        if cfg in ("per", "per_sum", "qp"):
            t, Z, _, t_new = anchor_inputs()
            (tn,) = _tensors(f64, device, t_new)
            for form in FORMS:
                if cfg == "qp":
                    # other starting values; the JAX leaves carried across
                    kern = kernel(cfg, f64, device, trend=(10.0, 2.0), env=(5.0, 3.0))
                    kern.parts[1].parts[0].period.raw.fill_(3.0)
                    model = ss_model(t, Z, kern, f64, device, sqrt=form == "sqrt",
                                     mean=linear_mean(f64, device, 0.0, 0.0), noise=1.0)
                    load_numpy_params(model, flat(gold, cfg))
                else:
                    model = ss_model(t, Z, kernel(cfg, f64, device), f64, device, sqrt=form == "sqrt")
                got[f"{form}::lml"] = model.log_marginal_likelihood()
                got.update(_moments(f"{form}::", model, tn))
        elif cfg == "wiener":
            t, y, t_new = wiener_inputs()
            (tn,) = _tensors(f64, device, t_new)
            for name, cls, extra in WIENER_KINDS:
                model = ss_model(t, y, cls(**extra, **kw), f64, device, noise=1.0)
                load_numpy_params(model, flat(gold, f"wiener::{name}"))
                got[f"{name}::lml"] = model.log_marginal_likelihood()
                if name == "wv":
                    f = model.predict_f(tn)
                    got["wv::pred_mean"], got["wv::pred_var"] = f.mean, f.var
        elif cfg == "stream":
            t, y, t_new = wiener_inputs()
            s = StreamingGP(WienerVelocity(_pp(WIENER["variance"], f64, device), _pp(WIENER["P0"], f64, device)),
                            Gaussian(_pp(WIENER["noise"], f64, device)),
                            mean=linear_mean(f64, device, 0.3, -0.2), parallel=True)
            state = s.init_state(t0=float(t[0]))
            for i, (a, b) in enumerate(STREAM_SEGMENTS):
                state, seg = s.update(state, *_tensors(f64, device, t[a:b], y[a:b]))
                got[f"seg{i}::f_mean"], got[f"seg{i}::f_var"] = seg.f_mean, seg.f_var
            got["m"], got["P"], got["lml"] = state.m, state.P, state.lml
            fc = s.forecast(state, *_tensors(f64, device, t[-1] + np.linspace(0.1, 1.0, 10)))
            got["fc_mean"], got["fc_var"] = fc.mean, fc.var
        elif cfg == "const":
            t, Z, _, t_new = anchor_inputs()
            model = ss_model(t, Z, Matern52(24.0, 0.8, **kw), f64, device,
                             mean=constant_mean(f64, device, 2.5))
            got["lml"] = model.log_marginal_likelihood()
            got.update(_moments("", model, *_tensors(f64, device, t_new)))
        elif cfg == "cvi":
            t, _, counts, t_new = anchor_inputs()
            tt, yy, tn = _tensors(f64, device, t, counts, t_new)
            model = CVIGP.init(tt, yy, kernel("qp", f64, device), Poisson(),
                               mean=constant_mean(f64, device), parallel=True)
            model, elbos = natgrad_scan(model, CVI["lr"], CVI["steps"])
            got["elbos"] = elbos
            got.update(_moments("", model, tn))
        elif cfg == "flows":
            Y, zm, zv = flow_inputs()
            Yt, zmt, zvt = _tensors(f64, device, Y, zm, zv)
            for name in FLOWS:
                td = TransformedData(Yt, flow(name))
                got[f"{name}::Z"], got[f"{name}::corr"] = td.Z, td.lml_correction()
                got[f"{name}::mean"], got[f"{name}::var"] = td.to_data_space(zmt, zvt)
        elif cfg == "uin":
            model = uin_model(f64, device, input_var=1.0)
            load_numpy_params(model, flat(gold, "uin"))
            model, elbos = natgrad_scan(model, UIN["lr"], UIN["steps"])
            post = model.posterior()
            got["elbos"], got["post_mean"], got["post_var"] = elbos, post.mean, post.var
        elif cfg == "batch":
            X, Y, _, _, Ya = batch_inputs()
            for name in MISC:
                model = BatchGP(X, Y, misc_kernel(name, f64, device), Gaussian(_pp(0.1, f64, device)),
                                **kw)
                if name in ("sm", "deep"):
                    load_numpy_params(model, flat(gold, f"batch::{name}"))
                got[f"{name}::lml"] = model.log_marginal_likelihood()
            agg = aggregated_kernel(f64, device)
            Xa = torch.arange(Ya.shape[0], **kw)[:, None]
            model = BatchGP(Xa, Ya, agg, Gaussian(_pp(1e-4, f64, device)), **kw)
            got["agg::lml"] = model.log_marginal_likelihood()
            got["agg::cross_K"] = agg.cross_K(Xa, torch.linspace(0.2, 3.8, 30, **kw)[:, None])
    return {k: (numpy(v), gold[f"{cfg}::{k}"], TOL["var"] if k.endswith("var") else TOL["value"])
            for k, v in got.items()}


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
# the model at full length
# ---------------------------------------------------------------------------


def _sync(device):
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _reset_peak(device):
    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(device):
    return torch.cuda.max_memory_allocated() / 2**30 if str(device).startswith("cuda") else None


def _timed(device, fn):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def full_model(dtype, device, sqrt, T=FULL["T"], chunk=FULL["chunk"]):
    """(model, TransformedData) of the trend + quasi-periodic model."""
    t, y, _ = full_inputs(T)
    td = TransformedData(torch.as_tensor(y, **_kw(dtype, device)), LogTransform())
    kern = kernel("qp", dtype, device, trend=TREND_FULL, env=ENV_FULL)
    (tt,) = _tensors(dtype, device, t)
    model = StateSpaceGP(tt, td.Z, kern, Gaussian(_pp(NOISE, dtype, device)),
                         mean=linear_mean(dtype, device), parallel=True, sqrt=sqrt, chunk_size=chunk)
    return model, td


def full_run(device, dtype, sqrt, T=FULL["T"], chunk=FULL["chunk"], n_new=FULL["n_new"]):
    """lml + the log-Jacobian correction, `predict_f` at n_new times (the
    last FULL["n_forecast"] past the data) and `to_data_space`, each timed;
    the peak memory of the whole run."""
    with torch.no_grad():
        (model, td), t_build = _timed(device, lambda: full_model(dtype, device, sqrt, T, chunk))
        _reset_peak(device)
        lml, t_lml = _timed(device, lambda: model.log_marginal_likelihood() + td.lml_correction())
        (tn,) = _tensors(dtype, device, new_times(T, n_new))
        f, t_pred = _timed(device, lambda: model.predict_f(tn))
        (mean, var), t_back = _timed(device, lambda: td.to_data_space(f.mean, f.var))
    finite = bool(torch.isfinite(lml) and torch.isfinite(f.mean).all() and torch.isfinite(f.var).all()
                  and (f.var > 0).all() and torch.isfinite(mean).all() and (var > 0).all())
    return {"lml": float(lml), "finite": finite, "state_dim": to_ss(model.kernel).state_dim,
            "build_s": t_build, "lml_s": t_lml, "predict_s": t_pred, "to_data_space_s": t_back,
            "peak_gib": _peak_gib(device), "forecast_mean_last": float(mean[-1, 0]),
            "pred_shape": list(f.mean.shape)}


def cvi_full(device, dtype=torch.float32, T=FULL["T"], chunk=FULL["chunk"], steps=FULL["cvi_steps"]):
    """A Poisson `CVIGP` with a `ConstantMean` on the counts at full length:
    `steps` natural-gradient steps (covariance form), timed, with its ELBOs."""
    t, _, counts = full_inputs(T)
    tt, yy = _tensors(dtype, device, t, counts)
    _reset_peak(device)
    kern = kernel("qp", dtype, device, trend=TREND_FULL, env=ENV_FULL)
    model = CVIGP.init(tt, yy, kern, Poisson(), mean=constant_mean(dtype, device), parallel=True,
                       chunk_size=chunk)
    (model, elbos), wall = _timed(device, lambda: natgrad_scan(model, FULL["cvi_lr"], steps))
    elbos = [float(e) for e in elbos]
    return {"elbos": elbos, "finite": bool(np.all(np.isfinite(elbos))), "wall_s": wall,
            "step_s": wall / steps, "peak_gib": _peak_gib(device)}


# ---------------------------------------------------------------------------
# the kernels at the path's shapes
# ---------------------------------------------------------------------------

# Operand shapes of the d = 30, p = 1 path at T = 100 000, chunk 25 000, 256
# scan blocks (`scripts/port/launch_census.py --model markov [--sqrt] --T
# 100000 --chunk 25000 --blocks 256`): the scans' batches 128 / 256 / 512,
# a chunk's 25 000 (25 088 padded to the blocks), the series' 100 000 (125 000
# with the new times of `predict_f`). (N, A's shape, B's shape, ta, tb).
MK_D, MK_CHUNK, MK_CHUNK_PAD, MK_T = 30, 25_000, 25_088, 100_000
MK_BMM = [(n, (MK_D, MK_D), (MK_D, MK_D), ta, tb) for n in (128, 256)
          for ta in (False, True) for tb in (False, True)] + [
    (MK_CHUNK, (1, MK_D), (1, MK_D), True, False), (MK_CHUNK, (1, MK_D), (MK_D, MK_D), False, False),
    (MK_CHUNK, (1, MK_D), (1, MK_D), False, True), (MK_CHUNK, (MK_D, MK_D), (1, MK_D), False, True),
    (MK_CHUNK, (MK_D, 1), (1, MK_D), False, False), (MK_CHUNK, (MK_D, 1), (1, 1), False, False),
    (MK_CHUNK, (MK_D, MK_D), (1, MK_D), True, True), (MK_CHUNK, (MK_D, MK_D), (MK_D, MK_D), True, False),
    (MK_CHUNK_PAD, (MK_D, MK_D), (MK_D, MK_D), False, False),
    (MK_CHUNK_PAD, (MK_D, MK_D), (MK_D, MK_D), False, True),
    (MK_CHUNK_PAD, (MK_D, MK_D), (MK_D, MK_D), True, False),
    (MK_T, (MK_D, MK_D), (MK_D, MK_D), False, True), (MK_T, (1, MK_D), (MK_D, MK_D), False, False),
    (MK_T, (1, MK_D), (1, MK_D), False, True)]
# (N, d, r, the system): "icj" the combine's I + C J with a stride-0 identity
# (r = d), "spd" a dense right-hand side, "tri" a triangular factor
MK_SOLVE = [(128, MK_D, MK_D, "icj"), (256, MK_D, MK_D, "icj"), (256, MK_D, 2 * MK_D, "tri"),
            (512, MK_D, 2 * MK_D, "tri"), (MK_CHUNK, 1, 2 * MK_D + 1, "spd"),
            (MK_CHUNK, 1, 2 * MK_D + 2, "spd"), (MK_CHUNK_PAD, MK_D, MK_D, "spd"),
            (MK_CHUNK_PAD, MK_D, MK_D + 1, "tri"), (MK_T, MK_D, MK_D, "spd"), (MK_T, 1, 1, "spd")]
MK_LQ = [(n, MK_D, 2 * MK_D) for n in (1, 128, 256, 512)] + [
    (MK_CHUNK, 1, MK_D + 1), (MK_CHUNK, MK_D, MK_D), (MK_CHUNK_PAD, MK_D, 2 * MK_D), (MK_T, 1, MK_D + 1)]
MK_CHOL_GRAM = [(128, MK_D), (256, MK_D), (MK_CHUNK, 1), (MK_CHUNK_PAD, MK_D), (MK_T, MK_D)]  # (N, Y's cols)


def kernel_cases(gen, dtype, dev="cuda"):
    """Yield (kernel, tolerance kind, kernel result, plain result, label) for
    every kernel of the path at its shapes (MK_*), on the card: operands at
    the scans' batches are strided views of [N, 3, ...], as the blocked
    scan's sequential pass hands them over; the LQ and the Gram + Cholesky
    are held on L Lᵀ; `chol` factors the noise of the model (Q at random
    gaps, with `safe_cholesky_rel`'s jitter) and of the bare-Periodic sum
    (Q with an exactly zero Periodic block), and SPD matrices at the
    series' width and as a batch of one. On the CPU (`dev`) the wrappers
    run the plain versions."""
    from physs_gp_tpu_torch.kernels.markov import noise_matrix
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq
    from physs_gp_tpu_torch.ops.matrix import default_jitter, symmetrize

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64, device=dev)

    def view(x):
        if x.shape[0] > 512:
            return x
        y = x.new_zeros((x.shape[0], 3) + tuple(x.shape[1:]))
        y[:, 1] = x
        return y[:, 1]

    def spd(N, d, dom=5.0):
        A = randn(N, d, d)
        return A @ A.mT / d + dom * torch.eye(d, dtype=torch.float64, device=dev)

    def system(N, d, kind):
        if kind == "icj":
            M = torch.eye(d, dtype=torch.float64, device=dev) + 0.01 * spd(N, d, 1.0) @ spd(N, d, 1.0)
        elif kind == "tri":
            M = torch.linalg.cholesky(spd(N, d)).contiguous()
        else:
            M = spd(N, d)
        return view(M.to(dtype))

    def gram(L):
        return L @ L.mT

    for N, a, b, ta, tb in MK_BMM:
        A, B = view((randn(N, *a) / 3).to(dtype)), view((randn(N, *b) / 3).to(dtype))
        yield ("bmm", "bmm", bl.batch_bmm(A, B, ta, tb), bl.bmm_plain(A, B, ta, tb),
               f"[{N},{a[0]},{a[1]}]{'^T' * ta} x [{N},{b[0]},{b[1]}]{'^T' * tb}")
    for N, d, r, kind in MK_SOLVE:
        M = system(N, d, kind)
        R = (torch.eye(d, dtype=dtype, device=dev).expand(N, d, d) if kind == "icj"
             else view(randn(N, d, r).to(dtype)))
        label = f"[{N},{d},{d}] r={r} {kind}{' stride-0 I' if kind == 'icj' else ''}"
        yield "gj_solve", "solve", bl.batch_solve(M, R), bl.gj_solve_plain(M, R), label
    for N in (MK_T, MK_T + MK_CHUNK):  # S [T, 1, 1] of the lml and of `predict_f`'s grid
        M, R = system(N, 1, "spd"), randn(N, 1, 1).to(dtype)
        (X, ld), (Xp, ldp) = bl.batch_solve_logdet(M, R), bl.gj_solve_logdet_plain(M, R)
        yield "gj_solve_logdet", "solve", X, Xp, f"[{N},1,1] r=1 X"
        yield "gj_solve_logdet", "logdet", ld, ldp, f"[{N},1,1] r=1 logdet"
    for N, d, m in MK_LQ:
        B = view(randn(N, d, m).to(dtype))
        yield "lq", "factor", gram(bq.batch_tria(B)), gram(bq.tria_plain(B)), f"[{N},{d},{m}] L L^T"
    for N, my in MK_CHOL_GRAM:
        X = view(torch.linalg.cholesky(spd(N, MK_D)).to(dtype).contiguous())
        Y = view((randn(N, MK_D, my) / 3).to(dtype))
        yield ("chol_gram", "factor", gram(bc.batch_chol_gram(X, Y)), gram(bc.chol_gram_plain(X, Y)),
               f"[{N},{MK_D},{MK_D}]+[{N},{MK_D},{my}] L L^T")
    rng = np.random.default_rng(12)
    for name, N in (("qp", 256), ("per_sum", 256), ("qp", MK_CHUNK)):
        with torch.no_grad():
            kern = kernel(name, torch.float64, dev, trend=TREND_FULL, env=ENV_FULL)
            Q = noise_matrix(kern, torch.as_tensor(rng.uniform(0.0, 3.0, N), device=dev))
        n = Q.shape[-1]
        eps = default_jitter(dtype) * torch.diagonal(Q, dim1=-2, dim2=-1).abs().amax(-1) + 1e-30
        A = view((symmetrize(Q) + eps[:, None, None] * torch.eye(n, dtype=Q.dtype, device=dev)).to(dtype))
        L, Lp = bc.batch_cholesky(A), bc.cholesky_plain(A)
        label = f"[{N},{n},{n}] Q of {name}{' (zero Periodic block)' if name == 'per_sum' else ''}"
        yield "chol", "factor", L, Lp, label + " L"
        yield "chol", "factor", gram(L), gram(Lp), label + " L L^T"
    for N in (1, MK_T):
        A = spd(N, MK_D).to(dtype)
        yield "chol", "factor", bc.batch_cholesky(A), bc.cholesky_plain(A), f"[{N},{MK_D},{MK_D}] L"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = {}
    for sqrt in (False, True):
        for dtype in (torch.float32, torch.float64):
            tag = f"{'sqrt' if sqrt else 'cov'} {str(dtype)[6:]}"
            out[tag] = full_run(args.device, dtype, sqrt)
    out["cvi f32"] = cvi_full(args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

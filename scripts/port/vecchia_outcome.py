"""The last batch-style models of the PyTorch port (VecchiaGP with its
neighbour sets, GPRN, LatentVariableGP): shared numpy inputs, port models,
float64 anchors against the golden file, outcome gates and full-size runs.

- anchors (`anchor`), against `tests/data/vecchia_golden.npz` (made by
  `make_vecchia_golden.py` from the JAX package on the CPU; the port loads
  the JAX `.raw` leaves, which the maker moves off their start values):
  `vec` (Vecchia at N = 200, D = 2, m = 12, maximin: lml, gradient by raw,
  `predict_f` with and without `m_predict`, `predict_y`, `nlpd`),
  `vec_nan` (every 5th y missing, a `ConstantMean`: lml, gradient,
  `predict_f`), `gprn_<mixing>` for each mixing (N = 40, P = L = 2, M = 10,
  on the JAX draws: ELBO, KL, gradient by raw, `predict_f`), `lvgp_<mode>`
  for `concat` and `additive` (N = 40: objective, gradient by raw,
  `predict_f` with and without W_new). Tolerances: lml, ELBO, objective,
  gradients and means rtol 1e-9, variances 1e-7.
- outcome gates: `gprn_fit` (the sign-dependent mixing fit of
  `tests/test_svgp_lmc.py:143`: N = 60, 800 Adam steps, RMSE < 0.15,
  float64) and `lvgp_separation` (`tests/test_input_transforms.py:78`: two
  offset branches at the same inputs, 200 Adam steps, the latents' gap
  between branches above twice their spread).
- full size (`vecchia_full`, `gprn_full`, `lvgp_full`): Vecchia at
  N = 100 000 on [0, 10]^2 with m = 16 (ordering and neighbour sets on the
  device, lml, gradient, 20 Adam steps, predictions at 1 000 points, the
  peak memory); GPRN at N = 20 000, P = L = 3, M = 64, n_mc = 16 (ELBO and
  gradient, 50 Adam steps with a generator, `predict_f` at 1 000 points);
  LatentVariableGP at N = 4 096 (objective and gradient, 50 Adam steps).

The numpy inputs here are shared by `make_vecchia_golden.py` (the JAX side),
`tests/test_torch_vecchia_golden.py` and `chip_smoke.py`.

    python3 scripts/port/vecchia_outcome.py [--device cuda]

runs the full-size models and the outcome gates and prints one JSON line.
"""
import argparse
import copy
import json
import math
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from physs_gp_tpu_torch.data.neighbours import maximin_ordering, nearest_neighbour_sets  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.means.mean import ConstantMean  # noqa: E402
from physs_gp_tpu_torch.models import GPRN, BatchGP, LatentVariableGP, VecchiaGP  # noqa: E402
from physs_gp_tpu_torch.trainers.scan import adam_scan  # noqa: E402
from physs_gp_tpu_torch.utils.params import param, positive_param  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "data", "vecchia_golden.npz")
TOL = {"value": 1e-9, "var": 1e-7}
VEC = dict(N=200, m=12, ls=(0.6, 0.8), var=1.0, noise=0.05, n_test=30, m_predict=40,
           nan_every=5, c=0.3)
# the inducing Grams (10 points on [-2, 2]) at lengthscales that keep them well conditioned:
# at 2.0 their condition number is ~1e13, and two Cholesky implementations part at ~1e-8
GP = dict(N=40, P=2, L=2, z_every=4, n_mc=4, n_pred_mc=16, n_test=20, noise=0.01, ls_w=0.6, ls_g=0.4)
LV = dict(N=40, noise=0.05**2, n_test=10)
MIXINGS = ("plain", "softplus", "ldl", "drd")
MODES = ("concat", "additive")
CONFIGS = ("vec", "vec_nan") + tuple(f"gprn_{m}" for m in MIXINGS) + tuple(f"lvgp_{m}" for m in MODES)
RAW_SHIFT = 0.1  # the golden models' raws move by this times standard-normal draws

# outcome gates and full sizes
GPRN_FIT = dict(N=60, steps=800, lr=0.02, n_mc=8, bound=0.15)  # tests/test_svgp_lmc.py:143
LV_FIT = dict(N=40, steps=200, lr=0.05)  # tests/test_input_transforms.py:78
FULL_V = dict(N=100_000, m=16, n_new=1000, steps=20, lr=0.01, ls=1.0, var=1.0, noise=0.01, box=10.0)
V_NB_CHECK_N = 5000  # the card's neighbour sets against the CPU's
V_EXACT = dict(N=8192, ms=(5, 12, 16, 30), bound=0.02)  # Vecchia against the exact lml (tests/test_vecchia.py:85)
V_F32_GAP = 1e-3  # the float32 lml against float64, relative
FULL_G = dict(N=20_000, P=3, L=3, M=64, n_mc=16, steps=50, lr=0.01, n_new=1000, noise=0.01)
FULL_L = dict(N=4096, steps=50, lr=0.05)


def _kw(dtype, device):
    return dict(dtype=dtype, device=device)


def numpy(x):
    return x.detach().double().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def relerr(got, want):
    """max |got - want| / max |want| (NaNs in the same places)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.array_equal(np.isnan(got), np.isnan(want)):
        return float("inf")
    return float(np.nanmax(np.abs(got - want)) / (np.nanmax(np.abs(want)) or 1.0))


def _rbf(ls, var, kw):
    return RBF(lengthscales=positive_param(np.asarray(ls, np.float64), **kw),
               variance=positive_param(var, **kw))


# ---------------------------------------------------------------------------
# inputs (numpy)
# ---------------------------------------------------------------------------


def field(X):
    """The smooth 2-D field the Vecchia data sample."""
    return np.sin(1.3 * X[:, 0]) * np.cos(0.9 * X[:, 1]) + 0.3 * np.sin(0.5 * (X[:, 0] + X[:, 1]))


def vecchia_inputs(N=VEC["N"], box=3.0, noise=VEC["noise"], n_test=VEC["n_test"], seed=0):
    """(X [N, 2], Y [N, 1], Xs [n_test, 2], Ys [n_test, 1]) uniform on [0, box]^2."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, box, (N, 2))
    Y = (field(X) + math.sqrt(noise) * rng.standard_normal(N))[:, None]
    Xs = rng.uniform(0, box, (n_test, 2))
    Ys = (field(Xs) + math.sqrt(noise) * rng.standard_normal(n_test))[:, None]
    return X, Y, Xs, Ys


def with_missing(Y, every=VEC["nan_every"]):
    Y = Y.copy()
    Y[::every] = np.nan
    return Y


def gprn_inputs(N=GP["N"], seed=11):
    """The GPRN mixing test's data (tests/test_svgp_lmc.py:229): X [N, 1],
    Y = [g, 0.6 g] + noise, Z = X[::4], Xs [n_test, 1]."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-2, 2, N))[:, None]
    g = np.sin(2 * X[:, 0])
    Y = np.stack([g, 0.6 * g], -1) + 0.05 * rng.normal(size=(N, 2))
    Xs = np.linspace(-2.1, 2.1, GP["n_test"])[:, None]
    return X, Y, X[::GP["z_every"]], Xs


def lvgp_inputs(mode, N=LV["N"], seed=1):
    """Two offset branches at the same inputs (tests/test_input_transforms.py:78):
    X [N, 1], Y [N, 1], W0 [N, 1], Xs [n_test, 1], W_new [n_test, 1]."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 4, N // 2)
    X = np.concatenate([x, x])[:, None]
    Y = (np.concatenate([np.sin(x), np.sin(x) + 2.0]) + 0.05 * rng.normal(size=N))[:, None]
    W0 = 0.01 * rng.standard_normal((N, 1))
    Xs = np.linspace(0.1, 3.9, LV["n_test"])[:, None]
    W_new = 0.5 * rng.standard_normal((LV["n_test"], 1))
    return X, Y, W0, Xs, W_new


def gprn_field(X, P=FULL_G["P"], L=FULL_G["L"]):
    """y_p = sum_l W_pl(x) g_l(x) with slowly varying W and faster g."""
    x = X[:, 0]
    g = np.stack([np.sin((l + 1) * x + l) for l in range(L)], 1)  # [N, L]
    W = np.stack([np.stack([np.cos(0.3 * (p + 1) * x + l) for l in range(L)], -1)
                  for p in range(P)], 1)  # [N, P, L]
    return np.einsum("npl,nl->np", W, g)


# ---------------------------------------------------------------------------
# port models
# ---------------------------------------------------------------------------


def vecchia_model(X, Y, dtype, device, m=VEC["m"], ls=VEC["ls"], var=VEC["var"], noise=VEC["noise"],
                  ordering="maximin", mean_c=None):
    kw = _kw(dtype, device)
    model = VecchiaGP.init(X, Y, _rbf(ls, var, kw), Gaussian(positive_param(noise, **kw)), m=m,
                           ordering=ordering, **kw)
    if mean_c is not None:
        model.mean = ConstantMean(param(mean_c, **kw))
    return model


def gprn_model(X, Y, Z, mixing, dtype, device, n_latent=GP["L"], n_mc=GP["n_mc"], noise=GP["noise"],
               ls_w=GP["ls_w"], ls_g=GP["ls_g"]):
    kw = _kw(dtype, device)
    return GPRN.init(X, Y, Z, kernel_w=_rbf(ls_w, 1.0, kw), kernel_g=_rbf(ls_g, 1.0, kw),
                     n_latent=n_latent, noise=noise, n_mc=n_mc, mixing=mixing, **kw)


def lvgp_model(X, Y, mode, W0, dtype, device, noise=LV["noise"], fixed_noise=False):
    kw = _kw(dtype, device)
    ls = [1.0, 1.0] if mode == "concat" else [1.0]
    return LatentVariableGP.init(X, Y, _rbf(ls, 1.0, kw),
                                 Gaussian(positive_param(noise, fixed=fixed_noise, **kw)),
                                 dw=1, mode=mode, W0=W0, **kw)


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------


def flat(gold, cfg):
    return {k.split("::", 2)[2]: gold[k] for k in gold.files if k.startswith(f"{cfg}::flat::")}


def _jax_name(key):
    """`.kernel.lengthscales.raw` -> `kernel.lengthscales.raw`."""
    return key[1:].replace("[", ".").replace("]", "")


def anchor_model(gold, cfg, device):
    """The port model of one configuration in float64 on `device`, loaded
    with the JAX leaves; and its inputs."""
    f64 = torch.float64
    if cfg.startswith("vec"):
        X, Y, Xs, Ys = vecchia_inputs()
        nan = cfg == "vec_nan"
        model = vecchia_model(X, with_missing(Y) if nan else Y, f64, device, mean_c=0.0 if nan else None)
        x = dict(Xs=Xs, Ys=Ys)
    elif cfg.startswith("gprn"):
        X, Y, Z, Xs = gprn_inputs()
        model = gprn_model(X, Y, Z, cfg.split("_")[1], f64, device)
        x = dict(Xs=Xs, eps=gold[f"{cfg}::in::eps"], eps_pred=gold[f"{cfg}::in::eps_pred"])
    else:
        mode = cfg.split("_")[1]
        X, Y, W0, Xs, W_new = lvgp_inputs(mode)
        model = lvgp_model(X, Y, mode, W0, f64, device)
        x = dict(Xs=Xs, W_new=W_new)
    load_numpy_params(model, flat(gold, cfg))
    return model, x


def anchor(gold, cfg, device):
    """{output: (port value, golden value, tolerance)} of one configuration."""
    out = {}
    model, x = anchor_model(gold, cfg, device)

    def hold(key, got, kind="value"):
        out[key] = (numpy(got), gold[f"{cfg}::{key}"], TOL[kind])

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    def grads():
        named = {name: p.grad for name, p in model.named_parameters() if p.grad is not None}
        for key in gold.files:
            if key.startswith(f"{cfg}::grad::"):
                hold(key.split("::", 1)[1], named[_jax_name(key.split("::")[2])])

    def moments(key, f):
        hold(f"{key}_mean", f.mean)
        hold(f"{key}_var", f.var, "var")

    if cfg.startswith("vec"):
        lml = model.log_marginal_likelihood()
        lml.backward()
        hold("lml", lml)
        grads()
        with torch.no_grad():
            moments("f", model.predict_f(x["Xs"]))
            if cfg == "vec":
                moments("f_wide", model.predict_f(x["Xs"], m_predict=VEC["m_predict"]))
                moments("y", model.predict_y(x["Xs"]))
                hold("nlpd", model.nlpd(x["Xs"], x["Ys"]))
    elif cfg.startswith("gprn"):
        elbo = model.elbo(draws=t(x["eps"]))
        elbo.backward()
        hold("elbo", elbo)
        grads()
        with torch.no_grad():
            hold("kl", model._kl())
            moments("f", model.predict_f(x["Xs"], n_mc=GP["n_pred_mc"], draws=t(x["eps_pred"])))
    else:
        obj = model.get_objective()
        obj.backward()
        hold("objective", obj)
        grads()
        with torch.no_grad():
            moments("f", model.predict_f(x["Xs"]))
            moments("f_w", model.predict_f(x["Xs"], W_new=x["W_new"]))
    return out


def anchors(gold, device, configs=CONFIGS):
    """{config: anchor(gold, config, device)}."""
    return {cfg: anchor(gold, cfg, device) for cfg in configs}


# ---------------------------------------------------------------------------
# outcome gates
# ---------------------------------------------------------------------------


def gprn_fit(device, dtype=torch.float64, steps=GPRN_FIT["steps"]):
    """GPRN on y = tanh(x) sin(3x) + noise (a sign-flipping weight, which a
    constant mixing cannot represent): Adam at lr 0.02 on the frozen-noise
    objective, as the JAX test trains it; RMSE of the mean against w g."""
    rng = np.random.default_rng(7)
    N = GPRN_FIT["N"]
    X = np.sort(rng.uniform(-3, 3, N))[:, None]
    w, g = np.tanh(X[:, 0]), np.sin(3 * X[:, 0])
    Y = (w * g + 0.05 * rng.normal(size=N))[:, None]
    model = gprn_model(X, Y, X[::2], "plain", dtype, device, n_latent=1, n_mc=GPRN_FIT["n_mc"],
                       noise=0.0025, ls_w=2.0, ls_g=0.6)
    _, losses = adam_scan(model, steps, lr=GPRN_FIT["lr"])
    with torch.no_grad():
        pred = model.predict_f(X)
    r = float(np.sqrt(np.mean((numpy(pred.mean[:, 0]) - w * g) ** 2)))
    return {"rmse": r, "bound": GPRN_FIT["bound"], "ok": r < GPRN_FIT["bound"],
            "loss_first": float(losses[0]), "loss_last": float(losses[-1])}


def lvgp_separation(device, gold, dtype=torch.float64, steps=LV_FIT["steps"]):
    """Concat-mode latents on two offset branches after `steps` Adam steps
    at lr 0.05 (the noise fixed), from the JAX test's initial latents
    (`lvgp_fit::in::W0` of the golden file: which branch a latent joins
    depends on where it starts): the gap between the branches' mean latent
    must exceed twice the sum of their spreads, and the objective must fall
    by more than 10."""
    N = LV_FIT["N"]
    X, Y, _, _, _ = lvgp_inputs("concat", N=N)
    W0 = gold["lvgp_fit::in::W0"]
    model = lvgp_model(X, Y, "concat", W0, dtype, device, fixed_noise=True)
    with torch.no_grad():
        v0 = float(model.get_objective())
    _, losses = adam_scan(model, steps, lr=LV_FIT["lr"])
    with torch.no_grad():
        v = float(model.get_objective())
    W = numpy(model.W.value)[:, 0]
    gap = abs(W[: N // 2].mean() - W[N // 2:].mean())
    spread = W[: N // 2].std() + W[N // 2:].std()
    return {"gap": float(gap), "spread": float(spread), "objective_first": v0, "objective_last": v,
            "ok": bool(gap > 2 * spread and v < v0 - 10.0)}


# ---------------------------------------------------------------------------
# full size
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


def _value_and_grad(model, **kw):
    model.zero_grad(set_to_none=True)
    obj = model.get_objective(**kw)
    obj.backward()
    return obj.detach()


def vecchia_build(device, N=FULL_V["N"], m=FULL_V["m"], seed=0):
    """(model in float64, ordering wall, neighbour-set wall, test inputs):
    the maximin ordering and the neighbour sets on `device`, timed apart."""
    X, Y, Xs, Ys = vecchia_inputs(N, box=FULL_V["box"], noise=FULL_V["noise"], n_test=FULL_V["n_new"],
                                  seed=seed)
    Xt = torch.as_tensor(X, dtype=torch.float64, device=device)
    order, t_order = _timed(device, lambda: maximin_ordering(Xt))
    model, t_nbrs = _timed(device, lambda: vecchia_model(
        Xt, Y, torch.float64, device, m=m, ls=(FULL_V["ls"],) * 2, var=FULL_V["var"],
        noise=FULL_V["noise"], ordering=order))
    return model, t_order, t_nbrs, (Xs, Ys)


def vecchia_run(model, device, test, steps=FULL_V["steps"]):
    """lml, the gradient of the objective, `steps` Adam steps and the
    predictions at the test points, each timed; the peak memory."""
    Xs, Ys = test
    _reset_peak(device)
    with torch.no_grad():
        lml, t_lml = _timed(device, model.log_marginal_likelihood)
    obj, t_grad = _timed(device, lambda: _value_and_grad(model))
    (_, losses), t_adam = _timed(device, lambda: adam_scan(model, steps, lr=FULL_V["lr"]))
    with torch.no_grad():
        f, t_f = _timed(device, lambda: model.predict_f(Xs))
        y, t_y = _timed(device, lambda: model.predict_y(Xs))
        nlpd, t_nlpd = _timed(device, lambda: model.nlpd(Xs, Ys))
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    finite = bool(torch.isfinite(lml) and all(torch.isfinite(g).all() for g in grads)
                  and torch.isfinite(losses).all() and torch.isfinite(f.mean).all()
                  and (f.var >= 0).all() and torch.isfinite(nlpd))
    rmse = float(np.sqrt(np.mean((numpy(f.mean[:, 0]) - field(np.asarray(Xs))) ** 2)))
    return {"lml": float(lml), "finite": finite, "lml_s": t_lml, "grad_s": t_grad, "adam_s": t_adam,
            "adam_steps": steps, "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "predict_f_s": t_f, "predict_y_s": t_y, "nlpd_s": t_nlpd, "nlpd": float(nlpd),
            "rmse_f": rmse, "pred_shape": list(f.mean.shape), "peak_gib": _peak_gib(device)}


def vecchia_f32(model64):
    """The float64 model's copy in float32 (the same ordering and sets)."""
    return copy.deepcopy(model64).to(torch.float32)


def neighbours_agree(device, N=V_NB_CHECK_N, m=FULL_V["m"]):
    """The neighbour sets on `device` equal the CPU's (maximin, float64)."""
    X, _, _, _ = vecchia_inputs(N, box=FULL_V["box"], noise=FULL_V["noise"], seed=1)
    dev = nearest_neighbour_sets(torch.as_tensor(X, device=device), m)
    cpu = nearest_neighbour_sets(torch.as_tensor(X), m)
    return all(torch.equal(a.cpu(), b) for a, b in zip(dev, cpu))


def vecchia_vs_exact(device, N=V_EXACT["N"], ms=V_EXACT["ms"]):
    """Vecchia's lml (maximin, each m of `ms`) against the exact BatchGP lml
    on the same data (N points on [0, 10]^2, the full run's settings),
    float64: {"exact", "vecchia": {m: lml}, "rel_gap": {m: gap}, "monotone":
    the gap falls as m grows (tests/test_vecchia.py:79)}."""
    X, Y, _, _ = vecchia_inputs(N, box=FULL_V["box"], noise=FULL_V["noise"], n_test=1, seed=2)
    lml, gap = {}, {}
    order = maximin_ordering(torch.as_tensor(X, device=device))
    with torch.no_grad():
        for m in ms:
            v = vecchia_model(X, Y, torch.float64, device, m=m, ls=(FULL_V["ls"],) * 2,
                              var=FULL_V["var"], noise=FULL_V["noise"], ordering=order)
            lml[m] = float(v.log_marginal_likelihood())
        exact = float(BatchGP(X, Y, v.kernel, v.likelihood, dtype=torch.float64,
                              device=device).log_marginal_likelihood())
    for m in ms:
        gap[m] = abs(lml[m] - exact) / abs(exact)
    gaps = [gap[m] for m in ms]
    return {"exact": exact, "vecchia": lml, "rel_gap": gap, "bound_at_16": V_EXACT["bound"],
            "monotone": all(a > b for a, b in zip(gaps, gaps[1:]))}


def gprn_full(device, dtype, mixing, N=FULL_G["N"], steps=FULL_G["steps"], n_new=FULL_G["n_new"],
              seed=0):
    """GPRN at N points, P = L = 3, M = 64 inducing points, n_mc = 16: ELBO
    and gradient, `steps` Adam steps with a generator, `predict_f` at n_new
    points, each timed; the peak memory."""
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-3, 3, N))[:, None]
    Y = gprn_field(X) + math.sqrt(FULL_G["noise"]) * rng.standard_normal((N, FULL_G["P"]))
    Z = np.linspace(-3, 3, FULL_G["M"])[:, None]
    Xs = np.linspace(-3, 3, n_new)[:, None]
    model = gprn_model(X, Y, Z, mixing, dtype, device, n_latent=FULL_G["L"], n_mc=FULL_G["n_mc"],
                       noise=FULL_G["noise"], ls_w=2.0, ls_g=0.6)
    gen = torch.Generator(device=device).manual_seed(seed)
    _reset_peak(device)
    obj, t_grad = _timed(device, lambda: _value_and_grad(model, generator=gen))
    (_, losses), t_adam = _timed(device, lambda: adam_scan(model, steps, lr=FULL_G["lr"], generator=gen))
    with torch.no_grad():
        f, t_f = _timed(device, lambda: model.predict_f(Xs, generator=gen))
    finite = bool(torch.isfinite(obj) and torch.isfinite(losses).all() and torch.isfinite(f.mean).all()
                  and (f.var >= 0).all())
    return {"elbo": -float(obj), "finite": finite, "grad_s": t_grad, "adam_s": t_adam, "adam_steps": steps,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]), "predict_f_s": t_f,
            "pred_shape": list(f.mean.shape), "peak_gib": _peak_gib(device)}


def lvgp_full(device, dtype, mode, N=FULL_L["N"], steps=FULL_L["steps"]):
    """LatentVariableGP at N points (two offset branches): objective and
    gradient, `steps` Adam steps, each timed; the peak memory."""
    X, Y, W0, Xs, _ = lvgp_inputs(mode, N=N)
    model = lvgp_model(X, Y, mode, W0, dtype, device, fixed_noise=True)
    _reset_peak(device)
    obj, t_grad = _timed(device, lambda: _value_and_grad(model))
    (_, losses), t_adam = _timed(device, lambda: adam_scan(model, steps, lr=FULL_L["lr"]))
    with torch.no_grad():
        f, t_f = _timed(device, lambda: model.predict_f(Xs))
    finite = bool(torch.isfinite(obj) and torch.isfinite(losses).all() and torch.isfinite(f.mean).all())
    return {"objective": float(obj), "finite": finite, "grad_s": t_grad, "adam_s": t_adam,
            "adam_steps": steps, "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "predict_f_s": t_f, "peak_gib": _peak_gib(device)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = {}
    model, t_order, t_nbrs, test = vecchia_build(args.device)
    out["vecchia order_s"], out["vecchia nbrs_s"] = t_order, t_nbrs
    out["vecchia f32"] = vecchia_run(vecchia_f32(model), args.device, test)
    out["vecchia f64"] = vecchia_run(model, args.device, test)
    for mixing in MIXINGS:
        out[f"gprn {mixing} f32"] = gprn_full(args.device, torch.float32, mixing)
    for mode in MODES:
        out[f"lvgp {mode} f64"] = lvgp_full(args.device, torch.float64, mode)
    out["gprn fit"] = gprn_fit(args.device)
    out["lvgp separation"] = lvgp_separation(args.device, np.load(GOLDEN))
    print(json.dumps(out))


if __name__ == "__main__":
    main()

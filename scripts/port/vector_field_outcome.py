"""The scattered-sensor and vector-field paths of the PyTorch port: float64
anchors against the golden file, and the outcome gates of two experiments.

- scattered and Helmholtz: the experiments' inputs, models and metrics are
  the drivers' own (`experiments_torch/scattered_st.py`, `helmholtz.py`);
  `scattered_rows_long` draws the scattered field at a longer series;
- sparse, magnetic field and LMC: small configurations of the recipes.

The numpy inputs here are shared by `make_vector_field_golden.py` (the JAX
side), `tests/test_torch_vector_field_golden.py` and `chip_smoke.py`.

    python3 scripts/port/vector_field_outcome.py [--device cuda]

runs both drivers' gates in float32, as the experiments run off the CPU
(scattered: held-out RMSE and NLPD within 5 % of `results/scattered_st.json`;
Helmholtz at T = 64: the v components held out over the second half
reconstructed to RMSE < 0.35 of their RMS, with the quick configuration's
metrics beside `results/helmholtz_st.json`), prints one JSON line and exits
non-zero if a gate fails.
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

from experiments_torch import helmholtz as hz  # noqa: E402
from experiments_torch import scattered_st as sc  # noqa: E402
from physs_gp_tpu_torch.interop import load_numpy_params  # noqa: E402
from physs_gp_tpu_torch.kernels.matern import Matern32, Matern52  # noqa: E402
from physs_gp_tpu_torch.kernels.multi_output import UnitLowerMixing  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import RBF  # noqa: E402
from physs_gp_tpu_torch.likelihoods.nongaussian import Poisson  # noqa: E402
from physs_gp_tpu_torch.utils.params import param, positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.multi_output import lmc_markov_gp  # noqa: E402
from physs_gp_tpu_torch.zoo.phi_ml import (helmholtz_st_predict, magnetic_field_gp,  # noqa: E402
                                           magnetic_field_predict)
from physs_gp_tpu_torch.zoo.spatio_temporal import sparse_st_gp  # noqa: E402

GOLDEN = os.path.join(REPO, "tests", "data", "vector_field_golden.npz")
SC_CHUNK = 64  # the scattered anchors' chunk (T = 200 padded)
HZ_RESULTS = {"rmse_flow": 0.04036519726616597, "nlpd_flow": -1.5086949645899541,  # results/helmholtz_st.json
              "rmse_v_reconstructed": 0.07442384984314142, "rms_v_truth": 0.32491819124841353}
TOL = {"value": 1e-9, "var": 1e-7}  # lml, ELBO, means, gradients / variances
# the anchors' forms: (parallel, sqrt, PHYSS_FUSED_COMBINE)
SC_FORMS = {"cov": (True, False, False), "sqrt": (True, True, False), "fused": (True, False, True)}
MF_FORMS = {"seq": (False, False), "par": (True, False)}


def _kw(dtype, device):
    return dict(dtype=dtype, device=device)


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def numpy(x):
    return x.detach().double().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# scattered sensors
# ---------------------------------------------------------------------------


def scattered_rows_long(n_times, t_end, seed=0):
    """The experiment's field, noise and sensor counts at n_times times on
    [0, t_end], drawn in bulk: (train rows, test rows)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, t_end, n_times))
    tt = np.repeat(t, rng.integers(1, 5, n_times))
    s = rng.uniform(-1, 1, (tt.shape[0], 2))
    A = np.column_stack([tt, s, sc.field(tt, s) + sc.NOISE * rng.normal(size=tt.shape[0])])
    test = rng.uniform(size=A.shape[0]) < 0.2
    return A[~test], A[test]


# ---------------------------------------------------------------------------
# sparse sites, magnetic field, LMC: small configurations
# ---------------------------------------------------------------------------


def sparse_inputs(seed=6):
    """(t [10], Y [10, 8] with NaNs, X_space [8, 2], Z [4, 2])."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 2, 10))
    X_space = rng.uniform(-1, 1, (8, 2))
    Z = rng.uniform(-1, 1, (4, 2))
    Y = np.sin(2 * t[:, None]) * np.cos(1.5 * X_space[None, :, 0]) + 0.1 * rng.normal(size=(10, 8))
    Y[rng.uniform(size=Y.shape) < 0.15] = np.nan
    return t, Y, X_space, Z


def sparse_model(t, Y, X_space, Z, dtype, device, parallel=True, chunk_size=4):
    kw = _kw(dtype, device)
    return sparse_st_gp(
        t, Y, X_space, Z, k_time=Matern32(lengthscale=0.9, variance=1.2, **kw),
        k_space=RBF(lengthscales=positive_param([0.7, 0.8], **kw), variance=positive_param(1.1, **kw)),
        noise=0.1, dtype=dtype, train_z=True, parallel=parallel, chunk_size=chunk_size, device=device,
    )


def magnetic_inputs(pot, T=10, Ns=5, seed=0):
    """(t [T], Z [Ns, 2], Y [T, (3|4) Ns] with NaNs, s_new [4, 2])."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 3, T))
    Z = rng.uniform(-1, 1, (Ns, 2))
    Y = rng.normal(size=(T, (4 if pot else 3) * Ns))
    Y[2, 1] = Y[4, Ns + 2] = Y[T - 2, -1] = np.nan
    return t, Z, Y, rng.uniform(-0.8, 0.8, (4, 2))


def magnetic_model(t, Z, Y, pot, dtype, device, parallel=False, sqrt=False):
    kw = _kw(dtype, device)
    return magnetic_field_gp(
        t, Y, Z, k_time=Matern32(lengthscale=0.8, variance=1.3, **kw),
        k_space=RBF(lengthscales=positive_param([0.7, 0.9], **kw), variance=positive_param(1.1, **kw)),
        noise=0.04, include_potential=pot, dtype=dtype, parallel=parallel, sqrt=sqrt,
        chunk_size=4 if parallel else None, device=device,
    )


def lmc_inputs(seed=7):
    """(t [18], Y [18, 3] with NaNs, counts [18, 2], W [3, 2])."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 4, 18))
    W = rng.normal(size=(3, 2))
    Y = rng.normal(size=(18, 3))
    Y[3, 1] = Y[9, 0] = np.nan
    counts = rng.poisson(1.5, size=(18, 2)).astype(float)
    return t, Y, counts, W


def lmc_latents(kw):
    return [Matern32(lengthscale=0.7, variance=1.0, **kw), Matern52(lengthscale=1.8, variance=0.6, **kw)]


def lmc_model(t, Y, W, dtype, device, parallel=False):
    kw = _kw(dtype, device)
    return lmc_markov_gp(t, Y, lmc_latents(kw), mixing=param(W, **kw), noise=0.05, dtype=dtype,
                         parallel=parallel, chunk_size=4 if parallel else None, device=device)


def lmc_cvi_model(t, counts, dtype, device):
    kw = _kw(dtype, device)
    return lmc_markov_gp(t, counts, lmc_latents(kw), mixing=UnitLowerMixing.init(2, 2, **kw),
                         likelihood=Poisson(), cvi=True, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# anchors against the golden file
# ---------------------------------------------------------------------------


def inputs(gold, cfg):
    return {k.split("::")[2]: gold[k] for k in gold.files if k.startswith(f"{cfg}::in::")}


def flat(gold, cfg):
    return {k.split("::", 2)[2]: gold[k] for k in gold.files if k.startswith(f"{cfg}::flat::")}


def _grads(model):
    return {name: p.grad for name, p in model.named_parameters() if p.grad is not None}


def _jax_name(key):
    """`.kernel.parts[0].Z.raw` -> `kernel.parts.0.Z.raw` (`named_parameters`)."""
    return key[1:].replace("[", ".").replace("]", "")


def anchors(gold, device):
    """{anchor: {output: (port value, golden value, tolerance)}}, every
    Phase A configuration in float64 on `device`. The port's models load the
    JAX flat leaves of the golden file (perturbed raws, trainable Z, the
    `StackedHead` coefficients, the mixing) before they run."""
    f64 = torch.float64
    out = {}

    def hold(name, got, cfg, key, kind="value"):
        out.setdefault(name, {})[key] = (numpy(got), gold[f"{cfg}::{key}"], TOL[kind])

    # scattered: the experiment's full configuration, chunk 64 (T = 200 padded)
    x = inputs(gold, "sc")
    for form, (parallel, sqrt, fused) in SC_FORMS.items():
        old = os.environ.pop("PHYSS_FUSED_COMBINE", None)
        if fused:
            os.environ["PHYSS_FUSED_COMBINE"] = "1"
        try:
            model, data = sc.build(x["train"], x["Z"], f64, device, parallel, sqrt, SC_CHUNK)
            res = sc.outputs(model, data, x["test"])
        finally:
            os.environ.pop("PHYSS_FUSED_COMBINE", None)
            if old is not None:
                os.environ["PHYSS_FUSED_COMBINE"] = old
        for key, got in res.items():
            hold(f"scattered {form}", got, "scs" if sqrt else "sc", key,
                 "var" if key.endswith("var") else "value")

    # sparse: lml and its gradient by raw, the trainable Z among them
    x = inputs(gold, "sp")
    model = sparse_model(x["t"], x["Y"], x["X_space"], x["Z"], f64, device)
    load_numpy_params(model, flat(gold, "sp"))
    lml = model.log_marginal_likelihood()
    lml.backward()
    hold("sparse", lml, "sp", "lml")
    grads = _grads(model)
    for key in gold.files:
        if key.startswith("sp::grad::"):
            hold("sparse", grads[_jax_name(key.split("::")[2])], "sp", key.split("::", 1)[1])

    # Helmholtz quick configuration (D = 100): lml and prediction in the
    # covariance and the square-root form (sequential), one CVI step
    x = inputs(gold, "hz")
    model = hz.build(x["t"], x["Z"], x["Y"], f64, device)
    load_numpy_params(model, flat(gold, "hz"))
    with torch.no_grad():
        hold("helmholtz", model.log_marginal_likelihood(), "hz", "lml")
        pred = helmholtz_st_predict(model, x["S_new"])
        cvi = hz.build(x["t"], x["Z"], x["Y"], f64, device, cvi=True)
        load_numpy_params(cvi, flat(gold, "hzc"))
        cvi, elbo = cvi.step_with_elbo(1.0)
        pred_c = helmholtz_st_predict(cvi, x["S_new"])
        sq = hz.build(x["t"], x["Z"], x["Y"], f64, device, sqrt=True)
        hold("helmholtz sqrt", sq.log_marginal_likelihood(), "hzs", "lml")
        pred_s = helmholtz_st_predict(sq, x["S_new"])
    hold("helmholtz sqrt", pred_s.mean, "hzs", "pred_mean")
    hold("helmholtz sqrt", pred_s.var, "hzs", "pred_var", "var")
    hold("helmholtz", pred.mean, "hz", "pred_mean")
    hold("helmholtz", pred.var, "hz", "pred_var", "var")
    hold("helmholtz cvi", elbo, "hzc", "elbo")
    hold("helmholtz cvi", pred_c.mean, "hzc", "pred_mean")
    hold("helmholtz cvi", pred_c.var, "hzc", "pred_var", "var")

    # magnetic field, with and without the potential block, both scans
    for pot in (False, True):
        cfg = f"mf{int(pot)}"
        x = inputs(gold, cfg)
        for form, (parallel, sqrt) in MF_FORMS.items():
            model = magnetic_model(x["t"], x["Z"], x["Y"], pot, f64, device, parallel, sqrt)
            load_numpy_params(model, flat(gold, cfg))
            with torch.no_grad():
                name = f"magnetic {'with' if pot else 'without'} potential {form}"
                hold(name, model.log_marginal_likelihood(), cfg, "lml")
                pred = magnetic_field_predict(model, x["s_new"], include_potential=pot)
            hold(name, pred.mean, cfg, "pred_mean")
            hold(name, pred.var, cfg, "pred_var", "var")

    # LMC: conjugate lml, then two Poisson CVI steps' ELBOs
    x = inputs(gold, "lmc")
    model = lmc_model(x["t"], x["Y"], x["W"], f64, device)
    load_numpy_params(model, flat(gold, "lmc"))
    cvi = lmc_cvi_model(x["t"], x["counts"], f64, device)
    load_numpy_params(cvi, flat(gold, "lmcc"))
    with torch.no_grad():
        hold("lmc", model.log_marginal_likelihood(), "lmc", "lml")
        elbos = []
        for _ in range(2):
            cvi, elbo = cvi.step_with_elbo(0.8)
            elbos.append(elbo)
    hold("lmc cvi", torch.stack(elbos), "lmcc", "elbos")
    return out


def relerr(got, want):
    """max |got - want| / max |want|."""
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# outcome gates
# ---------------------------------------------------------------------------


def outcome(device):
    """Both drivers' gates in float32 on `device`: the scattered experiment at
    full size, the Helmholtz one at T = 64 and at its quick T = 16 (reported
    beside the JAX record)."""
    f32 = torch.float32
    t0 = time.perf_counter()
    scattered = sc.run(device, f32)[0]
    full, quick = (hz.run(device, f32, T)[0] for T in (hz.T_FULL, hz.T_QUICK))
    res = {"scattered": {**scattered, "ok": all(sc.gates(scattered).values())},
           "helmholtz_full": {**full, "ok": all(hz.gates(full).values())},
           "helmholtz_quick": quick, "seconds": time.perf_counter() - t0,
           "reference": {"scattered": sc.REFERENCE, "helmholtz_quick": HZ_RESULTS}}
    res["ok"] = res["scattered"]["ok"] and res["helmholtz_full"]["ok"]
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("vector_field_outcome: no CUDA device", file=sys.stderr)
        return 1
    res = outcome(args.device)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

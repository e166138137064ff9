"""Helmholtz-decomposition flow experiment on the PyTorch port, state-space
form (counterpart of `experiments/helmholtz.py`).

A (time + 2-D space) flow, grad φ + rot ψ with φ = sin(x + 0.3 t) cos(y)
and a weak stream ψ = 0.3 cos(x) sin(y − 0.2 t), observed with noise 0.03 on
a 5 x 5 site grid at T = 64 random times (`--quick`: 16), the v components
held out over the second half of the series. The model
(`zoo.phi_ml.helmholtz_st_gp`: curl-free and divergence-free latent ST GPs
read through fixed spatial-derivative heads, sequential filters) predicts
the flow at 12 new sites (`helmholtz_st_predict`); the held-out v must be
reconstructed from u alone. Gate: `rmse_v_reconstructed < 0.35 *
rms_v_truth`.

Run: python3 experiments_torch/helmholtz.py [--quick] [--device cpu]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from experiments_torch.common import (  # noqa: E402
    RunStats, Timer, dump_results, nlpd, numpy, parse_args, resolve_device, rmse, run_dtype,
)
from physs_gp_tpu_torch.kernels.matern import Matern32  # noqa: E402
from physs_gp_tpu_torch.kernels.rbf import rbf  # noqa: E402
from physs_gp_tpu_torch.zoo.phi_ml import helmholtz_st_gp, helmholtz_st_predict  # noqa: E402


NOISE = 0.03
T_FULL, T_QUICK = 64, 16
N_NEW = 12  # prediction sites


def flow(t, S):
    """(u, v) [T, N] of grad φ + rot ψ at the sites S."""
    x, y = S[:, 0][None, :], S[:, 1][None, :]
    tt = np.asarray(t)[:, None]
    u = np.cos(x + 0.3 * tt) * np.cos(y) + 0.3 * np.cos(x) * np.cos(y - 0.2 * tt)
    v = -np.sin(x + 0.3 * tt) * np.sin(y) + 0.3 * np.sin(x) * np.sin(y - 0.2 * tt)
    return u, v


def inputs(T, seed=0):
    """(t [T], Z [25, 2], Y [T, 50] with v held out over the second half,
    S_new [12, 2]), with the JAX driver's generator calls."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 4, T))
    gx = np.linspace(-1.2, 1.2, 5)
    Z = np.stack(np.meshgrid(gx, gx), -1).reshape(-1, 2)
    u, v = flow(t, Z)
    Y = np.concatenate([u + NOISE * rng.normal(size=u.shape),
                        v + NOISE * rng.normal(size=v.shape)], axis=1)
    # v held out over the second half: the Helmholtz structure must
    # reconstruct it from u alone
    Y[T // 2:, Z.shape[0]:] = np.nan
    return t, Z, Y, rng.uniform(-1.0, 1.0, (N_NEW, 2))


def build(t, Z, Y, dtype, device, cvi=False, parallel=False, sqrt=False):
    """The experiment's model (sequential covariance form unless asked)."""
    kw = dict(dtype=dtype, device=device)
    return helmholtz_st_gp(
        t, Y, Z, k_time=Matern32(lengthscale=2.0, variance=1.0, **kw),
        k_space=(rbf([1.0, 1.0], 1.0, **kw), rbf([1.0, 1.0], 0.1, **kw)),
        noise=NOISE ** 2, parallel=parallel, sqrt=sqrt, cvi=cvi, **kw,
    )


def metrics(mean, var, t, S_new):
    """The experiment's metrics from the predicted flow's moments [T, 24]."""
    u_t, v_t = flow(t, S_new)
    truth = np.concatenate([u_t, v_t], axis=1)
    hold = slice(t.shape[0] // 2, None)
    n = S_new.shape[0]
    return {
        "rmse_flow": rmse(mean, truth),
        "nlpd_flow": nlpd(truth, mean, var + NOISE ** 2),
        "rmse_v_reconstructed": rmse(mean[hold, n:], v_t[hold]),
        "rms_v_truth": float(np.sqrt(np.mean(v_t[hold] ** 2))),
    }


def run(device, dtype, T=T_FULL, seed=0):
    """The experiment at T times on `device` in `dtype`: (metrics, seconds
    in the model)."""
    t, Z, Y, S_new = inputs(T, seed)
    with torch.no_grad(), Timer(device) as tm:
        pred = helmholtz_st_predict(build(t, Z, Y, dtype, device), S_new)
    return metrics(numpy(pred.mean).astype(np.float64), numpy(pred.var).astype(np.float64),
                   t, S_new), tm.seconds


def gates(m):
    return {"v_reconstructed_below_0.35_rms": m["rmse_v_reconstructed"] < 0.35 * m["rms_v_truth"]}


def main(argv=None):
    args = parse_args("helmholtz", argv)
    dev = resolve_device(args.device)
    dtype = run_dtype(dev)
    stats = RunStats(dev)
    T = T_QUICK if args.quick else T_FULL
    m, seconds = run(dev, dtype, T, args.seed)
    ok = gates(m)
    results = {
        "config": {"quick": args.quick, "T": T, "n_sites": 25, "seed": args.seed,
                   "dtype": str(dtype).removeprefix("torch."), "form": "sequential covariance"},
        "metrics": m,
        "gates": ok,
        "ok": all(ok.values()),
        "meta": {"training_time": seconds, **stats.meta()},
    }
    dump_results(args.out, "helmholtz_st", results)
    return results


if __name__ == "__main__":
    main()

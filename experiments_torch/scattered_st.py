"""Scattered spatio-temporal sensor experiment on the PyTorch port
(counterpart of `experiments/scattered_st.py`).

Raw (t, x, y, value) rows from 1-4 moving sensors at each of 200 random
times (`--quick`: 60) of the field sin(1.2 t + 2 x) cos(1.5 y) with noise
0.05, 20 % of the rows held out. `zoo.spatio_temporal.scattered_st_gp`
groups the rows by time behind a time-varying H over 12 k-means inducing
sites (Matérn-3/2 (1.5) x RBF (0.8, 0.8)); on the card the parallel
covariance form runs, on the CPU the sequential one, as the JAX driver
chooses by backend. Reported: the lml, the posterior at the training rows
through the `unsort` round trip, and `scattered_st_predict` at the held-out
rows (scored against their noisy values and the noise-free field). Gates:
finite metrics; at full size with seed 0, the held-out RMSE and NLPD within
5 % of the JAX package's record (`results/scattered_st.json`).

Run: python3 experiments_torch/scattered_st.py [--quick] [--device cpu]
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
from physs_gp_tpu_torch.zoo.spatio_temporal import scattered_st_gp, scattered_st_predict  # noqa: E402

NOISE = 0.05
N_INDUCING = 12
TIMES_FULL, TIMES_QUICK = 200, 60
# the JAX package's full-size run, seed 0 (results/scattered_st.json)
REFERENCE = {"rmse_test": 0.07847013049499373, "nlpd_test": -0.9915016989449238}
REFERENCE_TOL = 0.05


def field(t, s):
    """The field sin(1.2 t + 2 x) cos(1.5 y)."""
    return np.sin(1.2 * t + 2.0 * s[..., 0]) * np.cos(1.5 * s[..., 1])


def rows(n_times=TIMES_FULL, seed=0):
    """(train rows, test rows) [N, 4] = (t, x, y, value), with the JAX
    driver's generator calls."""
    rng = np.random.default_rng(seed)
    out = []
    for tk in np.sort(rng.uniform(0, 8, n_times)):
        for _ in range(rng.integers(1, 5)):  # 1-4 moving sensors per step
            s = rng.uniform(-1, 1, 2)
            out.append([tk, s[0], s[1], field(tk, s[None])[0] + NOISE * rng.normal()])
    A = np.array(out)
    test = rng.uniform(size=A.shape[0]) < 0.2
    return A[~test], A[test]


def build(train, Z, dtype, device, parallel=True, sqrt=False, chunk_size=None):
    """(model, data) on the training rows; Z=None takes N_INDUCING k-means
    sites."""
    kw = dict(dtype=dtype, device=device)
    return scattered_st_gp(
        train[:, :3], train[:, 3], Z=Z, n_inducing=N_INDUCING,
        k_time=Matern32(lengthscale=1.5, variance=1.0, **kw), k_space=rbf([0.8, 0.8], 1.0, **kw),
        noise=NOISE ** 2, parallel=parallel, sqrt=sqrt, chunk_size=chunk_size, **kw,
    )


def outputs(model, data, test):
    """lml, the posterior at the training rows through the `unsort` round
    trip and `scattered_st_predict` at the test rows, as numpy arrays."""
    with torch.no_grad():
        lml = model.log_marginal_likelihood()
        post = model.posterior()
        pred = scattered_st_predict(model, data, test[:, :3])
    return {"lml": numpy(lml), "post_mean": numpy(data.unsort(post.mean))[:, 0],
            "post_var": numpy(data.unsort(post.var))[:, 0], "pred_mean": numpy(pred.mean)[:, 0],
            "pred_var": numpy(pred.var)[:, 0]}


def metrics(out, train, test):
    """The experiment's metrics from `outputs`: the training rows against the
    noise-free field, the held-out rows against their noisy values (as the
    reference scores y_test) and the noise-free field."""
    truth_train = field(train[:, 0], train[:, 1:3])
    post_mean, pred_mean = (out[k].astype(np.float64) for k in ("post_mean", "pred_mean"))
    return {
        "lml": float(out["lml"]),
        "rmse_train_rows": rmse(post_mean, truth_train),
        "nlpd_train_rows": nlpd(truth_train, post_mean, out["post_var"] + NOISE ** 2),
        "rmse_test": rmse(pred_mean, test[:, 3]),
        "nlpd_test": nlpd(test[:, 3], pred_mean, out["pred_var"] + NOISE ** 2),
        "rmse_test_vs_truth": rmse(pred_mean, field(test[:, 0], test[:, 1:3])),
    }


def run(device, dtype, quick=False, seed=0):
    """The experiment on `device` in `dtype`, in the parallel form on the
    card and the sequential one on the CPU: (metrics, seconds in the model,
    row counts)."""
    parallel = torch.device(device).type == "cuda"
    train, test = rows(TIMES_QUICK if quick else TIMES_FULL, seed)
    with Timer(device) as tm:
        out = outputs(*build(train, None, dtype, device, parallel), test)
    counts = {"n_rows": train.shape[0] + test.shape[0], "n_test_rows": test.shape[0]}
    return metrics(out, train, test), tm.seconds, counts


def gates(m, quick=False, seed=0):
    """Finite metrics; at full size with seed 0, the held-out RMSE and NLPD
    within REFERENCE_TOL of the JAX record."""
    out = {"finite": bool(np.all(np.isfinite(list(m.values()))))}
    if not quick and seed == 0:
        for k, ref in REFERENCE.items():
            out[f"{k}_within_5pct_of_jax"] = abs(m[k] - ref) <= REFERENCE_TOL * abs(ref)
    return out


def main(argv=None):
    args = parse_args("scattered_st", argv)
    dev = resolve_device(args.device)
    dtype = run_dtype(dev)
    stats = RunStats(dev)
    m, seconds, counts = run(dev, dtype, args.quick, args.seed)
    ok = gates(m, args.quick, args.seed)
    results = {
        "config": {"quick": args.quick, **counts, "seed": args.seed,
                   "dtype": str(dtype).removeprefix("torch."),
                   "form": ("parallel" if dev.type == "cuda" else "sequential") + " covariance",
                   "reference": REFERENCE},
        "metrics": m,
        "gates": ok,
        "ok": all(ok.values()),
        "meta": {"training_time": seconds, **stats.meta()},
    }
    dump_results(args.out, "scattered_st", results)
    return results


if __name__ == "__main__":
    main()

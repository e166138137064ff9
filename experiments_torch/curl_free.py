"""Curl-free vector-field experiment on the PyTorch port (counterpart of
`experiments/curl_free.py`).

A 2-D curl-free field (the gradient of φ = sin(x) cos(y)) observed with
noise 0.05 at 120 scattered points (`--quick`: 40), the curl-free
derivative-operator GP (`zoo.phi_ml.curl_free_gp`, no training, as the
reference) predicted at 200 held-out points (`--quick`: 60) through
`predict_f` and `predict_y`, against one independent RBF `BatchGP` per
component. Gates: finite metrics, `rmse < rmse_independent_gp`.

Run: python3 experiments_torch/curl_free.py [--quick] [--device cpu]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from experiments_torch.common import (  # noqa: E402
    RunStats, Timer, dump_results, nlpd, numpy, parse_args, resolve_device, rmse, run_dtype,
)
from physs_gp_tpu_torch.kernels.rbf import rbf  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.models.batch_gp import BatchGP  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.phi_ml import curl_free_gp  # noqa: E402


NOISE = 0.05
SIZES = {False: (120, 200), True: (40, 60)}  # quick: (training, test) points


def field(X):
    """∇φ with φ = sin(x) cos(y): curl-free by construction."""
    x, y = X[:, 0], X[:, 1]
    return np.stack([np.cos(x) * np.cos(y), -np.sin(x) * np.sin(y)], axis=1)


def inputs(quick=False, seed=0):
    """(X, Y, Xs, truth), with the JAX driver's generator calls."""
    rng = np.random.default_rng(seed)
    n_train, n_test = SIZES[quick]
    X = rng.uniform(-2, 2, (n_train, 2))
    Y = field(X) + NOISE * rng.normal(size=(n_train, 2))
    Xs = rng.uniform(-1.8, 1.8, (n_test, 2))
    return X, Y, Xs, field(Xs)


def run(device, dtype, quick=False, seed=0):
    """The experiment on `device` in `dtype`: (metrics, seconds in the
    curl-free model)."""
    kw = dict(dtype=dtype, device=device)
    X, Y, Xs, truth = inputs(quick, seed)
    xs = torch.as_tensor(Xs, **kw)
    with torch.no_grad():
        with Timer(device) as tm:
            m = curl_free_gp(X, Y, noise=NOISE ** 2, **kw)
            pred = m.predict_f(xs)
            pred_y = m.predict_y(xs)  # observation space
        # independent-output baseline: one RBF GP per component
        base = [BatchGP(X, Y[:, c:c + 1], rbf([1.0, 1.0], 1.0, **kw),
                        Gaussian(positive_param(NOISE ** 2, **kw)), **kw).predict_f(xs)
                for c in range(2)]
    base_mean = np.stack([numpy(p.mean)[:, 0] for p in base], axis=1)
    mean_y = numpy(pred_y.mean)
    metrics = {
        "rmse": rmse(pred.mean, truth),
        "rmse_independent_gp": rmse(base_mean, truth),
        "nlpd": nlpd(truth.reshape(mean_y.shape), mean_y, pred_y.var),
    }
    return metrics, tm.seconds


def gates(metrics):
    return {"finite": bool(np.all(np.isfinite(list(metrics.values())))),
            "rmse_below_independent_gp": metrics["rmse"] < metrics["rmse_independent_gp"]}


def main(argv=None):
    args = parse_args("curl_free", argv)
    dev = resolve_device(args.device)
    dtype = run_dtype(dev)
    stats = RunStats(dev)
    metrics, seconds = run(dev, dtype, args.quick, args.seed)
    n_train, n_test = SIZES[args.quick]
    ok = gates(metrics)
    results = {
        "config": {"quick": args.quick, "n_train": n_train, "n_test": n_test,
                   "seed": args.seed, "dtype": str(dtype).removeprefix("torch.")},
        "metrics": metrics,
        "gates": ok,
        "ok": all(ok.values()),
        "meta": {"training_time": seconds, **stats.meta()},
    }
    dump_results(args.out, "curl_free", results)
    return results


if __name__ == "__main__":
    main()

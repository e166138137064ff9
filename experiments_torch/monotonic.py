"""Monotonic time-series experiment on the PyTorch port (counterpart of
`experiments/monotonic.py`).

Noisy samples of a monotone curve with a gap over its steep rise (t in
[1.2, 2.8] unobserved) and a Probit head on f' >= 0 at dense collocation
points. Arms:

- constrained CVI: `zoo.physics.monotonic_cvi_gp`, CVI steps at lr 0.5;
- unconstrained: the same model with the probit column masked
  (`constrained=False`);
- constrained VGP: `zoo.diff.deriv_vgp` with natural-gradient steps at
  lr 0.5 (the reference's diff_vgp arm).

Headline metrics are the RMSE and NLPD inside the gap and the derivative
violation rate on the test grid, for both CVI arms. Gates (the JAX
package's `tests/test_physics.py` and `results/monotonic.json`): the
constrained violation rate 0, `rmse_gap < rmse_gap_unconstrained`,
`rmse_gap <= 0.10`, and the VGP arm's violation rate 0.

Run: python3 experiments_torch/monotonic.py [--quick] [--device cpu]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from experiments_torch.common import (  # noqa: E402
    RunStats, Timer, dump_results, numpy, parse_args, resolve_device, rmse,
)
from physs_gp_tpu_torch.kernels.matern import Matern72  # noqa: E402
from physs_gp_tpu_torch.likelihoods.gaussian import Gaussian  # noqa: E402
from physs_gp_tpu_torch.likelihoods.nongaussian import Probit  # noqa: E402
from physs_gp_tpu_torch.metrics.metrics import gaussian_nlpd  # noqa: E402
from physs_gp_tpu_torch.utils.params import positive_param  # noqa: E402
from physs_gp_tpu_torch.zoo.diff import deriv_vgp  # noqa: E402
from physs_gp_tpu_torch.zoo.physics import monotonic_cvi_gp  # noqa: E402

GAP = (1.2, 2.8)  # unobserved window over the sigmoid's steep rise


def _truth(t):
    return 2.0 / (1.0 + np.exp(-3.0 * (t - 2.0))) + 0.1 * t


def _fit_cvi(m, iters, gen, dev):
    elbos = []
    with Timer(dev) as tm:
        for _ in range(iters):
            m, e = m.step_with_elbo(0.5, generator=gen)
            elbos.append(e)
    return m, [float(e) for e in numpy(torch.stack(elbos))], tm.seconds


def _eval(m, ts, noise):
    """(mean f, var y, mean f') on the test grid; heads are (f, f')."""
    pred = m.predict_f(ts)
    mean, var = numpy(pred.mean), numpy(pred.var)
    return mean[:, 0], var[:, 0] + noise ** 2, mean[:, 1]


def main(argv=None):
    args = parse_args("monotonic", argv)
    dev = resolve_device(args.device)
    kw = dict(dtype=torch.float64, device=dev)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stats = RunStats(dev)
    n_data = 30
    n_coll = 40 if args.quick else 100
    iters = args.iters or (80 if args.quick else 300)
    noise = 0.15

    # observed times avoid the gap; collocation spans it densely
    t_pool = rng.uniform(0, 4, 4 * n_data)
    t_data = np.sort(t_pool[(t_pool < GAP[0]) | (t_pool > GAP[1])][:n_data])
    y_data = _truth(t_data) + noise * rng.normal(size=t_data.size)
    t_coll = np.linspace(0, 4, n_coll)
    t_test = np.linspace(0.05, 3.95, 120)
    in_gap = (t_test > GAP[0]) & (t_test < GAP[1])
    truth = _truth(t_test)
    ts = torch.as_tensor(t_test, **kw)

    m_c, e_c, t_fit = _fit_cvi(monotonic_cvi_gp(t_data, y_data, t_coll, noise=noise ** 2,
                                                device=dev), iters, gen, dev)
    m_u, _, t_fit_u = _fit_cvi(monotonic_cvi_gp(t_data, y_data, t_coll, noise=noise ** 2,
                                                constrained=False, device=dev), iters, gen, dev)
    mean_c, vary_c, d_c = _eval(m_c, ts, noise)
    mean_u, vary_u, d_u = _eval(m_u, ts, noise)

    # the batch-VI arm: the same data, the Probit column at the collocation grid
    t_all = np.concatenate([t_data, t_coll])
    Y_vgp = np.full((t_all.shape[0], 2), np.nan)
    Y_vgp[:n_data, 0] = y_data
    Y_vgp[n_data:, 1] = 1.0  # f' >= 0 pseudo-observations
    m_vgp = deriv_vgp(
        t_all[:, None], Y_vgp, time_diff=1, space_diff=None,
        kernel=Matern72(lengthscale=1.0, variance=1.0, **kw),
        liks=[Gaussian(variance=positive_param(noise ** 2, **kw)), Probit(nu=1e-2)],
        Z=np.linspace(0, 4, 30 if args.quick else 50)[:, None], whiten=False, **kw,
    )
    with torch.no_grad(), Timer(dev) as tv:
        for _ in range(iters):
            m_vgp.natural_gradient_update(0.5)
    pv = numpy(m_vgp.predict_f(ts[:, None]).mean)
    mean_v, d_v = pv[:, 0], pv[:, 1]

    def viol(d):
        return float(np.mean(d < -1e-3))

    def nlpd(mean, var):
        t = [torch.as_tensor(x[in_gap], dtype=torch.float64) for x in (truth, mean, var)]
        return float(gaussian_nlpd(*t))

    metrics = {
        "rmse_gap": rmse(mean_c[in_gap], truth[in_gap]),
        "rmse_gap_unconstrained": rmse(mean_u[in_gap], truth[in_gap]),
        "nlpd_gap": nlpd(mean_c, vary_c),
        "nlpd_gap_unconstrained": nlpd(mean_u, vary_u),
        "deriv_violation_rate": viol(d_c),
        "deriv_violation_rate_unconstrained": viol(d_u),
        "rmse": rmse(mean_c, truth),
        "rmse_unconstrained": rmse(mean_u, truth),
        "final_elbo": e_c[-1],
        "rmse_gap_vgp": rmse(mean_v[in_gap], truth[in_gap]),
        "deriv_violation_rate_vgp": viol(d_v),
    }
    gates = {
        "violation_rate_0": metrics["deriv_violation_rate"] == 0.0,
        "rmse_gap_below_unconstrained": metrics["rmse_gap"] < metrics["rmse_gap_unconstrained"],
        "rmse_gap_at_most_0.10": metrics["rmse_gap"] <= 0.10,
        "vgp_violation_rate_0": metrics["deriv_violation_rate_vgp"] == 0.0,
    }
    results = {
        "config": {"quick": args.quick, "iters": iters, "gap": list(GAP),
                   "n_data": int(t_data.size), "seed": args.seed, "dtype": "float64"},
        "metrics": metrics,
        "gates": gates,
        "ok": all(gates.values()),
        "meta": {"training_time": t_fit, "training_time_unconstrained": t_fit_u,
                 "training_time_vgp": tv.seconds, **stats.meta()},
    }
    dump_results(args.out, "monotonic", results)
    return results


if __name__ == "__main__":
    main()

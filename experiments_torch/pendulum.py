"""Pendulum experiment on the PyTorch port: nonlinear-physics CVI
extrapolation (counterpart of `experiments/pendulum.py`).

Noisy angle data on the first half of the window, the nonlinear residual
f'' + c f' + w² sin(f) = 0 enforced by collocation through the whole window
(`zoo.physics.nonlinear_ode_cvi_gp`, Gauss-Newton site steps at lr 0.3);
RMSE and NLPD on the unobserved half against a physics-off arm (a zero
residual). Gates (the JAX package's `tests/test_physics.py`):
`rmse_extrap_physics_on < 0.05`, `< 0.1 * rmse_extrap_physics_off`, and the
final ELBO above the first.

Run: python3 experiments_torch/pendulum.py [--quick] [--device cpu]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.integrate import solve_ivp  # noqa: E402

from experiments_torch.common import (  # noqa: E402
    RunStats, Timer, dump_results, numpy, parse_args, resolve_device, rmse,
)
from physs_gp_tpu_torch.kernels.matern import Matern72  # noqa: E402
from physs_gp_tpu_torch.zoo.physics import nonlinear_ode_cvi_gp  # noqa: E402


def main(argv=None):
    args = parse_args("pendulum", argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stats = RunStats(dev)
    c_true, w2 = 0.3, 9.0
    horizon, data_end = 5.0, 2.5
    n_data = 25 if args.quick else 40
    n_coll = 40 if args.quick else 80
    iters = args.iters or (60 if args.quick else 250)

    sol = solve_ivp(
        lambda s, x: [x[1], -c_true * x[1] - w2 * np.sin(x[0])],
        (0, horizon), [1.2, 0.0], dense_output=True, rtol=1e-9,
    )
    t_data = np.sort(rng.uniform(0, data_end, n_data))
    y_data = sol.sol(t_data)[0] + 0.03 * rng.normal(size=t_data.size)
    t_coll = np.linspace(0, horizon, n_coll)

    def residual(f):  # heads (f, f', f'')
        return f[..., 2] + c_true * f[..., 1] + w2 * torch.sin(f[..., 0])

    def zero_residual(f):
        return torch.zeros_like(f[..., 0])

    def train(res_fn):
        m = nonlinear_ode_cvi_gp(
            t_data, y_data, t_coll, res_fn, n_heads=3,
            kernel=Matern72(lengthscale=1.0, variance=1.0, dtype=torch.float64, device=dev),
            noise=0.03 ** 2, coll_noise=1e-4, n_mc=16, device=dev,
        )
        elbos = []
        with Timer(dev) as tm:
            for _ in range(iters):
                m, e = m.step_with_elbo(0.3, hessian="gauss_newton", generator=gen)
                elbos.append(e)
        return m, [float(e) for e in numpy(torch.stack(elbos))], tm.seconds

    m_on, e_on, t_on = train(residual)
    m_off, _, t_off = train(zero_residual)

    t_test = np.linspace(data_end + 0.1, horizon, 50)
    truth = sol.sol(t_test)[0]
    ts = torch.as_tensor(t_test, dtype=torch.float64, device=dev)
    p_on, p_off = m_on.predict_f(ts), m_off.predict_f(ts)
    # the model's predictive density: the Gaussian data head only (the
    # derivative heads get NaN targets)
    y_test = np.stack([truth] + [np.full(truth.shape, np.nan)] * 2, axis=1)
    nlpd = m_on.nlpd(ts, torch.as_tensor(y_test, dtype=torch.float64, device=dev))

    metrics = {
        "rmse_extrap_physics_on": rmse(p_on.mean[:, 0], truth),
        "rmse_extrap_physics_off": rmse(p_off.mean[:, 0], truth),
        "nlpd_extrap_physics_on": float(numpy(nlpd)),
        "final_elbo": e_on[-1],
        "first_elbo": e_on[0],
    }
    gates = {
        "rmse_on_below_0.05": metrics["rmse_extrap_physics_on"] < 0.05,
        "rmse_on_below_0.1_off": metrics["rmse_extrap_physics_on"]
        < 0.1 * metrics["rmse_extrap_physics_off"],
        "final_elbo_above_first": bool(np.isfinite(e_on[-1]) and e_on[-1] > e_on[0]),
    }
    results = {
        "config": {"quick": args.quick, "iters": iters, "c": c_true, "w2": w2,
                   "seed": args.seed, "dtype": "float64"},
        "metrics": metrics,
        "gates": gates,
        "ok": all(gates.values()),
        "meta": {"training_time": t_on, "training_time_physics_off": t_off, **stats.meta()},
    }
    dump_results(args.out, "pendulum", results)
    return results


if __name__ == "__main__":
    main()

"""Allen-Cahn outcome gate of the PyTorch port, on the card.

The Allen-Cahn experiment's quick configuration (`experiments/ac.py
--quick`: T = 36, Ns = Nc = 8, n_mc = 16, 300 Gauss-Newton
natural-gradient iterations at lr 0.3; Matérn-5/2 (lengthscale 0.8) x RBF
(lengthscale 0.6), noise 0.02², collocation noise 1e-5), in float32 with the
sequential square-root filters, as the experiment's accelerator arm runs
it. It trains the model twice, with the physics on and with a residual that
returns zeros (physics off), each with its own generator seeded once (fresh
Monte-Carlo noise every iteration), and reports the extrapolation RMSE of
the grid heads' posterior mean against the simulated field past the data
cut. Gate, as the experiment's `physics_ok`: on < 0.5 * off.

    python3 scripts/port/physics_outcome.py [--device cuda] [--iters 300]

Prints one JSON line with both RMSEs, the final ELBOs and the wall times,
and exits non-zero if the gate fails. The data helpers (`simulate`,
`inputs`, `build`) are numpy and the port only; `make_physics_golden.py`
and `chip_smoke.py` use them too.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

EPS, T_END, CUT = 0.08, 3.5, 1.0
QUICK = dict(T=36, Ns=8, Nc=8, n_mc=16, iters=300)
FULL = dict(T=56, Ns=10, Nc=12, n_mc=32)  # the experiment's full width
LR = 0.3


def simulate(eps=EPS, t_end=T_END, nx=101, nt=4001):
    """Explicit finite-difference solve with Neumann boundaries (the
    experiment's `simulate`)."""
    xs = np.linspace(-1, 1, nx)
    dx = xs[1] - xs[0]
    dt = t_end / (nt - 1)
    u = 0.5 * np.sin(0.5 * np.pi * xs)
    U = [u.copy()]
    for _ in range(nt - 1):
        uxx = np.zeros_like(u)
        uxx[1:-1] = (u[2:] - 2 * u[1:-1] + u[:-2]) / dx**2
        uxx[0], uxx[-1] = uxx[1], uxx[-2]
        u = u + dt * (eps * uxx + u - u**3)
        U.append(u.copy())
    return xs, np.array(U)


def inputs(T, Ns, Nc, seed=0):
    """(t [T], Y [T, Ns] with NaN past the cut, Z [Ns, 1], coll [Nc, 1],
    F [T, Ns] the noise-free field), as the experiment makes them."""
    rng = np.random.default_rng(seed)
    xs, U = simulate()
    t = np.linspace(0, T_END, T)
    Z = np.linspace(-0.9, 0.9, Ns)[:, None]
    coll = np.linspace(-0.9, 0.9, Nc)[:, None]
    it = np.clip((t / T_END * (U.shape[0] - 1)).astype(int), 0, U.shape[0] - 1)
    F = np.array([np.interp(Z[:, 0], xs, U[k]) for k in it])
    Y = F + 0.02 * rng.normal(size=F.shape)
    Y[t > CUT, :] = np.nan
    return t, Y, Z, coll, F


def extrapolation_rows(t):
    """The window the experiment scores: t > cut + 0.1."""
    return t > CUT + 0.1


def build(t, Y, Z, coll, n_mc, dtype, sqrt, device, physics=True):
    """The experiment's model in the port; physics=False swaps the residual
    for one that returns zeros."""
    import torch

    from physs_gp_tpu_torch.kernels.matern import Matern52
    from physs_gp_tpu_torch.kernels.rbf import RBF
    from physs_gp_tpu_torch.utils.params import positive_param
    from physs_gp_tpu_torch.zoo.physics import allen_cahn_gp

    kw = dict(dtype=dtype, device=device)
    model = allen_cahn_gp(
        t, Y, Z, coll, epsilon=EPS,
        k_time=Matern52(lengthscale=0.8, variance=1.0, **kw),
        k_space=RBF(lengthscales=positive_param(torch.tensor([0.6], **kw)),
                    variance=positive_param(1.0, **kw)),
        noise=0.02**2, coll_noise=1e-5, n_mc=n_mc, dtype=dtype, sqrt=sqrt, device=device,
    )
    if not physics:
        Nc = coll.shape[0]
        model.likelihood.residual.fn = lambda f: torch.zeros(f.shape[:-1] + (Nc,), dtype=f.dtype,
                                                             device=f.device)
    return model


def train(model, iters, seed, lr=LR):
    """`iters` Gauss-Newton steps, fresh draws from one seeded generator;
    returns (model, final ELBO tensor, wall seconds)."""
    import torch

    gen = torch.Generator(device=model.t.device).manual_seed(seed)
    t0 = time.perf_counter()
    elbo = None
    for _ in range(iters):
        model, elbo = model.step_with_elbo(lr, hessian="gauss_newton", generator=gen)
    if model.t.is_cuda:
        torch.cuda.synchronize()
    return model, elbo, time.perf_counter() - t0


def run(device="cuda", iters=QUICK["iters"], seed=0):
    """Both trainings; returns the result dict (RMSEs, ELBOs, walls, gate)."""
    import torch

    cfg = QUICK
    t, Y, Z, coll, F = inputs(cfg["T"], cfg["Ns"], cfg["Nc"], seed)
    later = extrapolation_rows(t)
    out = {"config": dict(cfg, iters=iters, dtype="float32", form="sequential square-root",
                          device=device)}
    for name, physics in (("on", True), ("off", False)):
        model = build(t, Y, Z, coll, cfg["n_mc"], torch.float32, True, device, physics)
        model, elbo, wall = train(model, iters, seed)
        mean = model.posterior().mean[:, :cfg["Ns"]].double().cpu().numpy()
        out[f"rmse_extrap_physics_{name}"] = float(np.sqrt(np.mean((mean[later] - F[later]) ** 2)))
        out[f"final_elbo_physics_{name}"] = float(elbo)
        out[f"train_seconds_physics_{name}"] = wall
    out["physics_ok"] = out["rmse_extrap_physics_on"] < 0.5 * out["rmse_extrap_physics_off"]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=QUICK["iters"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("physics_outcome: no CUDA device", file=sys.stderr)
        return 1
    res = run(args.device, args.iters, args.seed)
    print(json.dumps(res))
    return 0 if res["physics_ok"] else 1


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    sys.exit(main())

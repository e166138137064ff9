"""Standardised posterior draws of config-5 against `predict_f`, by head group.

Builds `build_config5(T, 25 000)` on the card, takes 2 natural-gradient
steps at lr 0.5, draws `CVIGP.sample_f(S, t_new)` at 1000 new times from
each seed's generator and prints, for the grid heads (0-15) and the
collocation heads (16-31), the pooled mean and variance of
z = (f - mean) / sd against `predict_f` at the same times, the spread of the
per-sample variances, and the smallest and median predictive sd. Run per
type to separate sampling noise from rounding:

    python3 scripts/port/sample_moments.py [--T 100000] [--samples 16]
        [--seeds 24,25] [--dtypes float32,float64] [--sqrt]
"""
import argparse
import os
import sys

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=100_000)
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--seeds", default="24,25")
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--sqrt", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    os.environ.setdefault("PHYSS_KZZ_JITTER", "1e-4")
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5

    for name in args.dtypes.split(","):
        dtype = getattr(torch, name)
        model = build_config5(args.T, 25_000, dtype=dtype, sqrt=args.sqrt)
        model, _ = natgrad_scan(model, 0.5, n_steps=2, nan_guard=False)
        t_new = torch.as_tensor(np.sort(np.random.default_rng(23).uniform(0, 100, 1000)),
                                dtype=dtype, device="cuda")
        pf = model.predict_f(t_new)
        sd = torch.sqrt(pf.var)
        for seed in (int(s) for s in args.seeds.split(",")):
            fs = model.sample_f(torch.Generator(device="cuda").manual_seed(seed), args.samples,
                                t_new=t_new)
            z = (fs - pf.mean) / sd
            for group, cols in (("grid", slice(0, 16)), ("collocation", slice(16, 32))):
                zg = z[..., cols]
                per = zg.reshape(args.samples, -1).var(1)
                print(f"[{name} seed {seed}] {group} heads: z mean {float(zg.mean()):.4f} "
                      f"var {float(zg.var()):.4f}; per-sample var min {float(per.min()):.4f} "
                      f"max {float(per.max()):.4f}; sd min {float(sd[:, cols].min()):.3e} "
                      f"median {float(sd[:, cols].median()):.3e}")
        del model, pf, fs, z


if __name__ == "__main__":
    main()

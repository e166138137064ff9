"""Count the kernel-wrapper calls of one CVI step (and, optionally, one
prediction, or one Adam step's objective forward and backward) of the port
by kernel and operand shape.

    python3 scripts/port/launch_census.py
        [--model temporal|config5|allen_cahn|scattered|helmholtz|markov] [--sqrt] [--T 100000]
        [--chunk 50000] [--blocks 1024] [--predict 1000] [--train]
        [--device cpu|cuda] [--dtype float32|float64]

`--model allen_cahn` is the Allen-Cahn experiment at its full width
(`experiments_torch/ac.py`'s `FULL`: T = 56, Ns = 10, Nc = 12, n_mc = 32; sequential
filters, so `--T`, `--chunk` and `--blocks` do not apply) and its step is
a Gauss-Newton step at lr 0.3 with a seeded generator.

`--model scattered` is the scattered-sensor model (`scattered_st_gp`,
parallel scans) at T times, 25 a unit as in the experiment, with its 12
inducing sites: it has no CVI step, so the parts counted are one
`log_marginal_likelihood()`, one `posterior()` and one
`scattered_st_predict` at the held-out 20 % of the rows (chip_smoke.py runs
it at `--T 100000 --chunk 25000 --blocks 256`).

`--model markov` is the trend + quasi-periodic model of
`markov_outcome.full_model` (d = 30, a `LinearMean`, parallel scans; chip_smoke.py
runs it at `--T 100000 --chunk 25000 --blocks 256`): one
`log_marginal_likelihood()`, one `predict_f` at `--predict` new times (1000
if not given), and one natural-gradient step of the Poisson `CVIGP` on its
counts (covariance form; `--sqrt` changes the first two only).

`--model helmholtz` is the Helmholtz experiment at its full size (T = 64,
Ns = 25, state D = 100, sequential as the experiment runs it; `--sqrt`
the square-root form): one `log_marginal_likelihood()` and one
`helmholtz_st_predict` at its 12 new sites.

`--train` adds, after the step, the calls of `get_objective()` (the
forward of an Adam step) and of its backward (`backward()` to every
trainable raw), each counted on its own.

Each call of a wrapper with a non-empty batch is one launch of its kernel
on the card (on the CPU the wrapper runs the kernel's plain version), so
the counts are what `ops.cuda.launch_counts()` reads on the card, split by
shape. The shapes say where a kernel's launches run: at a scan's batch (the
number of blocks, or twice it for the stacked square-root pre-arrays) or at
a chunk's or the series' full width. Defaults: the temporal model at the
bench's settings (T = 100 000, chunk 50 000, 1024 blocks) on the CPU.
"""
import argparse
import collections
import os
import sys

import torch


def census(args):
    from physs_gp_tpu_torch.ops import sqrt_kalman
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan
    from physs_gp_tpu_torch.zoo import bench_configs

    calls = collections.Counter()

    def spy(module, attr, name, shape):
        wrapped = getattr(module, attr)

        def call(*a, **k):
            calls[name, shape(*a, **k)] += 1
            return wrapped(*a, **k)

        setattr(module, attr, call)

    def dims(x):
        return "x".join(str(n) for n in x.shape)

    spy(bl, "batch_bmm", "bmm", lambda A, B, ta=False, tb=False:
        f"[{dims(A)}]{'^T' if ta else ''} @ [{dims(B)}]{'^T' if tb else ''}")
    spy(bl, "batch_solve", "gj_solve", lambda M, R: f"[{dims(M)}] r={R.shape[-1]}")
    spy(bl, "batch_solve_logdet", "gj_solve_logdet", lambda M, R: f"[{dims(M)}] r={R.shape[-1]}")
    spy(bc, "batch_cholesky", "chol", lambda A, eps_rel=None: f"[{dims(A)}]")
    spy(sqrt_kalman, "batch_tria", "lq", lambda B: f"[{dims(B)}]")
    spy(sqrt_kalman, "batch_chol_gram", "chol_gram", lambda X, Y=None, plus_eye=False:
        f"[{dims(X)}] + [{'-' if Y is None else dims(Y)}] plus_eye={int(plus_eye)}")

    os.environ["PHYSS_SCAN_BLOCKS"] = str(args.blocks)
    dtype = getattr(torch, args.dtype)
    if args.model == "scattered":
        import numpy as np

        import vector_field_outcome as vf

        from experiments_torch import scattered_st
        from physs_gp_tpu_torch.zoo.spatio_temporal import scattered_st_predict

        train, test = vf.scattered_rows_long(args.T, args.T / 25)
        model, data = scattered_st.build(train, np.load(vf.GOLDEN)["sc::in::Z"], dtype,
                                         args.device, sqrt=args.sqrt, chunk_size=args.chunk)
        out = {}
        with torch.no_grad():
            for part, run in (("lml", model.log_marginal_likelihood), ("posterior", model.posterior),
                              ("scattered_st_predict",
                               lambda: scattered_st_predict(model, data, test[:, :3]))):
                calls.clear()
                run()
                out[part] = dict(calls)
        return out
    if args.model == "markov":
        import markov_outcome as mo

        model, _ = mo.full_model(dtype, args.device, args.sqrt, T=args.T, chunk=args.chunk)
        t_new = torch.as_tensor(mo.new_times(args.T, args.predict or mo.FULL["n_new"]), dtype=dtype,
                                device=args.device)
        out = {}
        with torch.no_grad():
            for part, run in (("lml", model.log_marginal_likelihood),
                              ("predict_f", lambda: model.predict_f(t_new)),
                              ("cvi step", lambda: mo.cvi_full(args.device, dtype, T=args.T,
                                                               chunk=args.chunk, steps=1))):
                calls.clear()
                run()
                out[part] = dict(calls)
        return out
    if args.model == "helmholtz":
        import vector_field_outcome as vf

        from experiments_torch import helmholtz

        t, Z, Y, S_new = helmholtz.inputs(helmholtz.T_FULL)
        model = helmholtz.build(t, Z, Y, dtype, args.device, sqrt=args.sqrt)
        out = {}
        with torch.no_grad():
            for part, run in (("lml", model.log_marginal_likelihood),
                              ("helmholtz_st_predict", lambda: vf.helmholtz_st_predict(model, S_new))):
                calls.clear()
                run()
                out[part] = dict(calls)
        return out
    if args.model == "allen_cahn":
        from experiments_torch import ac

        cfg = ac.FULL
        t, Y, Z, coll, _ = ac.inputs(cfg["T"], cfg["Ns"], cfg["Nc"])
        model = ac.build(t, Y, Z, coll, cfg["n_mc"], dtype, args.sqrt, args.device)
        natgrad_scan(model, ac.LR, n_steps=1, hessian="gauss_newton",
                     generator=torch.Generator(device=args.device).manual_seed(0))
    else:
        build = getattr(bench_configs, f"build_{args.model}")
        model = build(args.T, args.chunk, dtype=dtype, sqrt=args.sqrt, device=args.device)
        natgrad_scan(model, 0.5, n_steps=1)
    out = {"step": dict(calls)}
    if args.predict:
        calls.clear()
        hi = float(model.t.max())
        t_new = torch.linspace(0.0, hi, args.predict, dtype=dtype, device=args.device)
        model.predict_f(t_new)
        out["predict_f"] = dict(calls)
    if args.train:
        calls.clear()
        loss = model.get_objective()
        out["objective forward"] = dict(calls)
        calls.clear()
        loss.backward()
        out["objective backward"] = dict(calls)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="temporal", choices=["temporal", "config5", "allen_cahn", "scattered", "helmholtz",
                                                        "markov"])
    p.add_argument("--sqrt", action="store_true")
    p.add_argument("--T", type=int, default=100_000)
    p.add_argument("--chunk", type=int, default=50_000)
    p.add_argument("--blocks", type=int, default=1024)
    p.add_argument("--predict", type=int, default=0)
    p.add_argument("--train", action="store_true")
    p.add_argument("--device", default="cpu")
    p.add_argument("--dtype", default="float32")
    args = p.parse_args()
    sys.path.insert(0, os.getcwd())
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    form = "square-root" if args.sqrt else "covariance"
    print(f"{args.model} {form} T={args.T} chunk={args.chunk} blocks={args.blocks} "
          f"{args.dtype} on {args.device}")
    for part, calls in census(args).items():
        print(f"{part}: {sum(calls.values())} calls")
        for (name, shape), n in sorted(calls.items(), key=lambda kv: (kv[0][0], -kv[1])):
            print(f"  {name:16s} {n:6d}  {shape}")


if __name__ == "__main__":
    main()

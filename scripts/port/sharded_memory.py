"""Peak memory of a rank of the time-sharded config-5 lml + gradient against
the unsharded run's, on the card.

    python3 scripts/port/sharded_memory.py [--n 4] [--chunk 25000] FORM:TYPE:T [...]

FORM is cov, fused or sqrt, TYPE float32 or float64 (e.g. sqrt:float64:100000).
For each run this process takes the unsharded surrogate lml and its gradient
(`chip_smoke._surrogate_lml_grad`) and its peak, then n ranks that share the
card (`parallel/ranks.py`, gloo) build config-5 with a ("t",) mesh, each its
T / n segment, and take the same, each reporting its peak; the card's memory
in use by all processes is sampled meanwhile. One line a run:
"[sharded memory] FORM TYPE T: unsharded X GiB; ranks [...] GiB, share Y; the
card at most Z GiB", or the error that stopped it (a run that does not fit
on the card fails alone; the next runs go on).
"""
import argparse
import gc
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import chip_smoke as cs  # noqa: E402


def _rank(rank, n, form, dtype_name, T, chunk):
    """One rank: its peak over the sharded lml + gradient, and the values."""
    import physs_gp_tpu_torch.ops.matrix  # noqa: F401  (TF32 off)
    from physs_gp_tpu_torch.parallel import sharded
    from physs_gp_tpu_torch.parallel.ranks import make_mesh
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5

    if form == "fused":
        os.environ["PHYSS_FUSED_COMBINE"] = "1"
    mesh = make_mesh((n,), ("t",), "cuda")
    model = build_config5(T, chunk, dtype=getattr(torch, dtype_name), sqrt=form == "sqrt",
                          device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sharded.reset_exchange_stats()
    t0 = time.perf_counter()
    lml, grad = cs._surrogate_lml_grad(model)
    torch.cuda.synchronize()
    return {"lml": lml, "grad": grad, "wall_s": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "exchange": sharded.exchange_stats()}


def main():
    from physs_gp_tpu_torch.parallel.ranks import start_ranks
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=25_000)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args()
    os.environ["PHYSS_KZZ_JITTER"] = "1e-4"
    for run in args.runs:
        form, dtype_name, T = run.split(":")
        T = int(T)
        tag = f"[sharded memory] {form} {dtype_name} T = {T}, n = {args.n}"
        try:
            if form == "fused":
                os.environ["PHYSS_FUSED_COMBINE"] = "1"
            model = build_config5(T, args.chunk, dtype=getattr(torch, dtype_name),
                                  sqrt=form == "sqrt", device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            lml1, grad1 = cs._surrogate_lml_grad(model)
            peak1 = torch.cuda.max_memory_allocated() / 2**30
            del model
        except torch.OutOfMemoryError as e:
            print(f"{tag}: the unsharded run does not fit: {str(e).splitlines()[0]}", flush=True)
            peak1 = lml1 = grad1 = None
        finally:
            os.environ.pop("PHYSS_FUSED_COMBINE", None)
        gc.collect()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"  # the ranks' allocators
        try:
            with cs._card_memory_sampler() as used:
                outs = start_ranks(_rank, args.n, args=(form, dtype_name, T, args.chunk),
                                   device="cuda", timeout=600.0).wait()
        except (RuntimeError, TimeoutError) as e:
            print(f"{tag}: the sharded run failed with the card at most {max(used) / 2**30:.2f} "
                  f"GiB in use (this process {(total - free) / 2**30:.2f} before the ranks): "
                  f"{str(e).strip().splitlines()[-1]}", flush=True)
            continue
        finally:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        peaks = [o["peak_gib"] for o in outs]
        line = (f"{tag}: ranks {[round(p, 2) for p in peaks]} GiB, "
                f"walls {[round(o['wall_s'], 3) for o in outs]} s; the card at most "
                f"{max(used) / 2**30:.2f} GiB of {total / 2**30:.2f} in use "
                f"({(total - free) / 2**30:.2f} before the ranks)")
        if peak1 is not None:
            r_lml = abs(outs[0]["lml"] - lml1) / abs(lml1)
            r_grad = float(abs(outs[0]["grad"] - grad1).max() / abs(grad1).max())
            line += (f"; unsharded {peak1:.2f} GiB, share {max(peaks) / peak1:.3f}; lml rel "
                     f"{r_lml:.2e}, gradient rel {r_grad:.2e}")
        print(line, flush=True)
        print(f"{tag}: rank 0 exchanges {outs[0]['exchange']}", flush=True)


if __name__ == "__main__":
    main()

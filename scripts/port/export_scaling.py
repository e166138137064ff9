"""Time `utils/serving.export_predictor` on config-5's `predict_f` at several
lengths, on the card (or, with `--cpu`, on the host's CPU).

    python3 scripts/port/export_scaling.py [--sqrt | --fused] [--float64] [--cpu]
        [--steps N] T:chunk[:blocks[:new]] ...

For each case it builds `build_config5(T, chunk)` (float32 unless
`--float64`), takes `--steps` natural-gradient steps (default 1), sets
PHYSS_SCAN_BLOCKS to `blocks` (default 256) and exports `predict_f` at `new`
sorted new times (default 1000). It prints the export's wall time (the
trace, then `torch.export.save` into bytes), the program's nodes over all
its submodules, the artifact's bytes, the load's wall time
(`load_predictor`), the loaded program's max abs difference from the live
`predict_f` and each one's kernel launches. The export's size follows the
number of chunks and the scan's sequential levels, not T. A CPU run's times
are the host's, not the card's.
"""
import io
import os
import subprocess
import sys
import time

import numpy as np
import torch


def nodes(program) -> int:
    """Nodes of an exported program's graph and its submodules' graphs."""
    return sum(len(m.graph.nodes) for m in program.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule))


def main():
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, repo)
    from physs_gp_tpu_torch.ops import cuda as kernels
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan
    from physs_gp_tpu_torch.utils import serving
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5

    args = sys.argv[1:]
    sqrt, fused, f64, cpu = ("--sqrt" in args, "--fused" in args, "--float64" in args,
                             "--cpu" in args)
    print(f"[export] torch {torch.__version__}, fx stack-trace switch "
          f"{'present' if hasattr(torch.fx.config, 'do_not_emit_stack_traces') else 'absent'}")
    steps = 1
    if "--steps" in args:
        steps = int(args.pop(args.index("--steps") + 1))
    cases = [a for a in args if not a.startswith("--")]
    if not cpu:
        if not torch.cuda.is_available():
            print("export_scaling: no CUDA device", file=sys.stderr)
            return 1
        print("[export] " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    device = "cpu" if cpu else "cuda"
    dtype = torch.float64 if f64 else torch.float32
    if fused:
        os.environ["PHYSS_FUSED_COMBINE"] = "1"
    os.environ.setdefault("PHYSS_KZZ_JITTER", "1e-4")
    form = "sqrt" if sqrt else "cov fused" if fused else "cov"

    def sync():
        if not cpu:
            torch.cuda.synchronize()

    for case in cases:
        T, chunk, blocks, new = (list(map(int, case.split(":"))) + [256, 1000])[:4]
        os.environ["PHYSS_SCAN_BLOCKS"] = str(blocks)
        model, _ = natgrad_scan(build_config5(T, chunk, dtype=dtype, sqrt=sqrt, device=device),
                                0.5, n_steps=steps, nan_guard=False)
        ts = torch.as_tensor(np.sort(np.random.default_rng(22).uniform(0, 100, new)),
                             dtype=dtype, device=device)
        sync()
        t0 = time.perf_counter()
        module = serving._Predictor(model, "predict_f")
        with serving._frozen(module):
            program = torch.export.export(module, (ts,), strict=False)
        t1 = time.perf_counter()
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blob = buf.getvalue()
        t2 = time.perf_counter()
        serve = serving.load_predictor(blob)
        t3 = time.perf_counter()
        with torch.no_grad():
            kernels.reset_launch_counts()
            live = model.predict_f(ts)
            sync()
            live_counts = kernels.launch_counts()
            kernels.reset_launch_counts()
            mean, var = serve(ts)
            sync()
            loaded_counts = kernels.launch_counts()
        err = max(float((mean - live.mean).abs().max()), float((var - live.var).abs().max()))
        print(f"[export] config-5 {form} {str(dtype)[6:]} {device} T={T} chunk={chunk} "
              f"blocks={blocks} new={new}: trace {t1 - t0:.1f} s, save {t2 - t1:.1f} s, "
              f"nodes {nodes(program)}, bytes {len(blob)}, load {t3 - t2:.1f} s, "
              f"max abs diff {err:.3e}")
        print(f"[export] launches live {({k: v for k, v in live_counts.items() if v})} "
              f"loaded {({k: v for k, v in loaded_counts.items() if v})}")
        del model, program, serve, blob
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Profile one config-5 CVI step of the PyTorch port on a CUDA card.

    python3 scripts/port/profile_config5.py [--sqrt | --fused] [T] [chunk]

Builds `build_config5(T, chunk, float32)` (default T = 100 000, chunk
25 000, as the benchmark runs it; `--sqrt` for the square-root form,
`--fused` for the covariance form with `PHYSS_FUSED_COMBINE=1`), takes
one warm-up step, then traces one step with `torch.profiler`. Prints the
card, the step's wall time, the device-busy share (summed kernel time over
wall time), the launches of each hand-written kernel in the step, the
kernels that take the most device time, every hand-written kernel of the
port with its device time and calls, and the profiler's table by device
time.
"""
import os
import re
import subprocess
import sys
import time

import torch


def main():
    if not torch.cuda.is_available():
        print("profile_config5: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, repo)
    from physs_gp_tpu_torch.ops import cuda as kernels
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5

    args = sys.argv[1:]
    sqrt, fused = "--sqrt" in args, "--fused" in args
    args = [a for a in args if a not in ("--sqrt", "--fused")]
    if fused:
        os.environ["PHYSS_FUSED_COMBINE"] = "1"
    T = int(args[0]) if args else 100_000
    chunk = int(args[1]) if len(args) > 1 else 25_000
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[profile] {smi}")
    os.environ.setdefault("PHYSS_KZZ_JITTER", "1e-4")
    model = build_config5(T, chunk, dtype=torch.float32, sqrt=sqrt)
    natgrad_scan(model, 0.5, n_steps=1, nan_guard=False)  # warm-up (builds kernels)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        natgrad_scan(model, 0.5, n_steps=1, nan_guard=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    events = prof.key_averages()
    # kernels only: autograd-Function ranges repeat their kernels' time
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    form = "square-root" if sqrt else "covariance, fused combines" if fused else "covariance"
    print(f"[profile] {form} T={T} chunk={chunk} f32 step wall {wall * 1e3:.1f} ms, "
          f"device busy {dev_us / 1e3:.1f} ms ({100 * dev_us / 1e3 / (wall * 1e3):.1f}% of wall)")
    print(f"[profile] launches in the step: {counts}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        if e.self_device_time_total <= 0:
            break
        print(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms  {e.count:7d} calls  {e.key[:90]}")
    for e in sorted(kernels, key=lambda e: e.key):
        ours = re.match(r"void \(anonymous namespace\)::(\w+_kernel<[^(]*>)\(", e.key)
        if ours:
            print(f"[profile] port kernel {e.self_device_time_total / 1e3:9.2f} ms  "
                  f"{e.count:7d} calls  {ours.group(1)}")
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())

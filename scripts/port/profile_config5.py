"""Profile one config-5 or temporal CVI step of the PyTorch port on a CUDA card.

    python3 scripts/port/profile_config5.py [--temporal] [--sqrt | --fused] [T] [chunk]

Builds `build_config5(T, chunk, float32)` (default T = 100 000, chunk
25 000, as the benchmark runs it) or, with `--temporal`,
`build_temporal(T, chunk, float32)` (default T = 100 000, chunk 50 000 and
PHYSS_SCAN_BLOCKS=1024, as `bench.py` runs the JAX package's);
`--sqrt` for the square-root form, `--fused` for the covariance form with
`PHYSS_FUSED_COMBINE=1`. It takes one warm-up step, then traces one step
with `torch.profiler`. Prints the card, the step's wall time and peak
memory, the device-busy share (summed kernel time over wall time), the
device time of the port's hand-written kernels against PyTorch's own, the
launches of each hand-written kernel in the step (and, for the temporal
model, the calls of the d = 2 flat combines), the kernels that take the
most device time, every hand-written kernel of the port with its device
time and calls, and the profiler's table by device time.
"""
import collections
import os
import re
import subprocess
import sys
import time

import torch

_PORT_KERNEL = re.compile(r"void \(anonymous namespace\)::(\w+_kernel<[^(]*>)\(")


def main():
    if not torch.cuda.is_available():
        print("profile_config5: no CUDA device", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, repo)
    from physs_gp_tpu_torch.ops import cuda as kernels
    from physs_gp_tpu_torch.ops import parallel_kalman as pk
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5, build_temporal

    args = sys.argv[1:]
    temporal, sqrt, fused = "--temporal" in args, "--sqrt" in args, "--fused" in args
    args = [a for a in args if a not in ("--temporal", "--sqrt", "--fused")]
    if fused:
        os.environ["PHYSS_FUSED_COMBINE"] = "1"
    if temporal:
        os.environ.setdefault("PHYSS_SCAN_BLOCKS", "1024")
    T = int(args[0]) if args else 100_000
    chunk = int(args[1]) if len(args) > 1 else (50_000 if temporal else 25_000)
    flat = collections.Counter()
    for name in ("_flat2_filtering_operator", "_flat2_filtering_final",
                 "_flat2_smoothing_operator", "_flat2_smoothing_final"):
        def counted(*a, _name=name, _fn=getattr(pk, name)):
            flat[_name] += 1
            return _fn(*a)

        setattr(pk, name, counted)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[profile] {smi}")
    os.environ.setdefault("PHYSS_KZZ_JITTER", "1e-4")
    build = build_temporal if temporal else build_config5
    model = build(T, chunk, dtype=torch.float32, sqrt=sqrt)
    natgrad_scan(model, 0.5, n_steps=1, nan_guard=False)  # warm-up (builds kernels)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    flat.clear()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        natgrad_scan(model, 0.5, n_steps=1, nan_guard=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    events = prof.key_averages()
    # kernels only: autograd-Function ranges repeat their kernels' time
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    ours = [e for e in kernels if _PORT_KERNEL.match(e.key)]
    ours_us = sum(e.self_device_time_total for e in ours)
    form = "square-root" if sqrt else "covariance, fused combines" if fused else "covariance"
    name = "temporal" if temporal else "config-5"
    print(f"[profile] {name} {form} T={T} chunk={chunk} blocks "
          f"{os.environ.get('PHYSS_SCAN_BLOCKS', '256')} f32 step wall {wall * 1e3:.1f} ms, "
          f"peak {peak:.2f} GiB, device busy {dev_us / 1e3:.1f} ms "
          f"({100 * dev_us / 1e3 / (wall * 1e3):.1f}% of wall)")
    print(f"[profile] device time: hand-written kernels {ours_us / 1e3:.2f} ms in "
          f"{sum(e.count for e in ours)} launches, PyTorch's own "
          f"{(dev_us - ours_us) / 1e3:.2f} ms in {sum(e.count for e in kernels if e not in ours)} launches")
    print(f"[profile] launches in the step: {counts}")
    if temporal:
        print(f"[profile] flat d = 2 combines called in the step: {dict(flat)}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        if e.self_device_time_total <= 0:
            break
        print(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms  {e.count:7d} calls  {e.key[:90]}")
    for e in sorted(ours, key=lambda e: e.key):
        print(f"[profile] port kernel {e.self_device_time_total / 1e3:9.2f} ms  "
              f"{e.count:7d} calls  {_PORT_KERNEL.match(e.key).group(1)}")
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())

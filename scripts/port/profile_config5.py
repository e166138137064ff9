"""Profile one config-5 or temporal CVI step (or training iteration) of the
PyTorch port on a CUDA card.

    python3 scripts/port/profile_config5.py [--temporal | --markov] [--sqrt | --fused]
        [--train [--float64]] [--through-ops] [T] [chunk]

Builds `build_config5(T, chunk, float32)` (default T = 100 000, chunk
25 000, as the benchmark runs it) or, with `--temporal`,
`build_temporal(T, chunk, float32)` (default T = 100 000, chunk 50 000 and
PHYSS_SCAN_BLOCKS=1024, as `bench.py` runs the JAX package's);
`--sqrt` for the square-root form, `--fused` for the covariance form with
`PHYSS_FUSED_COMBINE=1`. With `--markov` the step is the trend +
quasi-periodic model's `log_marginal_likelihood()` and `predict_f` at 1000
new times (`scripts/port/markov_outcome.full_model`, d = 30, float32,
default T = 100 000, chunk 25 000). It takes one warm-up step, then traces one step
with `torch.profiler`. Prints the card, the step's wall time and peak
memory, the device-busy share (summed kernel time over wall time), the
device time of the port's hand-written kernels against PyTorch's own, the
launches of each hand-written kernel in the step (and, for the temporal
model, the calls of the d = 2 flat combines), the kernels that take the
most device time, every hand-written kernel of the port with its device
time and calls, and the profiler's table by device time; then the wall
times of three more steps, not traced.

`--through-ops` sends every kernel call through the dispatcher
(`torch.ops.physs_gp.*`), as a tracer's calls go, instead of straight to
the launch code: the two differ by the dispatcher's host time.

`--train` profiles one iteration of `trainers.vb_ng_adam_scan` (adam_lr
0.05, ng_lr 0.5) after a warm-up iteration, as its body runs: the
natural-gradient half, then the Adam step's objective forward, its backward
and the optimiser's update, each traced on its own and ended by a
synchronisation. For each part it prints the wall time, the device-busy
share, the hand-written kernels' device time against PyTorch's own, and
the launches and device time of each hand-written kernel; then the
iteration's wall time, device-busy share and peak memory. `--float64`
builds the model in float64.
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
    markov = "--markov" in args
    train, f64 = "--train" in args, "--float64" in args
    if "--through-ops" in args:
        from physs_gp_tpu_torch.ops.cuda import build as kernel_build

        kernel_build.traced = lambda: True
    args = [a for a in args if a not in ("--temporal", "--markov", "--sqrt", "--fused", "--train",
                                         "--float64", "--through-ops")]
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
    if train:
        dtype = torch.float64 if f64 else torch.float32
        return profile_train(build(T, chunk, dtype=dtype, sqrt=sqrt), kernels,
                             f"{'temporal' if temporal else 'config-5'} "
                             f"{'square-root' if sqrt else 'covariance, fused' if fused else 'covariance'} "
                             f"T={T} chunk={chunk} {str(dtype)[6:]}")
    if markov:
        sys.path.insert(0, os.path.join(repo, "scripts", "port"))
        import markov_outcome as mo

        model, _ = mo.full_model(torch.float32, "cuda", sqrt, T=T, chunk=chunk)
        t_new = torch.as_tensor(mo.new_times(T), dtype=torch.float32, device="cuda")

        @torch.no_grad()
        def step():
            return model.log_marginal_likelihood(), model.predict_f(t_new)
    else:
        model = build(T, chunk, dtype=torch.float32, sqrt=sqrt)

        def step():
            return natgrad_scan(model, 0.5, n_steps=1, nan_guard=False)
    step()  # warm-up (builds kernels)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    flat.clear()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
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
    name = "markov lml + predict_f" if markov else "temporal" if temporal else "config-5"
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
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"[profile] {name} {form} step wall, not traced: {[round(w * 1e3, 1) for w in walls]} ms")
    return 0


def _device_split(prof):
    """(all kernels' device us, hand-written device us, {kernel: (us, calls)})."""
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = {}
    for e in events:
        m = _PORT_KERNEL.match(e.key)
        if m:
            us, n = ours.get(m.group(1), (0.0, 0))
            ours[m.group(1)] = (us + e.self_device_time_total, n + e.count)
    return sum(e.self_device_time_total for e in events), sum(us for us, _ in ours.values()), ours


def profile_train(model, kernels, label):
    """One traced iteration of `vb_ng_adam_scan`, part by part (see the
    module docstring)."""
    from physs_gp_tpu_torch.trainers import scan

    opt = scan._adam(model, 0.05)
    parts = {
        "natural-gradient half": lambda st: (st.update(old=model.sites),
                                             model.natural_gradient_update(0.5),
                                             scan._guard_sites(model, st["old"]),
                                             opt.zero_grad(set_to_none=True)),
        "forward": lambda st: st.update(loss=model.get_objective()),
        "backward": lambda st: st["loss"].backward(),
        "update": lambda st: opt.step(),
    }
    # device activity only: the backward's host-side events are too many to
    # trace in square-root form
    acts = [torch.profiler.ProfilerActivity.CUDA]
    state = {}
    for part in parts.values():  # warm-up iteration (builds the kernels)
        part(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total_wall = total_dev = 0.0
    for name, part in parts.items():
        kernels.reset_launch_counts()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            part(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_us, ours_us, ours = _device_split(prof)
        total_wall, total_dev = total_wall + wall, total_dev + dev_us / 1e6
        print(f"[profile train] {label} {name}: wall {wall * 1e3:.1f} ms, device busy {dev_us / 1e3:.2f} ms "
              f"({100 * dev_us / 1e3 / (wall * 1e3):.1f}%), hand-written {ours_us / 1e3:.2f} ms, "
              f"PyTorch's own {(dev_us - ours_us) / 1e3:.2f} ms")
        print(f"[profile train] {label} {name}: launches {({k: v for k, v in kernels.launch_counts().items() if v})}")
        for k, (us, n) in sorted(ours.items()):
            print(f"[profile train] {label} {name}: {k} {us / 1e3:.3f} ms in {n} launches")
    state.clear()
    print(f"[profile train] {label} iteration: wall {total_wall * 1e3:.1f} ms, device busy "
          f"{total_dev * 1e3:.1f} ms ({100 * total_dev / total_wall:.1f}%), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drive the PyTorch port's config-5 CVI step on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device: versions, card name and power limit, TF32 off;
  2. build: compile the batched kernels from physs_gp_tpu_torch/csrc;
  3. kernels: each kernel against its plain PyTorch version on the card, in
     float32 and float64, then kernel and plain timed with CUDA events;
  4. slice against the JAX reference: float64, T = 256, 3 steps, ELBOs and
     sites against tests/data/config5_T256_golden.npz;
  5. slice at full width: float32, T = 100 000, chunk 25 000, 3 steps with
     the launch counters reset just before, then the same run in float64.
The second-to-last line is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Needs one card; imports no JAX.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "data", "config5_T256_golden.npz")
TOL = {  # normwise relative tolerance: max|kernel - plain| / max|plain|
    torch.float64: {"bmm": 1e-12, "solve": 1e-10, "logdet": 1e-10},
    torch.float32: {"bmm": 1e-5, "solve": 1e-4, "logdet": 1e-4},
}
N_MAIN, D = 25_000, 32


def phase_device():
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off")
    print("[device] TF32 off for matmul and cuDNN")


def phase_build():
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl

    t0 = time.perf_counter()
    bl.build()
    print(f"[build] {bl.build_info['path']} in {time.perf_counter() - t0:.1f} s")
    for line in bl.build_info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def _spd(gen, N, d, dtype, dom=5.0):
    A = torch.randn(N, d, d, generator=gen, dtype=torch.float64, device="cuda")
    return (A @ A.transpose(-1, -2) / d + dom * torch.eye(d, dtype=torch.float64, device="cuda")).to(dtype)


def _icj(gen, N, d, dtype):
    """Identity-dominated I + C J with SPD C, J, as in the filtering combine."""
    C = _spd(gen, N, d, torch.float64, dom=1.0) * 0.1
    J = _spd(gen, N, d, torch.float64, dom=1.0) * 0.1
    return (torch.eye(d, dtype=torch.float64, device="cuda") + C @ J).to(dtype)


def _rel(x, ref):
    return float((x - ref).abs().max() / ref.abs().max()), float((x - ref).abs().max())


def _time(fn, n=20):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _kernel_vs_plain(kernel, plain):
    """ms of kernel and plain, interleaved plain, kernel, kernel, plain."""
    kernel(), plain()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = _time(plain), _time(kernel), _time(kernel), _time(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_kernels():
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"bmm": 0.0, "gj_solve": 0.0, "gj_solve_logdet": 0.0}

    def check(name, kind, out, ref, dtype, label):
        rel, ab = _rel(out, ref)
        ok = rel <= TOL[dtype][kind]
        print(f"[kernels] {name} {label} {str(dtype)[6:]}: max_abs_err {ab:.3e} "
              f"rel {rel:.3e} (tol {TOL[dtype][kind]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label} disagrees with its plain version")
        if dtype == torch.float32:
            worst[name] = max(worst[name], ab)

    for dtype in (torch.float64, torch.float32):
        # bmm: all four transposes at [25000, 32, 32], rectangular, edges
        cases = [((N_MAIN, D, D), (N_MAIN, D, D), ta, tb) for ta in (False, True) for tb in (False, True)]
        cases += [((N_MAIN, D, D), (N_MAIN, D, 2 * D + 1), False, False),
                  ((N_MAIN, 2 * D + 1, D), (N_MAIN, 2 * D + 1, D), True, False),
                  ((1, 80, 80), (1, 80, 80), False, True),
                  ((300, 7, 7), (300, 7, 7), True, True)]
        for sa, sb, ta, tb in cases:
            A = torch.randn(sa, generator=gen, dtype=torch.float64, device="cuda").to(dtype)
            B = torch.randn(sb, generator=gen, dtype=torch.float64, device="cuda").to(dtype)
            check("bmm", "bmm", bl.batch_bmm(A, B, ta, tb), bl.bmm_plain(A, B, ta, tb),
                  dtype, f"{list(sa)}x{list(sb)} ta={ta:d} tb={tb:d}")
        # solves: identity-dominated and SPD systems at the main-path widths
        for N, d, r, mk in [(N_MAIN, D, 1, _spd), (N_MAIN, D, D, _icj),
                            (N_MAIN, D, 2 * D + 1, _spd), (1, 80, 80, _spd),
                            (300, 7, 3, _icj)]:
            M = mk(gen, N, d, dtype)
            R = torch.randn(N, d, r, generator=gen, dtype=torch.float64, device="cuda").to(dtype)
            check("gj_solve", "solve", bl.batch_solve(M, R), bl.gj_solve_plain(M, R),
                  dtype, f"[{N},{d},{d}] r={r}")
        for N, d, r in [(N_MAIN, D, 1), (N_MAIN, D, D), (1, 80, 80), (300, 7, 3)]:
            M = _spd(gen, N, d, dtype)
            R = torch.randn(N, d, r, generator=gen, dtype=torch.float64, device="cuda").to(dtype)
            X, ld = bl.batch_solve_logdet(M, R)
            Xp, ldp = bl.gj_solve_logdet_plain(M, R)
            check("gj_solve_logdet", "solve", X, Xp, dtype, f"[{N},{d},{d}] r={r} X")
            check("gj_solve_logdet", "logdet", ld, ldp, dtype, f"[{N},{d},{d}] r={r} logdet")
    torch.cuda.synchronize()

    # times at the main path's shapes, float32
    f32 = torch.float32
    A = torch.randn(N_MAIN, D, D, generator=gen, device="cuda")
    B = torch.randn(N_MAIN, D, D, generator=gen, device="cuda")
    S = _spd(gen, N_MAIN, D, f32)
    rhs = torch.randn(N_MAIN, D, 2 * D + 1, generator=gen, device="cuda")
    eye = torch.eye(D, device="cuda").expand(N_MAIN, D, D)
    timed = {
        "bmm": (lambda: bl.batch_bmm(A, B, False, True), lambda: bl.bmm_plain(A, B, False, True),
                "[25000,32,32] @ [25000,32,32]^T"),
        "gj_solve": (lambda: bl.batch_solve(S, rhs), lambda: bl.gj_solve_plain(S, rhs),
                     "[25000,32,32] r=65"),
        "gj_solve_logdet": (lambda: bl.batch_solve_logdet(S, eye),
                            lambda: bl.gj_solve_logdet_plain(S, eye), "[25000,32,32] r=32"),
    }
    times = {}
    for name, (kern, plain, shape) in timed.items():
        ms, plain_ms = _kernel_vs_plain(kern, plain)
        times[name] = (ms, plain_ms)
        print(f"[kernels] time {name} {shape} f32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return worst, times


def _run_slice(T, chunk, dtype, steps, nan_guard):
    from physs_gp_tpu_torch.trainers.scan import natgrad_scan
    from physs_gp_tpu_torch.zoo.bench_configs import build_config5

    model = build_config5(T, chunk, dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    walls, elbos = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        model, e = natgrad_scan(model, 0.5, n_steps=1, nan_guard=nan_guard)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        elbos.append(float(e[0]))
    return model, np.array(elbos), walls


def phase_slice_anchor():
    os.environ["PHYSS_SCAN_BLOCKS"] = "8"
    try:
        model, elbos, _ = _run_slice(256, 64, torch.float64, 3, nan_guard=True)
        post = model.posterior()
    finally:
        del os.environ["PHYSS_SCAN_BLOCKS"]
    gold = np.load(GOLDEN)
    rel = np.abs(elbos - gold["elbos"]) / np.abs(gold["elbos"])
    print(f"[anchor] ELBOs {elbos.tolist()}")
    print(f"[anchor] golden {gold['elbos'].tolist()} max rel {rel.max():.3e} (tol 1e-9)")
    if not rel.max() <= 1e-9:
        raise AssertionError("float64 slice on the card disagrees with the JAX reference")
    got = {
        "site_Y": model.sites.Y, "site_V_diag": torch.diagonal(model.sites.V, dim1=-2, dim2=-1),
        "post_mean": post.mean, "post_var": post.var,
    }
    for key, val in got.items():
        ref = gold[key]
        r = np.max(np.abs(val.cpu().numpy() - ref)) / np.max(np.abs(ref))
        print(f"[anchor] {key} max rel {r:.3e} (tol 1e-7)")
        if not r <= 1e-7:
            raise AssertionError(f"{key} disagrees with the JAX reference")


def phase_slice_full():
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl

    os.environ["PHYSS_KZZ_JITTER"] = "1e-4"
    out = {}
    for dtype in (torch.float32, torch.float64):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if dtype == torch.float32:
            bl.reset_launch_counts()
        model, elbos, walls = _run_slice(100_000, 25_000, dtype, 3, nan_guard=False)
        if dtype == torch.float32:
            counts = bl.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        finite = bool(np.all(np.isfinite(elbos))
                      and torch.isfinite(model.sites.V).all()
                      and torch.isfinite(model.sites.Y).all())
        print(f"[full] {str(dtype)[6:]} ELBOs {elbos.tolist()}")
        print(f"[full] {str(dtype)[6:]} step wall s {[round(w, 4) for w in walls]} "
              f"peak {peak:.2f} GiB finite {finite}")
        if not finite:
            raise AssertionError(f"non-finite ELBO or sites in {dtype}")
        out[dtype] = elbos
        del model
    print(f"[full] launches in the float32 run: {counts}")
    if not all(c > 0 for c in counts.values()):
        raise AssertionError("a kernel of the main path was never launched")
    # Step 0 starts from the broad initial sites, where the fp32 projection
    # H P H^T of the stiff collocation heads loses digits in the reference
    # algorithm itself (the JAX package's own float32 and float64 step-0
    # ELBOs differ by 2 % at T = 4000 on the CPU); the bound applies to the
    # steps after it.
    gap = np.abs(out[torch.float32] - out[torch.float64]) / np.abs(out[torch.float64])
    print(f"[full] float32 vs float64 ELBO rel gap {gap.tolist()} "
          f"(bound 1e-2 on steps 1 and 2; step 0 reported)")
    if not gap[1:].max() <= 1e-2:
        raise AssertionError("float32 and float64 ELBOs disagree")
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import physs_gp_tpu_torch.ops.matrix  # noqa: F401  (sets TF32 off)

    phase_device()
    phase_build()
    worst, times = phase_kernels()
    phase_slice_anchor()
    counts = phase_slice_full()
    replaces = {
        "bmm": "physs_gp_tpu/ops/pallas/batched_linalg.py:131",
        "gj_solve": "physs_gp_tpu/ops/pallas/batched_linalg.py:68",
        "gj_solve_logdet": "physs_gp_tpu/ops/pallas/batched_linalg.py:94",
    }
    kernels = [
        {"name": name, "route": "cuda", "source": "physs_gp_tpu_torch/csrc/batched_linalg.cu",
         "replaces": replaces[name], "launches": counts[name], "max_abs_err": worst[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("bmm", "gj_solve", "gj_solve_logdet")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of the tiled fused combines goes, level by level, on a CUDA
card: an instrumented copy of `csrc/fused_combine.cu` stamps `clock64()` at
the start of each block, after each block barrier and at the end.

    python3 scripts/port/stamp_fused.py [--unroll-inverse N] [--unroll-product N]

Builds the source twice (as it is, and with the stamps) into
`physs_gp_tpu_torch/_build/stamp/`, optionally with other unroll counts for
the elimination's loop over pivots and the products' contraction loop (32
and 8 unroll them fully), and runs `fused_filtering_combine` and
`fused_smoothing_combine` at [256, 32, 32] and [128, 32, 32] (the scans'
batches) in float32 and float64. For each it prints the device time per call
back to back of the build without stamps and, from the stamped build after
20 warm launches, the median over blocks of the cycles each level took:
filtering [staging, L0 .. L5], smoothing [staging, L0, L1, L2] (the levels of
the source's schedule comment), with the largest number of blocks an SM held.
The last line is one JSON object with all of it.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NB = 4096  # blocks stamped


def instrument(text):
    """Stamps in the two tiled kernels: block start, after each barrier, end."""
    text = text.replace('#include "tiles.cuh"\n', '#include "tiles.cuh"\n'
                        f"__device__ unsigned long long g_stamps[2][{NB}][12];\n"
                        f"__device__ unsigned g_sm[2][{NB}];\n", 1)
    for k, name in enumerate(("fused_filter_tiled_kernel(", "fused_smooth_tiled_kernel(")):
        start = text.index("{", text.index(name))
        end = text.index("\n}\n", start)
        stamp = f"if (threadIdx.x == 0 && blockIdx.x < {NB}) g_stamps[{k}][blockIdx.x][%d] = clock64();"
        n = [0]

        def after_barrier(_):
            n[0] += 1
            return "__syncthreads();\n  " + stamp % n[0]

        body = re.sub(r"__syncthreads\(\);", after_barrier, text[start + 1:end])
        head = (f"\n  if (threadIdx.x == 0 && blockIdx.x < {NB}) {{\n    unsigned s;\n"
                f"    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(s));\n    g_sm[{k}][blockIdx.x] = s;\n  }}\n  "
                + stamp % 0)
        tail = "\n  __syncthreads();\n  " + stamp % (n[0] + 1)
        text = text[:start + 1] + head + body + tail + text[end:]
    return text + ('\nextern "C" int physs_read_stamps(void* stamps, void* sm) {\n'
                   "  cudaMemcpyFromSymbol(sm, g_sm, sizeof(g_sm));\n"
                   "  return (int)cudaMemcpyFromSymbol(stamps, g_stamps, sizeof(g_stamps));\n}\n")


def unrolled(text, inverse, product):
    for pragma, loop, n in (("#pragma unroll 4", "for (int k = 0; k < 32; ++k)", inverse),
                            ("#pragma unroll 2", "for (int l0 = 0; l0 < 32; l0 += W)", product)):
        old = f"{pragma}\n  {loop}"
        if old not in text:
            raise SystemExit(f"stamp_fused: the source has no '{pragma}' before '{loop}'")
        if n is not None:
            text = text.replace(old, f"#pragma unroll {n}\n  {loop}")
    return text


def build(build_mod, texts):
    """Compile each {name: source} side by side; returns {name: loaded library}."""
    out = os.path.join(REPO, "physs_gp_tpu_torch", "_build", "stamp")
    os.makedirs(out, exist_ok=True)
    csrc = os.path.join(REPO, "physs_gp_tpu_torch", "csrc")
    procs = {}
    for name, text in texts.items():
        src = os.path.join(out, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        so = os.path.join(out, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [build_mod._nvcc(), *build_mod._NVCC_FLAGS, "-I", csrc, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"stamp_fused: nvcc failed on {name}:\n{err}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in build_mod._ENTRY_POINTS["fused_combine"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_device(fn, n=200):
    """ms per call, n calls enqueued behind large products (back to back)."""
    blocker = torch.randn(8192, 8192, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    for _ in range(12):
        blocker @ blocker
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--unroll-inverse", type=int, default=None)
    parser.add_argument("--unroll-product", type=int, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("stamp_fused: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from physs_gp_tpu_torch.ops import parallel_kalman as pk
    from physs_gp_tpu_torch.ops.cuda import build as build_mod
    from physs_gp_tpu_torch.ops.cuda import fused_combine as fc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[stamp] {smi}; unroll inverse {args.unroll_inverse or 'as in the source'}, "
          f"product {args.unroll_product or 'as in the source'}")
    with open(os.path.join(REPO, "physs_gp_tpu_torch", "csrc", "fused_combine.cu")) as f:
        text = unrolled(f.read(), args.unroll_inverse, args.unroll_product)
    libs = build(build_mod, {"plain": text, "stamped": instrument(text)})
    libs["stamped"].physs_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.float64):
        for N in (256, 128):
            d = 32

            def r(*shape):
                return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float64)

            def spd(dom):
                X = r(N, d, d)
                return X @ X.mT / d + dom * torch.eye(d, device="cuda", dtype=torch.float64)

            f = pk._FilterElems(A=0.1 * r(N, d, d), b=r(N, d), C=0.3 * spd(1.0), J=0.3 * spd(1.0), eta=r(N, d))
            s = pk._SmootherElems(E=0.2 * r(N, d, d), g=r(N, d), L=spd(0.5))
            f, s = (pk._map(lambda v: v.to(dtype), e) for e in (f, s))
            ref = list(fc.fused_filter_plain(f, f)) + list(fc.fused_smooth_plain(s, s))
            build_mod._libs["fused_combine"] = libs["plain"]
            out = list(fc.fused_filtering_combine(f, f)) + list(fc.fused_smoothing_combine(s, s))
            err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(out, ref))
            ms = {"filter": time_device(lambda: fc.fused_filtering_combine(f, f)),
                  "smooth": time_device(lambda: fc.fused_smoothing_combine(s, s))}
            build_mod._libs["fused_combine"] = libs["stamped"]
            for _ in range(20):
                fc.fused_filtering_combine(f, f)
                fc.fused_smoothing_combine(s, s)
            torch.cuda.synchronize()
            stamps = np.zeros((2, NB, 12), dtype=np.uint64)
            sm = np.zeros((2, NB), dtype=np.uint32)
            libs["stamped"].physs_read_stamps(stamps.ctypes.data, sm.ctypes.data)
            for k, (name, n) in enumerate((("filter", 8), ("smooth", 5))):
                x = stamps[k, :N, :n].astype(np.int64)
                row = {"kernel": f"fused_{name}", "shape": [N, d, d], "dtype": str(dtype)[6:],
                       "ms": ms[name], "max_rel_err": err,
                       "cycles_per_level": np.median(np.diff(x, axis=1), axis=0).astype(int).tolist(),
                       "cycles_total": int(np.median(x[:, -1] - x[:, 0])),
                       "blocks_per_sm": int(np.bincount(sm[k, :N].astype(np.int64)).max())}
                rows.append(row)
                print(f"[stamp] fused_{name} [{N},{d},{d}] {row['dtype']}: {ms[name] * 1e3:.2f} us device "
                      f"time back to back; cycles per level (median over blocks) {row['cycles_per_level']}, "
                      f"total {row['cycles_total']}; blocks per SM {row['blocks_per_sm']}; "
                      f"max rel err against plain {err:.2e}")
    build_mod._libs.pop("fused_combine")
    print(json.dumps({"stamp_fused": rows, "card": smi, "unroll_inverse": args.unroll_inverse,
                      "unroll_product": args.unroll_product}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the batched product and the Cholesky kernels of the PyTorch port on
a CUDA card, at the two batches the config-5 step launches them at.

    python3 scripts/port/bench_kernels.py [--root TREE] [--label NAME]

For float32 and float64, at [256, 32, 32] (the blocked scan's batch: nearly
every launch of a step) and [25000, 32, 32] (one chunk at full width), it
times `batch_bmm` in three transpose cases, `batch_chol_gram` and
`batch_cholesky` (the latter also at [100000, 32, 32]) beside the PyTorch
call that computes the same function. Every figure is device time per call:
200 calls (40 at full width) are enqueued while the device is busy with
large products, so that they run back to back between two CUDA events and
the host's launch path is not in the figure; a call that synchronises
cannot be queued so and is marked host-paced (the library Cholesky reads
its status back on the host: at batch 256 its figure is the host's). `--root`
imports the package from another tree (an unpacked earlier commit), so that
two versions can be timed in turns on one card; `--label` tags the lines.
Prints one line per case and, last, one JSON object with all of them.
"""
import argparse
import json
import os
import subprocess
import sys

import torch

D = 32


def time_device(fn, n=200):
    """(ms per call, queued): n calls between two CUDA events, enqueued while
    the device is busy with large products so that they run back to back.
    `queued` is False when the host could not get ahead of the device (a call
    that synchronises): the figure then holds the host's launch path too."""
    blocker = torch.randn(8192, 8192, device="cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    for products in (3, 12, 40):
        torch.cuda.synchronize()
        for _ in range(products):
            blocker @ blocker
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued = not start.query()  # the device had not reached the first call yet
        torch.cuda.synchronize()
        if queued:
            break
    return start.elapsed_time(end) / n, queued


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import build

    build.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[bench {args.label}] {smi}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def row(name, shape, dtype, kern, lib):
        kern(), lib()
        torch.cuda.synchronize()
        n = 200 if shape[0] <= 1000 else 40
        (k1, kq), (l1, lq) = time_device(kern, n), time_device(lib, n)
        (l2, _), (k2, _) = time_device(lib, n), time_device(kern, n)
        rows.append({"label": args.label, "kernel": name, "shape": list(shape),
                     "dtype": str(dtype)[6:], "ms": (k1 + k2) / 2, "library_ms": (l1 + l2) / 2,
                     "kernel_back_to_back": kq, "library_back_to_back": lq})
        print(f"[bench {args.label}] {name} {list(shape)} {str(dtype)[6:]}: kernel "
              f"{k1:.4f} {k2:.4f} ms{'' if kq else ' (host-paced)'}, library "
              f"{l1:.4f} {l2:.4f} ms{'' if lq else ' (host-paced)'}")

    for dtype in (torch.float32, torch.float64):
        for N in (256, 25_000):
            A = torch.randn(N, D, D, generator=gen, device="cuda", dtype=dtype)
            B = torch.randn(N, D, D, generator=gen, device="cuda", dtype=dtype)
            pre = torch.randn(N, D, 2 * D, generator=gen, device="cuda", dtype=dtype)
            X, Y = pre[..., :D], pre[..., D:]
            P = pre @ pre.mT + torch.eye(D, device="cuda", dtype=dtype)
            for ta, tb in ((False, True), (False, False), (True, False)):
                row(f"bmm ta={ta:d} tb={tb:d}", (N, D, D), dtype,
                    lambda: bl.batch_bmm(A, B, ta, tb),
                    lambda: torch.matmul(A.mT if ta else A, B.mT if tb else B))
            row("chol_gram", (N, D, D), dtype, lambda: bc.batch_chol_gram(X, Y),
                lambda: torch.linalg.cholesky(torch.bmm(pre, pre.mT)))
            row("chol", (N, D, D), dtype, lambda: bc.batch_cholesky(P),
                lambda: torch.linalg.cholesky(P))
    P = torch.randn(100_000, D, 2 * D, generator=gen, device="cuda")
    P = P @ P.mT
    row("chol", (100_000, D, D), torch.float32, lambda: bc.batch_cholesky(P),
        lambda: torch.linalg.cholesky(P))
    print(json.dumps({"bench_kernels": rows, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

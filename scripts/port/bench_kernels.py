"""Time the batched kernels of the PyTorch port on a CUDA card, at the
batches the config-5 step launches them at.

    python3 scripts/port/bench_kernels.py [--root TREE] [--label NAME] [--only K,K]

For float32 and float64, at [256, 32, 32] (the blocked scan's batch: nearly
every launch of a step) and [25000, 32, 32] (one chunk at full width), it
times `batch_bmm` in three transpose cases, `batch_chol_gram` and
`batch_cholesky` (the latter also at [100000, 32, 32]); `batch_solve` at
[256, 32, 32] with a stride-0 identity (r = 32, the scan's inverse), at
[512, 32, 32] with r = 64 (the square-root scan's) and at [25000, 32, 32]
with r = 65, `batch_solve_logdet` at [25000, 32, 32] with a stride-0
identity; `batch_tria` at [512, 32, 64], [256, 32, 64] and [25000, 32, 64];
each beside the PyTorch call that computes the same function; and the fused
filtering and smoothing combines at [256, 32, 32], [128, 32, 32] (the scans'
batches) and [25000, 32, 32], beside the unfused route (the scans' combine
without the fused kernels: its own launches of bmm, gj_solve and PyTorch's
ops). `--only` keeps the named kernels: bmm, chol_gram, chol, gj_solve,
gj_solve_logdet, lq, fused_filter, fused_smooth. Every figure is device time
per call:
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
    parser.add_argument("--only", default="", help="comma-separated kernel names")
    args = parser.parse_args()
    only = set(filter(None, args.only.split(",")))
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from physs_gp_tpu_torch.ops import parallel_kalman as pk
    from physs_gp_tpu_torch.ops.cuda import batched_chol as bc
    from physs_gp_tpu_torch.ops.cuda import batched_linalg as bl
    from physs_gp_tpu_torch.ops.cuda import batched_qr as bq
    from physs_gp_tpu_torch.ops.cuda import build
    from physs_gp_tpu_torch.ops.cuda import fused_combine as fc

    build.build()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[bench {args.label}] {smi}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def row(name, shape, dtype, kern, lib, lib_name="library"):
        if only and name.split()[0] not in only:
            return
        kern(), lib()
        torch.cuda.synchronize()
        n = 200 if shape[0] <= 1000 else 40
        (k1, kq), (l1, lq) = time_device(kern, n), time_device(lib, n)
        (l2, _), (k2, _) = time_device(lib, n), time_device(kern, n)
        rows.append({"label": args.label, "kernel": name, "shape": list(shape),
                     "dtype": str(dtype)[6:], "ms": (k1 + k2) / 2, "library": lib_name, "library_ms": (l1 + l2) / 2,
                     "kernel_back_to_back": kq, "library_back_to_back": lq})
        print(f"[bench {args.label}] {name} {list(shape)} {str(dtype)[6:]}: kernel "
              f"{k1:.4f} {k2:.4f} ms{'' if kq else ' (host-paced)'}, {lib_name} "
              f"{l1:.4f} {l2:.4f} ms{'' if lq else ' (host-paced)'}")

    def spd(N, dtype):
        A = torch.randn(N, D, D, generator=gen, device="cuda", dtype=dtype)
        return A @ A.mT / D + 5 * torch.eye(D, device="cuda", dtype=dtype)

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
        # the solves and the LQ at the scans' batches and at full width
        for N, r in ((256, "I"), (512, 2 * D), (25_000, 2 * D + 1), (25_000, "I logdet")):
            S = spd(N, dtype)
            if isinstance(r, str):
                R = torch.eye(D, device="cuda", dtype=dtype).expand(N, D, D)
            else:
                R = torch.randn(N, D, r, generator=gen, device="cuda", dtype=dtype)
            name = "gj_solve_logdet" if r == "I logdet" else "gj_solve"
            kern = (lambda: bl.batch_solve_logdet(S, R)) if r == "I logdet" else (lambda: bl.batch_solve(S, R))
            row(f"{name} r={R.shape[-1]}{' (stride-0 I)' if isinstance(r, str) else ''}",
                (N, D, D), dtype, kern, lambda: torch.linalg.solve(S, R))
        for N in (512, 256, 25_000):
            pre = torch.randn(N, D, 2 * D, generator=gen, device="cuda", dtype=dtype)
            row("lq", (N, D, 2 * D), dtype, lambda: bq.batch_tria(pre),
                lambda: torch.linalg.qr(pre.mT, mode="r"))
        # the fused combines: member 0 the identity element, member 1 a
        # chunk's first (A = J = eta = 0) or a series' last (E = 0) element
        for N in (256, 128, 25_000):
            def mats(scale, spd_dom=None):
                X = scale * torch.randn(N, D, D, generator=gen, device="cuda", dtype=dtype)
                return X if spd_dom is None else X @ X.mT / D + spd_dom * torch.eye(D, device="cuda", dtype=dtype)

            def vecs():
                return torch.randn(N, D, generator=gen, device="cuda", dtype=dtype)

            pair = []
            for _ in range(2):
                A, C, J = mats(0.1), 0.3 * mats(1.0, 1.0), 0.3 * mats(1.0, 1.0)
                b, eta = vecs(), vecs()
                A[0], C[0], J[0], b[0], eta[0] = torch.eye(D, device="cuda", dtype=dtype), 0, 0, 0, 0
                A[1], J[1], eta[1] = 0, 0, 0
                pair.append(pk._FilterElems(A=A, b=b, C=C, J=J, eta=eta))
            ei, ej = pair
            spair = []
            for _ in range(2):
                E, g, L = mats(0.2), vecs(), mats(1.0, 0.5)
                E[0], g[0], L[0] = torch.eye(D, device="cuda", dtype=dtype), 0, 0
                E[1] = 0
                spair.append(pk._SmootherElems(E=E, g=g, L=L))
            sj, si = spair
            row("fused_filter", (N, D, D), dtype, lambda: fc.fused_filtering_combine(ei, ej),
                lambda: pk._filtering_operator_unfused(ei, ej), "unfused route")
            row("fused_smooth", (N, D, D), dtype, lambda: fc.fused_smoothing_combine(sj, si),
                lambda: pk._smoothing_operator_unfused(sj, si), "unfused route")
    P = torch.randn(100_000, D, 2 * D, generator=gen, device="cuda")
    P = P @ P.mT
    row("chol", (100_000, D, D), torch.float32, lambda: bc.batch_cholesky(P),
        lambda: torch.linalg.cholesky(P))
    print(json.dumps({"bench_kernels": rows, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

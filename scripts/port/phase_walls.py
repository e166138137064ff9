"""Walls of `chip_smoke.py` phases of another checkout of the repo, on the
card, for comparing two trees in one call.

    python3 scripts/port/phase_walls.py --tree DIR --label NAME phase [phase ...]

Imports `chip_smoke` from DIR (so the phases run DIR's own package and build
DIR's kernels), runs `phase_device` and `phase_build`, then each named phase
in the order given, and prints one line per phase, "[walls NAME] phase s",
with the whole phase's output before it. Run the trees interleaved (parent,
change, change, parent): a host's pace moves these walls by tens of
percent from one call to the next."""
import argparse
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import chip_smoke as cs

    import physs_gp_tpu_torch.ops.matrix  # noqa: F401  (TF32 off)

    if not os.path.dirname(os.path.abspath(cs.__file__)) == tree:
        raise SystemExit(f"chip_smoke imported from {cs.__file__}, not {tree}")
    cs.phase_device()
    cs.phase_build()
    walls = {}
    for name in args.phases:
        t0 = time.perf_counter()
        getattr(cs, name)()
        walls[name] = time.perf_counter() - t0
        print(f"[walls {args.label}] {name} {walls[name]:.1f} s", flush=True)
    for name, wall in walls.items():
        print(f"[walls {args.label} summary] {name} {wall:.1f} s")


if __name__ == "__main__":
    main()

"""Shared harness of the PyTorch experiment drivers: options, timing,
metrics, result dumps (the port's counterpart of `experiments/common.py`).

Every driver takes `--quick` (small sizes), `--seed`, `--out DIR` (default
`results/torch`), `--iters N` (overrides the iteration count) and
`--device` (`cuda` unless `--device cpu`). Monte-Carlo draws come from a
`torch.Generator` on the device seeded by `--seed`. Each result file
carries the device it ran on: the card's name and power limit as
`nvidia-smi` gives them.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

__all__ = ["parse_args", "Timer", "rmse", "dump_results", "device_info", "numpy"]


def parse_args(name: str, argv=None):
    p = argparse.ArgumentParser(name)
    p.add_argument("--quick", action="store_true", help="small run")
    p.add_argument("--out", default=str(pathlib.Path("results") / "torch"),
                   help="results directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=None, help="override the iteration count")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


class Timer:
    """Wall seconds around a block, the card's queued work included."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self.t0


def numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rmse(pred, truth) -> float:
    pred, truth = numpy(pred).ravel(), numpy(truth).ravel()
    ok = np.isfinite(truth)
    return float(np.sqrt(np.mean((pred[ok] - truth[ok]) ** 2)))


def device_info(device) -> dict:
    """The device a run used: the card's name and power limit
    (`nvidia-smi --query-gpu=name,power.limit`), or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def dump_results(out_dir: str, name: str, results: dict) -> pathlib.Path:
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.json"
    with open(path, "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(f"[{name}] metrics: {json.dumps(results.get('metrics', {}), default=float)}")
    print(f"[{name}] gates: {json.dumps(results.get('gates', {}))}")
    print(f"[{name}] saved -> {path}")
    return path

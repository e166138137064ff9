"""Shared harness of the PyTorch experiment drivers: options, timing,
metrics, result dumps (the port's counterpart of `experiments/common.py`).

Every driver takes `--quick` (small sizes), `--seed`, `--out DIR` (default
`results/torch`), `--iters N` (overrides the iteration count) and
`--device` (`cuda` unless `--device cpu`; no fallback: `cuda` without a
card raises). Monte-Carlo draws come from a `torch.Generator` on the device
seeded by `--seed`. Each result file carries the device it ran on (the
card's name and power limit as `nvidia-smi` gives them) and, from
`RunStats`, the run's wall, peak device memory and kernel launches.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import numpy as np
import torch

__all__ = ["parse_args", "Timer", "RunStats", "rmse", "nlpd", "dump_results", "device_info",
           "numpy", "resolve_device", "run_dtype"]


def parse_args(name: str, argv=None, extra=None):
    p = argparse.ArgumentParser(name)
    p.add_argument("--quick", action="store_true", help="small run")
    p.add_argument("--out", default=str(pathlib.Path("results") / "torch"),
                   help="results directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iters", type=int, default=None, help="override the iteration count")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    if extra:
        extra(p)
    return p.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """The run's device; `cuda` without a card raises (no CPU fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu)")
    return dev


def run_dtype(dev) -> torch.dtype:
    """float64 on the CPU (the JAX drivers' `--cpu`), float32 on the card."""
    return torch.float32 if torch.device(dev).type == "cuda" else torch.float64


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


class RunStats:
    """A driver's whole run: wall seconds, peak device memory and the
    hand-written kernels' launches (`ops.cuda.launch_counts`, by kernel, and
    by route where a wrapper picks one of two designs), all counted from
    construction. On the CPU the wrappers run their plain versions, which
    count no launch."""

    def __init__(self, device):
        from physs_gp_tpu_torch.ops import cuda

        self._cuda = cuda
        self.device = torch.device(device)
        cuda.reset_launch_counts()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.t0 = time.perf_counter()

    def meta(self) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        out = {"wall_seconds": time.perf_counter() - self.t0, "device": device_info(self.device),
               "launches": self._cuda.launch_counts(), "routes": self._cuda.route_counts()}
        if self.device.type == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated(self.device) / 2**30
        return out


def numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rmse(pred, truth) -> float:
    pred, truth = numpy(pred).ravel(), numpy(truth).ravel()
    ok = np.isfinite(truth)
    return float(np.sqrt(np.mean((pred[ok] - truth[ok]) ** 2)))


def nlpd(y, mean, var) -> float:
    """Mean Gaussian NLPD over the finite entries of y, in float64."""
    from physs_gp_tpu_torch.metrics.metrics import gaussian_nlpd

    y, mean, var = (torch.as_tensor(numpy(x), dtype=torch.float64) for x in (y, mean, var))
    return float(gaussian_nlpd(y, mean, var))


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

"""AOT predictor export for serving (`torch.export`).

Counterpart of `physs_gp_tpu/utils/serving.py`, with the same four names. A
trained model's predictive function is traced once, with the trained
parameters and data captured as constants of the program, and serialised to
bytes (`torch.export.save`). A serving process loads the bytes and calls the
program without the model classes:

    blob = export_predictor(model, example_ts)          # on the build host
    Path("predictor.pt2").write_bytes(blob)
    ...
    serve = load_predictor(Path("predictor.pt2").read_bytes())
    mean, var = serve(ts_new)                           # serving process

The program is specialised to the example's shape, dtype and device, as
the reference's is: no dynamic dimensions.

Differences from the reference:

- The reference's `platforms=` has no counterpart. The program serves on
  the device it was exported on: an export from CPU tensors runs the
  kernels' plain versions, one from CUDA tensors launches the kernels.
- The reference's artifact carries its Pallas kernels inside. This one
  names its kernels as the custom ops `torch.ops.physs_gp.*`, so the
  serving process needs `physs_gp_tpu_torch.ops` (imported here, which
  registers them) and, on the card, `csrc/` to build them at first use; it
  does not need `models`, `kernels` or `likelihoods`.
- Tracing runs under `torch.no_grad()` with the captured parameters'
  `requires_grad` off. A `no_grad` inside the traced function would leave
  a grad-mode node in the program that `torch.export.load` rejects.
- Where PyTorch has the switch (`torch.fx.config.do_not_emit_stack_traces`),
  the program records no Python stack trace per node: they slow the trace
  and grow the artifact.
"""
from __future__ import annotations

import contextlib
import io
from typing import Callable

import torch

import physs_gp_tpu_torch.ops.cuda  # noqa: F401  (registers the custom ops)

__all__ = ["export_predictor", "load_predictor", "export_fn", "load_fn"]


class _Fn(torch.nn.Module):
    """A function as a module, so that `torch.export` can trace it: the
    tensors it closes over become constants of the program."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _Predictor(torch.nn.Module):
    """`ts -> (mean, var)` of `model.<predict>`; the model's parameters and
    buffers become the program's state."""

    def __init__(self, model: torch.nn.Module, predict: str):
        super().__init__()
        self.model, self.predict = model, predict

    def forward(self, ts):
        out = getattr(self.model, self.predict)(ts)
        return out.mean, out.var


@contextlib.contextmanager
def _frozen(module: torch.nn.Module):
    """Grad off, the module's parameters frozen, no stack traces recorded."""
    trainable = [p for p in module.parameters() if p.requires_grad]
    traces = torch.fx.config.__dict__.get("do_not_emit_stack_traces", False)
    for p in trainable:
        p.requires_grad_(False)
    torch.fx.config.do_not_emit_stack_traces = True
    try:
        with torch.no_grad():
            yield
    finally:
        torch.fx.config.do_not_emit_stack_traces = traces
        for p in trainable:
            p.requires_grad_(True)


def export_fn(fn: Callable, *example_args) -> bytes:
    """Serialise `fn` (a function or a module) traced at `example_args`
    (tensors). `fn` returns a tensor or a flat tuple of tensors; the
    parameters of a module are frozen during the trace."""
    module = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    with _frozen(module):
        program = torch.export.export(module, tuple(example_args), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_fn(blob: bytes) -> Callable:
    """Load an `export_fn` artifact into a callable; its parameters are
    frozen, so that a call records no autograd graph."""
    module = torch.export.load(io.BytesIO(blob)).module()
    for p in module.parameters():
        p.requires_grad_(False)
    return module


def export_predictor(model, example_ts, predict: str = "predict_f") -> bytes:
    """Export `model.<predict>(ts)` with the trained model baked in.

    Returns a serialised program whose call signature is `ts -> (mean,
    var)`. `predict` is any model method returning Gaussian moments
    (`predict_f`, `predict_y`, ...)."""
    return export_fn(_Predictor(model, predict), example_ts)


def load_predictor(blob: bytes) -> Callable:
    """Load an `export_predictor` artifact: `ts -> (mean, var)`."""
    return load_fn(blob)

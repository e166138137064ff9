"""Which leaves the hyperparameter optimiser trains (PyTorch).

Counterpart of `physs_gp_tpu/utils/training.py`. The rule is the same: a
leaf is hyperparameter-trainable iff it is the `raw` of a non-fixed `Param`.
In the port every `nn.Parameter` is a `Param.raw`, and `Param.fix()` turns
its gradient off; data, kernel inputs and CVI sites are buffers. So the
trainable leaves are the parameters that require a gradient, and the JAX
package's `zero_untrainable` has no counterpart: a fixed raw gets no
gradient at all.
"""
from __future__ import annotations

from torch import nn

__all__ = ["trainable_parameters", "trainable_mask"]


def trainable_parameters(model: nn.Module) -> list:
    """The non-fixed `Param.raw`s of `model`, in `named_parameters()` order."""
    return [p for p in model.parameters() if p.requires_grad]


def trainable_mask(model: nn.Module) -> dict:
    """{parameter name: True if Adam trains it} over `named_parameters()`."""
    return {name: p.requires_grad for name, p in model.named_parameters()}

"""Model checkpoints: save and restore a whole model (PyTorch counterpart of
`physs_gp_tpu/utils/checkpoint.py`).

A checkpoint is an `.npz` of the model's `state_dict()`: every parameter
(`Param.raw`) and every buffer (data, kernel inputs, CVI sites), so a
resumed model has both its hyperparameters and its variational state, as
in the reference. Settings the model keeps as plain Python values (the
form, the chunk size, a likelihood's binsize) come from the template, as
the JAX package's static fields come from its treedef.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_model", "load_model", "CheckpointCallback"]


def _npz(path) -> str:
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_model(path, model) -> None:
    """Write `model.state_dict()` to `path` (`.npz` is appended if missing)."""
    arrays = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    np.savez(_npz(path), **arrays)


def load_model(path, template):
    """Restore a checkpoint into `template` (a model of the same
    configuration), in place, in the template's dtype and on its device;
    returns it. Raises if the names or shapes of the tensors differ."""
    state = template.state_dict()
    with np.load(_npz(path), allow_pickle=False) as data:
        saved = {k: data[k] for k in data.files}
    if set(saved) != set(state):
        raise ValueError(
            "checkpoint does not match the template model: missing "
            f"{sorted(set(state) - set(saved))[:5]}, unexpected {sorted(set(saved) - set(state))[:5]}"
        )
    for key, value in saved.items():
        if value.shape != tuple(state[key].shape):
            raise ValueError(f"checkpoint {key}: shape {value.shape} != {tuple(state[key].shape)}")
    template.load_state_dict({
        k: torch.as_tensor(v, dtype=state[k].dtype, device=state[k].device) for k, v in saved.items()
    })
    return template


class CheckpointCallback:
    """Periodic and best-objective checkpoints (ref `callbacks.py:32`); a
    trainer's `callback(epoch, model, loss)`."""

    def __init__(self, path_prefix: str, every: int = 50):
        self.path_prefix = path_prefix
        self.every = every
        self.best = float("inf")

    def __call__(self, epoch: int, model, loss: float):
        if epoch % self.every == 0:
            save_model(f"{self.path_prefix}_e{epoch}", model)
        if loss < self.best:
            self.best = loss
            save_model(f"{self.path_prefix}_best", model)

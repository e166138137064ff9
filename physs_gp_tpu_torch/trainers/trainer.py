"""Host-loop trainers: Adam on hyperparameters, natural gradients on CVI
sites, and the alternating VB_NG_Adam (PyTorch counterpart of
`physs_gp_tpu/trainers/trainer.py`).

Each step runs on the model's device and updates the model in place; the
trainers never move it. As in the reference, the host reads each loss
(`AdamTrainer`) and each acceptance test (`NatGradTrainer`) as it goes:
`trainers/scan.py` has the loops that keep them on the device.
`seed=` seeds a `torch.Generator` on the model's device, from which every
step (and every retry) draws fresh Monte-Carlo noise, where the reference
splits a PRNG key; without it each step uses the model's frozen draws.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable

import numpy as np
import torch

from ..utils.training import trainable_parameters
from .scan import _adam, _adam_step, _mc, _sites_ok

__all__ = ["AdamTrainer", "NatGradTrainer", "VB_NG_Adam", "lr_schedule"]


def _generator(model, seed):
    """A generator on the model's device seeded with `seed`, or None."""
    if seed is None:
        return None
    tensor = next(itertools.chain(model.buffers(), model.parameters()))
    return torch.Generator(device=tensor.device).manual_seed(seed)


def lr_schedule(kind: str, base: float, n: int):
    """'constant' | 'linear' | 'log' ramps (ref `natgrad_trainer.py:198-301`)."""
    if kind == "constant":
        return [base] * n
    if kind == "linear":
        return list(np.linspace(base / 10, base, n))
    if kind == "log":
        return list(np.logspace(np.log10(base / 100), np.log10(base), n))
    raise ValueError(kind)


class AdamTrainer:
    """Adam on the model's hyperparameters (its non-fixed `Param.raw`s).

    The optimiser state belongs to the raws of the model given here, so
    `train` takes that model."""

    def __init__(self, model: Any, lr: float = 1e-2, seed: int | None = None):
        self.opt = _adam(model, lr)
        self._params = trainable_parameters(model)
        self.generator = _generator(model, seed)

    def train(self, model: Any, epochs: int, callback: Callable | None = None):
        """`epochs` Adam steps; returns `(model, losses)` with `losses[i]`
        the objective before step i."""
        if [id(p) for p in trainable_parameters(model)] != [id(p) for p in self._params]:
            raise ValueError("AdamTrainer.train takes the model the trainer was built for")
        losses = []
        for i in range(epochs):
            loss = float(_adam_step(model, self.opt, **_mc(self.generator)))
            losses.append(loss)
            if callback:
                callback(i, model, loss)
        return model, losses


class NatGradTrainer:
    """Natural-gradient site updates with a NaN-guard retry loop: a step
    whose site variances go non-finite, or whose site means change their
    finite pattern, is undone and retried at half the learning rate, up to
    `nan_max_attempts` tries (ref `natgrad_trainer.py:267-287`)."""

    def __init__(self, nan_max_attempts: int = 4, hessian: str = "exact",
                 seed: int | None = None):
        self.nan_max_attempts = nan_max_attempts
        self.hessian = hessian
        self.seed = seed
        self.generator = None  # made on the first model's device

    def train(self, model: Any, lrs, callback: Callable | None = None):
        """One step per learning rate in `lrs` (or one step at a scalar lr);
        `callback(i, model, lr)` gets the lr the step used. Returns the
        model."""
        if isinstance(lrs, (int, float)):
            lrs = [float(lrs)]
        if self.generator is None:
            self.generator = _generator(model, self.seed)
        for i, lr in enumerate(lrs):
            lr_try = float(lr)
            for _ in range(self.nan_max_attempts):
                old_sites = model.sites
                model.natural_gradient_update(lr_try, self.hessian, **_mc(self.generator))
                if bool(_sites_ok(model.sites, old_sites)):
                    break
                model.sites = old_sites
                lr_try *= 0.5
            if callback:
                callback(i, model, lr_try)
        return model


class VB_NG_Adam:
    """Alternate one natural-gradient site step and one Adam step on the
    hyperparameters per epoch (ref `standard.py:58` VB_NG_ADAM)."""

    def __init__(self, model: Any, adam_lr: float = 1e-2, ng_lr: float = 1.0,
                 hessian: str = "exact", seed: int | None = None):
        self.adam = AdamTrainer(model, adam_lr, seed=seed)
        self.ng = NatGradTrainer(hessian=hessian, seed=None if seed is None else seed + 1)
        self.ng_lr = ng_lr

    def train(self, model: Any, epochs: int, callback: Callable | None = None):
        """Returns `(model, losses)`: `losses[i]` the objective after epoch
        i's natural-gradient step, before its Adam step."""
        losses = []
        for i in range(epochs):
            model = self.ng.train(model, [self.ng_lr])
            model, ls = self.adam.train(model, 1)
            losses.extend(ls)
            if callback:
                callback(i, model, ls[-1])
        return model, losses

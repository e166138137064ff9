"""L-BFGS and composite trainers (PyTorch counterpart of
`physs_gp_tpu/trainers/extra.py`).

`LBFGSTrainer` is `optax.lbfgs` (memory 10, `scale_init_precond`) chained
with `optax.scale_by_zoom_linesearch(max_linesearch_steps=20)` as optax
0.2.6 builds them, step for step: the two-loop recursion over a circular
memory of parameter and gradient differences, the first step's identity
scale min(1, 1/|g|), and the zoom line search (Nocedal & Wright algorithms
3.5 and 3.6 with Hager and Zhang's approximate-Wolfe test, cubic / quadratic
/ bisection interpolation, the previous step size as the first guess).
`torch.optim.LBFGS` is another algorithm and is not used.

The vector is the model's trainable `Param.raw`s flattened in
`named_parameters()` order; trial points are written into the raws under
`no_grad` and the accepted point is kept. Each line-search trial reads its
value and slope back to the host (the branches of the search), so one
iteration costs 1 + `linesearch_steps[i]` objective-and-gradient
evaluations. The reference runs over every leaf of the model with the
untrainable gradients zeroed: on the trainable part that gives these
iterates for as long as the untrainable leaves stay put. Between the steps
of `VB_NG_LBFGS` the natural-gradient step moves the CVI sites, which the
reference's memory then records as a parameter difference, so that from its
second step its direction also moves the sites; here the sites are not
L-BFGS variables and only the natural-gradient step moves them.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..utils.training import trainable_parameters
from .trainer import NatGradTrainer

__all__ = ["LBFGSTrainer", "SwitchTrainer", "VB_NG_LBFGS"]

_MEMORY = 10  # optax.lbfgs's memory_size
# optax.scale_by_zoom_linesearch's defaults
_TOL, _INCREASE, _SLOPE_RTOL, _CURV_RTOL, _APPROX_DEC_RTOL, _STEP_PRECISION = (
    0.0, 2.0, 1e-4, 0.9, 1e-6, 1e-5)

_f = np.float64


def _vdot(a, b) -> float:
    return _f(torch.dot(a, b).item())


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN (or inf) when it has none, which the caller's range
    tests reject."""
    with np.errstate(all="ignore"):
        return _cubicmin_raw(a, fa, fpa, b, fb, c, fc)


def _cubicmin_raw(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc * dc * r0 + -(db * db) * r1) / denom
    B = (-(dc * (dc * dc)) * r0 + db * (db * db) * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    with np.errstate(all="ignore"):
        db = b - a
        B = (fb - fa - fpa * db) / (db * db)
        return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo, or Hager and Zhang's approximate decrease near a minimum; the
    violation (0 if met, inf for NaN)."""
    dec = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * _SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - _APPROX_DEC_RTOL * np.abs(value_init)
    dec = np.minimum(np.maximum(approx, delta), dec)
    dec = np.maximum(dec, 0.0)
    return _f(np.inf) if np.isnan(dec) else dec


def _curvature_error(slope, slope_init):
    curv = np.maximum(np.abs(slope) - _CURV_RTOL * np.abs(slope_init), 0.0)
    return _f(np.inf) if np.isnan(curv) else curv


class _Zoom:
    """The zoom line search's state for one direction; `trial(stepsize)`
    gives (value, slope) on the line."""

    def __init__(self, trial, value, slope, guess, max_steps):
        self.trial, self.guess, self.max_steps = trial, guess, max_steps
        self.count = 0
        self.stepsize, self.value, self.slope = _f(0.0), value, slope
        self.value_init, self.slope_init = value, slope
        self.decrease_error = self.curvature_error = _f(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = _f(0.0), value, slope
        self.high, self.value_high, self.slope_high = _f(0.0), value, slope
        self.cubic_ref, self.value_cubic_ref = _f(0.0), value
        self.safe_stepsize, self.safe_value = _f(0.0), value

    def _errors(self, stepsize, value, slope):
        dec = _decrease_error(stepsize, value, slope, self.value_init, self.slope_init)
        curv = _curvature_error(slope, self.slope_init)
        return dec, curv, np.maximum(dec, curv)

    def _search_interval(self):
        """Algorithm 3.5: grow the step until an interval holds a good one."""
        new = self.guess if self.count == 0 else _INCREASE * self.stepsize
        value, slope = self.trial(new)
        dec, curv, err = self._errors(new, value, slope)
        if dec <= _TOL:
            self.safe_stepsize, self.safe_value = new, value
        set_high = bool(dec > 0.0) or (bool(value >= self.value) and self.count > 0)
        set_low = bool(slope >= 0.0) and not set_high
        prev = (self.stepsize, self.value, self.slope)
        cur = (new, value, slope)
        (self.low, self.value_low, self.slope_low), (self.high, self.value_high,
                                                     self.slope_high) = (
            (cur, prev) if set_low else (prev, cur))
        self.interval_found = set_high or set_low or bool(err <= _TOL)
        self.done = bool(err <= _TOL)
        self.failed = self.count + 1 >= self.max_steps and not self.done
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self._moved_to(new, value, slope, dec, curv)

    def _zoom_into_interval(self):
        """Algorithm 3.6: shrink [low, high] by interpolation or bisection."""
        low, high = self.low, self.high
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        too_small = bool(delta <= _STEP_PRECISION)
        cubic = _cubicmin(low, self.value_low, self.slope_low, high, self.value_high,
                          self.cubic_ref, self.value_cubic_ref)
        use_cubic = bool(cubic > left + 0.2 * delta) and bool(cubic < right - 0.2 * delta)
        quad = _quadmin(low, self.value_low, self.slope_low, high, self.value_high)
        use_quad = (not use_cubic and bool(quad > left + 0.1 * delta)
                    and bool(quad < right - 0.1 * delta))
        if use_cubic:
            middle = cubic
        elif use_quad:
            middle = quad
        else:
            middle = (low + high) / 2.0
        value, slope = self.trial(middle)
        dec, curv, err = self._errors(middle, value, slope)
        if dec <= _TOL and bool(value < self.safe_value):
            self.safe_stepsize, self.safe_value = middle, value
        self.done = bool(err <= _TOL)
        set_high_to_middle = bool(dec > 0.0) or bool(value >= self.value_low)
        set_high_to_low = bool(slope * (high - low) >= 0.0) and not set_high_to_middle
        old_low = (low, self.value_low, self.slope_low)
        old_high = (high, self.value_high, self.slope_high)
        if set_high_to_middle or set_high_to_low:
            self.cubic_ref, self.value_cubic_ref = old_high[:2]
        else:
            self.cubic_ref, self.value_cubic_ref = old_low[:2]
        if set_high_to_middle:
            self.high, self.value_high, self.slope_high = middle, value, slope
        if set_high_to_low:
            self.high, self.value_high, self.slope_high = old_low
        if not set_high_to_middle:
            self.low, self.value_low, self.slope_low = middle, value, slope
        presumably_failed = (self.count + 1 >= self.max_steps
                             or (too_small and self.safe_stepsize > 0.0))
        self.failed = presumably_failed and not self.done
        self._moved_to(middle, value, slope, dec, curv)

    def _moved_to(self, stepsize, value, slope, dec, curv):
        self.stepsize, self.value, self.slope = stepsize, value, slope
        self.decrease_error, self.curvature_error = dec, curv
        self.count += 1

    def run(self):
        """The accepted step size (the safe one, with sufficient decrease, if
        the search failed)."""
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom_into_interval()
            else:
                self._search_interval()
            if self.failed and (self.safe_stepsize > 0.0 or np.isinf(self.decrease_error)):
                self.stepsize, self.value = self.safe_stepsize, self.safe_value
        return self.stepsize


class LBFGSTrainer:
    """Full-batch L-BFGS on the model's hyperparameters (its non-fixed
    `Param.raw`s). The memory belongs to the raws of the model given here,
    so `train` takes that model. `linesearch_steps[i]` is the number of
    line-search trials of iteration i."""

    def __init__(self, model: Any, max_linesearch_steps: int = 20):
        self._params = trainable_parameters(model)
        like = next(iter(self._params), None)
        if like is None:
            like = next(model.buffers())
        n = sum(p.numel() for p in self._params)
        kw = dict(dtype=like.dtype, device=like.device)
        self.max_linesearch_steps = max_linesearch_steps
        self.count = 0
        self.prev_x = torch.zeros(n, **kw)
        self.prev_g = torch.zeros(n, **kw)
        self.dw = torch.zeros(_MEMORY, n, **kw)
        self.du = torch.zeros(_MEMORY, n, **kw)
        self.rho = torch.zeros(_MEMORY, **kw)
        self.learning_rate = _f(1.0)
        self.linesearch_steps = []

    def _flat(self, tensors):
        return torch.cat([t.detach().reshape(-1) for t in tensors] + [self.prev_x.new_zeros(0)])

    @torch.no_grad()
    def _write(self, x):
        offset = 0
        for p in self._params:
            p.copy_(x[offset:offset + p.numel()].view_as(p))
            offset += p.numel()

    def _value_and_grad(self, model):
        loss = model.get_objective()
        grads = (torch.autograd.grad(loss, self._params, allow_unused=True, materialize_grads=True)
                 if self._params else [])
        return _f(loss.item()), self._flat(grads)

    def _direction(self, x, g):
        """The L-BFGS update of the memory and the preconditioned gradient
        (`optax.scale_by_lbfgs`)."""
        m = _MEMORY
        idx, prev_idx = self.count % m, (self.count - 1) % m
        if self.count > 0:
            dw, du = x - self.prev_x, g - self.prev_g
            s = torch.dot(du, dw)
            weight = torch.where(s == 0.0, 0.0, 1.0 / s)
        else:
            dw, du, weight = torch.zeros_like(x), torch.zeros_like(g), torch.zeros_like(self.rho[0])
        self.dw[prev_idx], self.du[prev_idx], self.rho[prev_idx] = dw, du, weight
        if self.count > 0:
            den = torch.sum(du * du)
            scale = torch.where(den > 0.0, torch.dot(du, dw) / den, 1.0)
        else:
            scale = torch.clamp(1.0 / torch.sqrt(torch.sum(g * g)), max=1.0)
        order = [(idx + i) % m for i in range(m)]
        vec, alphas = g, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * torch.dot(self.dw[i], vec)
            vec = vec + (-alphas[i]) * self.du[i]
        vec = scale * vec
        for i in order:
            beta = self.rho[i] * torch.dot(self.du[i], vec)
            vec = vec + (alphas[i] - beta) * self.dw[i]
        self.count += 1
        self.prev_x, self.prev_g = x, g
        return vec

    def step(self, model) -> float:
        """One L-BFGS iteration; returns the objective before it."""
        x = self._flat(self._params)
        loss, g = self._value_and_grad(model)
        u = -self._direction(x, g)

        def trial(stepsize):
            self._write(x + float(stepsize) * u)
            value, grad = self._value_and_grad(model)
            return value, _vdot(grad, u)

        zoom = _Zoom(trial, loss, _vdot(u, g), self.learning_rate, self.max_linesearch_steps)
        self.learning_rate = zoom.run()
        self.linesearch_steps.append(zoom.count)
        self._write(x + float(self.learning_rate) * u)
        return loss

    def train(self, model: Any, iters: int, callback: Callable | None = None):
        """`iters` iterations; returns `(model, losses)`, `losses[i]` the
        objective before iteration i."""
        if [id(p) for p in trainable_parameters(model)] != [id(p) for p in self._params]:
            raise ValueError("LBFGSTrainer.train takes the model the trainer was built for")
        losses = []
        for i in range(iters):
            loss = float(self.step(model))
            losses.append(loss)
            if callback:
                callback(i, model, loss)
        return model, losses


class SwitchTrainer:
    """Alternate between trainers in rounds: trainer k runs
    `epochs_per_round[k]` epochs per round (the reference's `SwitchTrainer`)."""

    def __init__(self, trainers: list, epochs_per_round: list):
        self.trainers = trainers
        self.epochs_per_round = epochs_per_round

    def train(self, model: Any, rounds: int):
        losses = []
        for _ in range(rounds):
            for trainer, n in zip(self.trainers, self.epochs_per_round):
                out = trainer.train(model, n)
                model, ls = out if isinstance(out, tuple) else (out, [])
                losses.extend(ls if isinstance(ls, list) else [])
        return model, losses


class VB_NG_LBFGS:
    """One natural-gradient site step and one L-BFGS hyperparameter step per
    epoch (the reference's `VB_NG_LBFGS`).

    Not the JAX package's iterates from the second L-BFGS step on: there the
    L-BFGS memory records the natural-gradient step's move of the sites as
    a parameter difference and its direction moves the sites too, while here
    the L-BFGS vector is the trainable raws only (module docstring). The
    losses agree for the first two epochs and differ from the third."""

    def __init__(self, model: Any, ng_lr: float = 1.0):
        self.lbfgs = LBFGSTrainer(model)
        self.ng = NatGradTrainer()
        self.ng_lr = ng_lr

    def train(self, model: Any, epochs: int):
        """Returns `(model, losses)`: `losses[i]` the objective after epoch
        i's natural-gradient step, before its L-BFGS step."""
        losses = []
        for _ in range(epochs):
            model = self.ng.train(model, [self.ng_lr])
            model, ls = self.lbfgs.train(model, 1)
            losses.extend(ls)
        return model, losses

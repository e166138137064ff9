"""Bijector-warped observations with log-Jacobian corrections (PyTorch).

Counterpart of `physs_gp_tpu/data/transformed.py`: observations are
modelled on a warped scale z = g(y) (log for positive data, Box-Cox, ...),
and the |dg/dy| Jacobian keeps the lml and NLPD in the original data space.
A flow without a closed-form log-Jacobian takes it by `torch.func.grad`.
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "Flow",
    "LogTransform",
    "BoxCoxTransform",
    "AffineTransform",
    "ExpTransform",
    "SoftplusTransform",
    "SquareTransform",
    "ReverseFlow",
    "CompositeFlow",
    "TransformedData",
]


class Flow:
    """An elementwise invertible transform: forward(y) = z, the modelled scale."""

    def forward(self, y):
        raise NotImplementedError

    def inverse(self, z):
        raise NotImplementedError

    def log_det_jacobian(self, y):
        """log |d forward / dy| elementwise, by autodiff unless overridden."""
        g = torch.func.grad(lambda v: torch.sum(self.forward(v)))
        return torch.log(torch.abs(g(y)))


class LogTransform(Flow):
    def __init__(self, shift: float = 0.0):
        self.shift = shift

    def forward(self, y):
        return torch.log(y + self.shift)

    def inverse(self, z):
        return torch.exp(z) - self.shift

    def log_det_jacobian(self, y):
        return -torch.log(y + self.shift)


class AffineTransform(Flow):
    def __init__(self, scale: float = 1.0, loc: float = 0.0):
        self.scale, self.loc = scale, loc

    def forward(self, y):
        return (y - self.loc) / self.scale

    def inverse(self, z):
        return z * self.scale + self.loc

    def log_det_jacobian(self, y):
        return torch.full_like(y, -math.log(abs(self.scale)))


class BoxCoxTransform(Flow):
    def __init__(self, lam: float = 0.5):
        self.lam = lam

    def forward(self, y):
        return (y**self.lam - 1.0) / self.lam

    def inverse(self, z):
        return (z * self.lam + 1.0) ** (1.0 / self.lam)

    def log_det_jacobian(self, y):
        return (self.lam - 1.0) * torch.log(y)


class ExpTransform(Flow):
    """z = exp(y)."""

    def forward(self, y):
        return torch.exp(y)

    def inverse(self, z):
        return torch.log(z)

    def log_det_jacobian(self, y):
        return y


class SoftplusTransform(Flow):
    """z = log(1 + e^y); its Softminus is `ReverseFlow(SoftplusTransform())`."""

    def forward(self, y):
        return torch.nn.functional.softplus(y)

    def inverse(self, z):
        # log(expm1(z)), stable for large z: z + log1p(-exp(-z))
        return z + torch.log(-torch.expm1(-z))

    def log_det_jacobian(self, y):
        return torch.nn.functional.logsigmoid(y)


class SquareTransform(Flow):
    """z = y^2 on positive data; the inverse takes the positive branch."""

    def forward(self, y):
        return y * y

    def inverse(self, z):
        return torch.sqrt(z)

    def log_det_jacobian(self, y):
        return torch.log(2.0 * torch.abs(y))


class ReverseFlow(Flow):
    """A base flow with forward and inverse swapped; the log-Jacobian by autodiff."""

    def __init__(self, base: Flow):
        self.base = base

    def forward(self, y):
        return self.base.inverse(y)

    def inverse(self, z):
        return self.base.forward(z)


class CompositeFlow(Flow):
    """Flows applied left to right on forward, with the chain-rule
    log-Jacobian (each flow's at its own input)."""

    def __init__(self, flows):
        self.flows = tuple(flows)

    def forward(self, y):
        for f in self.flows:
            y = f.forward(y)
        return y

    def inverse(self, z):
        for f in reversed(self.flows):
            z = f.inverse(z)
        return z

    def log_det_jacobian(self, y):
        total = torch.zeros_like(y)
        for f in self.flows:
            total = total + f.log_det_jacobian(y)
            y = f.forward(y)
        return total


class TransformedData:
    """A warped view of observations Y and its lml correction: fit the
    model on `Z` (NaN kept), add `lml_correction()` to its lml to state it
    in the original data space, and map predictive moments back with
    `to_data_space`."""

    def __init__(self, Y, flow: Flow):
        self.Y = Y
        self.flow = flow

    def _filled(self):
        ok = torch.isfinite(self.Y)
        return ok, torch.where(ok, self.Y, torch.ones_like(self.Y))

    @property
    def Z(self):
        ok, y = self._filled()
        return torch.where(ok, self.flow.forward(y), float("nan"))

    def lml_correction(self):
        ok, y = self._filled()
        return torch.sum(torch.where(ok, self.flow.log_det_jacobian(y), 0.0))

    def to_data_space(self, z_mean, z_var):
        """Warped Gaussian moments pushed back to the data scale: exact
        log-normal moments for `LogTransform`, else the delta method."""
        if isinstance(self.flow, LogTransform):
            mean = torch.exp(z_mean + 0.5 * z_var) - self.flow.shift
            var = torch.expm1(z_var) * torch.exp(2 * z_mean + z_var)
            return mean, var
        g_inv = torch.func.vmap(torch.func.grad(lambda z: torch.sum(self.flow.inverse(z))))
        dz = g_inv(z_mean.reshape(-1, 1)).reshape(z_mean.shape)
        return self.flow.inverse(z_mean), z_var * dz**2

"""Kernel base classes (PyTorch).

Counterpart of the parts of `physs_gp_tpu/kernels/base.py` that RBF and
Matern32 need. Kernels are `nn.Module`s; every kernel exposes the scalar
form `k_scalar(x1, x2)`, and stationary kernels the matmul Gram path.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Kernel", "StationaryKernel", "scaled_sqdist"]


def _as_2d(X):
    X = torch.as_tensor(X)
    if X.dim() == 1:
        X = X[:, None]
    return X


def scaled_sqdist(X1, X2, lengthscales):
    """Pairwise squared distance of lengthscale-scaled inputs [N, D], [M, D]
    -> [N, M], with the cross term as one matmul."""
    X1 = _as_2d(X1) / lengthscales
    X2 = _as_2d(X2) / lengthscales
    n1 = torch.sum(X1 * X1, -1)
    n2 = torch.sum(X2 * X2, -1)
    d2 = n1[:, None] + n2[None, :] - 2.0 * (X1 @ X2.T)
    return torch.clamp(d2, min=0.0)


class Kernel(nn.Module):
    """Abstract kernel."""

    def k_scalar(self, x1, x2):
        raise NotImplementedError


class StationaryKernel(Kernel):
    """ARD stationary kernel: variance * k_r(||(x1 - x2) / ls||); subclasses
    give the unit-variance correlation `k_from_sqdist(d2)`."""

    def k_from_sqdist(self, d2):
        raise NotImplementedError

    def k_scalar(self, x1, x2):
        diff = (torch.atleast_1d(x1) - torch.atleast_1d(x2)) / self.lengthscales.value
        d2 = torch.sum(diff * diff)
        return self.variance.value * self.k_from_sqdist(d2)

    def K(self, X1, X2):
        d2 = scaled_sqdist(X1, X2, self.lengthscales.value)
        return self.variance.value * self.k_from_sqdist(d2)

    def K_diag(self, X):
        X = _as_2d(X)
        return torch.ones(X.shape[0], dtype=X.dtype, device=X.device) * self.variance.value

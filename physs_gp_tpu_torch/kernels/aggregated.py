"""Aggregated (region-averaged) observations (PyTorch).

Counterpart of `physs_gp_tpu/kernels/aggregated.py`: observations are
averages of f over regions, y_i = (1/|A_i|) ∫_{A_i} f(x) dx + eps. The
kernel between two region averages is the double integral of the base
kernel, here by fixed quadrature over each region: one Gram over all the
quadrature nodes, then a weighted block sum. Its inputs are region
indices, so a `BatchGP` over it takes X = the indices as a [R, 1] column.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import Kernel

__all__ = ["AggregatedKernel", "uniform_box_nodes"]


def uniform_box_nodes(lows, highs, n_per_dim: int = 4):
    """Midpoint-rule nodes [R, Q, D] and averaging weights [R, Q] (rows sum
    to 1) for axis-aligned boxes with bounds lows / highs [R, D] (numpy);
    1-D bounds [R] are R regions on the line."""
    lows, highs = np.asarray(lows, float), np.asarray(highs, float)
    if lows.ndim == 1:
        lows, highs = lows[:, None], highs[:, None]
    R, D = lows.shape
    frac = (np.arange(n_per_dim) + 0.5) / n_per_dim
    mesh = np.stack(np.meshgrid(*([frac] * D), indexing="ij"), -1).reshape(-1, D)
    Q = mesh.shape[0]
    nodes = lows[:, None, :] + mesh[None] * (highs - lows)[:, None, :]
    return nodes, np.full((R, Q), 1.0 / Q)


class AggregatedKernel(Kernel):
    """K between region averages of a base-kernel GP, from per-region
    quadrature nodes [R, Q, D] and weights [R, Q]:
    K(i, j) = sum_{q q'} w_iq w_jq' k(x_iq, x_jq')."""

    def __init__(self, base, nodes, weights):
        super().__init__()
        self.base = base
        self.register_buffer("nodes", torch.as_tensor(nodes))
        self.register_buffer("weights", torch.as_tensor(weights))

    def _regions(self, X_idx):
        idx = torch.as_tensor(X_idx, device=self.nodes.device).reshape(-1).long()
        return self.nodes[idx], self.weights[idx]

    def K(self, X1_idx, X2_idx):
        """The Gram between the regions of two index arrays."""
        n1, w1 = self._regions(X1_idx)  # [R1, Q, D], [R1, Q]
        n2, w2 = self._regions(X2_idx)
        R1, Q, D = n1.shape
        Kfull = self.base.K(n1.reshape(-1, D), n2.reshape(-1, D)).reshape(R1, Q, n2.shape[0], -1)
        return torch.einsum("iq,iqjp,jp->ij", w1, Kfull, w2)

    def K_diag(self, X_idx):
        n, w = self._regions(X_idx)
        Kb = torch.func.vmap(lambda nn: self.base.K(nn, nn))(n)  # [R, Q, Q]
        return torch.einsum("iq,iqp,ip->i", w, Kb, w)

    def cross_K(self, X_idx, Xs):
        """The covariance [R, Ns] between region averages and point values at Xs."""
        n, w = self._regions(X_idx)
        R, Q, D = n.shape
        Kc = self.base.K(n.reshape(-1, D), torch.atleast_2d(torch.as_tensor(Xs))).reshape(R, Q, -1)
        return torch.einsum("iq,iqs->is", w, Kc)

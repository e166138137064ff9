"""Multi-output mixing for the linear model of coregionalisation (PyTorch
counterpart of the state-space part of `physs_gp_tpu/kernels/multi_output.py`).

Outputs f = W g mix independent latent GPs g; the parameterisations differ
only in how W is built, so they are mixing objects exposing `.value`
[P, L], as a `Param` does. `UnitLowerMixing` is the unit-lower-triangular
W (the reference's `LMC_LDL`). `CorrelationMixing` and the batch `LMC`
kernel are not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils.params import param

__all__ = ["UnitLowerMixing"]


class UnitLowerMixing(nn.Module):
    """W = eye(P, L) with a trainable strict lower triangle `z` (row-major):
    the unit diagonal pins output p to latent p, the strict-lower entries
    mix in earlier latents."""

    def __init__(self, z, P: int, L: int):
        super().__init__()
        self.z = z
        self.P = P
        self.L = L

    @classmethod
    def init(cls, P: int, L: int | None = None, dtype=None, device=None) -> "UnitLowerMixing":
        L = P if L is None else L
        n = len(np.tril_indices(P, -1, L)[0])
        return cls(z=param(torch.zeros(n), dtype=dtype, device=device), P=P, L=L)

    @property
    def value(self):
        z = self.z.value
        rows, cols = np.tril_indices(self.P, -1, self.L)
        W = torch.eye(self.P, self.L, dtype=z.dtype, device=z.device)
        return W.index_put((torch.as_tensor(rows, device=z.device),
                            torch.as_tensor(cols, device=z.device)), z)

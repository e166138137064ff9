"""Multi-output mixing for the linear model of coregionalisation (PyTorch
counterpart of `physs_gp_tpu/kernels/multi_output.py`).

Outputs f = W g mix independent latent GPs g; the parameterisations differ
only in how W is built, so they are mixing objects exposing `.value`
[P, L], as a `Param` does. `UnitLowerMixing` is the unit-lower-triangular
W (the reference's `LMC_LDL`). The batch `LMC` kernel,

    Cov(f_p(x), f_q(x')) = sum_l W_pl W_ql k_l(x, x'),

gives data-major block Grams like `DerivativeKernel`. `CorrelationMixing`
(`LMC.init_drd`, the reference's `LMC_DRD`) is W = diag(scales) L_corr(z),
L_corr the correlation Cholesky of `likelihoods/dynamic_covariance`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .base import Kernel, _as_2d
from .derivative import data_major
from ..likelihoods.dynamic_covariance import correlation_cholesky
from ..utils.params import Param, param, positive_param

__all__ = ["UnitLowerMixing", "CorrelationMixing", "LMC"]


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


class CorrelationMixing(nn.Module):
    """W = diag(scales) L_corr(z): trainable positive per-output `scales`
    [P] and a unit-diagonal correlation from the unconstrained `z` [Q],
    squashed into (-1, 1) by the probit 2 Φ(z) - 1. W Wᵀ = diag(s) C diag(s)
    (the reference's `LMC_DRD`)."""

    def __init__(self, scales: Param, z: Param, P: int):
        super().__init__()
        self.scales = scales
        self.z = z
        self.P = P

    @classmethod
    def init(cls, P: int, scales=None, dtype=None, device=None) -> "CorrelationMixing":
        s = torch.ones(P) if scales is None else torch.as_tensor(scales)
        return cls(scales=positive_param(s, dtype=dtype, device=device),
                   z=param(torch.zeros(P * (P - 1) // 2), dtype=dtype, device=device), P=P)

    @property
    def value(self):
        zc = 2.0 * torch.special.ndtr(self.z.value) - 1.0
        return self.scales.value[:, None] * correlation_cholesky(zc, self.P)


class LMC(Kernel):
    """Linear model of coregionalisation over independent latent kernels."""

    def __init__(self, latents, W):
        super().__init__()
        self.latents = nn.ModuleList(latents)
        self.W = W

    @classmethod
    def init(cls, latents, P: int, generator=None, dtype=None, device=None) -> "LMC":
        """W [P, L] standard normal / sqrt(L), drawn from `generator` (a
        `torch.Generator` on `device`; None draws from one seeded with 0)."""
        L = len(latents)
        if generator is None:
            generator = torch.Generator(device=device or "cpu").manual_seed(0)
        W0 = torch.randn(P, L, generator=generator, dtype=dtype, device=device) / np.sqrt(L)
        return cls(latents, Param(W0))

    @classmethod
    def init_ldl(cls, latents, P: int, dtype=None, device=None) -> "LMC":
        """Unit-lower-triangular mixing (the reference's `LMC_LDL`): plain
        LMC with W = I while the strict-lower entries are zero."""
        return cls(latents, UnitLowerMixing.init(P, len(latents), dtype=dtype, device=device))

    @classmethod
    def init_drd(cls, latents, scales=None, dtype=None, device=None) -> "LMC":
        """diag(scales) @ correlation-Cholesky mixing (the reference's
        `LMC_DRD`); as many latents as outputs (square W)."""
        return cls(latents, CorrelationMixing.init(len(latents), scales=scales, dtype=dtype,
                                                   device=device))

    @property
    def n_outputs(self) -> int:
        return self.W.value.shape[0]

    def K_blocks(self, X1, X2):
        """[P, P, N, M] mixed covariance blocks."""
        W = self.W.value
        Ks = torch.stack([k.K(X1, X2) for k in self.latents])  # [L, N, M]
        return torch.einsum("pl,lnm,ql->pqnm", W, Ks, W)

    def K(self, X1, X2):
        return data_major(self.K_blocks(_as_2d(X1), _as_2d(X2)))

    def K_diag(self, X):
        X = _as_2d(X)
        W = self.W.value
        kd = torch.stack([k.K_diag(X) for k in self.latents])  # [L, N]
        return torch.einsum("pl,ln->np", W * W, kd).reshape(-1)

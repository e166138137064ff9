"""Conjugate-computation VI (CVI) sites and natural-gradient updates (PyTorch).

Counterpart of `physs_gp_tpu/approx/cvi.py`. The approximate posterior is a
surrogate conjugate model q(f) ∝ p(f) Π_t N(Ỹ_t | f_t, Ṽ_t); the step is

    λ1 ← (1 - lr) λ1 + lr (g1 - 2 g2 m)
    λ2 ← (1 - lr) λ2 + lr g2,       λ1 = Ṽ⁻¹Ỹ,  λ2 = -0.5 Ṽ⁻¹,

with (g1, g2) = ∂ELL/∂(m, S) of the data ELL at the current q marginals,
taken with `torch.func.grad` (so the step also runs under `torch.func.vmap`,
`models/stacked.py`). Missing observations keep NaN site means.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.matrix import mat_inv, symmetrize

__all__ = ["Sites", "init_sites", "to_natural", "from_natural", "natgrad_update"]

_MIN_PREC = 1e-8  # floor on site precision (keeps Ṽ finite)


class Sites(nn.Module):
    """CVI pseudo-observations N(Ỹ_t | f_t, Ṽ_t): Y [T, p] (NaN = inactive),
    V [T, p, p]."""

    def __init__(self, Y, V):
        super().__init__()
        self.register_buffer("Y", Y)
        self.register_buffer("V", V)


def init_sites(Y_data, init_var: float = 1.0, active=None) -> Sites:
    """Weak initial sites centred on zero; inactive elements stay NaN."""
    T, p = Y_data.shape
    if active is None:
        active = torch.isfinite(Y_data)
    Y0 = torch.where(active, 0.0, float("nan")).to(Y_data.dtype)
    eye = torch.eye(p, dtype=Y_data.dtype, device=Y_data.device)
    V0 = (init_var * eye).expand(T, p, p).contiguous()
    return Sites(Y0, V0)


def to_natural(sites: Sites):
    """(Ỹ, Ṽ) -> (λ1, λ2); NaN site means count as zero."""
    Vinv = mat_inv(sites.V)
    lam1 = torch.einsum("tij,tj->ti", Vinv, torch.nan_to_num(sites.Y))
    return lam1, -0.5 * Vinv


def from_natural(lam1, lam2, nan_mask=None) -> Sites:
    """(λ1, λ2) -> (Ỹ, Ṽ) with the precision floored away from zero."""
    prec = symmetrize(-2.0 * lam2)
    p = prec.shape[-1]
    diag = torch.diagonal(prec, dim1=-2, dim2=-1)
    scale = torch.clamp(torch.amax(torch.abs(diag), -1), min=1.0)
    eps = _MIN_PREC * scale
    prec = prec + eps[..., None, None] * torch.eye(p, dtype=prec.dtype, device=prec.device)
    V = mat_inv(prec, jitter=0.0)  # already floored: no extra jitter
    Y = torch.einsum("tij,tj->ti", V, lam1)
    if nan_mask is not None:
        Y = torch.where(nan_mask, float("nan"), Y)
    return Sites(Y, symmetrize(V))


def natgrad_update(sites: Sites, m, S, ell_fn, lr: float, grads=None,
                   naturals=None) -> Sites:
    """One CVI natural-gradient step on all sites jointly.

    `ell_fn(m, S)` is the data expected log-likelihood of the q(f) block
    moments m [T, p], S [T, p, p]; its gradient is taken here unless `grads`
    gives (g1, g2). `naturals` overrides `to_natural(sites)`.
    """
    if grads is None:
        g1, g2 = torch.func.grad(ell_fn, argnums=(0, 1))(m.detach(), S.detach())
    else:
        g1, g2 = grads
    g2 = symmetrize(g2)
    lam1, lam2 = naturals if naturals is not None else to_natural(sites)
    lam1_new = (1.0 - lr) * lam1 + lr * (g1 - 2.0 * torch.einsum("tij,tj->ti", g2, m))
    lam2_new = (1.0 - lr) * lam2 + lr * g2
    return from_natural(lam1_new, lam2_new, ~torch.isfinite(sites.Y))

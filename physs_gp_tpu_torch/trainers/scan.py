"""CVI natural-gradient training loop (PyTorch counterpart of
`physs_gp_tpu/trainers/scan.natgrad_scan`).

The JAX package runs the steps inside one compiled `lax.scan`; here they run
as a Python loop. The NaN guard keeps the reference semantics: a step whose
sites go non-finite is reverted (that iteration becomes a no-op).
"""
from __future__ import annotations

from typing import Any

import torch

__all__ = ["natgrad_scan"]


def _as_lrs(lrs, n_steps):
    # learning rates are float32 in the reference loop; keep its rounding
    lrs = torch.as_tensor(lrs, dtype=torch.float32)
    if lrs.dim() == 0:
        if n_steps is None:
            raise ValueError("scalar lr requires n_steps")
        lrs = lrs.expand(int(n_steps))
    return [float(lr) for lr in lrs]


def _sites_ok(new_sites, old_sites) -> bool:
    """Finite site variances and an unchanged finite pattern of site means
    (inactive sites are NaN by convention)."""
    v_ok = torch.all(torch.isfinite(new_sites.V))
    y_ok = torch.all(torch.isfinite(new_sites.Y) == torch.isfinite(old_sites.Y))
    return bool(v_ok & y_ok)


@torch.no_grad()
def natgrad_scan(model: Any, lrs, n_steps: int | None = None, nan_guard: bool = True):
    """N CVI natural-gradient steps on a model exposing `step_with_elbo(lr)`.

    Returns `(model, elbos)` with `elbos[i]` the pre-update ELBO of step i.
    The model's sites are updated in place.
    """
    elbos = []
    for lr in _as_lrs(lrs, n_steps):
        old_sites = model.sites
        model, elbo = model.step_with_elbo(lr)
        if nan_guard and not _sites_ok(model.sites, old_sites):
            model.sites = old_sites
        elbos.append(elbo)
    return model, torch.stack(elbos)

"""Training loops that keep their results on the device (PyTorch counterpart
of `physs_gp_tpu/trainers/scan.py`).

The JAX package runs each schedule inside one compiled `lax.scan`; here the
steps run as a Python loop, and what the reference keeps in the graph stays
on the device: the ELBOs and losses are stacked and read once by the
caller, and the NaN guard picks the new or the old sites with
`torch.where`, with no read-back to the host. A step whose sites go
non-finite is reverted (that iteration becomes a no-op), as in the
reference.

Adam is `optax.adam`'s update (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias-corrected), which `torch.optim.Adam` computes. The
natural-gradient half runs under `torch.no_grad()`, so no site carries
autograd history into the next iteration.

`generator=` (a `torch.Generator` on the model's device, where the
reference splits a PRNG key per step) gives Monte-Carlo objectives fresh
noise at every step; within one `vb_ng_adam_scan` iteration both halves
share one set of draws, as the reference's halves share one key. Without
it every step uses the model's frozen draws.
"""
from __future__ import annotations

from typing import Any

import torch

from ..approx.cvi import Sites
from ..utils.training import trainable_parameters

__all__ = ["adam_scan", "natgrad_scan", "vb_ng_adam_scan"]


def _as_lrs(lrs, n_steps):
    # learning rates are float32 in the reference loop; keep its rounding
    lrs = torch.as_tensor(lrs, dtype=torch.float32)
    if lrs.dim() == 0:
        if n_steps is None:
            raise ValueError("scalar lr requires n_steps")
        lrs = lrs.expand(int(n_steps))
    return [float(lr) for lr in lrs]


def _sites_ok(new_sites, old_sites, batch_dims: int = 0):
    """Finite site variances and an unchanged finite pattern of site means
    (inactive sites are NaN by convention): a bool tensor over the leading
    `batch_dims` dimensions (a stacked model's members), 0-d without."""
    lead = new_sites.Y.shape[:batch_dims]
    v_ok = torch.all(torch.isfinite(new_sites.V).reshape(*lead, -1), -1)
    y_ok = torch.all((torch.isfinite(new_sites.Y) == torch.isfinite(old_sites.Y)).reshape(*lead, -1), -1)
    return v_ok & y_ok


@torch.no_grad()
def _guard_sites(model, old_sites) -> None:
    """Keep the model's new sites if they pass `_sites_ok`, else the old;
    per member of a stacked model (`models/stacked.py`). A time-sharded
    model (`mesh`) holds its segment of the sites: the check holds for the
    series when it holds on every rank, so every rank takes one branch."""
    batch_dims = getattr(model, "batch_dims", 0)
    ok = _sites_ok(model.sites, old_sites, batch_dims)
    if getattr(model, "mesh", None) is not None:
        from ..parallel import sharded

        ok = sharded.all_ranks(ok, model.mesh, model.mesh_axis)

    def pick(new, old):
        return torch.where(ok.reshape(ok.shape + (1,) * (new.dim() - batch_dims)), new, old)

    model.sites = Sites(pick(model.sites.Y, old_sites.Y), pick(model.sites.V, old_sites.V))


def _adam(model, lr: float) -> torch.optim.Adam:
    """`optax.adam(lr)` over the model's trainable raws."""
    return torch.optim.Adam(trainable_parameters(model), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _adam_step(model, opt, **mc):
    """One Adam step on `model.get_objective(**mc)`; returns the objective
    before the update, detached, on the device."""
    opt.zero_grad(set_to_none=True)
    loss = model.get_objective(**mc)
    loss.backward()
    opt.step()
    return loss.detach()


def _mc(generator) -> dict:
    """The keyword that passes `generator` on; none without one."""
    return {} if generator is None else {"generator": generator}


@torch.no_grad()
def natgrad_scan(model: Any, lrs, n_steps: int | None = None, hessian: str = "exact",
                 generator=None, nan_guard: bool = True):
    """N CVI natural-gradient steps on a model exposing
    `step_with_elbo(lr, hessian, generator=)`.

    Returns `(model, elbos)` with `elbos[i]` the pre-update ELBO of step i
    ([B] for a stacked model, `models/stacked.py`, whose members each keep
    or revert their own sites). The model's sites are updated in place.
    """
    elbos = []
    for lr in _as_lrs(lrs, n_steps):
        old_sites = model.sites
        model, elbo = model.step_with_elbo(lr, hessian=hessian, **_mc(generator))
        if nan_guard:
            _guard_sites(model, old_sites)
        elbos.append(elbo)
    return model, torch.stack(elbos)


def adam_scan(model: Any, n_steps: int, lr: float = 1e-2, generator=None):
    """N Adam steps on the trainable hyperparameters of any model exposing
    `get_objective()` (`get_objective(generator=)` with a generator).
    Returns `(model, losses)`, `losses[i]` the objective before step i; the
    model's raws are updated in place."""
    opt = _adam(model, lr)
    losses = [_adam_step(model, opt, **_mc(generator)) for _ in range(n_steps)]
    return model, torch.stack(losses)


def vb_ng_adam_scan(model: Any, n_steps: int, adam_lr: float = 1e-2, ng_lr: float = 1.0,
                    hessian: str = "exact", generator=None, nan_guard: bool = True):
    """VB_NG_ADAM: each iteration is one natural-gradient site step, then
    one Adam step on the trainable hyperparameters (ref
    `trainers/standard.py:58`).

    Returns `(model, elbos)`: `elbos[i]` is the ELBO Adam saw at iteration
    i (after the natural-gradient step, before the Adam step).
    """
    opt = _adam(model, adam_lr)
    elbos = []
    for lr in _as_lrs(ng_lr, n_steps):
        old_sites = model.sites
        mc = {} if generator is None else {"draws": model.mc_draws(generator)}
        model.natural_gradient_update(lr, hessian, **mc)
        if nan_guard:
            _guard_sites(model, old_sites)
        elbos.append(-_adam_step(model, opt, **mc))
    return model, torch.stack(elbos)

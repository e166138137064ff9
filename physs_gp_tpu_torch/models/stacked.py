"""Independent CVI models run as one stacked batch (PyTorch counterpart of
`jax.vmap` over `CVIGP`s, as the JAX package's dryrun steps many series in
one program).

`StackedCVIGP(models)` takes B `CVIGP`s of one structure and one series
length, each with its own parameters, data and sites, and holds:

- `template`: the first model, whose code runs every member;
- `state`: every parameter and buffer of the models stacked along a new
  leading dimension B (`torch.func.stack_module_state`), the sites under
  `sites.Y` [B, T, p] and `sites.V` [B, T, p, p].

Each method runs the template's own method once for all B members: under
`torch.func.vmap`, with the member's state swapped in by
`torch.func.functional_call`. Every kernel wrapper then launches once per
call with the B members folded into its batch (`ops/cuda/build.KernelOp`'s
vmap rule), so a stacked step launches each kernel as often as one model's
step does. `step_with_elbo`, `natural_gradient_update`, `elbo` and
`posterior` are the `CVIGP` methods of those names, with a leading B on
what they return; the two steps replace the stacked sites (the models
handed in are not changed). `trainers.natgrad_scan` takes a stacked model
and guards each member's sites on its own.

Monte-Carlo likelihoods take `draws=` stacked along B, or none: every member
then uses its likelihood's frozen draws, as a single model does without a
generator (the stacked methods take no `generator`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..approx.cvi import Sites
from .ssgp import GaussianMoments

__all__ = ["StackedCVIGP"]


class _Apply(nn.Module):
    """`fn(model, *args)` as a module call, so that `functional_call`
    swaps one member's state into `model`."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, fn, *args):
        return fn(self.model, *args)


class StackedCVIGP:
    """B independent `CVIGP`s of one structure as one stacked batch."""

    batch_dims = 1  # `trainers.scan` guards the sites per member

    def __init__(self, models):
        models = list(models)
        if not models:
            raise ValueError("StackedCVIGP needs at least one model")
        params, buffers = torch.func.stack_module_state(models)
        self.template = models[0]
        self.state = {**{k: v.detach() for k, v in params.items()}, **buffers}
        self.batch_size = len(models)
        self._apply = _Apply(self.template)

    def _map(self, fn, *batched):
        """fn(member, *args) for every member at once; `batched` holds
        tensors with a leading B or None (passed as None)."""
        given = [x for x in batched if x is not None]

        def one(state, *xs):
            it = iter(xs)
            args = [None if x is None else next(it) for x in batched]
            return torch.func.functional_call(
                self._apply, {f"model.{k}": v for k, v in state.items()}, (fn, *args))

        return torch.func.vmap(one, randomness="same")(self.state, *given)

    # ---- the stacked sites ----
    @property
    def sites(self) -> Sites:
        return Sites(self.state["sites.Y"], self.state["sites.V"])

    @sites.setter
    def sites(self, sites: Sites) -> None:
        self.state["sites.Y"], self.state["sites.V"] = sites.Y, sites.V

    # ---- the CVIGP methods, once for all members ----
    @torch.no_grad()
    def natgrad_step(self, lr: float, hessian: str = "exact", draws=None,
                     with_elbo: bool = True):
        """(new stacked sites, pre-update ELBOs [B] or None); pure."""

        def fn(model, d):
            sites, elbo = model.natgrad_step(lr, hessian, d, with_elbo)
            return (sites.Y, sites.V) + ((elbo,) if with_elbo else ())

        out = self._map(fn, draws)
        return Sites(out[0], out[1]), out[2] if with_elbo else None

    def natural_gradient_update(self, lr: float, hessian: str = "exact", draws=None):
        """One CVI step of every member; the stacked sites are replaced."""
        self.sites, _ = self.natgrad_step(lr, hessian, draws, with_elbo=False)
        return self

    def step_with_elbo(self, lr: float, hessian: str = "exact", draws=None):
        """One CVI step of every member and the pre-update ELBOs [B]."""
        self.sites, elbo = self.natgrad_step(lr, hessian, draws)
        return self, elbo

    @torch.no_grad()
    def elbo(self, draws=None):
        """The ELBOs [B]."""
        return self._map(lambda model, d: model.elbo(draws=d), draws)

    @torch.no_grad()
    def posterior(self) -> GaussianMoments:
        """q(f)'s marginals, mean and var [B, T, p]."""
        return GaussianMoments(*self._map(lambda model: tuple(model.posterior())))

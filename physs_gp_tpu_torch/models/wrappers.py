"""Model wrappers: multi-objective training and latent-head prediction
(PyTorch counterpart of `physs_gp_tpu/models/wrappers.py`)."""
from __future__ import annotations

from torch import nn

from .ssgp import GaussianMoments

__all__ = ["MultiObjectiveModel", "LatentPredictor"]


class MultiObjectiveModel(nn.Module):
    """The sum of several models' objectives, for one shared training loop.
    Natural-gradient updates go to the members that have them; as the
    port's CVI updates work in place, the update returns this model, and a
    member listed twice is updated once (the reference updates each entry
    once from the same state)."""

    def __init__(self, models):
        super().__init__()
        self.models = nn.ModuleList(models)

    def get_objective(self):
        return sum(m.get_objective() for m in self.models)

    def elbo(self):
        return -self.get_objective()

    def natural_gradient_update(self, lr: float) -> "MultiObjectiveModel":
        members = {id(m): m for m in self.models}
        for m in members.values():
            if hasattr(m, "natural_gradient_update"):
                m.natural_gradient_update(lr)
        return self

    def __getitem__(self, i):
        return self.models[i]


class LatentPredictor(nn.Module):
    """One latent head of a multi-head model (for example the derivative
    head of a physics model), as a [..., 1] column."""

    def __init__(self, base, head: int = 0):
        super().__init__()
        self.base = base
        self.head = head

    def _column(self, p) -> GaussianMoments:
        sl = slice(self.head, self.head + 1)
        return GaussianMoments(mean=p.mean[..., sl], var=p.var[..., sl])

    def predict_f(self, t_new) -> GaussianMoments:
        return self._column(self.base.predict_f(t_new))

    def posterior(self) -> GaussianMoments:
        return self._column(self.base.posterior())

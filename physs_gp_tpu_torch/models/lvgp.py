"""Latent-variable GP: trainable per-datapoint latent inputs, GPLVM-style
(PyTorch counterpart of `physs_gp_tpu/models/lvgp.py`).

The inputs of a `BatchGP` are augmented with a trainable latent W, either
concatenated ([X, W], `mode="concat"`) or added (X + W, `mode="additive"`),
and W is optimised jointly with the hyperparameters under an isotropic
N(0, prior_var I) prior (MAP: point-estimate latents).
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils.params import param
from ..utils.shapes import as_points
from .batch_gp import BatchGP
from .ssgp import GaussianMoments

__all__ = ["LatentVariableGP"]


class LatentVariableGP(nn.Module):
    """BatchGP over [X, W] (concat) or X + W (additive); `base.X` holds the
    observed inputs."""

    def __init__(self, base: BatchGP, W, mode: str = "concat", prior_var: float = 1.0):
        super().__init__()
        self.base = base
        self.W = W  # Param [N, dw] (concat) or [N, D] (additive)
        self.mode = mode
        self.prior_var = prior_var

    @classmethod
    def init(cls, X, Y, kernel, likelihood, dw: int = 1, mode: str = "concat",
             prior_var: float = 1.0, W0=None, generator=None, dtype=None,
             device="cuda") -> "LatentVariableGP":
        """W starts at `W0`, or at 0.01 times standard-normal draws from
        `generator` (a `torch.Generator` on `device`; one seeded with 0 by
        default). The data live on `device`, the card unless the caller asks
        for the CPU."""
        X = as_points(X, dtype=dtype, device=device)
        if W0 is None:
            if generator is None:
                generator = torch.Generator(device=X.device).manual_seed(0)
            shape = X.shape if mode == "additive" else (X.shape[0], dw)
            W0 = 0.01 * torch.randn(shape, generator=generator, dtype=X.dtype, device=X.device)
        base = BatchGP(X, Y, kernel, likelihood, dtype=X.dtype, device=X.device)
        W = param(torch.as_tensor(W0, dtype=X.dtype, device=X.device))
        return cls(base, W, mode=mode, prior_var=prior_var)

    def _augmented(self) -> BatchGP:
        """The base model over the augmented inputs (sharing its kernel,
        likelihood and mean)."""
        b, Wv = self.base, self.W.value
        X = b.X + Wv if self.mode == "additive" else torch.cat([b.X, Wv], 1)
        return BatchGP(X, b.Y, b.kernel, b.likelihood, mean=b.mean, solver=b.solver,
                       cg_tol=b.cg_tol, slq_probes=b.slq_probes, slq_iters=b.slq_iters,
                       device=X.device)

    def log_marginal_likelihood(self):
        return self._augmented().log_marginal_likelihood()

    def get_objective(self):
        """-lml - log N(W | 0, prior_var I): MAP over the latent inputs."""
        Wv = self.W.value
        log_prior = -0.5 * torch.sum(Wv * Wv) / self.prior_var
        return -(self.log_marginal_likelihood() + log_prior)

    def predict_f(self, X_new, W_new=None) -> GaussianMoments:
        """Predict at new inputs; W_new defaults to zeros (the prior mean of
        the latent)."""
        X_new = as_points(X_new, dtype=self.base.X.dtype, device=self.base.X.device)
        if self.mode == "additive":
            Xq = X_new if W_new is None else X_new + torch.as_tensor(W_new, dtype=X_new.dtype,
                                                                      device=X_new.device)
        else:
            Wq = (X_new.new_zeros((X_new.shape[0], self.W.value.shape[1])) if W_new is None
                  else as_points(W_new, dtype=X_new.dtype, device=X_new.device))
            Xq = torch.cat([X_new, Wq], 1)
        return self._augmented().predict_f(Xq)

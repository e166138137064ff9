"""Spatio-temporal state-space GP with Kronecker spatial conditionals
(PyTorch counterpart of `physs_gp_tpu/models/stgp.py`).

Filtering runs over the Kron-lifted state (temporal Markov blocks at the Ns
spatial sites); prediction at new space points is the linear read-out
w(s*) ⊗ h_t of the smoothed states plus the separable conditional-variance
correction. PDE residual rows (e.g. 2-D advection-diffusion) are
`STOperatorHead` observations; see `transforms/operators.py`.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.matrix import diag_from_XDXT
from ..transforms.operators import SpatialHead, StateObservation, derivative_row
from ..utils.shapes import as_points
from .ssgp import GaussianMoments, StateSpaceGP

__all__ = ["SpatioTemporalGP"]


class SpatioTemporalGP(nn.Module):
    """A `StateSpaceGP` over the Kron-lifted system plus spatial reads.

    core.Y is [T, p]: the first Ns columns are the grid observations (NaN
    where missing), further columns come from extra heads (collocation rows
    and the like).
    """

    def __init__(self, core: StateSpaceGP):
        super().__init__()
        self.core = core

    @classmethod
    def build(cls, t, Y_grid, st_kernel, likelihood, extra_heads=None, extra_Y=None,
              parallel: bool = False, sqrt: bool = False, chunk_size=None) -> "SpatioTemporalGP":
        """t [T]; Y_grid [T, Ns] observations at the kernel's sites Z (NaN =
        missing); extra_heads: more observation heads (physics) with their
        targets extra_Y [T, n_extra] (0 for residuals; NaN = off)."""
        heads = [SpatialHead(points=st_kernel.sites)]
        Y = Y_grid
        if extra_heads:
            heads = heads + list(extra_heads)
            Y = torch.cat([Y_grid, extra_Y], 1)
        core = StateSpaceGP(
            t=t.reshape(-1), Y=Y, kernel=st_kernel, likelihood=likelihood,
            observation=StateObservation(heads=heads), parallel=parallel, sqrt=sqrt,
            chunk_size=chunk_size,
        )
        return cls(core=core)

    # ---- passthroughs ----
    def log_marginal_likelihood(self):
        return self.core.log_marginal_likelihood()

    def get_objective(self):
        return self.core.get_objective()

    def posterior(self) -> GaussianMoments:
        return self.core.posterior()

    @property
    def kernel(self):
        return self.core.kernel

    # ---- spatio-temporal prediction ----
    def predict_grid(self, s_new, t_new=None) -> GaussianMoments:
        """q(f) at new spatial points s_new [N*, ds] (or [N*]) at the
        training times, or at `t_new` (the time grid augmented with NaN rows,
        sorted stably, smoothed and unsorted). Returns moments [Nt, N*]
        (ref `ST_SDE_GP.predict_f`, `models/sde_gp.py:882`)."""
        core = self.core
        kern = core.kernel
        s_new = as_points(s_new, dtype=core.Y.dtype, device=core.Y.device)
        if t_new is None:
            _, _, s = core.filter_smooth()
            ms, Ps = s.ms, s.Ps
        else:
            t_new = torch.as_tensor(t_new, dtype=core.t.dtype, device=core.t.device).reshape(-1)
            T, p = core.Y.shape
            t_all = torch.cat([core.t, t_new])
            Y_all = torch.cat([core.Y, core.Y.new_full((t_new.shape[0], p), float("nan"))])
            order = torch.argsort(t_all, stable=True)
            inv = torch.argsort(order)
            aug = StateSpaceGP(
                t=t_all[order], Y=Y_all[order], kernel=kern, likelihood=core.likelihood,
                observation=core.observation, parallel=core.parallel, sqrt=core.sqrt,
                chunk_size=core.chunk_size,
            )
            _, _, s = aug.filter_smooth()
            ms, Ps = s.ms[inv][T:], s.Ps[inv][T:]
        w = kern.spatial_weights(s_new)  # [N*, Ns]
        t_row = derivative_row(kern.k_time, 0)  # [d]
        H_new = torch.einsum("ns,d->nsd", w, t_row).reshape(s_new.shape[0], -1)  # [N*, Ns*d]
        mean = ms @ H_new.T  # [Nt, N*]
        var = diag_from_XDXT(H_new, Ps)
        var = var + kern.conditional_var_correction(s_new)[None, :]
        return GaussianMoments(mean=mean, var=var)

"""Zoo: state-space multi-output GPs (PyTorch counterpart of
`physs_gp_tpu/zoo/multi_output.py`).

`lmc_markov_gp` is the O(T) state-space form of the linear model of
coregionalisation: L independent Markov latents stack block-diagonally
(`StackedMarkov`) and the P outputs are mixing rows of the observation
matrix (`MixedValueHead`), with the batch LMC's marginal
Cov(g_p, g_q) = Σ_l W_pl W_ql k_l.
"""
from __future__ import annotations

import torch

from ..kernels.markov import StackedMarkov
from ..likelihoods.gaussian import BlockDiagonalGaussian, Gaussian, IndependentGaussian
from ..models.cvi_gp import CVIGP
from ..models.ssgp import StateSpaceGP
from ..transforms.operators import MixedValueHead, StateObservation
from ..utils.params import param, positive_param

__all__ = ["lmc_markov_gp"]


def lmc_markov_gp(t, Y, latents, mixing=None, noise: float = 0.1, likelihood=None,
                  dtype=torch.float64, parallel: bool = False, sqrt: bool = False,
                  chunk_size=None, cvi: bool = False, device="cuda"):
    """State-space LMC: P observed outputs = W @ (L independent Markov GPs).

    t [T] sorted times; Y [T, P] (NaN = missing); `latents` a list of Markov
    kernels. `mixing` is anything `MixedValueHead` takes (a [P, L] tensor or
    array, a `Param`, a `kernels.multi_output.UnitLowerMixing`); None is a
    trainable W starting at eye(P, L). A non-Gaussian `likelihood` (or
    `cvi=True`) gives the CVI model, a Gaussian one the exact
    `StateSpaceGP`."""
    kw = dict(dtype=dtype, device=device)
    t = torch.as_tensor(t, **kw)
    Y = torch.as_tensor(Y, **kw)
    P, L = Y.shape[1], len(latents)
    if mixing is None:
        mixing = param(torch.eye(P, L), **kw)
    elif not isinstance(mixing, torch.nn.Module):
        mixing = torch.as_tensor(mixing, **kw)
    kern = StackedMarkov(list(latents))
    obs = StateObservation([MixedValueHead(mixing)])
    lik = likelihood or IndependentGaussian([positive_param(noise, **kw) for _ in range(P)])
    if cvi or not isinstance(lik, (Gaussian, IndependentGaussian, BlockDiagonalGaussian)):
        return CVIGP.init(t, Y, kern, lik, observation=obs, parallel=parallel, sqrt=sqrt,
                          chunk_size=chunk_size)
    return StateSpaceGP(t=t, Y=Y, kernel=kern, likelihood=lik, observation=obs,
                        parallel=parallel, sqrt=sqrt, chunk_size=chunk_size)

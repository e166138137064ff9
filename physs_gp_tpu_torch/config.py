"""Library defaults (PyTorch counterpart of `physs_gp_tpu/config.py`).

The reference's mutable global settings are explicit arguments on the
objects they govern, in the port as in the JAX package (jitter per dtype in
`ops.matrix.default_jitter`, `parallel=` / `sqrt=` / `chunk_size=` on the
models, `n_mc` on the Monte-Carlo likelihoods, the fused-combine knob
`PHYSS_FUSED_COMBINE`). This module holds the default kernel and likelihood
factories of the reference's `defaults.py`, on `device` (the card unless
the caller asks for the CPU).
"""
from __future__ import annotations

import torch

__all__ = ["Defaults", "default_kernel", "default_likelihood"]


def default_kernel(dtype=torch.float64, device="cuda"):
    """The default kernel: RBF with lengthscale 1 and variance 1."""
    from .kernels.rbf import RBF
    from .utils.params import positive_param

    return RBF(lengthscales=positive_param(1.0, dtype=dtype, device=device),
               variance=positive_param(1.0, dtype=dtype, device=device))


def default_likelihood(dtype=torch.float64, device="cuda"):
    """The default likelihood: Gaussian with variance 1."""
    from .likelihoods.gaussian import Gaussian
    from .utils.params import positive_param

    return Gaussian(variance=positive_param(1.0, dtype=dtype, device=device))


class Defaults:
    kernel = staticmethod(default_kernel)
    likelihood = staticmethod(default_likelihood)

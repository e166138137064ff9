"""RBF / squared-exponential kernel (PyTorch counterpart of
`physs_gp_tpu/kernels/rbf.py`)."""
from __future__ import annotations

import torch

from .base import StationaryKernel, _as_2d
from ..utils.params import Param, positive_param

__all__ = ["RBF", "rbf"]


class RBF(StationaryKernel):
    def __init__(self, lengthscales: Param, variance: Param):
        super().__init__()
        self.lengthscales = lengthscales
        self.variance = variance

    def k_from_sqdist(self, d2):
        return torch.exp(-0.5 * d2)

    def K_op(self, S, Z, kind):
        """Closed-form derivative cross-covariances (L_s k)(S, Z), the operator
        applied in the first argument; kind in {"identity", ("grad", i),
        ("grad2", i), "laplacian"}, with d = S - Z and ARD lengthscales l:
            grad_i:    -k d_i / l_i^2
            laplacian: k (sum_i d_i^2 / l_i^4 - sum_i 1 / l_i^2)
        """
        S, Z = _as_2d(S), _as_2d(Z)
        K = self.K(S, Z)  # [N, Ns]
        if kind == "identity":
            return K
        ls = torch.atleast_1d(self.lengthscales.value).expand(S.shape[1])
        D = S[:, None, :] - Z[None, :, :]  # [N, Ns, ds]
        if isinstance(kind, tuple) and kind[0] == "grad":
            i = kind[1]
            return -K * D[..., i] / ls[i] ** 2
        if kind == "laplacian":
            quad = torch.sum(D * D / ls**4, -1)
            return K * (quad - torch.sum(1.0 / ls**2))
        if isinstance(kind, tuple) and kind[0] == "grad2":
            i = kind[1]
            return K * (D[..., i] ** 2 / ls[i] ** 4 - 1.0 / ls[i] ** 2)
        raise ValueError(f"unknown spatial operator kind: {kind!r}")


def rbf(lengthscales=1.0, variance=1.0, dtype=None, device=None) -> RBF:
    """An `RBF` with positive lengthscales and variance."""
    kw = dict(dtype=dtype, device=device)
    return RBF(lengthscales=positive_param(lengthscales, **kw), variance=positive_param(variance, **kw))

"""Batch derivative-operator kernels by nested autodiff (PyTorch counterpart
of `physs_gp_tpu/kernels/derivative.py`).

Outputs are linear-operator views L_a f of one scalar GP, and

    Cov((L_a f)(x), (L_b f)(x')) = L_a^x L_b^{x'} k(x, x')

comes from the base kernel's closed form (`k_deriv_fn`) where it has one,
else from nested `torch.func.grad` over its scalar form, evaluated over all
pairs with `torch.func.vmap`. An optional mixing W [P_out, P_ops] (a fixed
tensor or a `Param`) left-multiplies the operator outputs: curl-free fields
(W = −I), the 2-D divergence-free rotation, learned mixings.
"""
from __future__ import annotations

import torch

from .base import Kernel, _as_2d, _deriv, pairwise

__all__ = ["DerivativeKernel", "grad_ops", "second_order_ops", "data_major"]


def grad_ops(ds: int, include_value: bool = False):
    """Ops for (f,) and the gradient components: [(), (0,), (1,), ...]."""
    ops = [()] if include_value else []
    return tuple(ops) + tuple((i,) for i in range(ds))


def second_order_ops(ds: int):
    """(f, ∂_i f ..., ∂_ii f ...)."""
    return ((),) + tuple((i,) for i in range(ds)) + tuple((i, i) for i in range(ds))


def data_major(B):
    """[P, Q, N, M] blocks -> the data-major Gram [N·P, M·Q], row i·P + p."""
    P, Q, N, M = B.shape
    return B.permute(2, 0, 3, 1).reshape(N * P, M * Q)


class DerivativeKernel(Kernel):
    """Multi-output kernel over (L_a f)_a for the derivative operators `ops`
    (tuples of input dims; () is the identity). With `W`, the outputs are
    g = W (L f). Grams are data-major: K[(i, p), (j, q)] at row i·P + p."""

    def __init__(self, base, ops: tuple = ((),), W=None):
        super().__init__()
        self.base = base
        self.ops = tuple(ops)
        if W is None or isinstance(W, torch.nn.Module):
            self.W = W
        else:
            self.register_buffer("W", torch.as_tensor(W))

    def _mix(self):
        if self.W is None:
            return None
        return self.W.value if isinstance(self.W, torch.nn.Module) else self.W

    @property
    def n_outputs(self) -> int:
        W = self._mix()
        return len(self.ops) if W is None else W.shape[0]

    def K_blocks(self, X1, X2):
        """[P_ops, P_ops, N, M] operator-covariance blocks."""
        X1, X2 = _as_2d(X1), _as_2d(X2)
        return torch.stack([
            torch.stack([pairwise(_deriv(self.base, a, b), X1, X2) for b in self.ops])
            for a in self.ops
        ])

    def K(self, X1, X2):
        """Data-major multi-output Gram [N·P, M·P]."""
        B = self.K_blocks(X1, X2)
        W = self._mix()
        if W is not None:
            B = torch.einsum("pa,abnm,qb->pqnm", W, B, W)
        return data_major(B)

    def K_diag(self, X):
        X = _as_2d(X)
        B = torch.stack([
            torch.stack([torch.func.vmap(lambda x, f=_deriv(self.base, a, b): f(x, x))(X)
                         for b in self.ops])
            for a in self.ops
        ])  # [P, Q, N]
        W = self._mix()
        if W is not None:
            return torch.einsum("pa,abn,pb->np", W, B, W).reshape(-1)  # diag of W B Wᵀ
        return torch.diagonal(B, dim1=0, dim2=1).reshape(-1)  # [N, P] data-major

"""Point-array normalisation shared across models and zoo recipes (PyTorch
counterpart of `physs_gp_tpu/utils/shapes.py`).

A 1-D array of points is N points in ONE dimension, a column; `atleast_2d`
would make it one N-dimensional row instead, which broadcasts through kernel
evaluation with the wrong geometry. Every user-facing entry point that takes
points routes through here.
"""
from __future__ import annotations

import torch

__all__ = ["as_points"]


def as_points(A, dtype=None, D=None, what="query points", device=None) -> torch.Tensor:
    """[N] -> [N, 1]; [N, D] unchanged; scalars become [1, 1].

    `D`: expected input dimension; a mismatch raises."""
    A = torch.as_tensor(A, dtype=dtype, device=device)
    if A.dim() == 0:
        A = A[None]
    if A.dim() == 1:
        A = A[:, None]
    if D is not None and A.shape[-1] != D:
        raise ValueError(f"{what} have {A.shape[-1]} input dims; expected {D}")
    return A

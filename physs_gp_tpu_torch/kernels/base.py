"""Kernel base classes (PyTorch).

Counterpart of `physs_gp_tpu/kernels/base.py`. Kernels are `nn.Module`s;
every kernel exposes the scalar form `k_scalar(x1, x2)` (vectors in, scalar
out), and stationary kernels the matmul Gram path. Derivative covariances
∂^a_{x1} ∂^b_{x2} k are nested `torch.func.grad` over the scalar form
(`autodiff_deriv_fn`), unless the kernel gives a closed form
(`k_deriv_fn`); the parameters stay closed over, so the outer autograd
still reaches them. `+` and `*` build `SumKernel` and `ProductKernel`;
`OnDims` routes a kernel onto a subset of the input dims.
"""
from __future__ import annotations

import torch
from torch import nn

from ..utils.params import positive_param

__all__ = [
    "Kernel",
    "OnDims",
    "StationaryKernel",
    "SumKernel",
    "ProductKernel",
    "WhiteNoise",
    "Bias",
    "LinearKernel",
    "autodiff_deriv_fn",
    "scaled_sqdist",
]


def _as_2d(X):
    X = torch.as_tensor(X)
    if X.dim() == 1:
        X = X[:, None]
    return X


def scaled_sqdist(X1, X2, lengthscales):
    """Pairwise squared distance of lengthscale-scaled inputs [N, D], [M, D]
    -> [N, M], with the cross term as one matmul."""
    X1 = _as_2d(X1) / lengthscales
    X2 = _as_2d(X2) / lengthscales
    n1 = torch.sum(X1 * X1, -1)
    n2 = torch.sum(X2 * X2, -1)
    d2 = n1[:, None] + n2[None, :] - 2.0 * (X1 @ X2.T)
    return torch.clamp(d2, min=0.0)


def pairwise(fn, X1, X2):
    """[N, M] of fn(x1_i, x2_j) over the rows of X1 [N, D] and X2 [M, D]."""
    return torch.func.vmap(lambda a: torch.func.vmap(lambda b: fn(a, b))(X2))(X1)


def autodiff_deriv_fn(k_scalar, a: tuple, b: tuple):
    """∂^a_{x1} ∂^b_{x2} k by nested autodiff over the scalar form (a and b
    are tuples of input dims). Right for kernels smooth at x1 == x2 (RBF,
    ...); |τ| kernels (Matérn) give closed forms in `k_deriv_fn` instead,
    because the floor inside their square root zeroes the chain there."""
    f = k_scalar
    for i in a:
        f = (lambda g, i=i: lambda x1, x2: torch.func.grad(g, argnums=0)(x1, x2)[i])(f)
    for j in b:
        f = (lambda g, j=j: lambda x1, x2: torch.func.grad(g, argnums=1)(x1, x2)[j])(f)
    return f


def _like(*tensors):
    return dict(dtype=tensors[0].dtype, device=tensors[0].device)


class Kernel(nn.Module):
    """Abstract kernel."""

    def k_scalar(self, x1, x2):
        raise NotImplementedError

    def k_deriv_fn(self, a: tuple, b: tuple):
        """A closed-form fn(x1, x2) = ∂^a_{x1} ∂^b_{x2} k, or None for the
        nested-autodiff tower (`autodiff_deriv_fn`)."""
        return None

    def K(self, X1, X2):
        return pairwise(self.k_scalar, _as_2d(X1), _as_2d(X2))

    def K_diag(self, X):
        return torch.func.vmap(lambda a: self.k_scalar(a, a))(_as_2d(X))

    def __add__(self, other: "Kernel") -> "SumKernel":
        return SumKernel(_flatten(self, other, SumKernel))

    def __mul__(self, other: "Kernel") -> "ProductKernel":
        return ProductKernel(_flatten(self, other, ProductKernel))


def _flatten(a: Kernel, b: Kernel, cls) -> list:
    parts = []
    for k in (a, b):
        parts.extend(k.parts if isinstance(k, cls) else [k])
    return parts


def _deriv(kernel, a, b):
    return kernel.k_deriv_fn(a, b) or autodiff_deriv_fn(kernel.k_scalar, a, b)


class StationaryKernel(Kernel):
    """ARD stationary kernel: variance * k_r(||(x1 - x2) / ls||); subclasses
    give the unit-variance correlation `k_from_sqdist(d2)`."""

    def k_from_sqdist(self, d2):
        raise NotImplementedError

    def k_scalar(self, x1, x2):
        diff = (torch.atleast_1d(x1) - torch.atleast_1d(x2)) / self.lengthscales.value
        d2 = torch.sum(diff * diff)
        return self.variance.value * self.k_from_sqdist(d2)

    def K(self, X1, X2):
        d2 = scaled_sqdist(X1, X2, self.lengthscales.value)
        return self.variance.value * self.k_from_sqdist(d2)

    def K_diag(self, X):
        X = _as_2d(X)
        return torch.ones(X.shape[0], dtype=X.dtype, device=X.device) * self.variance.value


class SumKernel(Kernel):
    def __init__(self, parts):
        super().__init__()
        self.parts = nn.ModuleList(parts)

    def k_scalar(self, x1, x2):
        return sum(k.k_scalar(x1, x2) for k in self.parts)

    def K(self, X1, X2):
        return sum(k.K(X1, X2) for k in self.parts)

    def K_diag(self, X):
        return sum(k.K_diag(X) for k in self.parts)

    def k_deriv_fn(self, a, b):
        # derivatives distribute over sums; each part keeps its closed form
        fns = [_deriv(k, a, b) for k in self.parts]
        return lambda x1, x2: sum(f(x1, x2) for f in fns)


class OnDims(Kernel):
    """`base` on a subset of the input dims: k(x1, x2) = base(x1[dims],
    x2[dims]). Separable products are `OnDims(k_t, (0,)) * OnDims(k_s, (1, 2))`."""

    def __init__(self, base, dims: tuple = (0,)):
        super().__init__()
        self.base = base
        self.dims = tuple(dims)

    def _pick(self, x):
        return torch.atleast_1d(x)[..., list(self.dims)]

    def k_scalar(self, x1, x2):
        return self.base.k_scalar(self._pick(x1), self._pick(x2))

    def K(self, X1, X2):
        return self.base.K(_as_2d(X1)[:, list(self.dims)], _as_2d(X2)[:, list(self.dims)])

    def K_diag(self, X):
        return self.base.K_diag(_as_2d(X)[:, list(self.dims)])

    def k_deriv_fn(self, a, b):
        """Global derivative dims map onto the base's local dims; a
        derivative in a dim this kernel ignores is identically zero."""
        if any(g not in self.dims for g in (*a, *b)):
            return lambda x1, x2: torch.zeros((), dtype=x1.dtype, device=x1.device)
        la = tuple(self.dims.index(g) for g in a)
        lb = tuple(self.dims.index(g) for g in b)
        inner = _deriv(self.base, la, lb)
        return lambda x1, x2: inner(self._pick(x1), self._pick(x2))


class ProductKernel(Kernel):
    def __init__(self, parts):
        super().__init__()
        self.parts = nn.ModuleList(parts)

    def k_scalar(self, x1, x2):
        out = self.parts[0].k_scalar(x1, x2)
        for k in self.parts[1:]:
            out = out * k.k_scalar(x1, x2)
        return out

    def K(self, X1, X2):
        out = self.parts[0].K(X1, X2)
        for k in self.parts[1:]:
            out = out * k.K(X1, X2)
        return out

    def K_diag(self, X):
        out = self.parts[0].K_diag(X)
        for k in self.parts[1:]:
            out = out * k.K_diag(X)
        return out

    def k_deriv_fn(self, a, b):
        """Parts on disjoint `OnDims` subsets: each derivative index lands in
        one factor, so the product rule collapses to a product of per-factor
        derivatives. Otherwise None (the autodiff tower), which is refused
        when a part has a closed form (|τ| kernels are wrong under the
        tower at coincident points)."""
        if not (a or b):
            return None
        dims = [getattr(k, "dims", None) for k in self.parts]
        claimed = [g for d in dims for g in (d or ())]
        if (
            any(d is None for d in dims)
            or len(claimed) != len(set(claimed))
            or any(g not in claimed for g in (*a, *b))
        ):
            bad = [type(k).__name__ for k in self.parts
                   if type(k).k_deriv_fn is not Kernel.k_deriv_fn]
            if bad:
                raise ValueError(
                    f"ProductKernel derivative: parts are not disjoint OnDims "
                    f"factors, and {bad} have closed-form derivative "
                    f"covariances (|tau| kernels are WRONG under the autodiff "
                    f"tower at coincident points). Wrap each factor as "
                    f"OnDims(kernel, dims) with disjoint dims."
                )
            return None
        fns = [_deriv(k, tuple(g for g in a if g in d), tuple(g for g in b if g in d))
               for k, d in zip(self.parts, dims)]

        def fn(x1, x2):
            out = fns[0](x1, x2)
            for f in fns[1:]:
                out = out * f(x1, x2)
            return out

        return fn


class _VarianceKernel(Kernel):
    def __init__(self, variance=None, dtype=None, device=None):
        super().__init__()
        self.variance = variance if variance is not None else positive_param(
            1.0, dtype=dtype, device=device)

    def K_diag(self, X):
        X = _as_2d(X)
        return torch.ones(X.shape[0], **_like(X)) * self.variance.value


class WhiteNoise(_VarianceKernel):
    """variance where x1 == x2, else 0."""

    def k_scalar(self, x1, x2):
        v = self.variance.value
        return torch.where(torch.all(x1 == x2), v, torch.zeros_like(v))

    def K(self, X1, X2):
        X1, X2 = _as_2d(X1), _as_2d(X2)
        eq = torch.all(X1[:, None, :] == X2[None, :, :], -1)
        v = self.variance.value
        return torch.where(eq, v, torch.zeros_like(v))


class Bias(_VarianceKernel):
    """The constant kernel."""

    def k_scalar(self, x1, x2):
        return self.variance.value

    def K(self, X1, X2):
        X1, X2 = _as_2d(X1), _as_2d(X2)
        return torch.ones(X1.shape[0], X2.shape[0], **_like(X1)) * self.variance.value


class LinearKernel(_VarianceKernel):
    """k(x1, x2) = variance <x1, x2>."""

    def k_scalar(self, x1, x2):
        return self.variance.value * torch.dot(torch.atleast_1d(x1), torch.atleast_1d(x2))

    def K(self, X1, X2):
        X1, X2 = _as_2d(X1), _as_2d(X2)
        return self.variance.value * (X1 @ X2.T)

    def K_diag(self, X):
        X = _as_2d(X)
        return self.variance.value * torch.sum(X * X, -1)

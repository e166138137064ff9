"""Physics as linear observation operators over the Markov state (PyTorch).

Counterpart of the temporal and gridded spatio-temporal parts of
`physs_gp_tpu/transforms/operators.py`. A Matérn(p + 1/2) state holds
(f, f', ..., f^(p)) up to scale, so any linear temporal operator is a
constant row over the state: the temporal heads (`ValueHead`,
`DerivativeHead`, `LinearOperatorHead`) give one row (`.row`), the spatial
heads a block of rows (`.rows`). Spatial operators act through the Kronecker
spatial conditional w = (L_s k_s)(s, Z) Kzz^-1 and carry a `.kind` tag that
routes to the kernel's closed form (`RBF.K_op`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.matern import Matern

__all__ = [
    "derivative_row",
    "ValueHead",
    "DerivativeHead",
    "LinearOperatorHead",
    "StateObservation",
    "SpatialHead",
    "OperatorTerm",
    "STOperatorHead",
    "s_identity",
    "s_grad",
    "s_grad2",
    "s_laplacian",
]


def derivative_row(kernel, order: int):
    """Row vector w with f^(order)(t) = w @ state(t) (Matérn kernels; the
    Sum combinator and other Markov kernels are not ported yet)."""
    if not isinstance(kernel, Matern):
        raise NotImplementedError(f"derivative_row of {type(kernel).__name__}")
    d = kernel.p + 1
    if order >= d:
        raise ValueError(
            f"Matérn(p={kernel.p}) state holds derivatives up to order "
            f"{kernel.p}; requested {order}. Use a smoother kernel."
        )
    # balanced state: f^(k) = lam^k * x_k
    raw = kernel.lengthscales.raw
    onehot = (torch.arange(d, device=raw.device) == order).to(raw.dtype)
    return onehot * kernel._lam.to(raw.dtype) ** order


class ValueHead(nn.Module):
    """Observe f itself."""

    def row(self, kernel):
        return derivative_row(kernel, 0)


class DerivativeHead(nn.Module):
    """Observe f^(order), e.g. f' for monotonicity constraints."""

    def __init__(self, order: int = 1):
        super().__init__()
        self.order = order

    def row(self, kernel):
        return derivative_row(kernel, self.order)


class Coefficients(nn.Module):
    """A list of coefficients, each a number or a `Param` (registered as a
    submodule, so it trains); indexed as a list."""

    def __init__(self, values):
        super().__init__()
        self._values = list(values)
        for i, c in enumerate(self._values):
            if isinstance(c, nn.Module):
                self.add_module(str(i), c)

    def __len__(self):
        return len(self._values)

    def __iter__(self):
        return iter(self._values)

    def __getitem__(self, i):
        return self._values[i]

    def __setitem__(self, i, value):
        if isinstance(self._values[i], nn.Module) or isinstance(value, nn.Module):
            raise TypeError("only a number coefficient can be replaced")
        self._values[i] = value


class LinearOperatorHead(nn.Module):
    """Observe L[f] = sum_k c_k f^(k), a linear ODE residual (e.g. the damped
    oscillator f'' + c f' + k f observed as 0 at collocation times); a
    coefficient may be a trainable `Param`."""

    def __init__(self, coeffs):
        super().__init__()
        self.coeffs = Coefficients(coeffs)

    def row(self, kernel):
        out = 0.0
        for k, c in enumerate(self.coeffs):
            cv = c.value if hasattr(c, "value") else c
            out = out + cv * derivative_row(kernel, k)
        return out


def s_identity(k, s, z):
    """k_s itself, tagged for the closed form."""
    return k(s, z)


s_identity.kind = "identity"


def s_grad(i: int):
    """∂k_s/∂s_i in the first argument, tagged for the closed form."""

    def op(k, s, z):
        return torch.func.grad(lambda ss: k(ss, z))(s)[i]

    op.kind = ("grad", i)
    return op


def s_grad2(i: int):
    """∂²k_s/∂s_i² in the first argument, tagged for the closed form."""

    def op(k, s, z):
        return torch.func.grad(lambda ss: torch.func.grad(lambda s2: k(s2, z))(ss)[i])(s)[i]

    op.kind = ("grad2", i)
    return op


def s_laplacian(k, s, z):
    """Σ_i ∂²k_s/∂s_i² in the first argument, tagged for the closed form."""
    return torch.trace(torch.func.hessian(lambda ss: k(ss, z))(s))


s_laplacian.kind = "laplacian"


class StateObservation(nn.Module):
    """Observation matrix H [n_obs, d_state] stacked from heads: one row per
    `.row` head, a block per `.rows` head."""

    def __init__(self, heads):
        super().__init__()
        self.heads = nn.ModuleList(heads)

    def H(self, kernel):
        return torch.cat(
            [h.rows(kernel) if hasattr(h, "rows") else h.row(kernel)[None, :] for h in self.heads], 0
        )

    def var_correction(self, kernel):
        """[p] conditional-variance correction per head row, or None when
        every head reads the state exactly."""
        parts = []
        for h in self.heads:
            if hasattr(h, "var_correction") and getattr(h, "correction", True):
                parts.append(h.var_correction(kernel))
            else:  # reads the state exactly: a zero per row
                parts.append(h.points.shape[-2] if hasattr(h, "rows") else 1)
        like = next((c for c in parts if isinstance(c, torch.Tensor)), None)
        if like is None:
            return None
        return torch.cat([
            c if isinstance(c, torch.Tensor) else like.new_zeros(c) for c in parts
        ], 0)


class SpatialHead(nn.Module):
    """Observe coeff * (L_s ∂_t^order f)(s_k, t) at spatial points `points`:
    row block w ⊗ t_row. `correction=True` adds the conditional residual
    variance of off-site points to the observation noise."""

    def __init__(self, points, t_order: int = 0, s_op=None,
                 correction: bool = False, coeff=1.0):
        super().__init__()
        self.register_buffer("points", torch.as_tensor(points))
        self.t_order = t_order
        self.s_op = s_op
        self.correction = correction
        self.coeff = coeff

    def _coeff(self):
        return self.coeff.value if hasattr(self.coeff, "value") else self.coeff

    def rows(self, kernel):
        w = kernel.spatial_weights(self.points, self.s_op)  # [N_h, Ns]
        t_row = derivative_row(kernel.k_time, self.t_order)  # [d]
        N_h, Ns = w.shape
        return self._coeff() * torch.einsum("ns,d->nsd", w, t_row).reshape(
            N_h, Ns * t_row.shape[0]
        )

    def var_correction(self, kernel):
        if not self.correction:
            return torch.zeros(self.points.shape[0], dtype=self.points.dtype,
                               device=self.points.device)
        c = self._coeff()
        return (c * c) * kernel.conditional_var_correction(
            self.points, self.s_op, self.t_order
        )


class OperatorTerm(nn.Module):
    """One coeff * (L_s ∂_t^order f) term; coeff a float or a Param."""

    def __init__(self, coeff, t_order: int = 0, s_op=None):
        super().__init__()
        self.coeff = coeff
        self.t_order = t_order
        self.s_op = s_op


class STOperatorHead(nn.Module):
    """PDE residual rows sum_j c_j (L_s^j ∂_t^{o_j} f)(s_k, t), e.g. 2-D
    advection-diffusion ∂t f - a Δf + v·∇f:
        [OperatorTerm(1.0, t_order=1), OperatorTerm(-a, s_op=s_laplacian),
         OperatorTerm(vx, s_op=s_grad(0)), OperatorTerm(vy, s_op=s_grad(1))]."""

    def __init__(self, points, terms):
        super().__init__()
        self.register_buffer("points", torch.as_tensor(points))
        self.terms = nn.ModuleList(terms)

    def rows(self, kernel):
        out = None
        for term in self.terms:
            c = term.coeff
            cv = c.value if hasattr(c, "value") else c
            w = kernel.spatial_weights(self.points, term.s_op)  # [N_c, Ns]
            t_row = derivative_row(kernel.k_time, term.t_order)  # [d]
            block = torch.einsum("ns,d->nsd", w, t_row).reshape(
                w.shape[0], w.shape[1] * t_row.shape[0]
            )
            out = cv * block if out is None else out + cv * block
        return out

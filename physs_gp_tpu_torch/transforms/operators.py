"""Physics as linear observation operators over the Markov state (PyTorch).

Counterpart of `physs_gp_tpu/transforms/operators.py`. A Matérn(p + 1/2)
state holds (f, f', ..., f^(p)) up to scale, so any linear temporal operator
is a constant row over the state: the temporal heads (`ValueHead`,
`DerivativeHead`, `LinearOperatorHead`) give one row (`.row`), the spatial
heads a block of rows (`.rows`). Spatial operators act through the Kronecker
spatial conditional w = (L_s k_s)(s, Z) Kzz^-1; a `.kind` tag routes to the
kernel's closed form (`RBF.K_op`), and without one (or without `K_op`) the
operator is applied by nested autodiff. `ScatteredSpatialHead`
reads per-time-step points and gives a time-varying block [T, Ng, d];
`StackedHead` and `MixedValueHead` read a `StackedMarkov` state (fixed
physics mixings and the state-space LMC).
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.base import SumKernel
from ..kernels.markov import to_ss
from ..kernels.matern import Matern

__all__ = [
    "derivative_row",
    "ValueHead",
    "DerivativeHead",
    "LinearOperatorHead",
    "StateObservation",
    "SpatialHead",
    "ScatteredSpatialHead",
    "StackedHead",
    "ScaledHead",
    "MixedValueHead",
    "OperatorTerm",
    "STOperatorHead",
    "s_identity",
    "s_grad",
    "s_grad2",
    "s_laplacian",
]


def derivative_row(kernel, order: int):
    """Row vector w with f^(order)(t) = w @ state(t). Composes over sums (the
    parts' rows side by side); a Matérn state is balanced, any other Markov
    kernel's is taken as the canonical (f, f', ...) up to its state size."""
    if isinstance(kernel, SumKernel):
        return torch.cat([derivative_row(k, order) for k in kernel.parts])
    if isinstance(kernel, Matern):
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
    ss = to_ss(kernel)
    d = ss.state_dim
    if order >= d:
        raise ValueError(f"state dim {d} has no order-{order} derivative")
    return (torch.arange(d, device=ss.F.device) == order).to(ss.F.dtype)


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


class Entries(nn.Module):
    """A list whose entries are numbers, None or modules (each module
    registered as a submodule, so its Params train); indexed as a list, as
    the JAX package's lists and tuples are, so key paths such as
    `coeffs[1].raw` resolve. Only a number entry can be replaced."""

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
            raise TypeError("only a number entry can be replaced")
        self._values[i] = value


class LinearOperatorHead(nn.Module):
    """Observe L[f] = sum_k c_k f^(k), a linear ODE residual (e.g. the damped
    oscillator f'' + c f' + k f observed as 0 at collocation times); a
    coefficient may be a trainable `Param`."""

    def __init__(self, coeffs):
        super().__init__()
        self.coeffs = Entries(coeffs)

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
    """Observation matrix H stacked from heads: one row per `.row` head, a
    block per `.rows` head. H is [n_obs, d_state], or [T, n_obs, d_state]
    when a head is time-varying (its block is [T, N, d]; static blocks are
    broadcast over T). `steps` (a slice) builds a time-varying H over those
    steps alone (a rank's segment under time-axis sharding)."""

    def __init__(self, heads):
        super().__init__()
        self.heads = nn.ModuleList(heads)

    @property
    def n_heads(self) -> int:
        return len(self.heads)

    def H(self, kernel, steps: slice | None = None):
        blocks = [h.rows(kernel, steps) if isinstance(h, ScatteredSpatialHead)
                  else h.rows(kernel) if hasattr(h, "rows") else h.row(kernel)[None, :]
                  for h in self.heads]
        T = next((b.shape[0] for b in blocks if b.dim() == 3), None)
        if T is None:
            return torch.cat(blocks, 0)
        return torch.cat([b if b.dim() == 3 else b.expand((T,) + b.shape) for b in blocks], 1)

    def var_correction(self, kernel, steps: slice | None = None):
        """[p] or [T, p] conditional-variance correction per head row (over
        `steps` alone, as `H`), or None when every head reads the state
        exactly."""
        parts, any_corr = [], False
        for h in self.heads:
            if isinstance(h, ScatteredSpatialHead) and h.correction:
                parts.append(h.var_correction(kernel, steps))
                any_corr = True
            elif hasattr(h, "var_correction") and getattr(h, "correction", True):
                parts.append(h.var_correction(kernel))
                any_corr = True
            elif hasattr(h, "rows"):
                pts = getattr(h, "points", None)
                # reads the state exactly: a zero per row (per step and row
                # for per-step points; a point-free head counts its rows)
                if pts is not None and pts.dim() == 3 and steps is not None:
                    pts = pts[steps]
                parts.append(h.rows(kernel).shape[-2] if pts is None
                             else tuple(pts.shape[:-1]))
            else:
                parts.append(1)
        if not any_corr:
            return None
        like = next(c for c in parts if isinstance(c, torch.Tensor))
        parts = [c if isinstance(c, torch.Tensor) else like.new_zeros(c) for c in parts]
        T = next((c.shape[0] for c in parts if c.dim() == 2), None)
        if T is None:
            return torch.cat(parts, 0)
        return torch.cat([c if c.dim() == 2 else c.expand(T, c.shape[0]) for c in parts], 1)


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


class ScatteredSpatialHead(nn.Module):
    """Observe (∂_t^order f) at per-time-step spatial points `points`
    [T, Ng, ds] (moving sensors, ragged time groups:
    `TemporallyGroupedData.X_st`): a time-varying block H [T, Ng, Ns·d]
    through the spatial conditional at each step's points; NaN rows of Y
    mask the filler points. The conditional-variance correction is on by
    default (scattered points rarely coincide with Z). The weights are one
    call on the flattened [T·Ng, ds] points, with one factor of Kzz."""

    def __init__(self, points, t_order: int = 0, s_op=None, correction: bool = True):
        super().__init__()
        self.register_buffer("points", torch.as_tensor(points))
        self.t_order = t_order
        self.s_op = s_op
        self.correction = correction

    def _points(self, steps):
        return self.points if steps is None else self.points[steps]

    def rows(self, kernel, steps: slice | None = None):
        """H's block [T, Ng, Ns·d], or over `steps` alone."""
        pts = self._points(steps)
        T, Ng = pts.shape[:2]
        w = kernel.spatial_weights(pts.reshape(-1, pts.shape[-1]), self.s_op)  # [T*Ng, Ns]
        t_row = derivative_row(kernel.k_time, self.t_order)  # [d]
        return (w[:, :, None] * t_row).reshape(T, Ng, -1)

    def var_correction(self, kernel, steps: slice | None = None):
        pts = self._points(steps)
        if not self.correction:
            return pts.new_zeros(pts.shape[:2])
        return kernel.conditional_var_correction(
            pts.reshape(-1, pts.shape[-1]), self.s_op, self.t_order
        ).reshape(pts.shape[:2])


class ScaledHead(Entries):
    """A `(coeff, head)` part of a `StackedHead`: the coefficient (a number
    or a trainable `Param`) scales the head's rows; `[0]` is the
    coefficient and `[1]` the head, as in the JAX package's tuple."""

    def __init__(self, coeff, head):
        super().__init__([coeff, head])


class StackedHead(nn.Module):
    """One block of observation rows over a `StackedMarkov` state. `parts`
    has one entry per stacked latent: None (a zero block), a head, or a
    `(coeff, head)` pair (kept as a `ScaledHead`). The sub-heads give static
    [N, d_part] rows of one common N; the blocks concatenate over the parts'
    state slices. E.g. the 2-D Helmholtz flow over (φ potential, ψ stream):

        u row: [ (∂x φ)(s) | +(∂y ψ)(s) ]
        v row: [ (∂y φ)(s) | −(∂x ψ)(s) ]."""

    def __init__(self, parts):
        super().__init__()
        self.parts = Entries([ScaledHead(*e) if isinstance(e, tuple) else e for e in parts])

    @staticmethod
    def _split(entry):
        if isinstance(entry, ScaledHead):
            c, h = entry
            return (c.value if hasattr(c, "value") else c), h
        return 1.0, entry

    def rows(self, kernel):
        blocks, like = [], None
        for entry, part in zip(self.parts, kernel.parts):
            if entry is None:
                blocks.append(None)
                continue
            c, h = self._split(entry)
            b = h.rows(part) if hasattr(h, "rows") else h.row(part)[None, :]
            if b.dim() != 2:
                raise ValueError(
                    "StackedHead sub-heads must produce static [N, d_part] rows; got shape "
                    f"{tuple(b.shape)} (time-varying sub-heads are not supported)"
                )
            blocks.append(c * b)
            like = b
        if like is None:
            raise ValueError("StackedHead needs at least one non-None part")
        return torch.cat([
            like.new_zeros(like.shape[0], part.state_dim) if b is None else b
            for b, part in zip(blocks, kernel.parts)
        ], -1)

    def var_correction(self, kernel):
        """Σ_parts c² ρ_part(s): the conditional residual variances of
        independent latents add, each scaled by its coefficient squared."""
        out = None
        for entry, part in zip(self.parts, kernel.parts):
            if entry is None:
                continue
            c, h = self._split(entry)
            if hasattr(h, "var_correction") and getattr(h, "correction", True):
                v = (c * c) * h.var_correction(part)
                out = v if out is None else out + v
        if out is None:
            out = self.points.new_zeros(self.points.shape[0])
        return out

    @property
    def correction(self) -> bool:
        return any(getattr(self._split(e)[1], "correction", False)
                   for e in self.parts if e is not None)

    @property
    def points(self):
        """The first non-None sub-head's points (its row count)."""
        for e in self.parts:
            if e is not None:
                return self._split(e)[1].points
        raise AttributeError("StackedHead with no parts has no points")


class MixedValueHead(nn.Module):
    """State-space LMC rows: observe g = W f over a `StackedMarkov` state,
    P rows mixing the latents' ∂_t^order f. `W` is anything with `.value`
    [P, L] (a `Param`, `kernels.multi_output.UnitLowerMixing`) or a plain
    [P, L] tensor (a buffer)."""

    def __init__(self, W, t_order: int = 0):
        super().__init__()
        if isinstance(W, nn.Module):
            self.W = W
        else:
            self.register_buffer("W", torch.as_tensor(W))
        self.t_order = t_order

    def rows(self, kernel):
        W = self.W.value if hasattr(self.W, "value") else self.W
        parts = kernel.parts
        if W.shape[1] != len(parts):
            raise ValueError(
                f"mixing W has {W.shape[1]} latent columns but the stacked kernel has "
                f"{len(parts)} parts"
            )
        return torch.cat([
            W[:, l:l + 1] * derivative_row(part, self.t_order)[None, :]
            for l, part in enumerate(parts)
        ], -1)


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

"""Temporal-parallel Kalman filtering/smoothing, covariance form (PyTorch).

Counterpart of `physs_gp_tpu/ops/parallel_kalman.py` for state dimension
d > 2 (Särkkä & García-Fernández 2021): per-step filtering elements
(A, b, C, J, eta) combined by an associative operator, smoothing elements
(E, g, L) by another. PyTorch has no associative scan, so every scan runs
the blocked schedule of the JAX package (`blocked_inclusive_scan`): a
sequential pass over L steps at a constant batch of `PHYSS_SCAN_BLOCKS`
(default 256) blocks, a Sklansky scan over the block totals, and one
full-width distribute combine. Long series run in chunks whose carry is the
filtered state (filter) or the combined suffix element (smoother).

`_filtering_operator` and `_smoothing_operator` send a combine to the fused
kernels (`ops/cuda/fused_combine.py`, one launch per combine) when the
reference's knob asks for it (`PHYSS_FUSED_COMBINE=1`; default off) and the
shapes are eligible, else to the unfused route of batched products and one
solve. The distribute-stage combines stay unfused, as in the reference, and
so does the square-root smoother's scan (`ops/parallel_sqrt_kalman.py`).

The d = 2 flat path is not ported yet.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .gaussian import mask_covariance, masked_mvn_logpdf
from .cuda import fused_combine as fc
from .kalman import FilterResult, SmootherResult, observation_mask
from .matrix import bmm, gen_solve, psd_solve, symmetrize, unit_last

__all__ = [
    "parallel_kalman_filter",
    "parallel_rts_smoother",
    "blocked_inclusive_scan",
]


class _FilterElems(NamedTuple):
    A: torch.Tensor  # [T, d, d]
    b: torch.Tensor  # [T, d]
    C: torch.Tensor  # [T, d, d]
    J: torch.Tensor  # [T, d, d]
    eta: torch.Tensor  # [T, d]


class _SmootherElems(NamedTuple):
    E: torch.Tensor  # [T, d, d]
    g: torch.Tensor  # [T, d]
    L: torch.Tensor  # [T, d, d]


def _map(fn, *trees):
    """Apply fn leafwise over NamedTuples (or tuples) of tensors."""
    first = trees[0]
    out = [fn(*leaves) for leaves in zip(*trees)]
    return type(first)(*out) if hasattr(first, "_fields") else tuple(out)


def _mv(M, v):
    """einsum('...ij,...j->...i')."""
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    """einsum('...ji,...j->...i')."""
    return (v[..., None, :] @ M)[..., 0, :]


def _build_filter_elements(A, Q, H, R, y, mask, m0, P0) -> _FilterElems:
    """All T filtering elements in one batched pass; the first element folds
    in the prior (m0, P0)."""
    T, d = y.shape[0], m0.shape[-1]
    y0 = torch.where(mask > 0, torch.nan_to_num(y), 0.0)
    Hm = mask[..., :, None] * H  # [T, p, d]

    P_loc = Q.clone()
    P_loc[0] += A[0] @ P0 @ A[0].T
    m_loc = torch.zeros((T, d), dtype=P0.dtype, device=P0.device)
    m_loc[0] = A[0] @ m0

    HP = bmm(Hm, P_loc)  # [T, p, d]
    S = mask_covariance(bmm(HP, Hm, tb=True) + R, mask)
    vres = y0 - _mv(Hm, m_loc)  # [T, p]
    # one batched SPD solve for the three right-hand sides S^-1 [HP | v | H]
    rhs = torch.cat([HP, vres[..., None], Hm], -1)  # [T, p, 2d+1]
    sol = psd_solve(S, rhs)
    SinvHP = sol[..., :d]
    Sinv_v = sol[..., d]
    SinvH = sol[..., d + 1:]
    eye = torch.eye(d, dtype=P0.dtype, device=P0.device)
    ImKH = eye - bmm(SinvHP, Hm, ta=True)  # I - K H

    A_out = bmm(ImKH, A)
    b_out = m_loc + _mtv(SinvHP, vres)  # + K vres
    C_out = symmetrize(bmm(ImKH, P_loc))

    # eta = A^T H^T S^-1 (y - H m_loc);  J = A^T H^T S^-1 H A
    eta = _mtv(A, _mtv(Hm, Sinv_v))
    HtSinvH = bmm(Hm, SinvH, ta=True)
    J = symmetrize(bmm(bmm(A, HtSinvH, ta=True), A))

    # first element: A = 0, eta = 0, J = 0; b/C already hold the updated prior
    A_out[0] = 0.0
    eta[0] = 0.0
    J[0] = 0.0
    return _FilterElems(A=A_out, b=b_out, C=C_out, J=J, eta=eta)


def _batched_inverse(M):
    """inv(M) for [..., d, d] through the batched Gauss-Jordan solve."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(M.shape)
    return gen_solve(M, eye)


def _filtering_moments(ei: _FilterElems, ej: _FilterElems):
    """Shared core of the filtering combine: U = (I + C_i J_j)^-1, A_j U and
    the moment outputs (b, C)."""
    d = ei.A.shape[-1]
    eye = torch.eye(d, dtype=ei.A.dtype, device=ei.A.device)
    ICJ = eye + bmm(ei.C, ej.J)
    U = _batched_inverse(ICJ)
    AjU = bmm(ej.A, U)
    b = _mv(AjU, ei.b + _mv(ei.C, ej.eta)) + ej.b
    C = symmetrize(bmm(bmm(AjU, ei.C), ej.A, tb=True) + ej.C)
    return U, AjU, b, C


def _filtering_operator(ei: _FilterElems, ej: _FilterElems) -> _FilterElems:
    """Associative combine of filtering elements (Särkkä & G-F eq. 10): one
    fused kernel when `use_fused_combine` says so, else the unfused route."""
    if fc.use_fused_combine(ei.A.shape, ej.A.shape, ei.A.dtype):
        return _FilterElems(*_FusedCombine.apply(
            fc.fused_filtering_combine, _filtering_operator_unfused, _FilterElems, *ei, *ej))
    return _filtering_operator_unfused(ei, ej)


def _filtering_operator_unfused(ei: _FilterElems, ej: _FilterElems) -> _FilterElems:
    """The combine as batched products and one solve (counterpart of the
    reference's `_filtering_operator_xla`); the second inverse
    (I + J_j C_i)^-1 is U^T for symmetric C, J."""
    U, AjU, b, C = _filtering_moments(ei, ej)
    A = bmm(AjU, ei.A)
    W = bmm(U, ei.A)
    w = ej.eta - _mv(ej.J, ei.b)
    eta = _mtv(W, w) + ei.eta
    J = symmetrize(bmm(W, bmm(ej.J, ei.A), ta=True) + ei.J)
    return _FilterElems(A=A, b=b, C=C, J=J, eta=eta)


def _filtering_final(ei: _FilterElems, ej: _FilterElems):
    """Distribute-stage combine emitting only the filtered moments (b, C)."""
    _, _, b, C = _filtering_moments(ei, ej)
    return b, C


def _smoothing_final(ej: _SmootherElems, ei: _SmootherElems):
    """Distribute-stage smoothing combine emitting only (g, L)."""
    g = _mv(ei.E, ej.g) + ei.g
    L = symmetrize(bmm(bmm(ei.E, ej.L), ei.E, tb=True) + ei.L)
    return g, L


def _smoothing_operator(ej: _SmootherElems, ei: _SmootherElems) -> _SmootherElems:
    """Combine for the reverse scan, i earlier than j: one fused kernel when
    `use_fused_combine` says so, else the unfused route."""
    if fc.use_fused_combine(ej.E.shape, ei.E.shape, ej.E.dtype, smoothing=True):
        return _SmootherElems(*_FusedCombine.apply(
            fc.fused_smoothing_combine, _smoothing_operator_unfused, _SmootherElems, *ej, *ei))
    return _smoothing_operator_unfused(ej, ei)


def _smoothing_operator_unfused(ej: _SmootherElems, ei: _SmootherElems) -> _SmootherElems:
    """Counterpart of the reference's `_smoothing_operator_xla`."""
    g, L = _smoothing_final(ej, ei)
    return _SmootherElems(E=bmm(ei.E, ej.E), g=g, L=L)


class _FusedCombine(torch.autograd.Function):
    """Forward: `fused(first, second)`, one kernel launch, on the leaves of
    two elements of type `cls`. The kernels have no backward (nor have the
    reference's): the cotangents are recomputed through `unfused`."""

    @staticmethod
    def forward(ctx, fused, unfused, cls, *leaves):
        ctx.save_for_backward(*leaves)
        ctx.unfused, ctx.cls = unfused, cls
        x = [unit_last(v) for v in leaves]
        n = len(x) // 2
        return tuple(fused(cls(*x[:n]), cls(*x[n:])))

    @staticmethod
    def backward(ctx, *cts):
        with torch.enable_grad():
            x = [v.detach().requires_grad_(True) for v in ctx.saved_tensors]
            n = len(x) // 2
            out = ctx.unfused(ctx.cls(*x[:n]), ctx.cls(*x[n:]))
            grads = torch.autograd.grad(tuple(out), x, cts)
        return (None, None, None, *grads)


def _ident_filter_elem(d, like):
    kw = dict(dtype=like.dtype, device=like.device)
    return _FilterElems(
        A=torch.eye(d, **kw), b=torch.zeros(d, **kw), C=torch.zeros(d, d, **kw),
        J=torch.zeros(d, d, **kw), eta=torch.zeros(d, **kw),
    )


def _ident_smoother_elem(d, like):
    kw = dict(dtype=like.dtype, device=like.device)
    return _SmootherElems(
        E=torch.eye(d, **kw), g=torch.zeros(d, **kw), L=torch.zeros(d, d, **kw)
    )


def _sklansky_scan(op, elems):
    """Inclusive scan whose every combine runs at a constant n/2-wide batch
    (n a power of two); gather/scatter indices are fixed per level."""
    n = elems[0].shape[0]
    idx = np.arange(n)
    dev = elems[0].device
    for lev in range(n.bit_length() - 1):
        sel_np = idx[(idx & (1 << lev)) != 0]
        sel = torch.as_tensor(sel_np, device=dev)
        anchor = torch.as_tensor((sel_np >> lev << lev) - 1, device=dev)
        c = op(_map(lambda x: x[anchor], elems), _map(lambda x: x[sel], elems))

        def put(x, cc):
            x = x.clone()
            x[sel] = cc
            return x

        elems = _map(put, elems, c)
    return elems


def _scan_blocks() -> int:
    n_blocks = int(os.environ.get("PHYSS_SCAN_BLOCKS", "256"))
    if n_blocks < 1 or n_blocks & (n_blocks - 1):
        raise ValueError(f"PHYSS_SCAN_BLOCKS must be a power of two, got {n_blocks}")
    return n_blocks


def blocked_inclusive_scan(op, elems, ident, final_op=None, init=None):
    """Inclusive scan in which every combine runs at a wide batch.

        [n] -> pad with identities -> [B blocks, L] (time contiguous in a
        block) -> sequential pass over L (B-wide combines) -> Sklansky scan
        over the B block totals -> one distribute combine at full width.

    `ident` is a two-sided identity element of `op` (no batch dims). `init`
    is an optional element folded in from the left through the block-totals
    pass. `final_op(prefix, intra)` is an optional reduced combine for the
    distribute pass that emits only the fields consumers use. Returns
    `(out, total)`: the inclusive prefixes (through `final_op` when given)
    and the full combine of init and all n elements.
    """
    n_blocks = _scan_blocks()
    n = elems[0].shape[0]
    L = -(-n // n_blocks)
    pad = L * n_blocks - n

    def bcast(x, batch):
        return x.expand(batch + tuple(x.shape))

    if pad:
        elems = _map(lambda x, i: torch.cat([x, bcast(i, (pad,))]), elems, ident)
    # [n_blocks * L, ...] -> [L, n_blocks, ...] (strided views, no copy)
    blocked = _map(
        lambda x: x.reshape((n_blocks, L) + tuple(x.shape[1:])).transpose(0, 1),
        elems,
    )
    carry = _map(lambda x: bcast(x, (n_blocks,)), ident)
    steps = []
    for l in range(L):
        carry = op(carry, _map(lambda x: x[l], blocked))
        steps.append(carry)
    intra = _map(lambda *xs: torch.stack(xs), *steps)  # [L, B, ...]
    tot_scan = _sklansky_scan(op, steps[-1])
    if init is not None:
        tot_scan = op(_map(lambda x: bcast(x, (n_blocks,)), init), tot_scan)
        first = _map(lambda x: x[None], init)
    else:
        first = _map(lambda x: x[None], ident)
    total = _map(lambda x: x[-1], tot_scan)
    prefix = _map(lambda f, ts: torch.cat([f, ts[:-1]]), first, tot_scan)
    flat_intra = _map(
        lambda x: x.transpose(0, 1).reshape((n_blocks * L,) + tuple(x.shape[2:])),
        intra,
    )
    flat_prefix = _map(lambda x: x.repeat_interleave(L, dim=0), prefix)
    out = (final_op or op)(flat_prefix, flat_intra)
    return _map(lambda x: x[:n], out), total


def _per_step_lml(A, Q, H, R, y, mask, ms, m0, P0, Ps):
    """Per-step lml from one-step-ahead predictive moments; also returns the
    predicted covariances P_pred[t] = P_{t|t-1} for the smoother."""
    m_prev = torch.cat([m0[None], ms[:-1]])
    P_prev = torch.cat([P0[None], Ps[:-1]])
    m_pred = _mv(A, m_prev)
    P_pred = bmm(bmm(A, P_prev), A, tb=True) + Q
    Hm = mask[..., :, None] * H
    mu = _mv(Hm, m_pred)
    S = bmm(bmm(Hm, P_pred), Hm, tb=True) + R
    return masked_mvn_logpdf(y, mu, S, mask), P_pred


def _check_d(d):
    if d <= 2:
        raise NotImplementedError(
            "state dimension d <= 2 (the flat closed-form path) is not ported"
        )


def _chunks(T, chunk_size):
    if chunk_size is None or chunk_size >= T:
        return [(0, T)]
    if T % chunk_size:
        raise ValueError("T must be divisible by chunk_size")
    return [(s, s + chunk_size) for s in range(0, T, chunk_size)]


def parallel_kalman_filter(A, Q, H, R, y, m0, P0, mask=None,
                           chunk_size: int | None = None) -> FilterResult:
    """Parallel-scan Kalman filter in covariance form.

    A, Q: [T, d, d]; H: [p, d] or [T, p, d]; R: [T, p, p]; y: [T, p] (NaN =
    missing). `chunk_size` runs the chunks in sequence, each carrying the
    filtered state (m, P) of the previous one into its first element.
    """
    T = y.shape[0]
    d = m0.shape[-1]
    _check_d(d)
    if mask is None:
        mask = observation_mask(y, P0.dtype)
    H_steps = H.expand((T,) + tuple(H.shape[-2:])) if H.dim() == 2 else H

    m_prev, P_prev = m0, P0
    ms, Ps = [], []
    for s, e in _chunks(T, chunk_size):
        elems = _build_filter_elements(
            A[s:e], Q[s:e], H_steps[s:e], R[s:e], y[s:e], mask[s:e],
            m_prev, P_prev,
        )
        (ms_c, Ps_c), _ = blocked_inclusive_scan(
            _filtering_operator, elems, _ident_filter_elem(d, P0),
            final_op=_filtering_final,
        )
        Ps_c = symmetrize(Ps_c)
        m_prev, P_prev = ms_c[-1], Ps_c[-1]
        ms.append(ms_c)
        Ps.append(Ps_c)
    ms = torch.cat(ms)
    Ps = symmetrize(torch.cat(Ps))
    lmls, Pp = _per_step_lml(A, Q, H_steps, R, y, mask, ms, m0, P0, Ps)
    return FilterResult(ms=ms, Ps=Ps, lml=torch.sum(lmls), lmls=lmls, Pp=Pp)


def parallel_rts_smoother(A, Q, filtered: FilterResult,
                          chunk_size: int | None = None) -> SmootherResult:
    """Parallel-scan RTS smoother. The suffix combine runs as flip, forward
    scan, flip; chunks run from the end of the series, each folding the
    combined suffix of the later chunks in through `init`."""
    ms, Ps = filtered.ms, filtered.Ps
    T, d = ms.shape
    _check_d(d)

    # elements for k < T-1 use (A_{k+1}, Q_{k+1}); the k = T-1 element is
    # overwritten below
    A_next = torch.roll(A, -1, 0)
    m_pred = _mv(A_next, ms)
    AP = bmm(A_next, Ps)
    if filtered.Pp is not None:
        # the filter's lml pass already built P_{t+1|t} (its Pp[t+1])
        P_pred = torch.roll(filtered.Pp, -1, 0)
    else:
        P_pred = bmm(AP, A_next, tb=True) + torch.roll(Q, -1, 0)
    E = psd_solve(P_pred, AP).transpose(-1, -2)
    g = ms - _mv(E, m_pred)
    EP = bmm(E, P_pred)
    L = symmetrize(Ps - bmm(EP, E, tb=True))

    E = E.contiguous()
    E[-1] = 0.0
    g[-1] = ms[-1]
    L[-1] = Ps[-1]
    flipped = _SmootherElems(E=E.flip(0), g=g.flip(0), L=L.flip(0))

    carry = _ident_smoother_elem(d, Ps)
    gs, Ls = [], []
    for s, e in _chunks(T, chunk_size):
        (g_c, L_c), carry = blocked_inclusive_scan(
            _smoothing_operator, _map(lambda x: x[s:e], flipped),
            _ident_smoother_elem(d, Ps), final_op=_smoothing_final, init=carry,
        )
        gs.append(g_c)
        Ls.append(L_c)
    gs = torch.cat(gs).flip(0)
    Ls = torch.cat(Ls).flip(0)
    # lag-one gains: E carries [E_0 .. E_{T-2}, 0]
    return SmootherResult(ms=gs, Ps=symmetrize(Ls), Gs=E)

"""Temporal-parallel Kalman filtering/smoothing, covariance form (PyTorch).

Counterpart of `physs_gp_tpu/ops/parallel_kalman.py` (Särkkä &
García-Fernández 2021): per-step filtering elements (A, b, C, J, eta)
combined by an associative operator, smoothing elements (E, g, L) by
another. PyTorch has no associative scan, so every scan runs
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

At d = 2 the scans run the reference's flat path: each element packed into
one row ([.., 14] for filtering, [.., 9] for smoothing; symmetric blocks
keep 3 entries) and combined in closed form, elementwise in PyTorch's own
ops, with the adjugate for the 2 x 2 inverse (`_flat2_*`, `_inv2`). No
kernel of the port runs in those combines, and the fused knob cannot reach
them (the fused kernels take d >= 3). d = 1 runs the general path.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .gaussian import mask_covariance, masked_mvn_logpdf
from .cuda import fused_combine as fc
from .kalman import FilterResult, SmootherResult, observation_mask
from .matrix import apply_function, bmm, gen_solve, psd_solve, recompute_vjp, symmetrize, unit_last

__all__ = [
    "parallel_kalman_filter",
    "parallel_rts_smoother",
    "blocked_inclusive_scan",
    "blocked_pass",
    "blocked_distribute",
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
    """Apply fn leafwise over NamedTuples (or tuples) of tensors; a bare
    tensor (a flat d = 2 element) is its own single leaf."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    out = [fn(*leaves) for leaves in zip(*trees)]
    return type(first)(*out) if hasattr(first, "_fields") else tuple(out)


def _leaf(tree):
    """The first leaf of an element tree."""
    return tree if isinstance(tree, torch.Tensor) else tree[0]


def _mv(M, v):
    """einsum('...ij,...j->...i')."""
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    """einsum('...ji,...j->...i')."""
    return (v[..., None, :] @ M)[..., 0, :]


def _build_filter_elements(A, Q, H, R, y, mask, m0, P0, prior: bool = True) -> _FilterElems:
    """All T filtering elements in one batched pass; the first element folds
    in the prior (m0, P0). `prior=False`: every element generic (a later
    segment of a time-sharded series; m0 and P0 give only dtype and size)."""
    T, d = y.shape[0], m0.shape[-1]
    y0 = torch.where(mask > 0, torch.nan_to_num(y), 0.0)
    Hm = mask[..., :, None] * H  # [T, p, d]

    if prior:
        P_loc = Q.clone()
        P_loc[0] += A[0] @ P0 @ A[0].T
        m_first = (A[0] @ m0)[None]
        # out of place: under `vmap` the first row may be batched where zeros are not
        m_loc = torch.cat([m_first, m_first.new_zeros((T - 1, d))])
    else:
        P_loc, m_loc = Q, y.new_zeros((T, d))

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

    if prior:  # first element: A = 0, eta = 0, J = 0; b/C already hold the updated prior
        A_out[0] = 0.0
        eta[0] = 0.0
        J[0] = 0.0
    return _FilterElems(A=A_out, b=b_out, C=C_out, J=J, eta=eta)


def _inv2(M):
    """Closed-form batched 2 x 2 inverse (adjugate over determinant)."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, dd = M[..., 1, 0], M[..., 1, 1]
    det = a * dd - b * c
    inv = torch.stack([torch.stack([dd, -b], -1), torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


def _batched_inverse(M):
    """inv(M) for [..., d, d]: the adjugate at d = 2, else the batched
    Gauss-Jordan solve."""
    if M.shape[-1] == 2:
        return _inv2(M)
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
        return _FilterElems(*apply_function(_FusedCombine, 
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
        return _SmootherElems(*apply_function(_FusedCombine, 
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

    generate_vmap_rule = True

    @staticmethod
    def forward(fused, unfused, cls, *leaves):
        x = [unit_last(v) for v in leaves]
        n = len(x) // 2
        return tuple(fused(cls(*x[:n]), cls(*x[n:])))

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.unfused, ctx.cls, *leaves = inputs
        ctx.save_for_backward(*leaves)

    @staticmethod
    def backward(ctx, *cts):
        n = len(ctx.saved_tensors) // 2

        def unfused(*x):
            return tuple(ctx.unfused(ctx.cls(*x[:n]), ctx.cls(*x[n:])))

        return (None, None, None, *recompute_vjp(unfused, cts, *ctx.saved_tensors))


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
    n = _leaf(elems).shape[0]
    idx = np.arange(n)
    dev = _leaf(elems).device
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
    and the full combine of init and all n elements. The two stages are
    `blocked_pass` and `blocked_distribute`.
    """
    return blocked_distribute(op, blocked_pass(op, elems, ident), ident, final_op, init)


class BlockedPass(NamedTuple):
    """The first stage of the blocked scan: the in-block prefixes `intra`
    [L, B, ...], the Sklansky scan of the block totals `tot_scan` [B, ...]
    (without any init), and n."""
    intra: object
    tot_scan: object
    n: int


def blocked_pass(op, elems, ident) -> BlockedPass:
    """Pad, block, the sequential pass over L and the Sklansky scan over the
    block totals; `tot_scan[-1]` is the combine of all n elements."""
    n_blocks = _scan_blocks()
    n = _leaf(elems).shape[0]
    L = -(-n // n_blocks)
    pad = L * n_blocks - n
    if pad:
        elems = _map(lambda x, i: torch.cat([x, _bcast(i, (pad,))]), elems, ident)
    # [n_blocks * L, ...] -> [L, n_blocks, ...] (strided views, no copy)
    blocked = _map(
        lambda x: x.reshape((n_blocks, L) + tuple(x.shape[1:])).transpose(0, 1),
        elems,
    )
    carry = _map(lambda x: _bcast(x, (n_blocks,)), ident)
    steps = []
    for l in range(L):
        carry = op(carry, _map(lambda x: x[l], blocked))
        steps.append(carry)
    intra = _map(lambda *xs: torch.stack(xs), *steps)  # [L, B, ...]
    return BlockedPass(intra=intra, tot_scan=_sklansky_scan(op, steps[-1]), n=n)


def blocked_distribute(op, state: BlockedPass, ident, final_op=None, init=None):
    """The second stage: fold `init` into the block-totals scan and combine
    every block's exclusive prefix with its in-block prefixes at full
    width. Returns `(out, total)` as `blocked_inclusive_scan`."""
    tot_scan = state.tot_scan
    L, n_blocks = _leaf(state.intra).shape[:2]
    if init is not None:
        tot_scan = op(_map(lambda x: _bcast(x, (n_blocks,)), init), tot_scan)
        first = _map(lambda x: x[None], init)
    else:
        first = _map(lambda x: x[None], ident)
    total = _map(lambda x: x[-1], tot_scan)
    prefix = _map(lambda f, ts: torch.cat([f, ts[:-1]]), first, tot_scan)
    flat_intra = _map(
        lambda x: x.transpose(0, 1).reshape((n_blocks * L,) + tuple(x.shape[2:])),
        state.intra,
    )
    flat_prefix = _map(lambda x: x.repeat_interleave(L, dim=0), prefix)
    out = (final_op or op)(flat_prefix, flat_intra)
    return _map(lambda x: x[:state.n], out), total


def _bcast(x, batch):
    return x.expand(batch + tuple(x.shape))


# ---------------------------------------------------------------------------
# d = 2 flat path: every element one row, every combine closed-form
# ---------------------------------------------------------------------------


def _flat2_from_filter_elems(e: _FilterElems):
    """[.., 14] = [A00 A01 A10 A11 | b0 b1 | C00 C01 C11 | J00 J01 J11 |
    eta0 eta1]."""
    A, b, C, J, eta = e
    return torch.cat([
        A.reshape(A.shape[:-2] + (4,)), b,
        torch.stack([C[..., 0, 0], C[..., 0, 1], C[..., 1, 1]], -1),
        torch.stack([J[..., 0, 0], J[..., 0, 1], J[..., 1, 1]], -1),
        eta,
    ], -1)


def _ident_flat2_filter(like):
    return torch.tensor([1, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                        dtype=like.dtype, device=like.device)


def _flat2_moments(x, y):
    """Closed-form (b, C) outputs of the d = 2 combine and the (U, Aj U)
    scalars the full operator reuses; x earlier (i), y later (j)."""
    ci00, ci01, ci11 = x[..., 6], x[..., 7], x[..., 8]
    jj00, jj01, jj11 = y[..., 9], y[..., 10], y[..., 11]
    # M = I + C_i J_j ; U = M^-1 (adjugate)
    m00 = 1.0 + ci00 * jj00 + ci01 * jj01
    m01 = ci00 * jj01 + ci01 * jj11
    m10 = ci01 * jj00 + ci11 * jj01
    m11 = 1.0 + ci01 * jj01 + ci11 * jj11
    r = 1.0 / (m00 * m11 - m01 * m10)
    u00, u01, u10, u11 = m11 * r, -m01 * r, -m10 * r, m00 * r
    aj00, aj01, aj10, aj11 = y[..., 0], y[..., 1], y[..., 2], y[..., 3]
    p00 = aj00 * u00 + aj01 * u10
    p01 = aj00 * u01 + aj01 * u11
    p10 = aj10 * u00 + aj11 * u10
    p11 = aj10 * u01 + aj11 * u11
    # b = Aj U (b_i + C_i eta_j) + b_j
    ej0, ej1 = y[..., 12], y[..., 13]
    t0 = x[..., 4] + ci00 * ej0 + ci01 * ej1
    t1 = x[..., 5] + ci01 * ej0 + ci11 * ej1
    b0 = p00 * t0 + p01 * t1 + y[..., 4]
    b1 = p10 * t0 + p11 * t1 + y[..., 5]
    # C = sym(Aj U C_i Ajᵀ) + C_j
    x00 = p00 * ci00 + p01 * ci01
    x01 = p00 * ci01 + p01 * ci11
    x10 = p10 * ci00 + p11 * ci01
    x11 = p10 * ci01 + p11 * ci11
    y00 = x00 * aj00 + x01 * aj01
    y01 = x00 * aj10 + x01 * aj11
    y10 = x10 * aj00 + x11 * aj01
    y11 = x10 * aj10 + x11 * aj11
    c00 = y00 + y[..., 6]
    c01 = 0.5 * (y01 + y10) + y[..., 7]
    c11 = y11 + y[..., 8]
    return (u00, u01, u10, u11), (p00, p01, p10, p11), (b0, b1), (c00, c01, c11)


def _flat2_filtering_operator(x, y):
    (u00, u01, u10, u11), (p00, p01, p10, p11), (b0, b1), (c00, c01, c11) = _flat2_moments(x, y)
    ai00, ai01, ai10, ai11 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    # A = Aj U A_i
    A00 = p00 * ai00 + p01 * ai10
    A01 = p00 * ai01 + p01 * ai11
    A10 = p10 * ai00 + p11 * ai10
    A11 = p10 * ai01 + p11 * ai11
    # W = U A_i ; w = eta_j - J_j b_i ; eta = Wᵀ w + eta_i
    w00 = u00 * ai00 + u01 * ai10
    w01 = u00 * ai01 + u01 * ai11
    w10 = u10 * ai00 + u11 * ai10
    w11 = u10 * ai01 + u11 * ai11
    jj00, jj01, jj11 = y[..., 9], y[..., 10], y[..., 11]
    bi0, bi1 = x[..., 4], x[..., 5]
    wv0 = y[..., 12] - (jj00 * bi0 + jj01 * bi1)
    wv1 = y[..., 13] - (jj01 * bi0 + jj11 * bi1)
    E0 = w00 * wv0 + w10 * wv1 + x[..., 12]
    E1 = w01 * wv0 + w11 * wv1 + x[..., 13]
    # J = sym(Wᵀ (J_j A_i)) + J_i
    q00 = jj00 * ai00 + jj01 * ai10
    q01 = jj00 * ai01 + jj01 * ai11
    q10 = jj01 * ai00 + jj11 * ai10
    q11 = jj01 * ai01 + jj11 * ai11
    J00 = w00 * q00 + w10 * q10
    J01 = w00 * q01 + w10 * q11
    J10 = w01 * q00 + w11 * q10
    J11 = w01 * q01 + w11 * q11
    return torch.stack([
        A00, A01, A10, A11, b0, b1, c00, c01, c11,
        J00 + x[..., 9], 0.5 * (J01 + J10) + x[..., 10], J11 + x[..., 11],
        E0, E1,
    ], -1)


def _unflat2(v0, v1, s00, s01, s11):
    """(vector [.., 2], symmetric matrix [.., 2, 2]) from their entries."""
    return (torch.stack([v0, v1], -1),
            torch.stack([torch.stack([s00, s01], -1), torch.stack([s01, s11], -1)], -2))


def _flat2_filtering_final(x, y):
    """Distribute-stage combine emitting only the filtered moments (b, C)."""
    _, _, (b0, b1), (c00, c01, c11) = _flat2_moments(x, y)
    return _unflat2(b0, b1, c00, c01, c11)


def _flat2_from_smoother_elems(e: _SmootherElems):
    """[.., 9] = [E00 E01 E10 E11 | g0 g1 | L00 L01 L11]."""
    E, g, L = e
    return torch.cat([
        E.reshape(E.shape[:-2] + (4,)), g,
        torch.stack([L[..., 0, 0], L[..., 0, 1], L[..., 1, 1]], -1),
    ], -1)


def _ident_flat2_smoother(like):
    return torch.tensor([1, 0, 0, 1, 0, 0, 0, 0, 0], dtype=like.dtype, device=like.device)


def _flat2_smoothing_moments(a, b):
    """(g, L) of the reverse-scan combine: a = ej (the real-time suffix),
    b = ei (earlier)."""
    ei00, ei01, ei10, ei11 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    gj0, gj1 = a[..., 4], a[..., 5]
    g0 = ei00 * gj0 + ei01 * gj1 + b[..., 4]
    g1 = ei10 * gj0 + ei11 * gj1 + b[..., 5]
    lj00, lj01, lj11 = a[..., 6], a[..., 7], a[..., 8]
    x00 = ei00 * lj00 + ei01 * lj01
    x01 = ei00 * lj01 + ei01 * lj11
    x10 = ei10 * lj00 + ei11 * lj01
    x11 = ei10 * lj01 + ei11 * lj11
    y00 = x00 * ei00 + x01 * ei01
    y01 = x00 * ei10 + x01 * ei11
    y10 = x10 * ei00 + x11 * ei01
    y11 = x10 * ei10 + x11 * ei11
    l00 = y00 + b[..., 6]
    l01 = 0.5 * (y01 + y10) + b[..., 7]
    l11 = y11 + b[..., 8]
    return (g0, g1), (l00, l01, l11)


def _flat2_smoothing_operator(a, b):
    (g0, g1), (l00, l01, l11) = _flat2_smoothing_moments(a, b)
    ei00, ei01, ei10, ei11 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    ej00, ej01, ej10, ej11 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    e00 = ei00 * ej00 + ei01 * ej10
    e01 = ei00 * ej01 + ei01 * ej11
    e10 = ei10 * ej00 + ei11 * ej10
    e11 = ei10 * ej01 + ei11 * ej11
    return torch.stack([e00, e01, e10, e11, g0, g1, l00, l01, l11], -1)


def _flat2_smoothing_final(a, b):
    (g0, g1), (l00, l01, l11) = _flat2_smoothing_moments(a, b)
    return _unflat2(g0, g1, l00, l01, l11)


def _filter_scan(d, like):
    """(to_scan, op, identity, final_op) of the filtering scan at state d."""
    if d == 2:
        return (_flat2_from_filter_elems, _flat2_filtering_operator,
                _ident_flat2_filter(like), _flat2_filtering_final)
    return (lambda e: e), _filtering_operator, _ident_filter_elem(d, like), _filtering_final


def _smoother_scan(d, like):
    """(to_scan, op, identity, final_op) of the smoothing scan at state d."""
    if d == 2:
        return (_flat2_from_smoother_elems, _flat2_smoothing_operator,
                _ident_flat2_smoother(like), _flat2_smoothing_final)
    return (lambda e: e), _smoothing_operator, _ident_smoother_elem(d, like), _smoothing_final


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
    filtered state (m, P) of the previous one into its first element. At
    d = 2 the scan runs on flat elements (`_flat2_*`).
    """
    T = y.shape[0]
    d = m0.shape[-1]
    to_scan, op, ident, final = _filter_scan(d, P0)
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
        (ms_c, Ps_c), _ = blocked_inclusive_scan(op, to_scan(elems), ident, final_op=final)
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
    combined suffix of the later chunks in through `init`. At d = 2 the scan
    runs on flat elements (`_flat2_*`)."""
    ms, Ps = filtered.ms, filtered.Ps
    T, d = ms.shape
    to_scan, op, ident, final = _smoother_scan(d, Ps)

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
    flipped = _map(lambda x: x.flip(0), to_scan(_SmootherElems(E=E, g=g, L=L)))

    carry = ident
    gs, Ls = [], []
    for s, e in _chunks(T, chunk_size):
        (g_c, L_c), carry = blocked_inclusive_scan(
            op, _map(lambda x: x[s:e], flipped), ident, final_op=final, init=carry,
        )
        gs.append(g_c)
        Ls.append(L_c)
    gs = torch.cat(gs).flip(0)
    Ls = torch.cat(Ls).flip(0)
    # lag-one gains: E carries [E_0 .. E_{T-2}, 0]
    return SmootherResult(ms=gs, Ps=symmetrize(Ls), Gs=E)

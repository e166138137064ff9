"""Time-axis sharding of the parallel Kalman filter and smoother (PyTorch).

Counterpart of `physs_gp_tpu/parallel/sharded.py`. The time axis is split
over one dimension of a `torch.distributed.device_mesh.DeviceMesh` with
named dimensions (the counterpart of a `jax.sharding.Mesh` axis). Rank k of
that dimension, in turn:

  1. builds the elements of its T/n steps and runs the first stage of the
     blocked schedule of `ops/parallel_kalman` on them (`blocked_pass`: the
     in-block prefixes and the scan of the block totals, chunk by chunk),
     which gives its segment's total;
  2. exchanges the totals with ONE all_gather a pass;
  3. folds its own exclusive prefix (filter) or suffix (smoother) of the
     gathered totals and distributes it into its local results through the
     second stage (`blocked_distribute(init=)`, the reduced final combine).

The reference's ranks scan their segment to its full inclusive prefixes and
then combine the exchanged prefix with each; splitting the blocked schedule
instead folds the prefix in through the block totals and runs one reduced
full-width combine, as the single-device scans do.

The prior folds into element 0 on rank 0 only; the other ranks build generic
elements behind a dummy copy of their step 0. The smoother's boundary
element of rank k needs rank k + 1's first (A, Q) (square-root: (A, Qs));
those ride in the filter pass's all_gather with the totals. The last rank's
terminal element has E = 0. The local scans run the kernels of the
single-device scans, and the fused combines where `PHYSS_FUSED_COMBINE=1`
and the shapes allow.

Where the arrays live: every rank holds the global inputs, as a JAX caller
does; a call slices the rank's segment out and returns the results over the
full T on every rank (final all_gathers, one for the filter's results and
one for the smoother's, stand in for the global view of JAX's sharded
outputs), so whatever follows runs replicated. Gradients follow the
transpose rules of `shard_map`:

- a sharded input's gradient is the all_gather of the segments' gradients;
- a replicated input (m0, P0, a shared H) gets the sum of the gradients of
  the ranks that share it;
- the totals' all_gather sums its incoming gradient over the ranks and keeps
  the rank's own slice (each rank folds a different prefix);
- a final gather keeps the rank's own slice of its incoming gradient and
  sums nothing (the downstream is replicated, so that gradient is whole).

So every rank's gradient of a replicated objective is the single-device
gradient. A call's backward collectives form one chain (smoother totals,
filter totals, inputs), and every rank's graph reaches each of them: the
prefix and suffix folds run the whole chain of totals on every rank and
index the rank's own entry.

Memory: a rank holds the global inputs, its segment's pass and the gathered
results (views of one buffer each for the filter and the smoother).
`smooth=False` stops after the filter: under `jax.jit` an lml leaves the
smoother out of the program, and eager PyTorch must be told.

Composite dp x t mode: with [B, T, ...] inputs and `batch_axis=`, the series
split over a second mesh dimension and each series' scan over `axis`; the
rank's series run in turn, their exchanges packed into one collective a
pass.

Backends: NCCL takes the device tensors; every other backend (gloo: ranks
that share one card, or run on the CPU) exchanges host copies of the
buffers, chosen by the group's backend.
"""
from __future__ import annotations

import math
import time

import torch
import torch.distributed as dist

from ..ops.kalman import FilterResult, SmootherResult, observation_mask
from ..ops.matrix import bmm, psd_solve, symmetrize
from ..ops.parallel_kalman import (
    _build_filter_elements,
    _chunks,
    _filter_scan,
    _ident_smoother_elem,
    _leaf,
    _map,
    _mv,
    _per_step_lml,
    _SmootherElems,
    _smoother_scan,
    _smoothing_final,
    _smoothing_operator_unfused,
    _unflat2,
    blocked_distribute,
    blocked_pass,
)
from ..ops.parallel_sqrt_kalman import (
    _build_sqrt_elements,
    _factor_psd,
    _ident_sqrt_elem,
    _per_step_lml_sqrt,
    _solve_tri,
    _sqrt_filtering_final,
    _sqrt_filtering_operator,
    sqrt_smoother_elements,
)
from ..ops.sqrt_kalman import tria

__all__ = [
    "sharded_filter_smoother",
    "sharded_sqrt_filter_smoother",
    "axis_size",
    "exchange_stats",
    "reset_exchange_stats",
]


def axis_size(mesh, axis: str) -> int:
    """Ranks along the mesh dimension named `axis`."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no dimension named {axis!r} (it has {names})")
    return mesh.shape[names.index(axis)]


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

_EXCHANGE: dict = {}


def reset_exchange_stats() -> None:
    _EXCHANGE.clear()


def exchange_stats() -> dict:
    """{kind: {"calls", "bytes", "seconds"}} of this process's collectives
    since the last reset, by kind: "totals" (the passes' exchanges of chunk
    totals, with their backward), "results" (the gather of the results to
    full T), "grads" (the inputs' gradients). `bytes` counts what the rank
    received; `seconds` the host wall from a synchronised device to the end
    of the exchange, host copies included."""
    return {k: dict(v) for k, v in _EXCHANGE.items()}


def _record(kind: str, nbytes: int, seconds: float) -> None:
    s = _EXCHANGE.setdefault(kind, {"calls": 0, "bytes": 0, "seconds": 0.0})
    s["calls"] += 1
    s["bytes"] += nbytes
    s["seconds"] += seconds


def _via_host(x, group) -> bool:
    """Whether x crosses the group through a host copy: device tensors on a
    backend other than NCCL."""
    return x.is_cuda and "nccl" not in str(dist.get_backend(group))


def _sync(x) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _all_gather(x, group, kind: str):
    """[n, *x.shape]: x of every rank of the group, in the group's order."""
    n = dist.get_world_size(group)
    _sync(x)
    t0 = time.perf_counter()
    host = _via_host(x, group)
    src = (x.detach().cpu() if host else x.detach()).contiguous()
    out = src.new_empty((n,) + tuple(src.shape))
    dist.all_gather(list(out.unbind(0)), src, group=group)
    if host:
        out = out.to(x.device)
    _sync(out)
    _record(kind, (n - 1) * src.numel() * src.element_size(), time.perf_counter() - t0)
    return out


def _all_reduce(x, group, kind: str):
    """The sum of x over the ranks of the group."""
    _sync(x)
    t0 = time.perf_counter()
    host = _via_host(x, group)
    buf = x.detach().to("cpu" if host else x.device, copy=True).contiguous()
    dist.all_reduce(buf, group=group)
    if host:
        buf = buf.to(x.device)
    _sync(buf)
    _record(kind, buf.numel() * buf.element_size(), time.perf_counter() - t0)
    return buf


def _gather_cat(x, dim: int, group, kind: str):
    """The ranks' blocks of x concatenated along `dim`."""
    g = _all_gather(x, group, kind).movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= g.shape[dim]
    return g.reshape(shape)


class _Layout:
    """Which block of the global arrays the rank holds: the time segment
    `t_idx` of `n` along the mesh dimension `axis`, and in composite mode
    the batch block `b_idx` of `n_b` along `batch_axis`."""

    def __init__(self, mesh, axis: str, batch_axis: str | None):
        self.n = axis_size(mesh, axis)
        self.t_group, self.t_idx = mesh.get_group(axis), mesh.get_local_rank(axis)
        self.batched = batch_axis is not None
        if self.batched:
            self.n_b = axis_size(mesh, batch_axis)
            self.b_group, self.b_idx = mesh.get_group(batch_axis), mesh.get_local_rank(batch_axis)

    def block(self, x, tdim, bdim):
        if bdim is not None:
            size = x.shape[bdim] // self.n_b
            x = x.narrow(bdim, self.b_idx * size, size)
        if tdim is not None:
            size = x.shape[tdim] // self.n
            x = x.narrow(tdim, self.t_idx * size, size)
        return x

    def gather(self, x, tdim, bdim, kind: str):
        """Inverse of `block`: the blocks of every rank joined."""
        if tdim is not None:
            x = _gather_cat(x, tdim, self.t_group, kind)
        if bdim is not None:
            x = _gather_cat(x, bdim, self.b_group, kind)
        return x


class _Enter(torch.autograd.Function):
    """Forward: the rank's block of each global input; `dims` holds each
    input's (time, batch) dimension, None where it is replicated. Backward:
    a sharded dimension's gradient is the gather of the blocks' gradients, a
    replicated one's the sum over the ranks that share it."""

    @staticmethod
    def forward(ctx, layout, dims, *xs):
        ctx.layout, ctx.dims = layout, dims
        outs = tuple(layout.block(x, *d).clone() for x, d in zip(xs, dims))
        ctx.mark_non_differentiable(*[o for o, x in zip(outs, xs) if not x.requires_grad])
        return outs

    @staticmethod
    def backward(ctx, *gs):
        lay = ctx.layout
        grads = []
        for need, g, (tdim, bdim) in zip(ctx.needs_input_grad[2:], gs, ctx.dims):
            if not need:
                grads.append(None)
                continue
            if tdim is None:
                g = _all_reduce(g, lay.t_group, "grads")
            if lay.batched and bdim is None:
                g = _all_reduce(g, lay.b_group, "grads")
            grads.append(lay.gather(g, tdim, bdim, "grads"))
        return (None, None, *grads)


class _GatherTotals(torch.autograd.Function):
    """Forward: [n, ...], the exchanged totals of every rank of the time
    group. Backward: the incoming gradient summed over the group, the rank's
    own slice kept."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return _all_gather(x, layout.t_group, "totals")

    @staticmethod
    def backward(ctx, g):
        lay = ctx.layout
        return _all_reduce(g, lay.t_group, "totals")[lay.t_idx], None


class _GatherResults(torch.autograd.Function):
    """Forward: the ranks' result blocks ([Tl, K], or [Bl, Tl, K] in
    composite mode) joined over the full T (and B). Backward: the rank's own
    block of the incoming gradient."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        ctx.dims = (1, 0) if layout.batched else (0, None)
        return layout.gather(x, *ctx.dims, "results")

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.block(g, *ctx.dims), None


# ---------------------------------------------------------------------------
# The segment's pieces
# ---------------------------------------------------------------------------


def _leaves(tree):
    return [tree] if isinstance(tree, torch.Tensor) else list(tree)


def _like(tree, leaves):
    return leaves[0] if isinstance(tree, torch.Tensor) else type(tree)(*leaves)


def _segment_elements(build, t_idx, A, Q, H, R, y, mask, m0, P0):
    """The segment's filtering elements: the prior folds into element 0 of
    the first segment; the others are generic, built behind a dummy copy of
    their step 0 (which the builders treat as the series' first step) whose
    element is dropped."""
    if t_idx == 0:
        return build(A, Q, H, R, y, mask, m0, P0)

    def pad(x):
        return torch.cat([x[:1], x])

    elems = build(pad(A), pad(Q), pad(H), pad(R), pad(y), pad(mask),
                  torch.zeros_like(m0), torch.zeros_like(P0))
    return _map(lambda x: x[1:], elems)


def _local_pass(op, elems, ident, chunk_size):
    """The first stage of the segment's scan: each chunk's blocked pass
    (`blocked_pass`), and the segment's total, the chunk totals folded in
    order, which the ranks exchange."""
    T = _leaf(elems).shape[0]
    passes = [blocked_pass(op, _map(lambda x: x[s:e], elems), ident)
              for s, e in _chunks(T, chunk_size)]
    total = _map(lambda x: x[-1:], passes[0].tot_scan)
    for p in passes[1:]:
        total = op(total, _map(lambda x: x[-1:], p.tot_scan))
    return passes, _map(lambda x: x[0], total)


def _local_distribute(op, final_op, ident, passes, init):
    """The second stage, once the exchange has given the combined element
    entering the segment (`init`): each chunk's distribute through the
    reduced `final_op`, the chunks' carry folded in through `init` (the
    schedule of the single-device smoother's chunks)."""
    outs = []
    for p in passes:
        out, init = blocked_distribute(op, p, ident, final_op, init)
        outs.append(out)
    return _map(lambda *xs: torch.cat(xs), *outs)


def _exclusive_prefix(totals, t_idx, op, ident):
    """totals[0] o ... o totals[t_idx - 1] (the identity on the first rank),
    unbatched. Every rank folds the whole chain and indexes its own entry,
    so every total stays in every rank's graph."""
    n = _leaf(totals).shape[0]
    chain = [_map(lambda x: x[None], ident)]
    for j in range(n - 1):
        chain.append(op(chain[-1], _map(lambda x: x[j:j + 1], totals)))
    return _map(lambda *xs: torch.cat(xs)[t_idx], *chain)


def _exclusive_suffix(totals, t_idx, op, ident):
    """The smoothing mirror of `_exclusive_prefix`: the fold of totals[j] for
    j > t_idx, last first (the identity on the last rank)."""
    n = _leaf(totals).shape[0]
    chain = [_map(lambda x: x[None], ident)]
    for j in range(n - 1, 0, -1):
        chain.append(op(chain[-1], _map(lambda x: x[j:j + 1], totals)))
    return _map(lambda *xs: torch.cat(xs[::-1])[t_idx], *chain)


def _smoother_elements_interior(A, ms, Ps, Pp):
    """Smoothing elements for the segment's steps, full length: the k -> k+1
    shift is a roll, so element [-1] is junk that the caller replaces with
    the boundary element. The lml pass's predicted covariances Pp supply
    P_{k+1|k} (rolled)."""
    A_next = torch.roll(A, -1, 0)
    m_pred = _mv(A_next, ms)
    AP = bmm(A_next, Ps)
    P_pred = torch.roll(Pp, -1, 0)
    E = psd_solve(P_pred, AP).transpose(-1, -2)
    g = ms - _mv(E, m_pred)
    L = symmetrize(Ps - bmm(bmm(E, P_pred), E, tb=True))
    return E, g, L


def _smoother_boundary_element(A_next0, Q_next0, m_last, P_last):
    """Smoothing element of the segment's last step, from the next rank's
    first (A, Q)."""
    m_pred = A_next0 @ m_last
    P_pred = symmetrize(A_next0 @ P_last @ A_next0.T + Q_next0)
    E = psd_solve(P_pred[None], (A_next0 @ P_last)[None])[0].T
    g = m_last - E @ m_pred
    L = symmetrize(P_last - E @ P_pred @ E.T)
    return E, g, L


def _sqrt_smoother_boundary_element(A_next0, Qs_next0, m_last, U_last):
    """Square-root smoothing element of the segment's last step, from the
    next rank's first (A, Qs): one LQ of the 2d x 2d pre-array."""
    d = m_last.shape[-1]
    pre = torch.cat([torch.cat([A_next0 @ U_last, Qs_next0], -1),
                     torch.cat([U_last, torch.zeros_like(U_last)], -1)], -2)
    Tm = tria(pre[None])[0]
    Pp_sqrt, GP, Y22 = Tm[:d, :d], Tm[d:, :d], Tm[d:, d:]
    G = _solve_tri(Pp_sqrt.T[None], GP.T[None])[0].T
    g = m_last - G @ (A_next0 @ m_last)
    return G, g, Y22


def _flip_pass(selems, chunk_size, scan):
    """The smoothing elements flipped (the suffix combine runs as a forward
    scan of the flipped series) and their `_local_pass`."""
    to_scan, op, ident, _ = scan
    flipped = to_scan(_SmootherElems(*[x.flip(0) for x in selems]))
    return _local_pass(op, flipped, ident, chunk_size)


class _CovSegment:
    """One series' segment in covariance form. `filter_pass`,
    `filter_results`, `smoother_pass` and `finish` run in turn between the
    exchanges; the passes return what the next exchange sends."""

    def __init__(self, lay, chunk_size, A, Q, H, R, y, mask, m0, P0):
        self.lay, self.chunk = lay, chunk_size
        self.A, self.Q, self.R, self.y, self.mask, self.m0, self.P0 = A, Q, R, y, mask, m0, P0
        self.H = H if H.dim() == 3 else H.expand((y.shape[0],) + tuple(H.shape))
        self.d = m0.shape[-1]
        self.fscan, self.sscan = self._scans()

    def _scans(self):
        """(filtering scan, smoothing scan): (to_scan, op, identity, final)."""
        return _filter_scan(self.d, self.P0), _smoother_scan(self.d, self.P0)

    def filter_pass(self):
        to_scan, op, ident, _ = self.fscan
        elems = _segment_elements(self._build, self.lay.t_idx, self.A, self.Q, self.H, self.R,
                                  self.y, self.mask, self.m0, self.P0)
        self.passes, total = _local_pass(op, to_scan(elems), ident, self.chunk)
        return [*_leaves(total), self.A[0], self.Q[0]]

    _build = staticmethod(_build_filter_elements)

    def filter_results(self, got):
        """ms, Ps, lmls from the exchanged totals and first (A, Q)s."""
        *tot, self.A_first, self.Q_first = got
        _, op, ident, final = self.fscan
        prefix = _exclusive_prefix(_like(ident, tot), self.lay.t_idx, op, ident)
        self.out = self._moments(prefix, _local_distribute(op, final, ident, self.passes, prefix))
        return self.out

    def _moments(self, prefix, bC):
        """(ms, Ps, lmls) from the distributed (b, C); keeps the predicted
        covariances for the smoother."""
        ms, Ps = bC[0], symmetrize(bC[1])
        if self.lay.t_idx == 0:
            m_in, P_in = self.m0, self.P0
        elif self.d == 2:
            m_in, P_in = _unflat2(*[prefix[i] for i in range(4, 9)])
        else:
            m_in, P_in = prefix.b, symmetrize(prefix.C)
        lmls, self.Pp = _per_step_lml(self.A, self.Q, self.H, self.R, self.y, self.mask, ms, m_in,
                                      P_in, Ps)
        return [ms, Ps, lmls]

    def smoother_pass(self):
        """The smoothing elements, the last one from the next rank's first
        (A, Q) (the terminal element on the last rank), flipped and scanned."""
        lay, ms = self.lay, self.out[0]
        E, g, L = self._interior()
        if lay.t_idx == lay.n - 1:
            last = (torch.zeros_like(E[-1]), ms[-1], self._cov_last())
        else:
            last = self._boundary(self.A_first[lay.t_idx + 1], self.Q_first[lay.t_idx + 1])
        selems = [torch.cat([x[:-1], v[None]]) for x, v in zip((E, g, L), last)]
        self.E = selems[0]
        self.spasses, stotal = _flip_pass(selems, self.chunk, self.sscan)
        return _leaves(stotal)

    def _interior(self):
        return _smoother_elements_interior(self.A, self.out[0], self.out[1], self.Pp)

    def _cov_last(self):
        return self.out[1][-1]

    def _boundary(self, A_next0, Q_next0):
        return _smoother_boundary_element(A_next0, Q_next0, self.out[0][-1], self.out[1][-1])

    def finish(self, got):
        """sms, sPs (and, in square-root form, their factors), E."""
        _, op, ident, final = self.sscan
        suffix = _exclusive_suffix(_like(ident, got), self.lay.t_idx, op, ident)
        g, L = _local_distribute(op, final, ident, self.spasses, suffix)
        sPs = symmetrize(L.flip(0))
        return [g.flip(0), sPs, *self._factors(sPs), self.E]

    def _factors(self, sPs):
        return []


class _SqrtSegment(_CovSegment):
    """One series' segment in square-root form: Q, R and P0 arrive as lower
    factors (Qs, Rs, U0); the smoother scans in Gram form with the
    covariance combine, as `parallel_sqrt_rts_smoother` does."""

    def _scans(self):
        return ((lambda e: e, _sqrt_filtering_operator, _ident_sqrt_elem(self.d, self.P0),
                 _sqrt_filtering_final),
                (lambda e: e, _smoothing_operator_unfused, _ident_smoother_elem(self.d, self.P0),
                 _smoothing_final))

    _build = staticmethod(_build_sqrt_elements)

    def _moments(self, prefix, bU):
        """(ms, Ps, lmls) with covariance Ps; keeps the filtered and the
        predicted factors for the smoother."""
        ms, self.Us = bU
        m_in, U_in = (self.m0, self.P0) if self.lay.t_idx == 0 else (prefix.b, prefix.U)
        lmls, self.Pp = _per_step_lml_sqrt(self.A, self.Q, self.H, self.R, self.y, self.mask, ms,
                                           m_in, U_in, self.Us)
        return [ms, self.Us @ self.Us.transpose(-1, -2), lmls]

    def _interior(self):
        return sqrt_smoother_elements(torch.roll(self.A, -1, 0), torch.roll(self.Q, -1, 0),
                                      self.out[0], self.Us, torch.roll(self.Pp, -1, 0))

    def _cov_last(self):
        return self.Us[-1] @ self.Us[-1].T

    def _boundary(self, A_next0, Qs_next0):
        G, g, D = _sqrt_smoother_boundary_element(A_next0, Qs_next0, self.out[0][-1], self.Us[-1])
        return G, g, D @ D.T

    def _factors(self, sPs):
        return [_factor_psd(sPs)]


def _pack_vector(tensors):
    """One [K] vector of the tensors, and their shapes."""
    return torch.cat([x.reshape(-1) for x in tensors]), [tuple(x.shape) for x in tensors]


def _unpack(flat, shapes):
    """Split the last dimension of `flat` into tensors of `shapes`; the
    leading dimensions (ranks, steps, series) stay."""
    out, k = [], 0
    lead = tuple(flat.shape[:-1])
    for s in shapes:
        size = math.prod(s)
        out.append(flat[..., k:k + size].reshape(lead + s))
        k += size
    return out


def _sharded(segment_cls, A, Q, H, R, y, m0, P0, mesh, axis, mask, chunk_size, batch_axis,
             smooth):
    batched = A.dim() == 4
    if batched and batch_axis is None:
        raise ValueError("batched inputs ([B, T, ...]) need batch_axis= (a mesh dimension name "
                         "for the data-parallel dimension)")
    lay = _Layout(mesh, axis, batch_axis if batched else None)
    T = y.shape[-2]
    if T % lay.n:
        raise ValueError(f"T={T} must divide over {lay.n} '{axis}' shards")
    if batched and A.shape[0] % lay.n_b:
        raise ValueError(f"B={A.shape[0]} must divide over {lay.n_b} '{batch_axis}' shards")
    if mask is None:
        mask = observation_mask(y, P0.dtype)
    t, b = (1, 0) if batched else (0, None)
    tv_H = H.dim() == (4 if batched else 3)
    h_dims = (t, b) if tv_H else ((None, None) if H.dim() == 2 else (None, 0))
    dims = ((t, b), (t, b), h_dims, (t, b), (t, b), (t, b), (None, b), (None, b))
    local = _Enter.apply(lay, dims, A, Q, H, R, y, mask, m0, P0)
    if batched:
        series = [[x if d[1] is None else x[i] for x, d in zip(local, dims)]
                  for i in range(local[0].shape[0])]
    else:
        series = [local]
    segs = [segment_cls(lay, chunk_size, *s) for s in series]

    def exchange(parts):
        flats, shapes = zip(*[_pack_vector(p) for p in parts])
        got = _GatherTotals.apply(torch.stack(flats), lay)  # [n, series, K]
        return [_unpack(got[:, i], shapes[i]) for i in range(len(parts))]

    got = exchange([s.filter_pass() for s in segs])
    filt = [s.filter_results(g) for s, g in zip(segs, got)]  # ms, Ps, lmls

    def gather(parts):
        """The series' per-step results over the full T (and B): views of
        one gathered buffer. The filter's and the smoother's go apart, so a
        gradient of the filter's results leaves the smoother's graph out."""
        shapes = [tuple(x.shape[1:]) for x in parts[0]]
        rows = [torch.cat([x.reshape(x.shape[0], -1) for x in p], -1) for p in parts]
        return _unpack(_GatherResults.apply(torch.stack(rows) if batched else rows[0], lay), shapes)

    ms, Ps, lmls = gather(filt)
    f = FilterResult(ms=ms, Ps=Ps, lml=torch.sum(lmls, -1), lmls=lmls)
    if not smooth:
        return f, None
    got = exchange([s.smoother_pass() for s in segs])
    sms, sPs, *rest = gather([s.finish(g) for s, g in zip(segs, got)])  # [sLs,] E
    return f, SmootherResult(ms=sms, Ps=sPs, Gs=rest[-1], Ls=rest[0] if len(rest) == 2 else None)


def sharded_filter_smoother(A, Q, H, R, y, m0, P0, mesh, axis: str = "t", mask=None,
                            chunk_size: int | None = None, batch_axis: str | None = None,
                            smooth: bool = True):
    """Time-sharded parallel filter + smoother in covariance form.

    A, Q: [T, d, d]; H: [p, d] or [T, p, d]; R: [T, p, p]; y: [T, p] (NaN =
    missing); m0 [d], P0 [d, d]. `mesh` is a `DeviceMesh` with a dimension
    named `axis` of n ranks, and T must divide by n. Every rank of the mesh
    calls it with the same global inputs; each returns (FilterResult,
    SmootherResult) over the full T.

    Composite dp x t mode: every per-series array with a leading batch
    dimension ([B, T, ...]; m0 / P0 as [B, d] / [B, d, d]; H shared [p, d],
    per series [B, p, d] or time-varying [B, T, p, d]) plus `batch_axis=`
    naming a second mesh dimension: B splits over `batch_axis`, each
    series' scan over `axis`.

    `chunk_size` chunks each rank's local scan (an element carry from chunk
    to chunk: the state entering the segment is unknown until the
    exchange); it must divide T / n (`ops/runner` pads to that grid).

    `smooth=False` runs the filter alone and returns (FilterResult, None):
    what remains of the pass under `jax.jit` when only the filter's results
    are read (the lml), which eager PyTorch would otherwise compute and keep
    for the backward in full.
    """
    return _sharded(_CovSegment, A, Q, H, R, y, m0, P0, mesh, axis, mask, chunk_size, batch_axis,
                    smooth)


def sharded_sqrt_filter_smoother(A, Q_sqrt, H, R_sqrt, y, m0, P0_sqrt, mesh, axis: str = "t",
                                 mask=None, chunk_size: int | None = None,
                                 batch_axis: str | None = None, smooth: bool = True):
    """Time-sharded square-root parallel filter + smoother: the exchanges of
    `sharded_filter_smoother` with the square-root elements and combines.
    Q_sqrt, R_sqrt and P0_sqrt are lower Cholesky factors; the results'
    Ps are covariances, the smoother's Ls their factors."""
    return _sharded(_SqrtSegment, A, Q_sqrt, H, R_sqrt, y, m0, P0_sqrt, mesh, axis, mask,
                    chunk_size, batch_axis, smooth)

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

The prior folds into element 0 on rank 0 only; the other ranks' elements are
all generic (`_build_filter_elements(prior=False)`). The smoother's boundary
element of rank k needs rank k + 1's first (A, Q) (square-root: (A, Qs));
those ride in the filter pass's all_gather with the totals. The last rank's
terminal element has E = 0. The local scans run the kernels of the
single-device scans, and the fused combines where `PHYSS_FUSED_COMBINE=1`
and the shapes allow.

Where the arrays live: each rank holds only its segment of every array with
a time dimension (A, Q, R, y, the mask, a time-varying H) and gets only its
segment of the results; `segment(T, mesh, axis, chunk_size)` says which
global rows that is, and `ops/runner` pads the last ranks' segments to the
mesh and chunk grid. Replicated inputs (m0, P0, a shared H) are the same
on every rank. The filter's `lml` is the segment's sum: an objective is
`all_reduce_sum` of the ranks' shares. A global view over the full T is
built only where a caller asks for one (`gather_time`). Gradients:

- a segment input's gradient is the rank's own, of the objective's whole
  (the exchanges' backward carries the other segments' share into it);
- a replicated input gets the rank's share, and its gradient is the sum of
  the ranks' shares: `shared_params` sums the gradients of a module's
  parameters over the ranks in the backward;
- the totals' all_gather sums its incoming gradient over the ranks and
  keeps the rank's own slice (each rank folds a different prefix);
- `all_reduce_sum` passes its incoming gradient through (every rank's
  share enters the objective once), `gather_time` keeps the rank's own
  rows of it.

A call's backward collectives form one chain (smoother totals, filter
totals, then the parameters' sums), and every rank's graph reaches each of
them: the prefix and suffix folds run the whole chain of totals on every
rank and index the rank's own entry. So every rank's share of an objective
must read the same results: a term that counts on one rank alone (the
series' last step) enters the others' times 0, or their backward would
skip the smoother's exchanges and the ranks' collectives would not match.

Memory: a rank holds its segment's inputs, pass and results: 1 / n of the
single-device pass's, plus the replicated t and observations of a model.
`smooth=False` stops after the filter: under `jax.jit` an lml leaves the
smoother out of the program, and eager PyTorch must be told.

Composite dp x t mode: with [B, T, ...] inputs and `batch_axis=`, the rank
holds its block of the series along `batch_axis` and their segments along
`axis`; the rank's series run in turn, their exchanges packed into one
collective a pass.

Backends: NCCL takes the device tensors; every other backend (gloo: ranks
that share one card, or run on the CPU) exchanges host copies of the
buffers, chosen by the group's backend.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple

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
    "Segment",
    "segment",
    "gather_time",
    "all_reduce_sum",
    "all_ranks",
    "all_gather_totals",
    "shared_params",
    "exchange_stats",
    "reset_exchange_stats",
]


def axis_size(mesh, axis: str) -> int:
    """Ranks along the mesh dimension named `axis`."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no dimension named {axis!r} (it has {names})")
    return mesh.shape[names.index(axis)]


class Segment(NamedTuple):
    """The rank's share of a T-step series: global rows [lo, hi), and
    `length` rows on the grid padded to the mesh and the chunks, whose
    padded tail (length - (hi - lo) rows) lies on the last ranks."""

    T: int
    lo: int
    hi: int
    length: int

    def rows(self, x, dim: int = 0):
        """The rank's rows of x along `dim`: x holds the whole series (T
        rows, sliced here) or already the rank's rows (returned as it is)."""
        if x.shape[dim] == self.T:
            return x.narrow(dim, self.lo, self.hi - self.lo)
        if x.shape[dim] != self.hi - self.lo:
            raise ValueError(f"{x.shape[dim]} rows along dim {dim}: neither the series' {self.T} "
                             f"nor the segment's {self.hi - self.lo}")
        return x

    @property
    def holds_last(self) -> bool:
        """Whether the series' last step is among the rank's rows."""
        return self.lo < self.T == self.hi


def segment(T: int, mesh, axis: str = "t", chunk_size: int | None = None) -> Segment:
    """The rank's segment of a T-step series split over the mesh dimension
    `axis`, with T padded as `ops/runner` pads it (`_pad_amount`: equal
    segments, each a multiple of `chunk_size`)."""
    from ..ops.runner import _pad_amount

    n = axis_size(mesh, axis)
    length = (T + _pad_amount(T, chunk_size, n_shards=n)) // n
    k = mesh.get_local_rank(axis)
    return Segment(T, min(k * length, T), min((k + 1) * length, T), length)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

_EXCHANGE: dict = {}


def reset_exchange_stats() -> None:
    _EXCHANGE.clear()


def exchange_stats() -> dict:
    """{kind: {"calls", "bytes", "seconds"}} of this process's collectives
    since the last reset, by kind: "totals" (the passes' exchanges of chunk
    totals, with their backward, and the sums of objectives), "results"
    (global views over the full T, `gather_time`), "grads" (the sums of
    replicated parameters' gradients). `bytes` counts what the rank
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


def _all_reduce(x, group, kind: str, op=dist.ReduceOp.SUM):
    """x reduced (summed) over the ranks of the group."""
    _sync(x)
    t0 = time.perf_counter()
    host = _via_host(x, group)
    buf = x.detach().to("cpu" if host else x.device, copy=True).contiguous()
    dist.all_reduce(buf, op=op, group=group)
    if host:
        buf = buf.to(x.device)
    _sync(buf)
    _record(kind, buf.numel() * buf.element_size(), time.perf_counter() - t0)
    return buf


def _groups(mesh, axes):
    return [mesh.get_group(a) for a in ((axes,) if isinstance(axes, str) else axes)]


class _AllReduceSum(torch.autograd.Function):
    """Forward: x summed over the ranks of each group in turn. Backward: the
    incoming gradient as it is (the sum is replicated, and each rank's share
    enters it once)."""

    @staticmethod
    def forward(ctx, x, groups):
        for g in groups:
            x = _all_reduce(x, g, "totals")
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x, mesh, axes="t"):
    """The sum of the ranks' x over the mesh dimension(s) `axes` (a name or
    a tuple of names): an objective from the segments' shares. Its backward
    hands every rank the incoming gradient."""
    return _AllReduceSum.apply(x, _groups(mesh, axes))


def all_ranks(flag, mesh, axes="t"):
    """Whether a bool tensor holds on every rank of the mesh dimension(s)
    `axes` (elementwise), so that every rank takes the same branch."""
    x = flag.to(torch.int32)
    for g in _groups(mesh, axes):
        x = _all_reduce(x, g, "totals", op=dist.ReduceOp.MIN)
    return x > 0


class _SumGrads(torch.autograd.Function):
    """Forward: the tensors as they are. Backward: each incoming gradient
    summed over the ranks of the groups, in one packed collective."""

    @staticmethod
    def forward(ctx, groups, *xs):
        ctx.groups = groups
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat, shapes = _pack_vector(gs)
        for g in ctx.groups:
            flat = _all_reduce(flat, g, "grads")
        return (None, *_unpack(flat, shapes))


class _Bound(torch.nn.Module):
    """`fn(module)` as a module call, for `torch.func.functional_call`."""

    def __init__(self, module, fn):
        super().__init__()
        self.module, self.fn = module, fn

    def forward(self):
        return self.fn(self.module)


def shared_params(module, fn, mesh, axes="t"):
    """`fn(module)`, the module's parameters replicated over the ranks of
    the mesh dimension(s) `axes`: each rank's gradient of them is its
    segment's share, and the backward sums the shares, so every rank gets
    the gradient of the whole objective. Without grad mode, `fn(module)`."""
    named = [(k, p) for k, p in module.named_parameters() if p.requires_grad]
    if not named or not torch.is_grad_enabled():
        return fn(module)
    entered = _SumGrads.apply(_groups(mesh, axes), *[p for _, p in named])
    return torch.func.functional_call(
        _Bound(module, fn), {f"module.{k}": v for (k, _), v in zip(named, entered)}, ())


class _GatherTime(torch.autograd.Function):
    """Forward: the ranks' rows joined over the full T along `dim`.
    Backward: the rank's own rows of the incoming gradient."""

    @staticmethod
    def forward(ctx, x, seg, group, dim):
        ctx.seg, ctx.dim = seg, dim
        rows = seg.hi - seg.lo
        if rows < seg.length:  # every rank sends `length` rows
            pad = list(x.shape)
            pad[dim] = seg.length - rows
            x = torch.cat([x, x.new_zeros(pad)], dim)
        g = _all_gather(x, group, "results").movedim(0, dim)
        shape = list(x.shape)
        shape[dim] *= g.shape[dim]
        return g.reshape(shape).narrow(dim, 0, seg.T)

    @staticmethod
    def backward(ctx, g):
        seg = ctx.seg
        return g.narrow(ctx.dim, seg.lo, seg.hi - seg.lo), None, None, None


def gather_time(x, mesh, seg: Segment, axis: str = "t", dim: int = 0):
    """The global view of the ranks' rows of a series (x: this rank's rows
    of `seg` along `dim`): all T rows on every rank. One all_gather, counted
    as "results"; its backward keeps the rank's own rows."""
    return _GatherTime.apply(x, seg, mesh.get_group(axis), dim)


class _Layout:
    """The rank's place along the mesh dimension `axis`: its time segment
    `t_idx` of `n`."""

    def __init__(self, mesh, axis: str):
        self.n = axis_size(mesh, axis)
        self.t_group, self.t_idx = mesh.get_group(axis), mesh.get_local_rank(axis)


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


def all_gather_totals(x, mesh, axis: str = "t"):
    """[n, *x.shape]: every rank's x along the mesh dimension `axis` (a
    segment's total for a scan across segments), counted as "totals"."""
    return _GatherTotals.apply(x, _Layout(mesh, axis))


# ---------------------------------------------------------------------------
# The segment's pieces
# ---------------------------------------------------------------------------


def _leaves(tree):
    return [tree] if isinstance(tree, torch.Tensor) else list(tree)


def _like(tree, leaves):
    return leaves[0] if isinstance(tree, torch.Tensor) else type(tree)(*leaves)


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
        # the prior folds into element 0 of the first segment alone
        elems = self._build(self.A, self.Q, self.H, self.R, self.y, self.mask, self.m0, self.P0,
                            prior=self.lay.t_idx == 0)
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
    lay = _Layout(mesh, axis)
    if mask is None:
        mask = observation_mask(y, P0.dtype)
    inputs = (A, Q, H, R, y, mask, m0, P0)
    if batched:
        # H shared by the series ([p, d]) or one per series ([B, p, d] or [B, T, p, d])
        per_series = [True, True, H.dim() > 2, True, True, True, True, True]
        series = [[x[i] if b else x for x, b in zip(inputs, per_series)]
                  for i in range(A.shape[0])]
    else:
        series = [inputs]
    segs = [segment_cls(lay, chunk_size, *s) for s in series]

    def exchange(parts):
        flats, shapes = zip(*[_pack_vector(p) for p in parts])
        got = _GatherTotals.apply(torch.stack(flats), lay)  # [n, series, K]
        return [_unpack(got[:, i], shapes[i]) for i in range(len(parts))]

    def joined(parts):
        """The series' results, stacked in composite mode."""
        return [torch.stack(xs) for xs in zip(*parts)] if batched else parts[0]

    got = exchange([s.filter_pass() for s in segs])
    ms, Ps, lmls = joined([s.filter_results(g) for s, g in zip(segs, got)])
    f = FilterResult(ms=ms, Ps=Ps, lml=torch.sum(lmls, -1), lmls=lmls)
    if not smooth:
        return f, None
    got = exchange([s.smoother_pass() for s in segs])
    sms, sPs, *rest = joined([s.finish(g) for s, g in zip(segs, got)])  # [sLs,] E
    return f, SmootherResult(ms=sms, Ps=sPs, Gs=rest[-1], Ls=rest[0] if len(rest) == 2 else None)


def sharded_filter_smoother(A, Q, H, R, y, m0, P0, mesh, axis: str = "t", mask=None,
                            chunk_size: int | None = None, batch_axis: str | None = None,
                            smooth: bool = True):
    """Time-sharded parallel filter + smoother in covariance form.

    `mesh` is a `DeviceMesh` with a dimension named `axis` of n ranks; rank
    k of it passes its segment of the series, L steps (the same L on every
    rank; `ops/runner` pads the last segments), and gets its segment of
    the results. A, Q: [L, d, d]; H: [p, d] (every rank the same) or the
    segment's [L, p, d]; R: [L, p, p]; y: [L, p] (NaN = missing); m0 [d],
    P0 [d, d] the series' prior, the same on every rank. The filter's `lml`
    is the segment's sum (`all_reduce_sum` of it is the series').

    Composite dp x t mode: every per-series array with a leading batch
    dimension ([B, L, ...]; m0 / P0 as [B, d] / [B, d, d]; H shared [p, d],
    per series [B, p, d] or time-varying [B, L, p, d]) plus `batch_axis=`
    naming a second mesh dimension: the rank passes its block of B series
    along `batch_axis`, and their segments along `axis`.

    `chunk_size` chunks each rank's local scan (an element carry from chunk
    to chunk: the state entering the segment is unknown until the
    exchange); it must divide L.

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

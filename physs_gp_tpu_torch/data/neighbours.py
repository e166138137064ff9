"""Nearest-neighbour orderings and conditioning sets for Vecchia inference
(PyTorch counterpart of `physs_gp_tpu/data/neighbours.py`).

The same algorithms with the same outputs, written with torch on an explicit
device (the input's by default), so that at N ~ 10^5 the O(N^2) work runs on
the card rather than in host numpy:

- `maximin_ordering`: each step is an `argmax` and a `minimum` over N that
  stays on the device (the chosen index is never read back to the host),
  replayed in blocks as a CUDA graph on the card;
- `nearest_neighbour_sets`: a blocked sweep of [block, hi] distances with
  `torch.topk(largest=False)` in place of `argpartition` + stable `argsort`.

Distances use the reference's expansion |a|^2 + |b|^2 - 2 a.b in float64,
so on the CPU the outputs equal the JAX package's numpy functions on
tie-free data.
"""
from __future__ import annotations

import torch

__all__ = ["maximin_ordering", "nearest_neighbour_sets"]


def _points(X, device=None):
    """X as float64 [N, D] on `device` (X's own by default); a 1-D [N] input
    is N points in one dimension, as in the reference."""
    X = torch.as_tensor(X)
    X = X.to(device=X.device if device is None else device, dtype=torch.float64)
    X = torch.atleast_2d(X)
    if X.shape[0] == 1 and X.numel() > 1:
        X = X.T
    return X


def _sq_dists(A, B, sqA=None, sqB=None):
    """[Na, Nb] squared euclidean distances by the expansion."""
    sqA = torch.sum(A * A, 1) if sqA is None else sqA
    sqB = torch.sum(B * B, 1) if sqB is None else sqB
    return torch.clamp(sqA[:, None] + sqB[None, :] - 2.0 * (A @ B.T), min=0.0)


def maximin_ordering(X, device=None) -> torch.Tensor:
    """Maximin (farthest-point) ordering: start at the point closest to the
    centroid, then repeatedly take the point farthest from everything chosen
    so far (Guinness 2018). X: [N, D] (or [N]); returns an [N] int64
    permutation on `device`. O(N^2) time, O(N) memory.

    Each step is a handful of launches over N whose chosen index never leaves
    the device (the next slot of the order is a device counter too), so on
    the card blocks of GRAPH_STEPS steps are captured once as a CUDA graph
    and replayed: the host would otherwise pace the loop."""
    X = _points(X, device)
    N = X.shape[0]
    sq = torch.sum(X * X, 1)
    centroid = X.mean(0, keepdim=True)
    first = torch.argmin(_sq_dists(X, centroid, sqA=sq)[:, 0])
    order = torch.empty(N, dtype=torch.int64, device=X.device)
    order[0] = first
    min_d2 = _sq_dists(X, X[first][None], sqA=sq)[:, 0]
    min_d2[first] = -torch.inf
    slot = torch.ones(1, dtype=torch.int64, device=X.device)

    def step():
        nxt = torch.argmax(min_d2).reshape(1)
        order.index_copy_(0, slot, nxt)
        slot.add_(1)
        d2 = _sq_dists(X, X.index_select(0, nxt), sqA=sq, sqB=sq.index_select(0, nxt))[:, 0]
        torch.minimum(min_d2, d2, out=min_d2)
        min_d2.index_fill_(0, nxt, -torch.inf)

    remaining = N - 1
    if X.is_cuda and remaining > 2 * GRAPH_STEPS:
        remaining -= _replayed(step, remaining)
    for _ in range(remaining):
        step()
    return order


GRAPH_STEPS = 1024  # maximin steps per captured CUDA graph


def _replayed(step, n_steps: int) -> int:
    """Run `step` on the card as replays of one captured block of
    GRAPH_STEPS steps (after one eager warm-up step); returns the number of
    steps run, at most `n_steps`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # recorded, not run
        for _ in range(GRAPH_STEPS):
            step()
    replays = (n_steps - 1) // GRAPH_STEPS
    for _ in range(replays):
        graph.replay()
    return 1 + replays * GRAPH_STEPS


def nearest_neighbour_sets(X, m: int, *, ordering="maximin", block: int = 4096,
                           device=None):
    """Per-point conditioning sets: for each point i (in the ordering), the
    up-to-m nearest PRECEDING points.

    Args:
        X: [N, D] inputs (numpy or torch).
        m: conditioning-set size (clamped to N - 1, at least 1).
        ordering: "maximin", "input" or None (keep the given order), or an
            explicit [N] permutation.
        block: row-block size of the distance sweep.
        device: where to compute; X's own by default.

    Returns ``(order, nbrs, mask)`` on `device`:
        order: [N] permutation of the input rows (int64).
        nbrs: [N, m] int32 indices into the ordered rows; rows with fewer
            than m predecessors are padded with 0.
        mask: [N, m] float32, 1 for a real neighbour, 0 for padding.
    """
    X = _points(X, device)
    N = X.shape[0]
    m = int(min(m, max(N - 1, 1)))
    if isinstance(ordering, str):
        if ordering == "maximin":
            order = maximin_ordering(X)
        elif ordering == "input":
            order = torch.arange(N, dtype=torch.int64, device=X.device)
        else:
            raise ValueError(f"unknown ordering {ordering!r}")
    elif ordering is None:
        order = torch.arange(N, dtype=torch.int64, device=X.device)
    else:
        order = torch.as_tensor(ordering).to(device=X.device, dtype=torch.int64)
    Xo = X[order]
    sq = torch.sum(Xo * Xo, 1)

    nbrs = torch.zeros((N, m), dtype=torch.int32, device=X.device)
    mask = torch.zeros((N, m), dtype=torch.float32, device=X.device)
    for lo in range(0, N, block):
        hi = min(lo + block, N)
        k = min(m, hi - 1)
        if k <= 0:
            continue
        d2 = _sq_dists(Xo[lo:hi], Xo[:hi], sqA=sq[lo:hi], sqB=sq[:hi])  # [b, hi]
        rows = torch.arange(lo, hi, device=X.device)
        cols = torch.arange(hi, device=X.device)
        # exclude self and successors
        d2.masked_fill_(cols[None, :] >= rows[:, None], torch.inf)
        take, part = torch.topk(d2, k, dim=1, largest=False, sorted=True)
        valid = torch.isfinite(take)
        nbrs[lo:hi, :k] = torch.where(valid, part, 0).to(torch.int32)
        mask[lo:hi, :k] = valid.to(torch.float32)
    return order, nbrs, mask

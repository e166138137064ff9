"""Trajectory sampling for linear-Gaussian SSMs: prior scans and Matheron
posterior samples (PyTorch counterpart of `physs_gp_tpu/ops/sampling.py`).

Joint POSTERIOR trajectories come from Matheron's rule (pathwise
conditioning),

    x_post = x~ + E[x | Y] - E[x | Y~],      (x~, Y~) ~ prior model,

so a sample costs one prior trajectory and one smoother pass. The prior
trajectory is the affine recurrence x_k = A_k x_{k-1} + c_k, associative in
(A, c):

    (A2, c2) o (A1, c1) = (A2 A1, A2 c1 + c2),

run as the blocked inclusive scan of the filters
(`parallel_kalman.blocked_inclusive_scan`), both products through
`ops/matrix.bmm` (the batched product kernel on the card).

Randomness comes from an explicit `torch.Generator` on the model's device,
never from the global generator. Each sampler has a lower layer (`*_given`)
that takes the standard-normal draws themselves: the prior's eps [T, S, d]
and the observation noise [S, T, p].
"""
from __future__ import annotations

import torch

from .lgssm import project_mean
from .matrix import bmm, safe_cholesky_rel
from .parallel_kalman import blocked_inclusive_scan

__all__ = [
    "sample_lgssm_states",
    "sample_lgssm_states_given",
    "matheron_state_samples",
    "matheron_state_samples_given",
    "standard_normal",
]


def standard_normal(generator, shape, like):
    """Standard-normal draws of `shape` in `like`'s dtype and device, from
    `generator` (which must live on that device)."""
    if not isinstance(generator, torch.Generator):
        raise TypeError("sampling needs an explicit torch.Generator on the model's device")
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def _affine_combine(e1, e2):
    """(A, c) composition of the earlier e1 and the later e2; c carries a
    sample axis after the scan axis: A [L, d, d], c [L, S, d]."""
    A1, c1 = e1
    A2, c2 = e2
    return bmm(A2, A1), bmm(c1, A2, tb=True) + c2


def _affine_scan(A, c):
    """Inclusive prefixes (A_{k..0}, c_k) of the (A, c) elements."""
    d, S = A.shape[-1], c.shape[-2]
    ident = (torch.eye(d, dtype=A.dtype, device=A.device),
             torch.zeros((S, d), dtype=c.dtype, device=c.device))
    return blocked_inclusive_scan(_affine_combine, (A, c), ident)[0]


def sample_lgssm_states_given(ssm, eps, parallel: bool = True, chunk_size=None, mesh=None,
                              mesh_axis: str = "t", T=None):
    """Prior state trajectories [S, T, d] of the LGSSM from the draws eps
    [T, S, d].

    Convention (ops/lgssm.py): A[0] = I, Q[0] = 0 and the step-1 prior is
    N(m0, P0); the scan element at t = 0 is (0, m0 + L0 eps_0), which ignores
    the carry, and element t >= 1 is (A_t, L_{Q_t} eps_t). The noise factors
    use RELATIVE-jitter Choleskys: an absolute floor would inject a random
    walk that accumulates over exactly-zero-Q steps. `chunk_size` runs the
    chunks in sequence, carrying the last state; each chunk's inclusive
    (A, c) prefixes replay it exactly.

    `mesh`: the rank's rows of the T-step trajectories (T required), from
    its rows of ssm.A, ssm.Q and eps (or all T of them, sliced here). The
    rank scans its segment from a zero state, carrying d more paths that
    start from the columns of its first A (their states are the segment's
    transition products), exchanges the segments' (product, last state) in
    one all_gather, and adds the products times the state entering the
    segment.
    """
    if mesh is not None:
        return _sharded_states(ssm, eps, parallel, chunk_size, mesh, mesh_axis, T)
    LQ = safe_cholesky_rel(ssm.Q)  # [T, d, d]
    L0 = safe_cholesky_rel(ssm.P0)
    c = bmm(eps, torch.cat([L0[None], LQ[1:]]), tb=True)  # [T, S, d]
    c = torch.cat([c[:1] + ssm.m0, c[1:]])
    A = torch.cat([torch.zeros_like(ssm.A[:1]), ssm.A[1:]])
    return _states(A, c, parallel, chunk_size).transpose(0, 1)  # [S, T, d]


def _states(A, c, parallel, chunk_size):
    """States [T, S, d] of x_k = A_k x_{k-1} + c_k from x_{-1} = 0."""
    T, d, S = A.shape[0], A.shape[-1], c.shape[1]
    if not parallel:
        x = torch.zeros((S, d), dtype=c.dtype, device=c.device)
        xs = []
        for A_t, c_t in zip(A, c):
            x = x @ A_t.T + c_t
            xs.append(x)
        return torch.stack(xs)
    if chunk_size is not None and T > chunk_size:
        pad = (-T) % chunk_size
        if pad:
            A = torch.cat([A, torch.eye(d, dtype=A.dtype, device=A.device).expand(pad, d, d)])
            c = torch.cat([c, c.new_zeros((pad, S, d))])
        x = c.new_zeros((S, d))
        out = []
        for s in range(0, A.shape[0], chunk_size):
            Aps, cps = _affine_scan(A[s:s + chunk_size], c[s:s + chunk_size])
            xs_c = torch.einsum("kij,sj->ksi", Aps, x) + cps
            x = xs_c[-1]
            out.append(xs_c)
        return torch.cat(out)[:T]
    return _affine_scan(A, c)[1]


def _sharded_states(ssm, eps, parallel, chunk_size, mesh, mesh_axis, T):
    """`sample_lgssm_states_given(mesh=)`: the rank's rows [S, hi - lo, d]."""
    from ..parallel import sharded

    if T is None:
        raise ValueError("time-sharded sampling needs T, the series' length over all ranks")
    seg = sharded.segment(T, mesh, mesh_axis, chunk_size)
    A, Q, eps = seg.rows(ssm.A), seg.rows(ssm.Q), seg.rows(eps)
    d, S = A.shape[-1], eps.shape[1]
    LQ = safe_cholesky_rel(Q)
    if seg.lo == 0:  # the series' first element: (0, m0 + L0 eps_0)
        c = bmm(eps, torch.cat([safe_cholesky_rel(ssm.P0)[None], LQ[1:]]), tb=True)
        c, A_first = torch.cat([c[:1] + ssm.m0, c[1:]]), torch.zeros_like(A[0])
    else:
        c, A_first = bmm(eps, LQ, tb=True), A[0]  # [L, S, d]
    # d more paths from the columns of the first element's A: their states
    # are the columns of the segment's transition products A_k ... A_lo
    basis = torch.cat([A_first.T[None], A.new_zeros((A.shape[0] - 1, d, d))])
    xs = _states(torch.cat([torch.zeros_like(A[:1]), A[1:]]), torch.cat([c, basis], 1), parallel,
                 chunk_size)
    xs, prods = xs[:, :S], xs[:, S:]  # prods[k, j] = (A_k ... A_lo) e_j
    got = sharded.all_gather_totals(torch.cat([prods[-1], xs[-1]]), mesh, mesh_axis)  # [n, d + S, d]
    x = xs.new_zeros((S, d))  # the state entering the segment
    for j in range(mesh.get_local_rank(mesh_axis)):
        x = x @ got[j, :d] + got[j, d:]
    return (xs + torch.einsum("kji,sj->ksi", prods, x)).transpose(0, 1)


def sample_lgssm_states(generator, ssm, n_samples: int, parallel: bool = True,
                        chunk_size=None):
    """n prior state trajectories [S, T, d], the draws eps [T, S, d] taken
    from `generator`."""
    T, d = ssm.A.shape[0], ssm.A.shape[-1]
    eps = standard_normal(generator, (T, n_samples, d), ssm.A)
    return sample_lgssm_states_given(ssm, eps, parallel=parallel, chunk_size=chunk_size)


def _project(H, xs):
    """Head values [S, T, p] of state trajectories xs [S, T, d]."""
    if H.dim() == 2:
        return project_mean(H, xs)
    return torch.einsum("tpd,std->stp", H, xs)


def matheron_state_samples_given(ssm, R, Y, eps_x, eps_y, parallel: bool = True,
                                 sqrt: bool = False, chunk_size=None, mesh=None,
                                 mesh_axis: str = "t", T=None):
    """Joint posterior STATE samples [S, T, d] given observations Y [T, p]
    (NaN = missing), from the prior draws eps_x [T, S, d] and the noise
    draws eps_y [S, T, p].

    Draw (x~, Y~) from the prior model (Y~ keeps Y's NaN pattern), smooth
    the data and every pseudo-dataset, and shift: x_s = x~_s + ms(Y) -
    ms(Y~_s). Exact for any prior mean m0 (the smoother's offset cancels).
    The S + 1 smoother passes run one after another (the counterpart of the
    reference's `lax.map` branch): a batched pass would hold S + 1 passes'
    covariance recursions at once. `mesh`: each rank computes its rows of
    the T-step samples (T required) from its rows of the time-indexed
    inputs and draws (or all T of them, sliced here: the draws of a whole
    series give the same samples on any mesh), the prior paths by the
    sharded affine scan and each smoother pass time-sharded over the mesh
    dimension `mesh_axis`.
    """
    from .runner import run_filter_smoother

    if mesh is not None:
        from ..parallel import sharded

        if T is None:
            raise ValueError("time-sharded sampling needs T, the series' length over all ranks")
        seg = sharded.segment(T, mesh, mesh_axis, chunk_size)
        H = seg.rows(ssm.H) if ssm.H.dim() == 3 else ssm.H
        ssm = ssm._replace(A=seg.rows(ssm.A), Q=seg.rows(ssm.Q), H=H)
        R, Y, eps_x, eps_y = seg.rows(R), seg.rows(Y), seg.rows(eps_x), seg.rows(eps_y, 1)
    xprior = sample_lgssm_states_given(ssm, eps_x, parallel=parallel, chunk_size=chunk_size,
                                       mesh=mesh, mesh_axis=mesh_axis, T=T)
    # marginalising a joint chol(R) draw onto the observed entries IS the
    # observed block's noise marginal, so no masking here (the smoother masks)
    LR = safe_cholesky_rel(R)  # [T, p, p]
    y_noise = bmm(eps_y.transpose(0, 1), LR, tb=True).transpose(0, 1)  # [S, T, p]
    Yt = _project(ssm.H, xprior) + y_noise
    Yt = torch.where(torch.isnan(Y)[None], torch.nan, Yt)  # copy the pattern
    ms = [
        run_filter_smoother(ssm, R, Yb, parallel=parallel, sqrt=sqrt,
                            chunk_size=chunk_size, mesh=mesh, mesh_axis=mesh_axis, T=T)[1].ms
        for Yb in [Y, *Yt]
    ]
    return xprior + ms[0][None] - torch.stack(ms[1:])


def matheron_state_samples(generator, ssm, R, Y, n_samples: int, parallel: bool = True,
                           sqrt: bool = False, chunk_size=None, mesh=None,
                           mesh_axis: str = "t"):
    """`matheron_state_samples_given` with the draws eps_x [T, S, d], then
    eps_y [S, T, p], taken from `generator` (with a mesh: Y [T, p] of the
    whole series, and every rank the same generator state)."""
    T, p = Y.shape
    d = ssm.A.shape[-1]
    eps_x = standard_normal(generator, (T, n_samples, d), Y)
    eps_y = standard_normal(generator, (n_samples, T, p), Y)
    return matheron_state_samples_given(ssm, R, Y, eps_x, eps_y, parallel=parallel,
                                        sqrt=sqrt, chunk_size=chunk_size, mesh=mesh,
                                        mesh_axis=mesh_axis, T=T)

"""Extended Kalman filtering for nonlinear SDE priors and nonlinear
observations (PyTorch counterpart of `physs_gp_tpu/ops/ekf.py`).

- the nonlinear SDE predict step linearises the Euler-Maruyama mean
  propagation (the reference's `jax.jacfwd`: one batched reverse pass per
  Jacobian in the sequential loops, `torch.func.jacfwd` mapped over T in
  the iterated smoother);
- the update linearises the observation function at the predicted mean and
  reuses the linear masked update of `ops/kalman.py`;
- the extended RTS smoother linearises the same way.

`ekf_filter` and `ekf_smoother` are host loops over T (the reference's
`lax.scan`), each step PyTorch's own small operations on the model's device;
the smoother's factorisation of the predicted covariance is the port's
`safe_cholesky` (the Cholesky kernel at 3 <= d <= 80 on the card, closed
form at d <= 2).

On the card without grad mode these loops launch tens of tiny kernels per
substep, which the host cannot issue fast enough: there the substepped
propagation of a step (`_em_propagate`) and blocks of `_BLOCK` steps of the
mean propagation run as CUDA graphs captured once per call (`_Graph`) and
replayed, the same kernels on the same inputs. In grad mode (the lml's
gradient by a drift parameter) they run eagerly.

`iterated_parallel_ekf_smoother` linearises the dynamics and observations
about a reference trajectory, batched over T (`torch.func.vmap` of
`jacfwd`), and runs the exact linear `parallel_kalman_filter` /
`parallel_rts_smoother` once per iteration; the affine offset recurrence
c_k = A_k c_{k-1} + b_k runs as the parallel affine scan of
`ops/sampling.py`. Its first reference trajectory, the noise-free
propagation of m0, is a nonlinear recurrence and stays a host loop
(`propagate_mean`).

`euler_maruyama_sample` draws from a `torch.Generator` (where the reference
splits a PRNG key); `euler_maruyama_sample_given` takes the standard-normal
draws eps [T - 1, n_substeps, w] themselves.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .kalman import FilterResult, SmootherResult, masked_update, observation_mask
from .matrix import cholesky_solve, safe_cholesky, symmetrize
from .sampling import _affine_scan, standard_normal

__all__ = ["NonlinearSSM", "ekf_filter", "ekf_smoother", "euler_maruyama_sample",
           "euler_maruyama_sample_given", "iterated_parallel_ekf_smoother", "propagate_mean"]


class NonlinearSSM(NamedTuple):
    """dx = drift(x) dt + L dW; y = obs_fn(x) + noise. `drift` maps [d] to
    [d] and `obs_fn` [d] to [p], both written with torch operations."""

    drift: Callable
    L: torch.Tensor  # [d, w]
    Qc: torch.Tensor  # [w, w]
    m0: torch.Tensor  # [d]
    P0: torch.Tensor  # [d, d]
    obs_fn: Callable


_BLOCK = 100  # steps of the mean propagation in one captured graph


def _graphable(x) -> bool:
    """Whether the loops on x run as captured CUDA graphs."""
    return x.is_cuda and not torch.is_grad_enabled()


class _Graph:
    """`fn(*inputs)` captured once as a CUDA graph on static copies of the
    example inputs; a call copies its inputs in, replays the graph and
    returns clones of the outputs (a tensor or a tuple of them)."""

    def __init__(self, fn, *example):
        self.inputs = [x.clone() for x in example]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up, as capture requires
            for _ in range(2):
                fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)

    def __call__(self, *xs):
        for buf, x in zip(self.inputs, xs):
            buf.copy_(x)
        self.graph.replay()
        if isinstance(self.outputs, torch.Tensor):
            return self.outputs.clone()
        return tuple(o.clone() for o in self.outputs)


def _propagator(drift, LQL, n_substeps: int, m, P, dt):
    """`(m, P, dt) -> _em_propagate(...)`, captured as a graph where
    `_graphable`; m, P, dt are example inputs."""
    def prop(m_, P_, dt_):
        return _em_propagate(drift, m_, P_, LQL, dt_, n_substeps)

    return _Graph(prop, m, P, dt) if _graphable(P) else prop


def _value_and_jacfwd(fn, x):
    """(fn(x), its Jacobian at x) from one forward-mode pass; `torch.func`
    composes, so the iterated smoother maps it over T."""
    def both(z):
        value = fn(z)
        return value, value

    J, value = torch.func.jacfwd(both, has_aux=True)(x)
    return value, J


def _value_and_jac(fn, x, n_out: int):
    """(fn(x) [n_out], its Jacobian [n_out, d] at x) for the sequential
    loops: fn runs once on n_out copies of x side by side (`vmap` over a
    trailing axis), and one reverse pass of Σ_j fn(x_j)_j gives row j of J
    in column j. Eager (grad mode, the CPU) this issues fewer host-side
    operations than `torch.func.jacfwd` and runs faster; replayed as a
    graph the two take the same time (`scripts/port/dynamics_outcome.py
    --jacobians` times both). In grad mode the
    pass keeps its graph, so outer gradients (of the lml by a drift
    parameter) pass through J as through the reference's `jax.jacfwd`."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        X = x[:, None].repeat(1, n_out)
        if not X.requires_grad:
            X.requires_grad_(True)
        Y = torch.func.vmap(fn, in_dims=1, out_dims=1)(X)  # [n_out, n_out]
        (G,) = torch.autograd.grad(torch.diagonal(Y).sum(), X, create_graph=outer)
    return Y[:, 0], G.T


def _em_mean(drift, x, dt, n_substeps: int):
    """Noise-free Euler-Maruyama propagation of x over dt in n_substeps."""
    h = dt / n_substeps
    for _ in range(n_substeps):
        x = x + h * drift(x)
    return x


def _em_mean_jac(drift, m, dt, n_substeps: int):
    """Euler-Maruyama mean propagation and its Jacobian (the EKF A)."""
    return _value_and_jacfwd(lambda x: _em_mean(drift, x, dt, n_substeps), m)


def _em_propagate(drift, m, P, LQL, dt, n_substeps: int):
    """Substepped joint (mean, covariance) propagation; returns (m_pred,
    P_pred, A_total), A_total the composed Jacobian the smoother gain uses.
    The covariance is substepped too: one step's Q = L Qc Lᵀ dt is only
    first order."""
    h = dt / n_substeps
    eye = torch.eye(m.shape[-1], dtype=P.dtype, device=P.device)
    A_tot = eye
    for _ in range(n_substeps):
        f, J = _value_and_jac(drift, m, m.shape[-1])
        A_s = eye + h * J
        m = m + h * f
        P = symmetrize(A_s @ P @ A_s.T + LQL * h)
        A_tot = A_s @ A_tot
    return m, P, A_tot


def _steps(t):
    """dt [T] with a leading 0 (step 0 predicts the prior itself)."""
    t = t.reshape(-1)
    return torch.cat([torch.zeros(1, dtype=t.dtype, device=t.device), torch.diff(t)])


def ekf_filter(ssm: NonlinearSSM, t, R, y, mask=None, n_substeps: int = 1) -> FilterResult:
    """Sequential EKF over the nonlinear SSM at the times t [T]; R [T, p, p],
    y [T, p] (NaN = missing)."""
    T = y.shape[0]
    if mask is None:
        mask = observation_mask(y, ssm.P0.dtype)
    dt = _steps(t)
    LQL = ssm.L @ ssm.Qc @ ssm.L.T
    m, P = ssm.m0, ssm.P0
    prop = _propagator(ssm.drift, LQL, n_substeps, m, P, dt[0])
    ms, Ps, lmls = [], [], []
    for k in range(T):
        m_pred, P_pred, _ = prop(m, P, dt[k])
        # linearise obs_fn at the predicted mean; the innovation
        # y - h(m_pred) = (y - h0 + H m_pred) - H m_pred
        h0, Hk = _value_and_jac(ssm.obs_fn, m_pred, y.shape[-1])
        y_eff = y[k] - h0 + Hk @ m_pred
        m, P, lml_k = masked_update(m_pred, P_pred, Hk, R[k], y_eff, mask[k])
        ms.append(m)
        Ps.append(P)
        lmls.append(lml_k)
    lmls = torch.stack(lmls)
    return FilterResult(ms=torch.stack(ms), Ps=torch.stack(Ps), lml=torch.sum(lmls), lmls=lmls)


def ekf_smoother(ssm: NonlinearSSM, t, filtered: FilterResult,
                 n_substeps: int = 1) -> SmootherResult:
    """Extended RTS smoother, linearised at the filtered means."""
    ms, Ps = filtered.ms, filtered.Ps
    T, d = ms.shape
    dt = torch.diff(t.reshape(-1))
    LQL = ssm.L @ ssm.Qc @ ssm.L.T
    m_s, P_s = ms[-1], Ps[-1]
    out_m, out_P, out_G = [m_s], [P_s], [torch.zeros_like(P_s)]
    prop = _propagator(ssm.drift, LQL, n_substeps, ms[0], Ps[0], dt[0]) if T > 1 else None
    for k in range(T - 2, -1, -1):
        m_pred, P_pred, A = prop(ms[k], Ps[k], dt[k])
        G = cholesky_solve(safe_cholesky(P_pred), A @ Ps[k]).T
        m_s = ms[k] + G @ (m_s - m_pred)
        P_s = symmetrize(Ps[k] + G @ (P_s - P_pred) @ G.T)
        out_m.append(m_s)
        out_P.append(P_s)
        out_G.append(G)
    return SmootherResult(
        ms=torch.stack(out_m[::-1]), Ps=torch.stack(out_P[::-1]), Gs=torch.stack(out_G[::-1])
    )


def propagate_mean(ssm: NonlinearSSM, t, n_substeps: int = 1):
    """The noise-free propagation of m0 over t [T] ([T, d]): the iterated
    smoother's first reference trajectory, a host loop of T steps, run in
    blocks of `_BLOCK` steps (captured graphs where `_graphable`)."""
    dt = _steps(t)
    T = dt.shape[0]

    def block(m, dts):
        out = []
        for k in range(dts.shape[0]):
            m = _em_mean(ssm.drift, m, dts[k], n_substeps)
            out.append(m)
        return torch.stack(out)

    n_full = T // _BLOCK * _BLOCK
    run = _Graph(block, ssm.m0, dt[:_BLOCK]) if n_full and _graphable(dt) else block
    out, m = [], ssm.m0
    for s0 in range(0, n_full, _BLOCK):
        out.append(run(m, dt[s0:s0 + _BLOCK]))
        m = out[-1][-1]
    if n_full < T:
        out.append(block(m, dt[n_full:]))
    return torch.cat(out)


def _linearise(ssm: NonlinearSSM, m_ref, dt, y, n_substeps: int):
    """(A, b, Hk, y_eff): the dynamics linearised about m_ref[k-1] (m0 for
    k = 0), x_k ≈ A_k x_{k-1} + b_k, and the observations about m_ref[k],
    batched over T."""
    m_prev_ref = torch.cat([ssm.m0[None], m_ref[:-1]])

    def lin_dyn(mp, dtk):
        m_pred, A = _em_mean_jac(ssm.drift, mp, dtk, n_substeps)
        return A, m_pred - A @ mp

    A, b = torch.func.vmap(lin_dyn)(m_prev_ref, dt)
    h0, Hk = torch.func.vmap(lambda m: _value_and_jacfwd(ssm.obs_fn, m))(m_ref)
    y_eff = y - h0 + torch.einsum("tpj,tj->tp", Hk, m_ref)
    return A, b, Hk, y_eff


def affine_offsets(A, b):
    """c_k = A_k c_{k-1} + b_k from c_{-1} = 0, for A [T, d, d], b [T, d]:
    the parallel affine scan of `ops/sampling.py` with one sample."""
    return _affine_scan(A, b[:, None, :])[1][:, 0, :]


def iterated_parallel_ekf_smoother(ssm: NonlinearSSM, t, R, y, mask=None, n_iters: int = 5,
                                   n_substeps: int = 1, chunk_size=None, m_ref=None):
    """Iterated parallel EKS: linearise the dynamics and observations about a
    reference trajectory, run the exact linear parallel filter and smoother,
    and take the smoothed means as the next reference, `n_iters` times.
    `m_ref` [T, d] replaces the first reference (default: `propagate_mean`).
    Returns the last pass's (FilterResult, SmootherResult).

    The affine dynamics x_k = A_k x_{k-1} + b_k + q_k become zero-offset
    linear in z_k = x_k - c_k; the observations shift by H_k c_k and the
    means get c back."""
    from .parallel_kalman import parallel_kalman_filter, parallel_rts_smoother

    if mask is None:
        mask = observation_mask(y, ssm.P0.dtype)
    dt = _steps(t)
    Q = (ssm.L @ ssm.Qc @ ssm.L.T)[None] * dt[:, None, None]
    if m_ref is None:
        m_ref = propagate_mean(ssm, t, n_substeps)
    f = s = None
    for _ in range(n_iters):
        A, b, Hk, y_eff = _linearise(ssm, m_ref, dt, y, n_substeps)
        c = affine_offsets(A, b)
        y_shift = y_eff - torch.einsum("tpj,tj->tp", Hk, c)
        f = parallel_kalman_filter(A, Q, Hk, R, y_shift, ssm.m0, ssm.P0, mask=mask,
                                   chunk_size=chunk_size)
        s = parallel_rts_smoother(A, Q, f, chunk_size=chunk_size)
        f, s = f._replace(ms=f.ms + c), s._replace(ms=s.ms + c)
        m_ref = s.ms
    return f, s


def euler_maruyama_sample_given(drift, L, Qc, x0, t, eps, n_substeps: int = 1):
    """Forward-simulate the SDE over t [T] from the standard-normal draws eps
    [T - 1, n_substeps, w]; returns [T, d] with x0 first."""
    dt = torch.diff(t.reshape(-1))
    w = Qc.shape[-1]
    Ls = torch.linalg.cholesky(Qc + 1e-12 * torch.eye(w, dtype=Qc.dtype, device=Qc.device))
    x = x0
    xs = [x0]
    for k in range(dt.shape[0]):
        h = dt[k] / n_substeps
        for j in range(n_substeps):
            x = x + h * drift(x) + L @ (Ls @ eps[k, j]) * torch.sqrt(h)
        xs.append(x)
    return torch.stack(xs)


def euler_maruyama_sample(drift, L, Qc, x0, t, generator, n_substeps: int = 1):
    """`euler_maruyama_sample_given` on draws from `generator` (a
    `torch.Generator` on x0's device)."""
    eps = standard_normal(generator, (t.numel() - 1, n_substeps, Qc.shape[-1]), x0)
    return euler_maruyama_sample_given(drift, L, Qc, x0, t, eps, n_substeps)

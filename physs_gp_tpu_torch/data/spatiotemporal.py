"""Host-side spatio-temporal data assembly, scattered rows to the state-space
layout: the port's own copy of `physs_gp_tpu/data/spatiotemporal.py`.

All index bookkeeping (sorting, uniquing, padding) is one-time host-side
numpy, done before any tensor is made; the models consume the fixed,
sorted arrays made here, and `unsort` maps posterior rows back
to the caller's order. `unsort` takes a numpy array or a tensor (indexed on
the tensor's own device).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = [
    "pad_with_nan_to_make_grid",
    "SpatioTemporalData",
    "TemporallyGroupedData",
    "spatial_minibatch_indices",
]


def _as_2d(X):
    X = np.asarray(X)
    if X.ndim != 2:
        raise ValueError(f"X must be [N, 1+ds] (time first column); got {X.shape}")
    return X


def _as_rows(Y):
    Y = np.asarray(Y)
    return Y[:, None] if Y.ndim == 1 else Y


def _take(A, i, j):
    """A[i, j] for a numpy array or a tensor (index arrays on its device)."""
    if isinstance(A, torch.Tensor):
        return A[torch.as_tensor(i, device=A.device), torch.as_tensor(j, device=A.device)]
    return np.asarray(A)[i, j]


@dataclass
class SpatioTemporalData:
    """Scattered (t, s) observations snapped onto the full [Nt, Ns] grid.

    t [Nt] sorted unique times, X_space [Ns, ds] sorted unique sites,
    Y [Nt, Ns, P] with NaN where no observation exists. `Y_flat`
    ([Nt, Ns*P], site-major as `SpatioTemporalKernel`) feeds the models and
    `unsort(A)` reads one value per original row out of a grid-shaped
    result."""

    t: np.ndarray
    X_space: np.ndarray
    Y: np.ndarray
    _row_t: np.ndarray = field(repr=False)  # [N] original row -> time index
    _row_s: np.ndarray = field(repr=False)  # [N] original row -> site index

    @classmethod
    def from_scattered(cls, X, Y) -> "SpatioTemporalData":
        """X: [N, 1+ds] rows (t, s...); Y: [N] or [N, P]."""
        X = _as_2d(X)
        Y = _as_rows(Y)
        if Y.shape[0] != X.shape[0]:
            raise ValueError("X and Y row counts differ")
        t_u, t_idx = np.unique(X[:, 0], return_inverse=True)
        s_u, s_idx = np.unique(X[:, 1:], axis=0, return_inverse=True)
        s_idx = s_idx.reshape(-1)
        grid = np.full((t_u.shape[0], s_u.shape[0], Y.shape[1]), np.nan,
                       dtype=np.result_type(Y.dtype, np.float32))
        grid[t_idx, s_idx] = Y  # later duplicates win
        return cls(t=t_u, X_space=s_u, Y=grid, _row_t=t_idx, _row_s=s_idx)

    @property
    def Nt(self) -> int:
        return self.t.shape[0]

    @property
    def Ns(self) -> int:
        return self.X_space.shape[0]

    @property
    def P(self) -> int:
        return self.Y.shape[-1]

    @property
    def Y_flat(self) -> np.ndarray:
        """[Nt, Ns*P] site-major head layout for the filters."""
        return self.Y.reshape(self.Nt, self.Ns * self.P)

    def unsort(self, A):
        """[Nt, Ns, ...] (or [Nt, Ns*P] flat) -> one row per original row."""
        if A.ndim == 2 and tuple(A.shape) == (self.Nt, self.Ns * self.P):
            A = A.reshape(self.Nt, self.Ns, self.P)
        return _take(A, self._row_t, self._row_s)

    @property
    def X(self) -> np.ndarray:
        """Full-grid [Nt*Ns, 1+ds] inputs (time-major), for dense oracles."""
        tt = np.repeat(self.t, self.Ns)[:, None]
        ss = np.tile(self.X_space, (self.Nt, 1))
        return np.hstack([tt, ss])


def pad_with_nan_to_make_grid(X, Y):
    """Scattered (t, s, y) rows -> full-grid rows with NaN fill: returns
    (n_added, X_grid [Nt*Ns, 1+ds], Y_grid [Nt*Ns, P]) whose first N rows
    are the original X, Y in their order and the rest the grid's missing
    cells with NaN observations."""
    X = _as_2d(X)
    Y = _as_rows(Y)
    d = SpatioTemporalData.from_scattered(X, Y)
    present = np.zeros((d.Nt, d.Ns), dtype=bool)
    present[d._row_t, d._row_s] = True
    miss_t, miss_s = np.nonzero(~present)
    X_add = np.hstack([d.t[miss_t][:, None], d.X_space[miss_s]])
    Y_add = np.full((X_add.shape[0], Y.shape[1]), np.nan, dtype=Y.dtype)
    return X_add.shape[0], np.vstack([X, X_add]), np.vstack([Y, Y_add])


@dataclass
class TemporallyGroupedData:
    """Ragged time groups padded to a fixed spatial width.

    Each time step keeps only its own observation locations, padded to the
    largest group with filler points and NaN data; the models read them
    through a time-varying observation matrix (`ScatteredSpatialHead`).
    t [Nt] sorted unique times; X_st [Nt, Ng, ds] per-step points (filler
    rows repeat the step's first point; their Y is NaN); Y_st [Nt, Ng, P]."""

    t: np.ndarray
    X_st: np.ndarray
    Y_st: np.ndarray
    _row_t: np.ndarray = field(repr=False)
    _row_j: np.ndarray = field(repr=False)
    X_raw: np.ndarray = field(repr=False, default=None)  # the original rows
    Y_raw: np.ndarray = field(repr=False, default=None)

    @classmethod
    def from_scattered(cls, X, Y) -> "TemporallyGroupedData":
        X = _as_2d(X)
        Y = _as_rows(Y)
        order = np.lexsort(np.rot90(X))  # time-major stable sort
        inv = np.argsort(order, kind="stable")
        Xs, Ys = X[order], Y[order]
        t_u, t_idx, counts = np.unique(Xs[:, 0], return_inverse=True, return_counts=True)
        Nt, Ng, P = t_u.shape[0], int(counts.max()), Y.shape[1]
        # position of each sorted row inside its time group
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        j_idx = np.arange(Xs.shape[0]) - starts[t_idx]
        X_st = np.zeros((Nt, Ng, X.shape[1] - 1), dtype=Xs.dtype)
        X_st[:] = Xs[starts, 1:][:, None, :]  # filler: the group's first point
        X_st[t_idx, j_idx] = Xs[:, 1:]
        Y_st = np.full((Nt, Ng, P), np.nan, dtype=np.result_type(Y.dtype, np.float32))
        Y_st[t_idx, j_idx] = Ys
        return cls(t=t_u, X_st=X_st, Y_st=Y_st, _row_t=t_idx[inv], _row_j=j_idx[inv],
                   X_raw=X, Y_raw=Y)

    @property
    def Nt(self) -> int:
        return self.t.shape[0]

    @property
    def Ng(self) -> int:
        return self.X_st.shape[1]

    @property
    def P(self) -> int:
        return self.Y_st.shape[-1]

    @property
    def Y_flat(self) -> np.ndarray:
        return self.Y_st.reshape(self.Nt, self.Ng * self.P)

    def unsort(self, A):
        """[Nt, Ng, ...] (or [Nt, Ng*P] flat) -> one row per original row."""
        if A.ndim == 2 and tuple(A.shape) == (self.Nt, self.Ng * self.P):
            A = A.reshape(self.Nt, self.Ng, self.P)
        return _take(A, self._row_t, self._row_j)


def spatial_minibatch_indices(rng, Ns: int, batch: int) -> np.ndarray:
    """A uniform spatial-site minibatch, drawn with replacement; the ELL
    scale factor is Ns / batch."""
    return rng.integers(0, Ns, size=(batch,))

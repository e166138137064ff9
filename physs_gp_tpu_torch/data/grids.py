"""Host-side (numpy) time-grid assembly: the port's own copy of
`physs_gp_tpu/data/grids.py`.

Grids are built once per dataset, in numpy, before any tensor is made; the
models consume fixed, sorted arrays.
"""
from __future__ import annotations

import numpy as np

__all__ = ["merge_time_grids", "sort_time_series"]


def sort_time_series(t, Y):
    """Sort (t [N], Y [N, p]) by time; returns sorted copies and the inverse
    index."""
    t = np.asarray(t).ravel()
    Y = np.asarray(Y)
    order = np.argsort(t, kind="stable")
    inv = np.argsort(order, kind="stable")
    return t[order], Y[order], inv


def merge_time_grids(*series, dtype=np.float64):
    """Merge per-head time series onto one NaN-padded grid.

    series: (t_h [N_h], y_h [N_h]) per head h. Returns (t [T] sorted unique,
    Y [T, H]) with Y[i, h] = y_h at t[i] or NaN. Duplicate times within one
    head must not conflict.
    """
    all_t = np.unique(np.concatenate([np.asarray(t).ravel() for t, _ in series]))
    Y = np.full((all_t.shape[0], len(series)), np.nan, dtype=dtype)
    for h, (t_h, y_h) in enumerate(series):
        idx = np.searchsorted(all_t, np.asarray(t_h).ravel())
        Y[idx, h] = np.asarray(y_h).ravel()
    return all_t.astype(dtype), Y

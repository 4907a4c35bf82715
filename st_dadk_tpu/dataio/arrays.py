"""Static-shape point buffers: the dataset representation under jit.

The reference materializes observed (t, s) points as a Python list of dict
samples consumed by a torch DataLoader (train_st_interp.py:413-460). Under jit
everything under jit needs static shapes, so a dataset is a `PointSet`: dense
arrays of per-point features plus a 0/1 weight vector. Padding points carry
weight 0 and all weighted reductions reproduce the reference's ragged means
exactly. Padded capacity is chosen per experiment batch so vmapped lanes share
one shape.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class PointSet:
    """A set of (coords, t, y) training/eval points with validity weights."""
    coords: np.ndarray    # (n, 2) float32
    t: np.ndarray         # (n, 1) float32, normalized to [0, 1]
    y: np.ndarray         # (n, 1) float32
    w: np.ndarray         # (n,) float32, 1.0 = real point, 0.0 = padding
    n_real: int           # number of real points

    def __len__(self) -> int:
        return self.coords.shape[0]


def pointset_from_mask(z_data: np.ndarray, coords: np.ndarray,
                       mask: np.ndarray) -> PointSet:
    """Gather observed points under a (T, S) mask.

    NaN targets are skipped, time is normalized t/(T-1)
    (ref create_dataset_from_mask, train_st_interp.py:413-450). Point order is
    row-major (t, s), matching np.argwhere.
    """
    T, S = z_data.shape
    tt, ss = np.nonzero(mask)
    y = z_data[tt, ss]
    keep = ~np.isnan(y)
    tt, ss, y = tt[keep], ss[keep], y[keep]
    t_norm = (tt / (T - 1)).astype(np.float32) if T > 1 else np.zeros_like(tt, np.float32)
    return PointSet(
        coords=coords[ss].astype(np.float32),
        t=t_norm[:, None],
        y=y.astype(np.float32)[:, None],
        w=np.ones(len(y), dtype=np.float32),
        n_real=int(len(y)),
    )


def pad_pointset(ps: PointSet, capacity: int) -> PointSet:
    """Zero-pad to `capacity` points with weight 0 (static shapes for jit)."""
    n = len(ps)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < n points {n}")
    pad = capacity - n
    if pad == 0:
        return ps
    return PointSet(
        coords=np.concatenate([ps.coords, np.zeros((pad, 2), np.float32)]),
        t=np.concatenate([ps.t, np.zeros((pad, 1), np.float32)]),
        y=np.concatenate([ps.y, np.zeros((pad, 1), np.float32)]),
        w=np.concatenate([ps.w, np.zeros(pad, np.float32)]),
        n_real=ps.n_real,
    )


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def dense_grid_points(T: int, coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All (t, s) grid points for dense-field inference.

    Returns (coords_rep (T*S, 2), t_rep (T*S, 1)) in row-major (t, s) order so
    predictions reshape back to (T, S) — the layout of predictions.npz
    (ref plot_spatial_mse, train_st_interp.py:1196-1300).
    """
    S = coords.shape[0]
    coords_rep = np.tile(coords, (T, 1)).astype(np.float32)
    if T > 1:
        t_vals = (np.arange(T, dtype=np.float32) / (T - 1))
    else:
        t_vals = np.zeros(1, np.float32)
    t_rep = np.repeat(t_vals, S)[:, None]
    return coords_rep, t_rep

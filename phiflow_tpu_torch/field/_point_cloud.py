"""Particles — port of `phiflow_tpu/field/_point_cloud.py::distribute_points`
(`:45-82`) for a box inside a uniform grid.

A point cloud of the port is a (N, d) float32 position array (and, in the FLIP
model, a (N, d) velocity array beside it); no field object wraps it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ['distribute_points']


def distribute_points(lower: Sequence[float], upper: Sequence[float], resolution: Sequence[int],
                      points_per_cell: int = 8, seed: int = 0) -> np.ndarray:
    """Positions of `points_per_cell` jittered particles in every cell of the
    grid (`resolution` unit cells from the origin) whose centre lies in the
    box [lower, upper].

    Returns a (N, d) float32 numpy array, cells in row-major order. The draw
    is numpy's `default_rng(seed)` on the host; seed 0 is the JAX package's
    generator, so its particles come out bit for bit."""
    d = len(resolution)
    if len(lower) != d or len(upper) != d:
        raise ValueError(f"lower and upper need {d} entries each")
    f32 = np.float32
    # cell centres and the box test in float32, as the JAX package's grid computes them
    occupied = None
    for a, n in enumerate(resolution):
        centre = (np.arange(n, dtype=f32) + f32(0.5)) / f32(n) * f32(n)
        inside = ((centre >= f32(lower[a])) & (centre <= f32(upper[a]))).reshape((-1,) + (1,) * (d - a - 1))
        occupied = inside if occupied is None else occupied & inside
    idx = np.argwhere(occupied)  # (n_cells, d)
    offsets = np.random.default_rng(seed).uniform(0, 1, (idx.shape[0], points_per_cell, d))
    return (idx[:, None, :] + offsets).reshape(-1, d).astype(f32)

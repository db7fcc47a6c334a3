"""Particles — port of `phiflow_tpu/field/_point_cloud.py` (`PointCloud`,
`:17`; `distribute_points`, `:45-80`), in two layers.

The Field layer, with JAX's signatures: a point cloud is a Field on a `Point`
or `Sphere` geometry whose centre is a Tensor of points with an instance dim
(it stays on its device); its values are one value for all points or one per
point. `distribute_points` jitters `points_per_cell` particles into every cell
of a grid whose centre lies inside the geometries, and returns them as
spheres of a quarter cell's radius with values 0 and a NaN boundary — the
FLIP convention.

The array layer: `distribute_points_native` does the same for a box inside a
grid of unit cells from the origin and returns the (N, d) float32 positions.
Both draw from numpy's `default_rng` on the host — seed 0, the JAX package's
generator — so their particles are the JAX package's bit for bit.
"""
from __future__ import annotations

from numbers import Number
from typing import Sequence

import numpy as np

from ..geom import Geometry, Point, Sphere
from ..math import Tensor, channel, expand, instance, wrap
from ._field import Field, as_boundary

__all__ = ['PointCloud', 'nonzero', 'distribute_points', 'distribute_points_native']


def _cell_points(occupied: np.ndarray, points_per_cell: int, seed: int, center: bool = False) -> np.ndarray:
    """(n_cells · points_per_cell, d) float64 points in cell units: per
    occupied cell, in row-major order, its index plus offsets drawn uniformly
    from [0, 1)^d (or its centre, one point a cell, with `center`)."""
    idx = np.argwhere(occupied)  # (n_cells, d)
    if center:
        offsets = np.full((idx.shape[0], 1, idx.shape[1]), 0.5)
    else:
        offsets = np.random.default_rng(seed).uniform(0, 1, (idx.shape[0], points_per_cell, idx.shape[1]))
    return idx[:, None, :] + offsets


def distribute_points_native(lower: Sequence[float], upper: Sequence[float], resolution: Sequence[int],
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
    return _cell_points(occupied, points_per_cell, seed).reshape(-1, d).astype(f32)


def PointCloud(elements, values=1., extrapolation=0., bounds=None, **kwargs) -> Field:
    """A Field sampled at the points of `elements`: a `Point` / `Sphere`
    geometry with an instance dim, or a Tensor of points (a `vector` dim)."""
    if 'boundary' in kwargs:
        extrapolation = kwargs.pop('boundary')
    if isinstance(elements, Tensor):
        if not elements.shape.instance:
            assert elements.shape.channel, "a point Tensor needs a vector dim"
            elements = expand(elements, instance(points=1)) if not elements.shape.spatial else elements
        elements = Point(elements)
    assert isinstance(elements, Geometry), f"elements must be a Geometry or a point Tensor, got {type(elements)}"
    if isinstance(values, (Number, bool)):
        values = wrap(values)
    elif isinstance(values, (tuple, list)):
        values = wrap(list(values), channel(vector=elements.shape.get_labels('vector')))
    return Field(elements, values, as_boundary(extrapolation, elements))


def nonzero(field) -> Field:
    """A point cloud (values 1, boundary 0) at the sample points of the nonzero values of a grid."""
    from ..math import _ops as ops
    points = ops.gather(field.center, ops.nonzero(field.values, list_dim=instance('points')))
    return PointCloud(Point(points), 1., 0.)


def distribute_points(geometries, dim=instance('points'), points_per_cell: int = 8, center: bool = False,
                      radius: float = None, extrapolation=float('nan'), **domain) -> Field:
    """A point cloud of `points_per_cell` particles in each cell of the grid
    `domain` (or the grid Field `geometries`) whose centre lies inside the
    geometries; one at each such centre with `center`. The points are host
    float32, spheres of `radius` (a quarter of the mean cell size by
    default), values 0, boundary `extrapolation`."""
    from ._grid import CenteredGrid
    if isinstance(geometries, (tuple, list)):
        from ..geom import union
        geometries = union(*geometries)
    mask_grid = geometries if isinstance(geometries, Field) else CenteredGrid(geometries, 0., **domain)
    labels = mask_grid.resolution.names
    occupied = np.asarray(mask_grid.values.numpy(labels)) > 0.5
    dx = np.asarray(mask_grid.dx.numpy(mask_grid.dx.shape.names))
    lower = np.asarray(mask_grid.bounds.lower.numpy())
    pts = (_cell_points(occupied, points_per_cell, 0, center) * dx + lower).reshape(-1, len(labels))
    points = wrap(pts.astype(np.float32), dim.with_size(pts.shape[0]), channel(vector=labels))
    if radius is None:
        radius = float(0.5 * np.mean(dx) * 0.5)
    elements = Sphere(points, radius=radius)
    return Field(elements, wrap(0.), as_boundary(extrapolation, elements))

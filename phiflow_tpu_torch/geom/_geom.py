"""Geometries as plain objects — the part of `phiflow_tpu/geom/_geom.py` and
`_geom_ops.py` that obstacles need: the inside test, the signed distance, the
soft voxelisation, the complement `~g` and `union`.

A geometry's own numbers (centre, radius, half size, rotation) are float32
numpy arrays on the host. Its queries take a *location*: one tensor per axis,
broadcastable against each other — the sample points of a grid are d
one-dimensional coordinate arrays (`geom/_grid.py`), so a query allocates full
grids only for its result. Arithmetic is float32 in JAX's order (subtract,
square, sum, compare), which decides the cells whose centre lies on a surface.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ['Geometry', 'InvertedGeometry', 'Union', 'union']

Location = Sequence[torch.Tensor]


def vec32(x, ndim: int = None) -> np.ndarray:
    """`x` as a float32 vector on the host; a scalar fills `ndim` entries."""
    a = np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float32)
    if a.ndim == 0 and ndim is not None:
        a = np.full((ndim,), a, np.float32)
    if a.ndim != 1 or (ndim is not None and a.shape[0] != ndim):
        raise ValueError(f"a vector of {ndim if ndim is not None else 'd'} entries expected, got shape {a.shape}")
    return a


def vec_squared(v: Location) -> torch.Tensor:
    total = None
    for c in v:
        total = c ** 2 if total is None else total + c ** 2
    return total


def vec_length(v: Location, eps: float = None) -> torch.Tensor:
    sq = vec_squared(v)
    if eps is not None:
        sq = torch.clamp(sq, min=eps)
    return torch.sqrt(sq)


def box_signed_distance(q: Location) -> torch.Tensor:
    """Exact signed distance of a box from q = |x − centre| − half size."""
    outside = vec_length([torch.clamp(c, min=0.0) for c in q])
    largest = q[0]
    for c in q[1:]:
        largest = torch.maximum(largest, c)
    return outside + torch.clamp(largest, max=0.0)


class Geometry:
    """Interface of the geometries below; `center` is a float32 vector."""

    center: np.ndarray

    @property
    def spatial_rank(self) -> int:
        return int(self.center.shape[0])

    def lies_inside(self, location: Location) -> torch.Tensor:
        raise NotImplementedError(type(self))

    def approximate_signed_distance(self, location: Location) -> torch.Tensor:
        raise NotImplementedError(type(self))

    def approximate_fraction_inside(self, cells, balance: float = 0.5) -> torch.Tensor:
        """The fraction of each cell of `cells` (a `UniformGrid`) inside this
        geometry, estimated from the signed distance at the cell's centre
        against the cell's bounding radius. ``balance`` is the fraction of a
        cell whose centre lies on the surface."""
        distance = self.approximate_signed_distance(cells.center)
        return torch.clamp(balance - distance / cells.bounding_radius(), 0.0, 1.0)

    def at(self, center) -> 'Geometry':
        raise NotImplementedError(type(self))

    def shifted(self, delta) -> 'Geometry':
        return self.at(self.center + vec32(delta, self.spatial_rank))

    def rotated(self, angle) -> 'Geometry':
        raise NotImplementedError(type(self))

    def __invert__(self) -> 'Geometry':
        return InvertedGeometry(self)


class InvertedGeometry(Geometry):
    """The complement `~geometry`."""

    def __init__(self, geometry: Geometry):
        self.geometry = geometry

    @property
    def center(self):
        return self.geometry.center

    @property
    def spatial_rank(self) -> int:
        return self.geometry.spatial_rank

    def lies_inside(self, location):
        return ~self.geometry.lies_inside(location)

    def approximate_signed_distance(self, location):
        return -self.geometry.approximate_signed_distance(location)

    def approximate_fraction_inside(self, cells, balance=0.5):
        return 1 - self.geometry.approximate_fraction_inside(cells, 1 - balance)

    def __invert__(self):
        return self.geometry

    def __repr__(self):
        return f"~{self.geometry!r}"


class Union(Geometry):
    """The union of geometries: inside any member, the distance to the
    nearest."""

    def __init__(self, geometries: Sequence[Geometry]):
        self.geometries = tuple(geometries)
        if not self.geometries:
            raise ValueError("a union needs at least one geometry")

    @property
    def spatial_rank(self) -> int:
        return self.geometries[0].spatial_rank

    def lies_inside(self, location):
        result = self.geometries[0].lies_inside(location)
        for g in self.geometries[1:]:
            result = result | g.lies_inside(location)
        return result

    def approximate_signed_distance(self, location):
        result = self.geometries[0].approximate_signed_distance(location)
        for g in self.geometries[1:]:
            result = torch.minimum(result, g.approximate_signed_distance(location))
        return result

    def approximate_fraction_inside(self, cells, balance=0.5):
        # members of one type stack into one geometry in the JAX package (the
        # nearest member's distance decides); a mixed union sums its members' fractions
        if all(type(g) is type(self.geometries[0]) for g in self.geometries):
            return super().approximate_fraction_inside(cells, balance)
        total = None
        for g in self.geometries:
            frac = g.approximate_fraction_inside(cells, balance)
            total = frac if total is None else total + frac
        return torch.clamp(total, 0.0, 1.0)

    def __repr__(self):
        return f"union{self.geometries!r}"


def union(*geometries) -> Geometry:
    """The union of the geometries (also given as one list); a single
    geometry is returned as it is."""
    if len(geometries) == 1 and isinstance(geometries[0], (tuple, list)):
        geometries = tuple(geometries[0])
    if len(geometries) == 1:
        return geometries[0]
    return Union(geometries)

"""Spheres — port of `phiflow_tpu/geom/_sphere.py` as far as obstacles use it:
the inside test, the signed distance and `at`. `Sphere(center, radius)` takes
a sequence or a Tensor as the centre, `Sphere(x=…, y=…, radius=R)` one keyword
per axis (`:23`)."""
from __future__ import annotations

import numpy as np
import torch

from ..math import EMPTY_SHAPE, Tensor, default_float
from ._geom import Geometry, host_scalar, host_vec, vec_length, vec_squared

__all__ = ['Sphere']


class Sphere(Geometry):
    """An N-dimensional sphere: centre vector and radius."""

    def __init__(self, center=None, radius=None, **center_kw):
        if center_kw:
            self._center = np.asarray([float(v) for v in center_kw.values()], default_float())
            self.names = tuple(center_kw)
        else:
            if center is None:
                raise ValueError("Sphere takes a centre: a vector or one keyword per axis")
            self._center, self.names = host_vec(center)
        if radius is None:
            raise ValueError("Sphere takes a radius")
        self._radius = host_scalar(radius)

    @property
    def radius(self):
        return Tensor(np.asarray(self._radius), EMPTY_SHAPE)

    def _delta(self, location):
        if len(location) != self.spatial_rank:
            raise ValueError(f"a {self.spatial_rank}D sphere queried at a {len(location)}D location")
        return [x - float(c) for x, c in zip(location, self._center)]

    def lies_inside(self, location) -> torch.Tensor:
        return vec_squared(self._delta(location)) <= float(self._radius ** 2)

    def approximate_signed_distance(self, location) -> torch.Tensor:
        return vec_length(self._delta(location), eps=1e-12) - float(self._radius)

    def at(self, center) -> 'Sphere':
        sphere = Sphere(host_vec(center, self.spatial_rank)[0], self._radius)
        sphere.names = self.names
        return sphere

    def rotated(self, angle) -> 'Sphere':
        return self

    def __eq__(self, other):
        return isinstance(other, Sphere) and np.array_equal(self._center, other._center) \
            and self._radius == other._radius

    def __hash__(self):
        return hash('Sphere')

    def __repr__(self):
        return f"Sphere(center={self._center.tolist()}, radius={float(self._radius)})"

"""Spheres — port of `phiflow_tpu/geom/_sphere.py` as far as obstacles use it:
the inside test, the signed distance and `at`."""
from __future__ import annotations

import numpy as np
import torch

from ._geom import Geometry, vec32, vec_length, vec_squared

__all__ = ['Sphere']


class Sphere(Geometry):
    """An N-dimensional sphere: centre vector and radius."""

    def __init__(self, center, radius):
        self.center = vec32(center)
        self.radius = np.float32(radius)

    def _delta(self, location):
        if len(location) != self.spatial_rank:
            raise ValueError(f"a {self.spatial_rank}D sphere queried at a {len(location)}D location")
        return [x - float(c) for x, c in zip(location, self.center)]

    def lies_inside(self, location) -> torch.Tensor:
        return vec_squared(self._delta(location)) <= float(self.radius ** 2)

    def approximate_signed_distance(self, location) -> torch.Tensor:
        return vec_length(self._delta(location), eps=1e-12) - float(self.radius)

    def at(self, center) -> 'Sphere':
        return Sphere(vec32(center, self.spatial_rank), self.radius)

    def rotated(self, angle) -> 'Sphere':
        return self

    def __repr__(self):
        return f"Sphere(center={self.center.tolist()}, radius={float(self.radius)})"

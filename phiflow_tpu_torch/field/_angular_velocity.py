"""The velocity field of a rigid rotation — port of
`phiflow_tpu/field/_angular_velocity.py`: v(x) = ω × (x − x₀), in 2D
(−dy, dx)·ω. `AngularVelocity` is JAX's Field initializer (with its
falloff); `angular_velocity` / `angular_velocity_at_faces` the array layer's
form without falloff, which moving obstacles impose on the faces they cover
(`physics/fluid.py::apply_boundary_conditions`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..geom._grid import UniformGrid_native
from ..math import Tensor, wrap, channel, stack
from ..math import _ops as ops
from ._field import FieldInitializer

__all__ = ['AngularVelocity', 'angular_velocity', 'angular_velocity_at_faces']


class AngularVelocity(FieldInitializer):
    """v(x) = ω × (x − x₀), optionally times `falloff(x − x₀)`; `location`
    may hold several centres along an instance dim, whose fields add up."""

    def __init__(self, location: Tensor, strength=1.0, falloff=None):
        self.location = wrap(location)
        self.strength = wrap(strength)
        self.falloff = falloff

    def _sample(self, geometry, at: str, boundaries, **kwargs) -> Tensor:
        points = geometry.face_centers if at == 'face' else geometry.center
        distances = points - self.location
        labels = points.shape.get_labels('vector')
        if len(labels) == 2:
            x, y = labels
            velocity = stack({x: -distances.vector[y], y: distances.vector[x]},
                             channel(vector=labels)) * self.strength
        elif len(labels) == 3:
            velocity = ops.cross(self.strength, distances)
        else:
            raise NotImplementedError(f"AngularVelocity in {len(labels)}D")
        if self.falloff is not None:
            velocity = velocity * self.falloff(distances)
        reduce = self.location.shape.instance.without(points.shape.instance.names)
        if reduce:
            velocity = ops.sum_(velocity, reduce)
        return velocity


def angular_velocity(location: Sequence[torch.Tensor], center, strength) -> Tuple[torch.Tensor, ...]:
    """The vector ω × (x − center) at `location` (one tensor per axis): one
    tensor per component, each of the shape its inputs broadcast to. `strength`
    is a scalar in 2D and a rotation vector in 3D."""
    dist = [x - float(c) for x, c in zip(location, np.asarray(center, np.float32))]
    w = np.asarray(strength, np.float32)
    if len(dist) == 2:
        if w.ndim != 0:
            raise ValueError(f"a 2D angular velocity is a scalar, got shape {w.shape}")
        return -dist[1] * float(w), dist[0] * float(w)
    if len(dist) == 3:
        if w.shape != (3,):
            raise ValueError(f"a 3D angular velocity is a vector of 3 entries, got shape {w.shape}")
        w = [float(x) for x in w]
        return (w[1] * dist[2] - w[2] * dist[1],
                w[2] * dist[0] - w[0] * dist[2],
                w[0] * dist[1] - w[1] * dist[0])
    raise NotImplementedError(f"angular velocity in {len(dist)}D")


def angular_velocity_at_faces(face_grids: Sequence[UniformGrid_native], center, strength) -> Tuple[torch.Tensor, ...]:
    """The staggered sample of the rotation: component a taken at the face
    centres of axis a, each component at its own points."""
    return tuple(angular_velocity(grid.center, center, strength)[a] for a, grid in enumerate(face_grids))

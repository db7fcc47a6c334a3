"""The velocity field of a rigid rotation — port of
`phiflow_tpu/field/_angular_velocity.py::AngularVelocity` without falloff:
v(x) = ω × (x − x₀), in 2D (−dy, dx)·ω. Moving obstacles impose it on the
faces they cover (`physics/fluid.py::apply_boundary_conditions`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..geom._grid import UniformGrid_native

__all__ = ['angular_velocity', 'angular_velocity_at_faces']


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

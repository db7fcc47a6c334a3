"""Boxes — port of `phiflow_tpu/geom/_box.py` as far as particles and obstacles
use it: `BaseBox.push` (`:121-135`) on raw position tensors as `box_push`, the
axis-aligned `Box` (two corners) and the `Cuboid` (centre, half size and an
optional rotation) with their inside tests and signed distances.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ._geom import Geometry, box_signed_distance, vec32
from ._transform import rotate_vector

__all__ = ['box_push', 'Box', 'Cuboid']


def box_push(positions: torch.Tensor, lower: Sequence[float], upper: Sequence[float], outward: bool = True,
             shift_amount: float = 0.0) -> torch.Tensor:
    """Move the positions (N, d) that violate the box [lower, upper], axis by
    axis. ``outward=True``: positions inside are pushed out along their
    closest axis, `shift_amount` beyond the surface. ``outward=False`` — what
    the inverted box `~box` does, the walls of a domain: positions outside are
    pulled in to `shift_amount` inside the surface, at most to the centre."""
    f32 = np.float32
    lo = np.asarray(lower, f32)
    up = np.asarray(upper, f32)
    center = torch.as_tensor((lo + up) * f32(0.5), device=positions.device)
    half_size = torch.as_tensor((up - lo) * f32(0.5), device=positions.device)
    loc_to_center = positions - center
    sgn_dist = torch.abs(loc_to_center) - half_size  # per-axis signed distance
    if outward:
        closest = (sgn_dist >= sgn_dist.max(dim=1, keepdim=True).values - 1e-12) & (sgn_dist < 0)
        shift = closest.to(positions.dtype) * (sgn_dist - shift_amount)
    else:
        shift = (sgn_dist + shift_amount) * (sgn_dist > 0).to(positions.dtype)
        shift = torch.where(torch.abs(shift) > torch.abs(loc_to_center), torch.abs(loc_to_center), shift)
    sign = torch.where(loc_to_center < 0, torch.ones_like(shift), -torch.ones_like(shift))
    return positions + sign * shift


class Box(Geometry):
    """An axis-aligned box from its lower and upper corner."""

    def __init__(self, lower, upper):
        self.lower = vec32(lower)
        self.upper = vec32(upper, self.lower.shape[0])

    @property
    def center(self) -> np.ndarray:
        return (self.lower + self.upper) * np.float32(0.5)

    @property
    def half_size(self) -> np.ndarray:
        return (self.upper - self.lower) * np.float32(0.5)

    def lies_inside(self, location) -> torch.Tensor:
        result = None
        for x, lo, up in zip(location, self.lower, self.upper):
            inside = (x >= float(lo)) & (x <= float(up))
            result = inside if result is None else result & inside
        return result

    def approximate_signed_distance(self, location) -> torch.Tensor:
        return box_signed_distance([torch.abs(x - float(c)) - float(h)
                                    for x, c, h in zip(location, self.center, self.half_size)])

    def at(self, center) -> 'Box':
        center, half = vec32(center, self.spatial_rank), self.half_size
        return Box(center - half, center + half)

    def shifted(self, delta) -> 'Box':
        delta = vec32(delta, self.spatial_rank)
        return Box(self.lower + delta, self.upper + delta)

    def rotated(self, angle) -> 'Cuboid':
        return Cuboid(self.center, self.half_size, rotation=angle)

    def __repr__(self):
        return f"Box({self.lower.tolist()}, {self.upper.tolist()})"


class Cuboid(Geometry):
    """A box from its centre and half size, optionally rotated about its
    centre: one angle in 2D, Euler angles (or one angle about z) in 3D."""

    def __init__(self, center, half_size, rotation=None):
        self.half_size = vec32(half_size)
        self.center = vec32(center, self.half_size.shape[0])
        self.rotation = None if rotation is None else np.asarray(rotation, np.float32)

    @property
    def lower(self) -> np.ndarray:
        return self.center - self.half_size

    @property
    def upper(self) -> np.ndarray:
        return self.center + self.half_size

    def _to_local(self, location):
        """World → body frame: relative to the centre, the rotation undone."""
        delta = [x - float(c) for x, c in zip(location, self.center)]
        return rotate_vector(delta, self.rotation, invert=True)

    def lies_inside(self, location) -> torch.Tensor:
        result = None
        for q, h in zip(self._to_local(location), self.half_size):
            inside = torch.abs(q) <= float(h)
            result = inside if result is None else result & inside
        return result

    def approximate_signed_distance(self, location) -> torch.Tensor:
        return box_signed_distance([torch.abs(q) - float(h) for q, h in zip(self._to_local(location), self.half_size)])

    def at(self, center) -> 'Cuboid':
        return Cuboid(vec32(center, self.spatial_rank), self.half_size, self.rotation)

    def rotated(self, angle) -> 'Cuboid':
        angle = np.asarray(angle, np.float32)
        return Cuboid(self.center, self.half_size, angle if self.rotation is None else self.rotation + angle)

    def __repr__(self):
        rot = '' if self.rotation is None else f", rotation={self.rotation.tolist()}"
        return f"Cuboid(center={self.center.tolist()}, half_size={self.half_size.tolist()}{rot})"

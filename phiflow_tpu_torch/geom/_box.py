"""Boxes — port of `phiflow_tpu/geom/_box.py` as far as particles, obstacles
and grid bounds use it: `BaseBox.push` (`:121-135`) on raw position tensors as
`box_push`, the axis-aligned `Box` (two corners; `Box(x=1., y=1.)` and
`Box(lower, upper)` with Tensors as in the JAX package, `:168`) and the
`Cuboid` (centre, half size and an optional rotation; JAX's signature, `:283`)
with their inside tests and signed distances, `sample_uniform` (`:137`) and
`push` of a Tensor of points (`:121-135`), which unwraps into `box_push`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..math import default_float
from ._geom import Geometry, box_signed_distance, host_vec, flat_points, vector_tensor
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


def _uniform_in_box(lower, size, names, shape):
    """Points uniform in the box [lower, lower + size), from the port's random generator."""
    from ..math import channel, random_uniform
    return lower + random_uniform(*shape, channel(vector=names)) * size


class _BoxPush:
    """`push` of the box geometries: the axis-wise push of `box_push` on the
    points `positions` (a Tensor with an instance dim and `vector`), between
    the box's lower and upper corner."""

    def push(self, positions, outward: bool = True, shift_amount: float = 0):
        flat, like = flat_points(positions)
        lower, upper = self.lower.numpy(), self.upper.numpy()
        return like(box_push(flat, lower, upper, outward=outward, shift_amount=shift_amount))


class Box(_BoxPush, Geometry):
    """An axis-aligned box from its lower and upper corner: two sequences or
    Tensors, or one keyword per axis — a size (lower corner 0) or a
    (lower, upper) pair."""

    def __init__(self, lower=None, upper=None, **size):
        if size:
            names = tuple(size)
            lo, up = [], []
            for v in size.values():
                l, u = (v[0], v[1]) if isinstance(v, (tuple, list)) else (0., v)
                lo.append(-np.inf if l is None else float(l))
                up.append(np.inf if u is None else float(u))
            self._lower, self._upper = np.asarray(lo, default_float()), np.asarray(up, default_float())
            self.names = names
            return
        if lower is None or upper is None:
            raise ValueError("Box takes lower and upper or one keyword per axis")
        self._lower, names_lo = host_vec(lower)
        self._upper, names_up = host_vec(upper, self._lower.shape[0])
        self.names = names_lo or names_up

    @classmethod
    def _of(cls, lower: np.ndarray, upper: np.ndarray, names) -> 'Box':
        box = cls.__new__(cls)
        box._lower, box._upper, box.names = lower, upper, names
        return box

    @property
    def lower(self):
        return vector_tensor(self._lower, self.names)

    @property
    def upper(self):
        return vector_tensor(self._upper, self.names)

    @property
    def _center(self) -> np.ndarray:
        return (self._lower + self._upper) * self._lower.dtype.type(0.5)

    @property
    def _half_size(self) -> np.ndarray:
        return (self._upper - self._lower) * self._lower.dtype.type(0.5)

    @property
    def half_size(self):
        return vector_tensor(self._half_size, self.names)

    @property
    def size(self):
        return vector_tensor(self._upper - self._lower, self.names)

    def sample_uniform(self, *shape):
        """Points drawn uniformly inside the box (`math.random_uniform`), of the dims `shape` and `vector`."""
        return _uniform_in_box(self.lower, self.size, self.names, shape)

    def lies_inside(self, location) -> torch.Tensor:
        result = None
        for x, lo, up in zip(location, self._lower, self._upper):
            inside = (x >= float(lo)) & (x <= float(up))
            result = inside if result is None else result & inside
        return result

    def approximate_signed_distance(self, location) -> torch.Tensor:
        return box_signed_distance([torch.abs(x - float(c)) - float(h)
                                    for x, c, h in zip(location, self._center, self._half_size)])

    def at(self, center) -> 'Box':
        center, half = host_vec(center, self.spatial_rank)[0], self._half_size
        return Box._of(center - half, center + half, self.names)

    def shifted(self, delta) -> 'Box':
        delta = host_vec(delta, self.spatial_rank)[0]
        return Box._of(self._lower + delta, self._upper + delta, self.names)

    def rotated(self, angle) -> 'Cuboid':
        return Cuboid(self._center, self._half_size, rotation=angle)

    def __eq__(self, other):
        return isinstance(other, Box) and np.array_equal(self._lower, other._lower) \
            and np.array_equal(self._upper, other._upper)

    def __hash__(self):
        return hash('Box')

    def __repr__(self):
        if self.names:
            return "Box(" + ', '.join(f"{n}=({float(l)},{float(u)})"
                                      for n, l, u in zip(self.names, self._lower, self._upper)) + ")"
        return f"Box({self._lower.tolist()}, {self._upper.tolist()})"


class Cuboid(_BoxPush, Geometry):
    """A box from its centre and half size, optionally rotated about its
    centre: one angle in 2D, Euler angles (or one angle about z) in 3D. The
    half size is `half_size`, half of `size`, or one keyword per axis
    (`Cuboid(vec(x=20., y=80.), x=20., y=20.)`); a scalar centre fills every
    axis. Its push is the axis-aligned one of the JAX package (the rotation
    does not take part)."""

    def __init__(self, center=0, half_size=None, rotation=None, size=None, **half_size_kw):
        names_h = None
        if half_size_kw:
            self._half_size = np.asarray([float(v) for v in half_size_kw.values()], default_float())
            names_h = tuple(half_size_kw)
        elif half_size is not None:
            self._half_size, names_h = host_vec(half_size)
        elif size is not None:
            size, names_h = host_vec(size)
            self._half_size = size * size.dtype.type(0.5)
        else:
            raise ValueError("Cuboid takes a half size: half_size, size or one keyword per axis")
        self._center, names_c = host_vec(center, self._half_size.shape[0])
        self.names = names_c or names_h
        self.rotation = None if rotation is None else np.asarray(rotation, np.float32)

    @property
    def half_size(self):
        return vector_tensor(self._half_size, self.names)

    @property
    def lower(self):
        return vector_tensor(self._center - self._half_size, self.names)

    @property
    def upper(self):
        return vector_tensor(self._center + self._half_size, self.names)

    def sample_uniform(self, *shape):
        """Points drawn uniformly inside the axis-aligned box of the same
        corners, as the JAX package draws them (its rotation does not take part)."""
        return _uniform_in_box(self.lower, self.half_size * 2, self.names, shape)

    def _to_local(self, location):
        """World → body frame: relative to the centre, the rotation undone."""
        delta = [x - float(c) for x, c in zip(location, self._center)]
        return rotate_vector(delta, self.rotation, invert=True)

    def lies_inside(self, location) -> torch.Tensor:
        result = None
        for q, h in zip(self._to_local(location), self._half_size):
            inside = torch.abs(q) <= float(h)
            result = inside if result is None else result & inside
        return result

    def approximate_signed_distance(self, location) -> torch.Tensor:
        return box_signed_distance([torch.abs(q) - float(h) for q, h in zip(self._to_local(location), self._half_size)])

    def at(self, center) -> 'Cuboid':
        cub = Cuboid(host_vec(center, self.spatial_rank)[0], self._half_size, self.rotation)
        cub.names = self.names
        return cub

    def rotated(self, angle) -> 'Cuboid':
        angle = np.asarray(angle, np.float32)
        cub = Cuboid(self._center, self._half_size, angle if self.rotation is None else self.rotation + angle)
        cub.names = self.names
        return cub

    def __repr__(self):
        rot = '' if self.rotation is None else f", rotation={self.rotation.tolist()}"
        return f"Cuboid(center={self._center.tolist()}, half_size={self._half_size.tolist()}{rot})"

"""Boxes — port of `phiflow_tpu/geom/_box.py` as far as particles, obstacles
and grid bounds use it: `BaseBox.push` (`:121-135`) on raw position tensors as
`box_push`, the axis-aligned `Box` (two corners; `Box(x=1., y=1.)` and
`Box(lower, upper)` with Tensors as in the JAX package, `:168`) and the
`Cuboid` (centre, half size and an optional rotation; JAX's signature, `:283`)
with their inside tests and signed distances, `sample_uniform` (`:137`) and
`push` of a Tensor of points (`:121-135`), which unwraps into `box_push`.
`BaseBox` holds what both share with the JAX package's: the volume, local
coordinates, the closest surface, bounds and the corner / centre forms;
`Box['x,y', 0:1, 0:1]` builds a box from slices; `bounding_box` and
`box_from_limits` are the module functions.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..math import Tensor, channel, default_float
from ._geom import Geometry, box_signed_distance, host_vec, flat_points, vector_tensor
from ._transform import rotate_vector

__all__ = ['box_push', 'Box', 'Cuboid', 'BaseBox', 'bounding_box', 'box_from_limits']


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
    from ..math._ops import channel, random_uniform
    return lower + random_uniform(*shape, channel(vector=names)) * size


class _BoxPush:
    """`push` of the box geometries: the axis-wise push of `box_push` on the
    points `positions` (a Tensor with an instance dim and `vector`), between
    the box's lower and upper corner."""

    def push(self, positions, outward: bool = True, shift_amount: float = 0):
        flat, like = flat_points(positions)
        lower, upper = self.lower.numpy(), self.upper.numpy()
        return like(box_push(flat, lower, upper, outward=outward, shift_amount=shift_amount))


class BaseBox(_BoxPush, Geometry):
    """What `Box` and `Cuboid` share (JAX: `BaseBox`)."""

    @property
    def volume(self) -> Tensor:
        from ..math._ops import prod
        return prod(self.half_size * 2, 'vector')

    @property
    def size(self):
        return self.half_size * 2

    def global_to_local(self, global_position: Tensor, scale=True, origin='lower') -> Tensor:
        """World coordinates relative to the box's `origin` ('lower', 'center'
        or 'upper'), in units of its size with `scale`."""
        pos = global_position - {'lower': self.lower, 'center': self.center}.get(origin, self.upper)
        return pos / self.size if scale else pos

    def local_to_global(self, local_position: Tensor, scale=True, origin='lower') -> Tensor:
        if scale:
            local_position = local_position * self.size
        return local_position + {'lower': self.lower, 'center': self.center}.get(origin, self.upper)

    def approximate_closest_surface(self, location):
        """(signed distance, delta to the surface, the outward normal of the
        face whose distance is largest, None, None) at a Tensor of points."""
        from ..math._ops import max_, sign, stack, to_float, vec_normalize
        q = location - self.center
        aq = abs(q) - self.half_size
        sgn_dist = self.approximate_signed_distance(location)
        max_aq = max_(aq, 'vector')
        normal = {n: to_float(aq.vector[n] >= max_aq - 1e-6) * sign(q.vector[n]) for n in q.shape.get_labels('vector')}
        normal = vec_normalize(stack(normal, channel('vector')), epsilon=1e-12)
        return sgn_dist, -sgn_dist * normal, normal, None, None

    def bounding_radius(self) -> Tensor:
        from ..math._ops import vec_length
        return vec_length(self.half_size)

    def bounding_half_extent(self) -> Tensor:
        return self.half_size

    def bounding_box(self) -> 'Box':
        return Box(self.lower, self.upper)

    def corner_representation(self) -> 'Box':
        return Box(self.lower, self.upper)

    def center_representation(self) -> 'Cuboid':
        return Cuboid(self.center, self.half_size)

    def contains(self, other: 'BaseBox') -> Tensor:
        from ..math._ops import all_
        return all_((other.lower >= self.lower) & (other.upper <= self.upper), 'vector')


class _BoxType(type):
    """`Box['x,y', 0:1, 0:1]`: a box from axis names and one slice an axis (None: unbounded)."""

    def __getitem__(cls, item):
        if not isinstance(item, tuple):
            item = (item,)
        if not isinstance(item[0], str):
            raise ValueError("Box[...] takes the axis names first, e.g. Box['x,y', 0:1, 0:1]")
        names = tuple(n.strip() for n in item[0].split(','))
        if len(item) - 1 != len(names) or not all(isinstance(x, slice) for x in item[1:]):
            raise ValueError(f"Box[...] takes one slice an axis of {names}, got {item[1:]}")
        return cls(**{n: (x.start, x.stop) for n, x in zip(names, item[1:])})


class Box(BaseBox, metaclass=_BoxType):
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

    def _lies_inside(self, location) -> torch.Tensor:
        result = None
        for x, lo, up in zip(location, self._lower, self._upper):
            inside = (x >= float(lo)) & (x <= float(up))
            result = inside if result is None else result & inside
        return result

    def _signed_distance(self, location) -> torch.Tensor:
        return box_signed_distance([torch.abs(x - float(c)) - float(h)
                                    for x, c, h in zip(location, self._center, self._half_size)])

    def at(self, center) -> 'Box':
        center, half = host_vec(center, self.spatial_rank)[0], self._half_size
        return Box._of(center - half, center + half, self.names)

    def shifted(self, delta) -> 'Box':
        delta = host_vec(delta, self.spatial_rank)[0]
        return Box._of(self._lower + delta, self._upper + delta, self.names)

    def rotated(self, angle) -> 'Cuboid':
        cub = Cuboid(self._center, self._half_size, rotation=angle)
        cub.names = self.names
        return cub

    def scaled(self, factor) -> 'Box':
        center, half = self._center, self._half_size * np.asarray(factor, self._lower.dtype)
        return Box._of(center - half, center + half, self.names)

    def __getitem__(self, item):
        """The box over some axes: `box['x']`, `box['x,y']` or `box.vector[...]`-style item dicts."""
        from ..math._magic import slicing_dict
        item = slicing_dict(self, item)
        sel = item.get('vector', slice(None))
        names = self.names or tuple(range(self.spatial_rank))
        if isinstance(sel, str):
            sel = [n.strip() for n in sel.split(',')]
        idx = list(range(len(names)))[sel] if isinstance(sel, slice) else \
            [names.index(n) if isinstance(n, str) else n for n in (sel if isinstance(sel, (list, tuple)) else [sel])]
        return Box._of(self._lower[idx], self._upper[idx], tuple(names[i] for i in idx) if self.names else None)

    def __mul__(self, other):
        """The product of boxes over different axes: Box(x=1) * Box(y=2)."""
        if not isinstance(other, Box):
            return NotImplemented
        return Box._of(np.concatenate([self._lower, other._lower]), np.concatenate([self._upper, other._upper]),
                       (self.names or ()) + (other.names or ()))

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


class Cuboid(BaseBox):
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

    @property
    def rotation_matrix(self):
        from ._transform import rotation_matrix
        return None if self.rotation is None else rotation_matrix(self.rotation, self.names or ('x', 'y', 'z')[
            :self.spatial_rank])

    def _lies_inside(self, location) -> torch.Tensor:
        result = None
        for q, h in zip(self._to_local(location), self._half_size):
            inside = torch.abs(q) <= float(h)
            result = inside if result is None else result & inside
        return result

    def _signed_distance(self, location) -> torch.Tensor:
        return box_signed_distance([torch.abs(q) - float(h) for q, h in zip(self._to_local(location), self._half_size)])

    def bounding_half_extent(self) -> Tensor:
        """The half size of the axis-aligned box around the rotated cuboid."""
        if self.rotation is None:
            return self.half_size
        from ._transform import rotation_matrix_native
        m = np.abs(rotation_matrix_native(self.rotation, self.spatial_rank))
        return vector_tensor((m @ self._half_size).astype(self._half_size.dtype), self.names)

    def scaled(self, factor) -> 'Cuboid':
        cub = Cuboid(self._center, self._half_size * np.asarray(factor, self._half_size.dtype), self.rotation)
        cub.names = self.names
        return cub

    def __eq__(self, other):
        return isinstance(other, Cuboid) and np.array_equal(self._center, other._center) \
            and np.array_equal(self._half_size, other._half_size) \
            and (self.rotation is None) == (other.rotation is None) \
            and (self.rotation is None or np.array_equal(self.rotation, other.rotation))

    def __hash__(self):
        return hash('Cuboid')

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


def bounding_box(geometry_or_tensor) -> Box:
    """The smallest axis-aligned box around a geometry, or around the points
    of a Tensor (its non-batch dims but `vector` reduced)."""
    if isinstance(geometry_or_tensor, Tensor):
        from ..math._ops import max_, min_
        t = geometry_or_tensor
        reduce = t.shape.non_batch.without('vector')
        return Box(min_(t, reduce), max_(t, reduce))
    return geometry_or_tensor.bounding_box()


def box_from_limits(lower, upper) -> Box:
    return Box(lower, upper)

"""Cylinders — port of `phiflow_tpu/geom/_cylinder.py`: a finite cylinder
along an axis, optionally rotated (`Cylinder`, the factory `cylinder`), on
Tensors as the JAX package's; its queries also take per-axis locations
(`_geom.py::TensorGeometry`)."""
from __future__ import annotations

from ..math import Tensor, Shape, wrap, channel, stack, expand
from ..math import _ops as ops
from ..math._magic import slicing_dict
from ._geom import TensorGeometry
from ._transform import rotate_vector

__all__ = ['Cylinder', 'cylinder']


class Cylinder(TensorGeometry):
    """Finite cylinder with axis along `axis` (a spatial dim name), rotatable.

    Defined by center, radius, depth (length along the axis), and optional
    rotation (Euler angles / 2D angle applied to the axis)."""

    def __init__(self, center: Tensor, radius, depth, axis: str = 'z', rotation=None):
        self._center = wrap(center)
        self._radius = wrap(radius)
        self._depth = wrap(depth)
        self.axis = axis
        self._rotation = rotation

    @property
    def center(self) -> Tensor:
        return self._center

    @property
    def radius(self) -> Tensor:
        return self._radius

    @property
    def depth(self) -> Tensor:
        return self._depth

    @property
    def shape(self) -> Shape:
        return self._center.shape & self._radius.shape & self._depth.shape

    @property
    def volume(self) -> Tensor:
        d = self.spatial_rank
        from ._sphere import Sphere
        cap_area = Sphere.volume_from_radius(self._radius, d - 1)
        return cap_area * self._depth

    @property
    def up(self) -> Tensor:
        labels = self.shape.get_labels('vector')
        unit = ops.vec(**{n: 1. if n == self.axis else 0. for n in labels})
        return rotate_vector(unit, self._rotation) if self._rotation is not None else unit

    def _local(self, location: Tensor):
        """(axial coordinate, radial distance) in the cylinder frame."""
        delta = location - self._center
        if self._rotation is not None:
            delta = rotate_vector(delta, self._rotation, invert=True)
        axial = delta.vector[self.axis]
        labels = [n for n in self.shape.get_labels('vector') if n != self.axis]
        radial2 = None
        for n in labels:
            t = delta.vector[n] ** 2
            radial2 = t if radial2 is None else radial2 + t
        return axial, ops.sqrt(ops.maximum(radial2, 1e-20))

    def _lies_inside(self, location: Tensor) -> Tensor:
        axial, radial = self._local(location)
        inside = (abs(axial) <= self._depth / 2) & (radial <= self._radius)
        reduce = self.shape.instance.without(location.shape.instance.names)
        return ops.any_(inside, reduce) if reduce else inside

    def _signed_distance(self, location: Tensor) -> Tensor:
        axial, radial = self._local(location)
        dr = radial - self._radius
        dz = abs(axial) - self._depth / 2
        outside = ops.sqrt(ops.maximum(dr, 0.) ** 2 + ops.maximum(dz, 0.) ** 2)
        inside = ops.minimum(ops.maximum(dr, dz), 0.)
        result = outside + inside
        reduce = self.shape.instance.without(location.shape.instance.names)
        return ops.min_(result, reduce) if reduce else result

    def bounding_radius(self) -> Tensor:
        return ops.sqrt(self._radius ** 2 + (self._depth / 2) ** 2)

    def bounding_half_extent(self) -> Tensor:
        if self._rotation is None:
            labels = self.shape.get_labels('vector')
            return ops.vec(**{n: (self._depth / 2 if n == self.axis else self._radius) for n in labels})
        return expand(self.bounding_radius(), self.shape.only('vector'))

    def at(self, center: Tensor) -> 'Cylinder':
        return Cylinder(center, self._radius, self._depth, self.axis, self._rotation)

    def rotated(self, angle) -> 'Cylinder':
        new_rot = angle if self._rotation is None else self._rotation + wrap(angle)
        return Cylinder(self._center, self._radius, self._depth, self.axis, new_rot)

    def scaled(self, factor) -> 'Cylinder':
        return Cylinder(self._center, self._radius * factor, self._depth * factor, self.axis, self._rotation)

    def sample_uniform(self, *shape: Shape) -> Tensor:
        labels = self.shape.get_labels('vector')
        d = len(labels)
        from ._sphere import Sphere
        cap = Sphere(ops.vec(**{n: 0. for n in labels if n != self.axis}), self._radius)
        radial = cap.sample_uniform(*shape)
        axial = (ops.random_uniform(*shape) - 0.5) * self._depth
        comps = {n: (axial if n == self.axis else radial.vector[n]) for n in labels}
        local = stack(comps, channel(vector=labels))
        if self._rotation is not None:
            local = rotate_vector(local, self._rotation)
        return self._center + local

    def __getitem__(self, item):
        item = slicing_dict(self, item)
        return Cylinder(self._center[{k: v for k, v in item.items() if k in self._center.shape}],
                        self._radius[{k: v for k, v in item.items() if k in self._radius.shape}],
                        self._depth[{k: v for k, v in item.items() if k in self._depth.shape}],
                        self.axis, self._rotation)

    def __field_stack__(self, values, dim):
        return Cylinder(stack([v._center for v in values], dim),
                        stack([v._radius for v in values], dim, expand_values=True),
                        stack([v._depth for v in values], dim, expand_values=True),
                        values[0].axis, values[0]._rotation)

    def __eq__(self, other):
        return isinstance(other, Cylinder) and ops.equal(self._center, other._center) \
            and ops.equal(self._radius, other._radius) and ops.equal(self._depth, other._depth)

    def __hash__(self):
        return hash(('Cylinder', self.axis))

    def __repr__(self):
        return f"Cylinder(center={self._center}, radius={self._radius}, depth={self._depth}, axis={self.axis})"


def cylinder(center=None, radius=None, depth=None, rotation=None, axis='z', **center_kw) -> Cylinder:
    """Factory: ``cylinder(x=0, y=0, z=0, radius=1, depth=2)``."""
    if center_kw:
        center = stack({k: wrap(float(v) if isinstance(v, (int, float)) else v) for k, v in center_kw.items()},
                       channel('vector'), expand_values=True)
    return Cylinder(center, radius, depth, axis, rotation)

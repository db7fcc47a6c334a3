"""Embedding — port of `phiflow_tpu/geom/_embed.py`: a geometry extended
infinitely along further axes (`embed`), and `infinite_cylinder`, a sphere
so extended."""
from __future__ import annotations

from ..math import Tensor, Shape, wrap, channel, stack, INF
from ..math._shape import parse_dim_order
from ._geom import Geometry, TensorGeometry

__all__ = ['embed', 'infinite_cylinder']


class _EmbeddedGeometry(TensorGeometry):
    """Geometry extruded infinitely along extra axes."""

    def __init__(self, geometry: Geometry, axes: tuple):
        self.geometry = geometry
        self.axes = tuple(axes)  # projected-out dims

    @property
    def _labels(self):
        inner = self.geometry.shape.get_labels('vector')
        return tuple(inner) + self.axes

    @property
    def shape(self) -> Shape:
        return self.geometry.shape.without('vector') & channel(vector=self._labels)

    @property
    def center(self) -> Tensor:
        inner = self.geometry.center
        comps = {n: inner.vector[n] for n in self.geometry.shape.get_labels('vector')}
        for a in self.axes:
            comps[a] = wrap(0.)
        return stack(comps, channel(vector=self._labels), expand_values=True)

    @property
    def volume(self) -> Tensor:
        return wrap(INF)

    def _project(self, location: Tensor) -> Tensor:
        inner_labels = self.geometry.shape.get_labels('vector')
        return stack({n: location.vector[n] for n in inner_labels}, channel(vector=inner_labels))

    def _lies_inside(self, location: Tensor) -> Tensor:
        return self.geometry.lies_inside(self._project(location))

    def _signed_distance(self, location: Tensor) -> Tensor:
        return self.geometry.approximate_signed_distance(self._project(location))

    def bounding_radius(self) -> Tensor:
        return wrap(INF)

    def bounding_half_extent(self) -> Tensor:
        inner = self.geometry.bounding_half_extent()
        comps = {n: inner.vector[n] for n in self.geometry.shape.get_labels('vector')}
        for a in self.axes:
            comps[a] = wrap(INF)
        return stack(comps, channel(vector=self._labels), expand_values=True)

    def at(self, center: Tensor):
        return _EmbeddedGeometry(self.geometry.at(self._project(center)), self.axes)

    def __getitem__(self, item):
        return _EmbeddedGeometry(self.geometry[item], self.axes)

    def __eq__(self, other):
        return isinstance(other, _EmbeddedGeometry) and self.geometry == other.geometry and self.axes == other.axes

    def __hash__(self):
        return hash(('embed', self.axes))

    def __repr__(self):
        return f"embed({self.geometry}, {self.axes})"


def embed(geometry: Geometry, projected_dims) -> Geometry:
    """Extend a geometry infinitely along `projected_dims`."""
    if projected_dims is None:
        return geometry
    axes = parse_dim_order(projected_dims)
    axes = tuple(a for a in axes if a not in (geometry.shape.get_labels('vector') or ()))
    if not axes:
        return geometry
    return _EmbeddedGeometry(geometry, axes)


def infinite_cylinder(center=None, radius=None, inf_dim=None, **center_kw) -> Geometry:
    """Cylinder with infinite axis."""
    from ._sphere import Sphere
    sphere = Sphere(center, radius, **center_kw)
    return embed(sphere, inf_dim)

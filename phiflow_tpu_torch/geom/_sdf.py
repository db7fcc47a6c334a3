"""Signed-distance-function geometries — port of `phiflow_tpu/geom/_sdf.py`:
`SDF` wraps a function of a Tensor of points within bounds, `numpy_sdf` one
of a numpy array of points."""
from __future__ import annotations

import numpy as np

from ..math import Tensor, Shape, wrap
from ._geom import TensorGeometry, sdf_normal as _sdf_normal
from ._box import BaseBox

__all__ = ['SDF', 'numpy_sdf']


class SDF(TensorGeometry):
    """Geometry defined by a python signed-distance function sdf(location)→distance."""

    def __init__(self, sdf_fn, bounds: BaseBox, center: Tensor = None, volume: Tensor = None,
                 bounding_radius: Tensor = None):
        self._sdf = sdf_fn
        self._bounds = bounds
        self._center = center if center is not None else bounds.center
        self._volume = volume
        self._bounding_radius = bounding_radius if bounding_radius is not None else bounds.bounding_radius()

    @property
    def sdf(self):
        return self._sdf

    @property
    def bounds(self) -> BaseBox:
        return self._bounds

    @property
    def center(self) -> Tensor:
        return self._center

    @property
    def shape(self) -> Shape:
        return self._center.shape

    @property
    def volume(self) -> Tensor:
        if self._volume is None:
            raise NotImplementedError("SDF volume not specified; pass volume= to SDF()")
        return self._volume

    def _lies_inside(self, location: Tensor) -> Tensor:
        return self._sdf(location) <= 0

    def _signed_distance(self, location: Tensor) -> Tensor:
        return self._sdf(location)

    def approximate_closest_surface(self, location: Tensor):
        dist = self._sdf(location)
        normal = _sdf_normal(self._sdf, location)
        delta = -dist * normal
        return dist, delta, normal, None, None

    def bounding_radius(self) -> Tensor:
        return self._bounding_radius

    def bounding_half_extent(self) -> Tensor:
        return self._bounds.bounding_half_extent()

    def bounding_box(self):
        return self._bounds.bounding_box()

    def at(self, center: Tensor) -> 'SDF':
        delta = center - self._center
        return SDF(lambda x: self._sdf(x - delta), self._bounds.shifted(delta), center,
                   self._volume, self._bounding_radius)

    def rotated(self, angle):
        from ._transform import rotate_vector
        c = self._center
        return SDF(lambda x: self._sdf(c + rotate_vector(x - c, angle, invert=True)),
                   self._bounds, self._center, self._volume, self._bounding_radius)

    def scaled(self, factor) -> 'SDF':
        c = self._center
        return SDF(lambda x: self._sdf(c + (x - c) / factor) * factor,
                   self._bounds.scaled(factor), c, None, self._bounding_radius * factor)

    def __getitem__(self, item):
        return self

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self._sdf)

    def __repr__(self):
        return f"SDF[{self._bounds}]"


def numpy_sdf(sdf_fn, bounds: BaseBox, center: Tensor = None) -> SDF:
    """Wrap a numpy-based sdf(points: (n,d) ndarray) → (n,) ndarray."""
    def tensor_sdf(location: Tensor) -> Tensor:
        labels = location.shape.get_labels('vector')
        listed = location.shape.without('vector')
        native = np.asarray(location.numpy(listed.names + ('vector',))).reshape(-1, len(labels))
        out = np.asarray(sdf_fn(native), np.float32).reshape(tuple(listed.sizes))
        return wrap(out, listed)
    return SDF(tensor_sdf, bounds, center)

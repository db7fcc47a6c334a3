"""Spheres — port of `phiflow_tpu/geom/_sphere.py` as far as obstacles and
particles use it: the inside test (also at a Tensor of points, as
`build_mesh` asks it), the signed distance, `at`, the volume and the
conversions between radius and volume (`:47-68`, SPH's sizing) and
`sample_uniform` (`:91`).
`Sphere(center, radius, volume)` takes a sequence or a Tensor as the centre,
`Sphere(x=…, y=…, radius=R)` one keyword per axis (`:23`), and a radius or a
volume.

An obstacle's sphere keeps its centre on the host. A particle set's —
a Tensor of points with an instance dim (`distribute_points`) — keeps the
Tensor as it is, on its device, for `at` and `center`; its inside test and
signed distance, at a Tensor of points, are the union over its spheres (any
inside, the nearest's distance), as in the JAX package."""
from __future__ import annotations

import numpy as np

from ..math import EMPTY_SHAPE, Tensor, default_float, sqrt, wrap
from ._geom import Geometry, host_scalar, host_vec, is_point_set, vec_length, vec_squared

__all__ = ['Sphere']


class Sphere(Geometry):
    """An N-dimensional sphere: centre vector and radius."""

    def __init__(self, center=None, radius=None, volume=None, **center_kw):
        self._points = None
        if center_kw:
            self._center = np.asarray([float(v) for v in center_kw.values()], default_float())
            self.names = tuple(center_kw)
        elif is_point_set(center):
            self._points, self._center = center, None
            self.names = center.shape.get_labels('vector')
        else:
            if center is None:
                raise ValueError("Sphere takes a centre: a vector or one keyword per axis")
            self._center, self.names = host_vec(center)
        if radius is None and volume is not None:
            radius = Sphere.radius_from_volume(host_scalar(volume), self.spatial_rank)
        if radius is None:
            raise ValueError("Sphere takes a radius or a volume")
        self._radius = host_scalar(radius)

    @property
    def volume(self) -> Tensor:
        return Sphere.volume_from_radius(self.radius, self.spatial_rank)

    @staticmethod
    def volume_from_radius(radius, rank: int) -> Tensor:
        radius = wrap(radius)
        if rank == 1:
            return 2 * radius
        if rank == 2:
            return np.pi * radius ** 2
        if rank == 3:
            return (4 / 3 * np.pi) * radius ** 3
        raise NotImplementedError(f"{rank}-D sphere volume")

    @staticmethod
    def radius_from_volume(volume, rank: int) -> Tensor:
        volume = wrap(volume)
        if rank == 1:
            return volume / 2
        if rank == 2:
            return sqrt(volume / np.pi)
        if rank == 3:
            return (volume / (4 / 3 * np.pi)) ** (1 / 3)
        raise NotImplementedError(f"{rank}-D sphere radius")

    @property
    def center(self):
        return self._points if self._points is not None else super().center

    @property
    def spatial_rank(self) -> int:
        return self._points.shape.get_size('vector') if self._points is not None else super().spatial_rank

    @property
    def shape(self):
        return self._points.shape if self._points is not None else super().shape

    @property
    def radius(self):
        return Tensor(np.asarray(self._radius), EMPTY_SHAPE)

    @property
    def query_form(self):
        """'axes' for a sphere, 'tensor' for a set of spheres at points."""
        return 'tensor' if self._points is not None else 'axes'

    def _delta(self, location):
        if len(location) != self.spatial_rank:
            raise ValueError(f"a {self.spatial_rank}D sphere queried at a {len(location)}D location")
        return [x - float(c) for x, c in zip(location, self._center)]

    def _reduce_points(self, result: Tensor, location: Tensor, reduce_fn) -> Tensor:
        """The union over the spheres of a point set: `reduce_fn` over the
        instance dims of the points that the location does not share."""
        dims = self._points.shape.instance.without(location.shape.instance.names)
        return reduce_fn(result, dims) if dims else result

    def _lies_inside(self, location):
        if self._points is not None:  # inside any of the spheres
            from ..math._ops import any_, vec_squared as t_squared
            return self._reduce_points(t_squared(location - self._points) <= float(self._radius) ** 2, location, any_)
        return vec_squared(self._delta(location)) <= float(self._radius ** 2)

    def _signed_distance(self, location):
        if self._points is not None:  # the nearest sphere's
            from ..math._ops import min_, vec_length as t_length
            return self._reduce_points(t_length(location - self._points, eps=1e-12) - float(self._radius), location,
                                       min_)
        return vec_length(self._delta(location), eps=1e-12) - float(self._radius)

    def approximate_closest_surface(self, location):
        """(signed distance, delta to the surface, outward normal, None, None) at a Tensor of points."""
        from ..math._ops import maximum, vec_length as t_length
        delta_c = location - self.center
        dist = t_length(delta_c, eps=1e-12)
        sgn_dist = dist - self.radius
        normal = delta_c / maximum(dist, 1e-12)
        return sgn_dist, -sgn_dist * normal, normal, None, None

    def bounding_radius(self) -> Tensor:
        return self.radius

    def bounding_half_extent(self) -> Tensor:
        from ..math._ops import expand
        return expand(self.radius, self.shape.only('vector'))

    def scaled(self, factor) -> 'Sphere':
        sphere = Sphere(self._points if self._points is not None else self._center,
                        self._radius * np.asarray(factor, np.asarray(self._radius).dtype))
        sphere.names = self.names
        return sphere

    def sample_uniform(self, *shape):
        """Points drawn uniformly inside the sphere: a normalised normal
        direction times radius · u^(1/d), u uniform (`math.random_normal`,
        `math.random_uniform`)."""
        from ..math._ops import channel, random_normal, random_uniform, vec_normalize
        v = vec_normalize(random_normal(*shape, channel(vector=self.names or self.spatial_rank)))
        return self.center + v * (self.radius * random_uniform(*shape) ** (1 / self.spatial_rank))

    def at(self, center) -> 'Sphere':
        if is_point_set(center):
            return Sphere(center, self._radius)
        sphere = Sphere(host_vec(center, self.spatial_rank)[0], self._radius)
        sphere.names = self.names
        return sphere

    def rotated(self, angle) -> 'Sphere':
        return self

    def __getitem__(self, item) -> 'Sphere':
        if self._points is None:
            raise NotImplementedError("slicing an obstacle's sphere")
        return Sphere(self._points[item], self._radius)

    def __eq__(self, other):
        if not isinstance(other, Sphere) or self._radius != other._radius:
            return False
        if self._points is not None or other._points is not None:
            return other._points is self._points
        return np.array_equal(self._center, other._center)

    def __hash__(self):
        return hash('Sphere')

    def __repr__(self):
        if self._points is not None:
            return f"Sphere(points {self._points.shape}, radius={float(self._radius)})"
        return f"Sphere(center={self._center.tolist()}, radius={float(self._radius)})"

"""Geometries as plain objects — the part of `phiflow_tpu/geom/_geom.py` and
`_geom_ops.py` that obstacles and particles need: the inside test, the signed
distance, the soft voxelisation, the complement `~g`, `union`, `push` (boxes
and their complements) and `Point`.

A geometry's own numbers (centre, radius, half size, rotation) are numpy
arrays on the host: float32 when given as numbers or sequences (the array
layer's calls), the Tensor's own precision when given as Tensors or keyword
components (the Field layer's calls, `Box(x=1., y=1.)`). Its public
attributes (`center`, `half_size`, `lower`, `upper`, `radius`) are host
Tensors with a `vector` dim, labelled by the axis names where they are known.
A particle set is the exception: `Point(points)` and `Sphere(points, radius)`
keep a Tensor of points with an instance dim as it is, on its device.

Its queries take a *location*: one tensor per axis, broadcastable against
each other — the sample points of a grid are d one-dimensional coordinate
arrays (`geom/_grid.py`), so a query allocates full grids only for its
result. Arithmetic is float32 in JAX's order (subtract, square, sum,
compare), which decides the cells whose centre lies on a surface.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..math import Tensor, channel, instance

__all__ = ['Geometry', 'InvertedGeometry', 'Union', 'union', 'Point']

Location = Sequence[torch.Tensor]


def vec32(x, ndim: int = None) -> np.ndarray:
    """`x` as a float32 vector on the host; a scalar fills `ndim` entries."""
    a = np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float32)
    if a.ndim == 0 and ndim is not None:
        a = np.full((ndim,), a, np.float32)
    if a.ndim != 1 or (ndim is not None and a.shape[0] != ndim):
        raise ValueError(f"a vector of {ndim if ndim is not None else 'd'} entries expected, got shape {a.shape}")
    return a


def host_vec(x, ndim: int = None):
    """(`x` as a host vector, its axis names or None). A named-dim Tensor keeps
    its precision and its `vector` labels; numbers and sequences become
    float32 (`vec32`)."""
    if isinstance(x, Tensor):
        a = x.numpy(x.shape.names)
        if a.dtype not in (np.float32, np.float64):
            a = a.astype(np.float32)
        if a.ndim == 0 and ndim is not None:
            a = np.full((ndim,), a, a.dtype)
        names = x.shape.get_labels('vector') if 'vector' in x.shape else None
        if a.ndim != 1 or (ndim is not None and a.shape[0] != ndim):
            raise ValueError(f"a vector of {ndim if ndim is not None else 'd'} entries expected, got {x.shape}")
        return a, names
    return vec32(x, ndim), None


def host_scalar(x):
    """`x` as a host scalar: float32 from a number, a Tensor's own precision."""
    if isinstance(x, Tensor):
        a = x.numpy()
        return a.astype(np.float32) if a.dtype not in (np.float32, np.float64) else a
    return np.float32(x)


def vector_tensor(a: np.ndarray, names):
    """A host vector as a named-dim Tensor with a `vector` dim."""
    return Tensor(a, channel(vector=names) if names else channel(vector=a.shape[0]))


def is_point_set(x) -> bool:
    """Whether `x` is a Tensor of points: a `vector` dim and an instance dim."""
    return isinstance(x, Tensor) and bool(x.shape.instance) and 'vector' in x.shape


def flat_points(points: Tensor):
    """A Tensor of points as a torch array (n, d) — its dims but `vector`
    flattened, `vector` last — and the function that wraps such an array back
    into a Tensor of `points`' shape."""
    shape = points.shape.without('vector') & points.shape.only('vector')
    native = points.torch(shape.names)
    flat = native.reshape(-1, shape.get_size('vector'))
    return flat, lambda a: Tensor(a.reshape(native.shape), shape)


def point_components(points: Tensor, names=None):
    """(one native a component along `vector` — in the order of the axis
    `names` where both they and the labels are known —, the shape of the
    points without `vector`): a Tensor of points as a query location."""
    shape = points.shape.without('vector')
    labels = points.shape.get_labels('vector')
    native = points.native(shape.names + ('vector',))
    order = [labels.index(n) for n in names] if names and labels else range(native.shape[-1])
    return [native[..., i] for i in order], shape


def vec_squared(v: Location) -> torch.Tensor:
    total = None
    for c in v:
        total = c ** 2 if total is None else total + c ** 2
    return total


def vec_length(v: Location, eps: float = None) -> torch.Tensor:
    sq = vec_squared(v)
    if eps is not None:
        sq = torch.clamp(sq, min=eps)
    return torch.sqrt(sq)


def box_signed_distance(q: Location) -> torch.Tensor:
    """Exact signed distance of a box from q = |x − centre| − half size."""
    outside = vec_length([torch.clamp(c, min=0.0) for c in q])
    largest = q[0]
    for c in q[1:]:
        largest = torch.maximum(largest, c)
    return outside + torch.clamp(largest, max=0.0)


class Geometry:
    """Interface of the geometries below. `_center` is the centre as a host
    vector, `names` the axis names (None where unknown); `center` is the
    centre as a Tensor."""

    _center: np.ndarray
    names = None

    @property
    def center(self):
        return vector_tensor(self._center, self.names)

    @property
    def spatial_rank(self) -> int:
        return int(self._center.shape[0])

    @property
    def shape(self):
        return channel(vector=self.names) if self.names else channel(vector=self.spatial_rank)

    def lies_inside(self, location: Location) -> torch.Tensor:
        raise NotImplementedError(type(self))

    def approximate_signed_distance(self, location: Location) -> torch.Tensor:
        raise NotImplementedError(type(self))

    def sample_uniform(self, *shape) -> Tensor:
        """Points drawn uniformly inside the geometry, of the dims `shape` and `vector`."""
        raise NotImplementedError(type(self))

    def approximate_fraction_inside(self, cells, balance: float = 0.5) -> torch.Tensor:
        """The fraction of each cell of `cells` (a `UniformGrid_native`) inside this
        geometry, estimated from the signed distance at the cell's centre
        against the cell's bounding radius. ``balance`` is the fraction of a
        cell whose centre lies on the surface."""
        distance = self.approximate_signed_distance(cells.center)
        return torch.clamp(balance - distance / cells.bounding_radius(), 0.0, 1.0)

    def at(self, center) -> 'Geometry':
        raise NotImplementedError(type(self))

    def shifted(self, delta) -> 'Geometry':
        return self.at(self._center + host_vec(delta, self.spatial_rank)[0])

    def rotated(self, angle) -> 'Geometry':
        raise NotImplementedError(type(self))

    def push(self, positions: Tensor, outward: bool = True, shift_amount: float = 0) -> Tensor:
        """Shift the points `positions` out of this geometry (inside with
        ``outward=False``) to `shift_amount` from its surface. Boxes and their
        complements have it; the finite-difference push of other shapes
        comes with a later slice."""
        raise NotImplementedError(f"push of a {type(self).__name__}: boxes and their complements are ported")

    def __invert__(self) -> 'Geometry':
        return InvertedGeometry(self)


class InvertedGeometry(Geometry):
    """The complement `~geometry`."""

    def __init__(self, geometry: Geometry):
        self.geometry = geometry

    def shifted(self, delta) -> 'InvertedGeometry':
        return InvertedGeometry(self.geometry.shifted(delta))

    @property
    def _center(self):
        return self.geometry._center

    @property
    def names(self):
        return self.geometry.names

    @property
    def spatial_rank(self) -> int:
        return self.geometry.spatial_rank

    def lies_inside(self, location):
        return ~self.geometry.lies_inside(location)

    def approximate_signed_distance(self, location):
        return -self.geometry.approximate_signed_distance(location)

    def approximate_fraction_inside(self, cells, balance=0.5):
        return 1 - self.geometry.approximate_fraction_inside(cells, 1 - balance)

    def push(self, positions, outward=True, shift_amount=0):
        return self.geometry.push(positions, outward=not outward, shift_amount=shift_amount)

    def __invert__(self):
        return self.geometry

    def __repr__(self):
        return f"~{self.geometry!r}"


class Union(Geometry):
    """The union of geometries: inside any member, the distance to the
    nearest."""

    def __init__(self, geometries: Sequence[Geometry]):
        self.geometries = tuple(geometries)
        if not self.geometries:
            raise ValueError("a union needs at least one geometry")

    def shifted(self, delta) -> 'Union':
        return Union([g.shifted(delta) for g in self.geometries])

    @property
    def _center(self):
        return self.geometries[0]._center

    @property
    def names(self):
        return self.geometries[0].names

    @property
    def spatial_rank(self) -> int:
        return self.geometries[0].spatial_rank

    def lies_inside(self, location):
        result = self.geometries[0].lies_inside(location)
        for g in self.geometries[1:]:
            result = result | g.lies_inside(location)
        return result

    def approximate_signed_distance(self, location):
        result = self.geometries[0].approximate_signed_distance(location)
        for g in self.geometries[1:]:
            result = torch.minimum(result, g.approximate_signed_distance(location))
        return result

    def approximate_fraction_inside(self, cells, balance=0.5):
        # members of one type stack into one geometry in the JAX package (the
        # nearest member's distance decides); a mixed union sums its members' fractions
        if all(type(g) is type(self.geometries[0]) for g in self.geometries):
            return super().approximate_fraction_inside(cells, balance)
        total = None
        for g in self.geometries:
            frac = g.approximate_fraction_inside(cells, balance)
            total = frac if total is None else total + frac
        return torch.clamp(total, 0.0, 1.0)

    def __repr__(self):
        return f"union{self.geometries!r}"


def union(*geometries, dim=instance('union')) -> Geometry:
    """The union of the geometries (also given as one list); a single
    geometry is returned as it is. `dim` names the JAX package's stack of the
    members; the union here keeps them in a tuple."""
    if len(geometries) == 1 and isinstance(geometries[0], (tuple, list)):
        geometries = tuple(geometries[0])
    if len(geometries) == 1:
        return geometries[0]
    return Union(geometries)


class Point(Geometry):
    """Zero-size geometries at the points `location` (a Tensor with a
    `vector` dim), kept as they are: a device Tensor stays on its device."""

    def __init__(self, location):
        self._location = location if isinstance(location, Tensor) else vector_tensor(vec32(location), None)

    @property
    def center(self) -> Tensor:
        return self._location

    @property
    def names(self):
        return self._location.shape.get_labels('vector')

    @property
    def spatial_rank(self) -> int:
        return self._location.shape.get_size('vector')

    @property
    def shape(self):
        return self._location.shape

    def at(self, center) -> 'Point':
        return Point(center)

    def sample_uniform(self, *shape) -> Tensor:
        from ..math import expand
        return expand(self._location, *shape)

    def __getitem__(self, item) -> 'Point':
        return Point(self._location[item])

    def rotated(self, angle) -> 'Point':
        return self

    def __eq__(self, other):
        return isinstance(other, Point) and other._location is self._location

    def __hash__(self):
        return hash('Point')

    def __repr__(self):
        return f"Point({self._location.shape})"

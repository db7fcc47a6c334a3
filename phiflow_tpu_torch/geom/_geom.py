"""Geometries as plain objects — port of `phiflow_tpu/geom/_geom.py`: the
`Geometry` interface (the inside test, the signed distance, the closest
surface, the soft voxelisation, bounds, transforms, faces, `push` through a
finite-difference normal of the signed distance), the complement `~g`,
`Point`, `NoGeometry` and the module functions `invert`, `rotate`, `scale`,
`sample_function`, `assert_same_rank`.

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
result — or, as in the JAX package, a Tensor with a `vector` dim, for which
they return Tensors. Arithmetic is float32 in JAX's order (subtract, square,
sum, compare), which decides the cells whose centre lies on a surface. The
shapes written on Tensors (`_cylinder.py`, `_heightmap.py`, `_sdf.py`, …)
are written for a Tensor of points, the others (`Box`, `Cuboid`, `Sphere`)
for a per-axis location (`Geometry.query_form`); `Geometry.lies_inside` and
`approximate_signed_distance` are the one place that converts a location of
the other form (`Geometry._query`).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..math import EMPTY_SHAPE, Tensor, channel, spatial, wrap

__all__ = ['Geometry', 'InvertedGeometry', 'Point', 'NoGeometry', 'GeometryException', 'assert_same_rank', 'invert',
           'rotate', 'scale', 'sample_function']


class GeometryException(Exception):
    """Raised where an operation is not defined for a geometry."""


def assert_same_rank(rank1, rank2, error_message):
    rank1 = rank1.spatial_rank if hasattr(rank1, 'spatial_rank') else rank1
    rank2 = rank2.spatial_rank if hasattr(rank2, 'spatial_rank') else rank2
    assert rank1 == rank2, f"{error_message} ranks {rank1} != {rank2}"

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


_LOC_DIMS = ('_l0', '_l1', '_l2', '_l3')


def tensor_location(location: Location, names) -> Tensor:
    """A per-axis location as a Tensor of points: the components broadcast
    against each other and stacked along `vector` (labelled `names`), its
    other dims `_l0`, `_l1`, …"""
    comps = torch.broadcast_tensors(*[torch.as_tensor(c) for c in location])
    native = torch.stack(comps, -1)
    lead = spatial(*_LOC_DIMS[:native.ndim - 1]).with_sizes(native.shape[:-1]) if native.ndim > 1 else EMPTY_SHAPE
    return Tensor(native, lead & channel(vector=tuple(names) if names else len(comps)))


def location_native(result: Tensor, location: Location) -> torch.Tensor:
    """The native of a query's Tensor result at a location that
    `tensor_location` made, broadcast to the location's shape."""
    shape = torch.broadcast_shapes(*[torch.as_tensor(c).shape for c in location])
    names = _LOC_DIMS[:len(shape)]
    for n in result.shape.names:
        if n not in names:
            raise ValueError(f"a query at a per-axis location returned the dim {n!r}: query it at a Tensor of points")
    native = result.native([n for n in names if n in result.shape])
    native = torch.as_tensor(native)
    full = [shape[i] if n in result.shape else 1 for i, n in enumerate(names)]
    return native.reshape(full).expand(shape)


def at_points(location: Tensor, names, fn):
    """`fn` of a per-axis location evaluated at a Tensor of points: the
    components along `vector` (in the order of `names`), as torch tensors;
    the result wrapped into a Tensor of the points' dims but `vector` — a
    host constant (numpy) where the points are one, so that it moves to the
    device of the tensors it meets, as host constants do."""
    comps, shape = point_components(location, names)
    result = fn([torch.as_tensor(c) for c in comps])
    host = not any(isinstance(c, torch.Tensor) for c in comps)
    return Tensor(result.numpy() if host else result, shape)


def clip01(fraction):
    """A volume fraction of either location form — a torch array or a Tensor —
    clipped to [0, 1]."""
    if isinstance(fraction, Tensor):
        from ..math._ops import clip
        return clip(fraction, 0, 1)
    return torch.clamp(fraction, 0.0, 1.0)


def sdf_normal(sdf_fn, positions: Tensor, eps=1e-3) -> Tensor:
    """The normalised central-difference gradient of `sdf_fn` at `positions`
    (a Tensor of points), a step of `eps` along each axis (JAX: `_sdf_normal`)."""
    from ..math._ops import dim_mask, stack, vec_normalize
    comps = {}
    labels = positions.shape.get_labels('vector')
    for n in labels:
        offset = dim_mask(positions.shape.only('vector').with_size(len(labels), labels), n) * eps
        comps[n] = (sdf_fn(positions + offset) - sdf_fn(positions - offset)) / (2 * eps)
    return vec_normalize(stack(comps, channel('vector'), expand_values=True), epsilon=1e-12)


class Geometry:
    """Interface of the geometries below. `_center` is the centre as a host
    vector, `names` the axis names (None where unknown); `center` is the
    centre as a Tensor.

    `query_form`: the location form that a shape's `_lies_inside` and
    `_signed_distance` are written for — 'axes' (one torch array per axis,
    broadcastable: the array layer's grids and masks) or 'tensor' (a Tensor of
    points with a `vector` dim, as the JAX package's shapes are written)."""

    _center: np.ndarray
    names = None
    query_form = 'axes'

    @property
    def center(self):
        return vector_tensor(self._center, self.names)

    @property
    def spatial_rank(self) -> int:
        return int(self._center.shape[0])

    @property
    def shape(self):
        return channel(vector=self.names) if self.names else channel(vector=self.spatial_rank)

    @property
    def volume(self) -> Tensor:
        raise NotImplementedError(type(self))

    # --- faces (FVM; a plain geometry has none) ---
    @property
    def face_centers(self) -> Tensor:
        raise NotImplementedError(f"{type(self)} does not define faces")

    @property
    def face_areas(self) -> Tensor:
        raise NotImplementedError(f"{type(self)} does not define faces")

    @property
    def face_normals(self) -> Tensor:
        raise NotImplementedError(f"{type(self)} does not define faces")

    @property
    def face_shape(self):
        return EMPTY_SHAPE

    @property
    def faces(self) -> 'Geometry':
        raise NotImplementedError(type(self))

    @property
    def boundary_elements(self) -> dict:
        return {}

    @property
    def boundary_faces(self) -> dict:
        return {}

    @property
    def sets(self) -> dict:
        """The named sample-point sets a Field's values can match."""
        centers = self.shape.non_batch.non_channel
        if self.face_shape and self.face_shape.volume > 0:
            return {'center': centers, 'face': self.face_shape.non_batch}
        return {'center': centers}

    def get_points(self, set_key: str) -> Tensor:
        if set_key == 'center':
            return self.center
        if set_key == 'face':
            return self.face_centers
        raise ValueError(set_key)

    def get_boundary(self, set_key: str) -> dict:
        if set_key == 'center':
            return self.boundary_elements
        if set_key == 'face':
            return self.boundary_faces
        raise ValueError(set_key)

    # --- queries ---
    def lies_inside(self, location):
        """Whether each location lies inside: at a per-axis location an array
        of the components' broadcast shape, at a Tensor of points a Tensor of
        its dims but `vector`."""
        return self._query(self._lies_inside, location)

    def approximate_signed_distance(self, location):
        return self._query(self._signed_distance, location)

    def _lies_inside(self, location):
        raise NotImplementedError(type(self))

    def _signed_distance(self, location):
        raise NotImplementedError(type(self))

    def _query(self, fn, location):
        """`fn`, written for `query_form`, at `location` of either form: a
        Tensor of points at an 'axes' shape as its components (`at_points`), a
        per-axis location at a 'tensor' shape as a Tensor of points
        (`tensor_location`, the result back as a native of the location's
        shape)."""
        if isinstance(location, Tensor) == (self.query_form == 'tensor'):
            return fn(location)
        if isinstance(location, Tensor):
            return at_points(location, self.names, fn)
        return location_native(fn(tensor_location(location, self.names)), location)

    def approximate_closest_surface(self, location):
        """(signed distance, delta to the surface, outward normal, offset, face index)."""
        raise NotImplementedError(type(self))

    def sample_uniform(self, *shape) -> Tensor:
        """Points drawn uniformly inside the geometry, of the dims `shape` and `vector`."""
        raise NotImplementedError(type(self))

    def approximate_fraction_inside(self, cells, balance: float = 0.5):
        """The fraction of each cell of `cells` (a geometry, or the array
        layer's `UniformGrid_native`) inside this geometry, estimated from the
        signed distance at the cell's centre against the cell's bounding
        radius. ``balance`` is the fraction of a cell whose centre lies on the
        surface."""
        distance = self.approximate_signed_distance(cells.center)
        radius = cells.bounding_radius()
        if not isinstance(distance, Tensor):
            radius = float(radius.numpy() if isinstance(radius, Tensor) else radius)
        return clip01(balance - distance / radius)

    def push(self, positions: Tensor, outward: bool = True, shift_amount: float = 0) -> Tensor:
        """Shift the points `positions` (a Tensor with `vector`) out of this
        geometry (inside with ``outward=False``) to `shift_amount` from its
        surface, along the normalised central-difference gradient of the
        signed distance (`sdf_normal`); points already that far stay."""
        from ..math._ops import where
        sdf = self.approximate_signed_distance(positions)
        normal = sdf_normal(self.approximate_signed_distance, positions)
        if outward:
            return where(sdf < shift_amount, positions + (shift_amount - sdf) * normal, positions)
        return where(sdf > -shift_amount, positions + (-shift_amount - sdf) * normal, positions)

    # --- bounds ---
    def bounding_radius(self):
        raise NotImplementedError(type(self))

    def bounding_half_extent(self):
        raise NotImplementedError(type(self))

    def bounding_box(self) -> 'Geometry':
        """The axis-aligned box around the geometry (over its instance dims)."""
        from ..math._ops import max_, min_
        from ._box import Box
        center, half = self.center, self.bounding_half_extent()
        reduce = self.shape.non_batch.non_channel
        if reduce:
            return Box(min_(center - half, reduce), max_(center + half, reduce))
        return Box(center - half, center + half)

    @property
    def bounds(self) -> 'Geometry':
        return self.bounding_box()

    # --- transforms ---
    def at(self, center) -> 'Geometry':
        raise NotImplementedError(type(self))

    def shifted(self, delta) -> 'Geometry':
        return self.at(self._center + host_vec(delta, self.spatial_rank)[0])

    def rotated(self, angle) -> 'Geometry':
        raise NotImplementedError(type(self))

    def scaled(self, factor) -> 'Geometry':
        raise NotImplementedError(type(self))

    # --- surface integrals ---
    def integrate_surface(self, face_values: Tensor, divide_volume=False) -> Tensor:
        from ..math._ops import sum_
        result = sum_(face_values * self.face_areas, self.face_shape.dual)
        return result / self.volume if divide_volume else result

    def integrate_flux(self, flux: Tensor, divide_volume=False) -> Tensor:
        from ..math._ops import sum_
        result = sum_(sum_(flux * self.face_normals, 'vector') * self.face_areas, self.face_shape.dual)
        return result / self.volume if divide_volume else result

    def __invert__(self) -> 'Geometry':
        return InvertedGeometry(self)

    def __add__(self, other):
        from ._geom_ops import union
        return union(self, other)

    def __or__(self, other):
        from ._geom_ops import union
        return union(self, other)

    def __and__(self, other):
        from ._geom_ops import intersection
        return intersection(self, other)

    def __stack__(self, values, dim, **kwargs):
        """A stack of geometries: one geometry of their type where it stacks
        its values (`__field_stack__`), else a `GeometryStack`."""
        from ._geom_ops import GeometryStack
        if all(type(v) == type(values[0]) for v in values) and hasattr(values[0], '__field_stack__'):
            return values[0].__field_stack__(values, dim)
        return GeometryStack(tuple(values), dim)


class TensorGeometry(Geometry):
    """Base of the shapes written on Tensors as the JAX package's are
    (`Cylinder`, `Heightmap`, `SDF`, `SDFGrid`, `Voxels`, embedded
    geometries): their numbers are Tensors, on the host or a device, and
    their queries are written for a Tensor of points."""

    query_form = 'tensor'

    @property
    def names(self):
        return self.shape.get_labels('vector')

    @property
    def spatial_rank(self) -> int:
        return self.shape.get_size('vector')

    def shifted(self, delta) -> 'Geometry':
        return self.at(self.center + delta)


class InvertedGeometry(Geometry):
    """The complement `~geometry`."""

    def __init__(self, geometry: Geometry):
        self.geometry = geometry

    @property
    def query_form(self):
        return self.geometry.query_form

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

    @property
    def center(self):
        return self.geometry.center

    @property
    def shape(self):
        return self.geometry.shape

    @property
    def volume(self):
        return -self.geometry.volume

    def bounding_radius(self):
        return self.geometry.bounding_radius()

    def bounding_half_extent(self):
        return self.geometry.bounding_half_extent()

    def at(self, center):
        return InvertedGeometry(self.geometry.at(center))

    def __getitem__(self, item):
        return InvertedGeometry(self.geometry[item])

    def __invert__(self):
        return self.geometry

    def __eq__(self, other):
        return isinstance(other, InvertedGeometry) and self.geometry == other.geometry

    def __hash__(self):
        return -hash(self.geometry)

    def __repr__(self):
        return f"~{self.geometry!r}"


def invert(geometry: Geometry) -> Geometry:
    return ~geometry


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
        from ..math._ops import expand
        return expand(self._location, *shape)

    def __getitem__(self, item) -> 'Point':
        return Point(self._location[item])

    def rotated(self, angle) -> 'Point':
        return self

    def scaled(self, factor) -> 'Point':
        return self

    @property
    def volume(self) -> Tensor:
        return wrap(0.)

    query_form = 'tensor'

    def _lies_inside(self, location):
        from ..math._ops import zeros_like
        return zeros_like(location.vector[0]) > 1

    def _signed_distance(self, location):
        from ..math._ops import vec_length
        return vec_length(location - self._location)

    def bounding_radius(self):
        return wrap(0.)

    def bounding_half_extent(self):
        from ..math._ops import zeros_like
        return zeros_like(self._location)

    def __field_stack__(self, values, dim):
        from ..math._ops import stack
        return Point(stack([v._location for v in values], dim))

    def __eq__(self, other):
        if not isinstance(other, Point):
            return False
        if other._location is self._location:
            return True
        from ..math._ops import equal
        return bool(equal(self._location, other._location))

    def __hash__(self):
        return hash('Point')

    def __repr__(self):
        return f"Point({self._location.shape})"


class NoGeometry(Geometry):
    """The empty geometry: nothing lies inside, every distance is +inf."""

    def __init__(self, vector_labels=('x', 'y')):
        self._labels = tuple(vector_labels)

    @property
    def names(self):
        return self._labels

    @property
    def _center(self):
        return np.zeros(len(self._labels), np.float32)

    @property
    def volume(self):
        return wrap(0.)

    query_form = 'tensor'

    def _lies_inside(self, location):
        from ..math._ops import zeros_like
        return zeros_like(location.vector[0]) > 1

    def _signed_distance(self, location):
        from ..math._ops import vec_length
        return vec_length(location) + np.inf

    def push(self, positions, outward=True, shift_amount=0):
        return positions

    def bounding_radius(self):
        return wrap(0.)

    def bounding_half_extent(self):
        from ..math._ops import zeros
        return zeros(channel(vector=self._labels))

    def at(self, center):
        return self

    def shifted(self, delta):
        return self

    def __eq__(self, other):
        return isinstance(other, NoGeometry)

    def __hash__(self):
        return hash('NoGeometry')

    def __repr__(self):
        return 'NoGeometry'


def sample_function(f, elements, at: str, extrapolation):
    """`f` called at the sample points `at` of `elements` ('center' or
    'face'): with the points as one argument, or one argument per component
    where `f` takes several."""
    import inspect
    points = elements.get_points(at) if hasattr(elements, 'get_points') else elements.center
    try:
        n_params = len(inspect.signature(f).parameters)
    except (TypeError, ValueError):
        n_params = 1
    if n_params == 1:
        return f(points)
    return f(*[points.vector[i] for i in range(points.shape.get_size('vector'))])


def rotate(geometry, angle, pivot=None):
    """A geometry, or a vector Tensor, rotated by `angle` about its centre or `pivot`."""
    if isinstance(geometry, Tensor):
        from ._transform import rotate_vector
        return rotate_vector(geometry, angle)
    if pivot is None:
        return geometry.rotated(angle)
    center = pivot + rotate(geometry.center - pivot, angle)
    return geometry.rotated(angle).at(center)


def scale(geometry, factor, pivot=None):
    """A geometry scaled by `factor` about its centre or `pivot`; a Tensor times `factor`."""
    if isinstance(geometry, Tensor):
        return geometry * factor
    if pivot is None:
        return geometry.scaled(factor)
    center = pivot + factor * (geometry.center - pivot)
    return geometry.scaled(factor).at(center)

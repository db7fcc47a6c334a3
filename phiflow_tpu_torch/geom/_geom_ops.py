"""Geometry composition — port of `phiflow_tpu/geom/_geom_ops.py`: stacks of
geometries (a stack along an instance dim named 'union' is their union),
intersections, `union`, `intersection` and `expel`.

A union or an intersection answers its queries in its members' form
(`Geometry.query_form`: 'tensor' where every member's is, else 'axes') and
reduces over them (inside any / all, the nearest / farthest surface); any other
stack stacks the members' results along its dim, on Tensors."""
from __future__ import annotations

from typing import Tuple

import torch

from ..math import Shape, Tensor, instance, merge_shapes, stack
from ._geom import Geometry, NoGeometry, clip01

__all__ = ['GeometryStack', 'Intersection', 'union', 'intersection', 'expel']


def _members_form(geometries) -> str:
    """'tensor' where every member's queries are written for Tensors, else 'axes'."""
    return 'tensor' if all(g.query_form == 'tensor' for g in geometries) else 'axes'


def _reduce(results, form: str, how: str):
    """The elementwise minimum or maximum (`how`) of query results of one form."""
    if form == 'tensor':
        from ..math import _ops
        op = getattr(_ops, how)
    else:
        op = getattr(torch, how)
    result = results[0]
    for r in results[1:]:
        result = op(result, r)
    return result


class GeometryStack(Geometry):
    """Geometries stacked along `stack_dim`; along an instance dim named
    'union' (what `union` makes) the stack is their union."""

    def __init__(self, geometries: Tuple[Geometry, ...], stack_dim: Shape):
        self.geometries = tuple(geometries)
        if not self.geometries:
            raise ValueError("a stack needs at least one geometry")
        dim = stack_dim.dims[0]
        self.stack_dim = Shape((dim.with_size(len(self.geometries), dim.labels),))

    def _is_union(self) -> bool:
        return self.stack_dim.dims[0].name == 'union'

    @property
    def _center(self):
        return self.geometries[0]._center

    @property
    def names(self):
        return self.geometries[0].names

    @property
    def spatial_rank(self) -> int:
        return self.geometries[0].spatial_rank

    @property
    def shape(self):
        inner = merge_shapes(*[g.shape for g in self.geometries], allow_varying_sizes=True)
        return self.stack_dim & inner

    @property
    def center(self) -> Tensor:
        return stack([g.center for g in self.geometries], self.stack_dim, expand_values=True)

    @property
    def volume(self) -> Tensor:
        return stack([g.volume for g in self.geometries], self.stack_dim, expand_values=True)

    @property
    def query_form(self):
        return _members_form(self.geometries) if self._is_union() else 'tensor'

    def _lies_inside(self, location):
        inside = [g.lies_inside(location) for g in self.geometries]
        if not self._is_union():
            return stack(inside, self.stack_dim, expand_values=True)
        result = inside[0]
        for i in inside[1:]:
            result = result | i
        return result

    def _signed_distance(self, location):
        dists = [g.approximate_signed_distance(location) for g in self.geometries]
        if not self._is_union():
            return stack(dists, self.stack_dim, expand_values=True)
        return _reduce(dists, self.query_form, 'minimum')

    def approximate_fraction_inside(self, cells, balance=0.5):
        # members of one type stack into one geometry in the JAX package (the nearest member's distance
        # decides); a mixed union sums its members' fractions
        if self._is_union() and all(type(g) is type(self.geometries[0]) for g in self.geometries):
            return super().approximate_fraction_inside(cells, balance)
        fracs = [g.approximate_fraction_inside(cells, balance) for g in self.geometries]
        if not self._is_union():
            return self._stacked(fracs)
        total = fracs[0]
        for f in fracs[1:]:
            total = total + f
        return clip01(total)

    def push(self, positions, outward: bool = True, shift_amount: float = 0):
        for g in self.geometries:
            positions = g.push(positions, outward=outward, shift_amount=shift_amount)
        return positions

    def bounding_radius(self):
        from ..math._ops import max_
        return max_(stack([g.bounding_radius() for g in self.geometries], instance('_g'), expand_values=True), '_g')

    def _corners(self):
        from ..math._ops import max_, min_
        boxes = [g.bounding_box() for g in self.geometries]
        upper = max_(stack([b.upper for b in boxes], instance('_g'), expand_values=True), '_g')
        lower = min_(stack([b.lower for b in boxes], instance('_g'), expand_values=True), '_g')
        return lower, upper

    def bounding_half_extent(self):
        lower, upper = self._corners()
        return (upper - lower) * 0.5

    @property
    def bounding_box_center(self):
        lower, upper = self._corners()
        return (upper + lower) * 0.5

    def bounding_box(self):
        from ._box import Box
        lower, upper = self._corners()
        return Box(lower, upper)

    def at(self, center) -> Geometry:
        return self.shifted(center - self.bounding_box_center)

    def shifted(self, delta) -> Geometry:
        name = self.stack_dim.dims[0].name
        if isinstance(delta, Tensor) and name in delta.shape:
            parts = [delta[{name: i}] for i in range(len(self.geometries))]
            return GeometryStack(tuple(g.shifted(p) for g, p in zip(self.geometries, parts)), self.stack_dim)
        return GeometryStack(tuple(g.shifted(delta) for g in self.geometries), self.stack_dim)

    def rotated(self, angle) -> Geometry:
        return GeometryStack(tuple(g.rotated(angle) for g in self.geometries), self.stack_dim)

    def scaled(self, factor) -> Geometry:
        return GeometryStack(tuple(g.scaled(factor) for g in self.geometries), self.stack_dim)

    def __getitem__(self, item):
        from ..math._magic import slicing_dict
        item = dict(slicing_dict(self, item))
        name = self.stack_dim.dims[0].name
        if name in item:
            sel = item.pop(name)
            if isinstance(sel, int):
                g = self.geometries[sel]
                return g[item] if item else g
            geoms = self.geometries[sel] if isinstance(sel, slice) else [self.geometries[i] for i in sel]
            result = GeometryStack(tuple(geoms), self.stack_dim)
            return result[item] if item else result
        return GeometryStack(tuple(g[item] for g in self.geometries), self.stack_dim)

    def __eq__(self, other):
        return isinstance(other, GeometryStack) and self.stack_dim == other.stack_dim \
            and len(self.geometries) == len(other.geometries) \
            and all(a == b for a, b in zip(self.geometries, other.geometries))

    def __hash__(self):
        return hash(self.stack_dim)

    def __repr__(self):
        if self._is_union():
            return f"union{self.geometries!r}"
        return f"GeometryStack[{self.stack_dim} over {[type(g).__name__ for g in self.geometries]}]"


class Intersection(Geometry):
    """The intersection of geometries: inside all, the farthest surface."""

    def __init__(self, geometries: Tuple[Geometry, ...]):
        self.geometries = tuple(geometries)

    @property
    def _center(self):
        return self.geometries[0]._center

    @property
    def names(self):
        return self.geometries[0].names

    @property
    def spatial_rank(self) -> int:
        return self.geometries[0].spatial_rank

    @property
    def shape(self):
        return merge_shapes(*[g.shape for g in self.geometries])

    @property
    def center(self):
        return self.geometries[0].center

    @property
    def volume(self):
        raise NotImplementedError("volume of an Intersection")

    @property
    def query_form(self):
        return _members_form(self.geometries)

    def _lies_inside(self, location):
        result = self.geometries[0].lies_inside(location)
        for g in self.geometries[1:]:
            result = result & g.lies_inside(location)
        return result

    def _signed_distance(self, location):
        return _reduce([g.approximate_signed_distance(location) for g in self.geometries], self.query_form, 'maximum')

    def approximate_fraction_inside(self, cells, balance=0.5):
        # the members' fractions come in the form of `cells`' centre
        fracs = [g.approximate_fraction_inside(cells, balance) for g in self.geometries]
        form = 'tensor' if isinstance(fracs[0], Tensor) else 'axes'
        return _reduce(fracs, form, 'minimum')

    def bounding_radius(self):
        from ..math._ops import min_
        return min_(stack([g.bounding_radius() for g in self.geometries], instance('_g'), expand_values=True), '_g')

    def bounding_half_extent(self):
        return self.geometries[0].bounding_half_extent()

    def at(self, center):
        return Intersection(tuple(g.at(center) for g in self.geometries))

    def shifted(self, delta):
        return Intersection(tuple(g.shifted(delta) for g in self.geometries))

    def __eq__(self, other):
        return isinstance(other, Intersection) and len(self.geometries) == len(other.geometries) \
            and all(a == b for a, b in zip(self.geometries, other.geometries))

    def __hash__(self):
        return hash(len(self.geometries))

    def __repr__(self):
        return f"intersection{self.geometries!r}"


def _members(geometries):
    if len(geometries) == 1 and isinstance(geometries[0], (tuple, list)):
        return tuple(geometries[0])
    return tuple(geometries)


def union(*geometries, dim=instance('union')) -> Geometry:
    """The union of the geometries (also given as one list): a single one as
    it is, none as `NoGeometry`, else a `GeometryStack` along `dim`."""
    geometries = _members(geometries)
    if not geometries:
        return NoGeometry()
    if len(geometries) == 1:
        return geometries[0]
    return GeometryStack(geometries, dim)


def intersection(*geometries, dim=instance('intersection')) -> Geometry:
    """The intersection of the geometries: a single one as it is, none as `NoGeometry`."""
    geometries = _members(geometries)
    if not geometries:
        return NoGeometry()
    if len(geometries) == 1:
        return geometries[0]
    return Intersection(geometries)


def expel(geometry: Geometry, location: Tensor, min_separation=0, invert=False) -> Tensor:
    """The points `location` shifted out of `geometry` (into it with ``invert``) to `min_separation`."""
    return geometry.push(location, outward=not invert, shift_amount=min_separation)

"""Field — a quantity sampled on a geometry, with a boundary condition — port
of `phiflow_tpu/field/_field.py`.

A grid Field holds a `UniformGrid`, values and an `Extrapolation`. Centred
values are one Tensor of the grid's dims (and channel dims, e.g. `vector`); a
staggered grid's values are a `TensorStack` over the dual dim `~vector`, one
uniform component per axis whose size along its own axis follows
``boundary.valid_outer_faces`` — the components are the arrays the array
layer and the kernels take, unchanged. Arithmetic with numbers, tuples and
Fields works on the values and carries the boundary along.

A point cloud is a Field on a `Point` or `Sphere` geometry whose centre is a
Tensor of points with an instance dim (`field/_point_cloud.py`); `points` and
`center` are that Tensor, `with_geometry` moves the points.

A `FieldInitializer` (such as `Noise`) or a callable of the sample points
given as values is sampled at the grid's cells (`field/_resample.py::sample`).

A mesh Field lies on a `Mesh` (`geom/_mesh.py`): its values have the dim
`cells` (and channel dims, e.g. `vector`); a constant is expanded to the
cells, and its boundary names are the mesh's boundary groups. Graphs as
Fields come with a later slice.
"""
from __future__ import annotations

from numbers import Number
from typing import Tuple

from ..math import (
    Shape, Tensor, TensorStack, wrap, channel, dual, batch, merge_shapes, concat_shapes, stack, expand,
    rename_dims,
)
from ..math import _ops as ops
from ..math import extrapolation as extrapolation_mod
from ..math._extrapolation import Extrapolation, ConstantExtrapolation, domain_slice
from ..math._magic import BoundDim, slicing_dict
from ..math._tensor import to_torch
from ..math._shape import Dim, CHANNEL
from ..geom import Box, Geometry, Point, Sphere, UniformGrid

__all__ = ['Field', 'FieldInitializer', 'as_boundary', 'is_staggered', 'face_components', 'face_values']


class FieldInitializer:
    """The protocol of analytic initializers such as `Noise`: a Field built
    from one samples it with `_sample(geometry, at, boundaries)`."""

    def _sample(self, geometry: Geometry, at: str, boundaries: Extrapolation, **kwargs) -> Tensor:
        raise NotImplementedError(type(self))


def _is_mesh(geometry) -> bool:
    from ..geom._mesh import Mesh
    return isinstance(geometry, Mesh)


def as_boundary(obj, geometry=None) -> Extrapolation:
    """A value as an Extrapolation: numbers and Tensors are constants, dicts
    combine sides, None is NONE."""
    if isinstance(obj, Extrapolation):
        return obj
    if isinstance(obj, Field):
        from ._embed import FieldEmbedding
        return FieldEmbedding(obj)
    if isinstance(obj, dict):
        return extrapolation_mod.combine_sides(**{k: as_boundary(v) for k, v in obj.items()})
    if isinstance(obj, (int, float, complex, Tensor)):
        return ConstantExtrapolation(wrap(obj))
    if obj is None:
        return extrapolation_mod.NONE
    return extrapolation_mod.as_extrapolation(obj)


def is_staggered(values, geometry: Geometry) -> bool:
    """Whether `values` are sampled at faces (a dual dim is present)."""
    return bool(values.shape.dual) if isinstance(values, Tensor) else False


def face_components(values) -> Tuple[Tensor, ...]:
    """The components of staggered values: a TensorStack's own Tensors, or
    views of a uniform stack (the periodic box, where all have one shape)."""
    return values.components if isinstance(values, TensorStack) else values._unstack('~vector')


def face_values(components, like) -> TensorStack:
    """Components as staggered values along `like`'s `~vector` dim, kept as they are."""
    return TensorStack(components, like.shape.only('~vector'))


class Field:
    """`Field(geometry, values, boundary)`, or through `CenteredGrid` /
    `StaggeredGrid`."""

    def __init__(self, geometry: Geometry, values, boundary=0., **sampling_kwargs):
        assert isinstance(geometry, Geometry), f"geometry must be a Geometry but got {type(geometry)}"
        boundary = as_boundary(boundary, geometry)
        if values is not None and not isinstance(values, Tensor):
            if isinstance(values, (Number, bool)):
                values = wrap(values)
            elif isinstance(values, (tuple, list)) and len(values) == geometry.spatial_rank:
                values = wrap(list(values), channel(vector=geometry.shape.get_labels('vector')))
            else:
                from ._resample import sample
                values = sample(values, geometry, 'center', boundary, **sampling_kwargs)
        if isinstance(values, Tensor) and not values.shape.dual and isinstance(geometry, UniformGrid):
            missing = geometry.resolution.without(values.shape.names)
            if missing:
                values = expand(values, missing)
        elif isinstance(values, Tensor) and not values.shape.dual and _is_mesh(geometry):
            cells = geometry.shape.non_channel
            if not all(n in values.shape for n in cells.names):
                values = expand(values, cells.without(values.shape.names))
                values = Tensor(to_torch(values.native(), geometry.device), values.shape)
        self._geometry = geometry
        self._values = values
        self._boundary = boundary

    # --- core attributes ---
    @property
    def geometry(self) -> Geometry:
        return self._geometry

    elements = geometry

    @property
    def values(self) -> Tensor:
        return self._values

    data = values

    @property
    def boundary(self) -> Extrapolation:
        return self._boundary

    extrapolation = boundary

    @property
    def shape(self) -> Shape:
        if self.is_staggered and self.is_grid:
            resolution = self._geometry.resolution
            extra = self._values.shape.without(resolution.names).without('~vector')
            vec = Shape((Dim('vector', len(resolution.names), CHANNEL, tuple(resolution.names)),))
            return concat_shapes(extra.batch, resolution, vec)
        return merge_shapes(self._values.shape, batch(self._geometry.shape))

    @property
    def spatial_rank(self) -> int:
        return self._geometry.spatial_rank

    @property
    def resolution(self) -> Shape:
        return self._geometry.resolution

    @property
    def bounds(self) -> Box:
        assert self.is_grid, f"bounds of a {type(self._geometry).__name__} Field come with a later slice"
        return self._geometry.bounds

    box = bounds

    @property
    def dx(self) -> Tensor:
        """The cell size, a host Tensor with a `vector` dim (the grid's own)."""
        assert self.is_grid, f"dx of a {type(self._geometry).__name__} Field comes with a later slice"
        return self._geometry.dx

    @property
    def is_grid(self) -> bool:
        return isinstance(self._geometry, UniformGrid)

    @property
    def is_mesh(self) -> bool:
        return _is_mesh(self._geometry)

    @property
    def is_graph(self) -> bool:
        from ..geom._graph import Graph
        return isinstance(self._geometry, Graph)

    @property
    def is_point_cloud(self) -> bool:
        if isinstance(self._geometry, UniformGrid):
            return False
        return isinstance(self._geometry, (Point, Sphere)) or bool(self._geometry.shape.instance)

    @property
    def is_staggered(self) -> bool:
        return is_staggered(self._values, self._geometry)

    @property
    def is_centered(self) -> bool:
        return not self.is_staggered

    @property
    def sampled_at(self) -> str:
        return 'face' if self.is_staggered else 'center'

    @property
    def cells(self):
        assert self.is_grid
        return self._geometry

    @property
    def grid(self) -> UniformGrid:
        assert self.is_grid
        return self._geometry

    @property
    def center(self) -> Tensor:
        """The sample points: of a centred grid or a point cloud its
        geometry's centres, of a staggered grid the centres of each
        component's face grid, stacked along `~vector` (JAX's
        `sampled_elements`)."""
        if self.is_staggered and self.is_grid:
            names = self.resolution.names
            return TensorStack([self._geometry.stagger(d, *self._boundary.valid_outer_faces(d)).center
                                for d in names], dual(vector=names))
        return self._geometry.center

    points = center

    @property
    def boundary_names(self) -> Tuple[str, ...]:
        if self.is_mesh:
            return self._geometry.boundary_names
        return tuple(self.resolution.names) if self.is_grid else ()

    @property
    def dtype(self):
        return self._values.dtype

    # --- modification ---
    def with_values(self, values, **sampling_kwargs) -> 'Field':
        if not isinstance(values, Tensor) and isinstance(values, (Number, bool)):
            if self.is_staggered:
                comps = [ops.zeros_like(c) + values for c in face_components(self._values)]
                return Field(self._geometry, face_values(comps, self._values), self._boundary)
            values = wrap(values)
        return Field(self._geometry, values, self._boundary, **sampling_kwargs)

    def with_boundary(self, boundary) -> 'Field':
        """The Field under another boundary; a staggered grid's components
        gain or lose their outer faces as `valid_outer_faces` changes."""
        boundary = as_boundary(boundary, self._geometry)
        if self.is_staggered and self.is_grid and boundary != self._boundary:
            comps = []
            for dim in self.resolution.names:
                v = self.vector[dim].values
                old_lo, old_up = self._boundary.valid_outer_faces(dim)
                new_lo, new_up = boundary.valid_outer_faces(dim)
                if old_lo and not new_lo:
                    v = v[{dim: slice(1, None)}]
                elif not old_lo and new_lo:
                    v = self._boundary[{'vector': dim}].pad(v, {dim: (1, 0)})
                if old_up and not new_up:
                    v = v[{dim: slice(0, -1)}]
                elif not old_up and new_up:
                    v = self._boundary[{'vector': dim}].pad(v, {dim: (0, 1)})
                comps.append(v)
            return Field(self._geometry, stack(comps, dual(vector=self.resolution.names)), boundary)
        return Field(self._geometry, self._values, boundary)

    with_extrapolation = with_boundary

    def with_geometry(self, geometry: Geometry) -> 'Field':
        return Field(geometry, self._values, self._boundary)

    def at(self, representation, keep_boundary=False, **kwargs) -> 'Field':
        from ._resample import resample
        return resample(self, representation, keep_boundary, **kwargs)

    def at_centers(self, **kwargs) -> 'Field':
        if self.is_centered:
            return self
        from ._resample import sample
        return Field(self._geometry, sample(self, self._geometry, at='center', boundary=self._boundary), self._boundary)

    def sample(self, where, at: str = 'center', **kwargs) -> Tensor:
        """This Field at the sample points of `where` (`field.sample`)."""
        from ._resample import sample
        return sample(self, where, at=at, **kwargs)

    def staggered_tensor(self) -> Tensor:
        """All components padded to resolution+1 and stacked into one uniform tensor."""
        assert self.is_staggered and self.is_grid
        padded = []
        for dim in self.resolution.names:
            widths = {d: (0, 1) for d in self.resolution.names}
            lo_valid, up_valid = self._boundary.valid_outer_faces(dim)
            widths[dim] = (int(not lo_valid), int(not up_valid))
            padded.append(ops.pad(self._values[{'~vector': dim}], widths, self._boundary[{'vector': dim}]))
        return stack(padded, Shape((Dim('vector', len(self.resolution.names), CHANNEL, tuple(self.resolution.names)),)))

    def numpy(self, order=None):
        if order is None and self.is_grid:
            if self.is_staggered:
                return [c.numpy(self.resolution.names) for c in face_components(self._values)]
            order = self.shape.batch.names + self.resolution.names + self.shape.channel.names
        return self._values.numpy(order)

    # --- operators (the boundary takes part where both operands have one) ---
    def _op1(self, operator) -> 'Field':
        return Field(self._geometry, operator(self._values), operator(self._boundary))

    def _op2(self, other, operator, zero_is_identity=False) -> 'Field':
        """`operator` on the values. With `zero_is_identity` (x + 0, x − 0), a
        vector constant's zero entries leave a staggered grid's components as
        they are instead of adding 0 on the device: the same values (only
        −0.0 stays −0.0) for no launch."""
        if isinstance(other, Geometry):
            raise ValueError(f"Cannot combine Field with Geometry {other}")
        if isinstance(other, Field):
            if self._geometry == other._geometry:
                values = operator(self._values, other._values)
                try:
                    boundary = operator(self._boundary, other._boundary)
                    if boundary is NotImplemented:
                        boundary = self._boundary
                except (TypeError, NotImplementedError):
                    boundary = self._boundary
                return Field(self._geometry, values, boundary)
            from ._resample import sample
            other_values = sample(other, self._geometry, self.sampled_at, self._boundary,
                                  dot_face_normal=self._geometry)
            values = operator(self._values, other_values)
            try:
                boundary = operator(self._boundary, other._boundary)
            except Exception:
                boundary = self._boundary
            return Field(self._geometry, values, boundary)
        if isinstance(other, (tuple, list)):
            ch = self.shape.channel
            if ch.rank == 1 and ch.volume == len(other):
                other = wrap(list(other), ch)
            else:
                labels = self._geometry.shape.get_labels('vector') or self.resolution.names
                assert len(other) == len(labels), f"vector constant {other} does not match dims {labels}"
                other = wrap(list(other), channel(vector=labels))
        else:
            other = wrap(other)
        if self.is_staggered and 'vector' in other.shape and 'vector' not in self._values.shape:
            other = rename_dims(other, 'vector', dual(vector=other.shape.get_labels('vector')))
            if zero_is_identity and other.is_host and other.rank == 1:
                comps = [c if float(e) == 0 else operator(c, e)
                         for c, e in zip(face_components(self._values), other._unstack('~vector'))]
                return Field(self._geometry, face_values(comps, self._values), self._boundary)
        return Field(self._geometry, operator(self._values, other), self._boundary)

    def __add__(self, other): return self._op2(other, lambda a, b: a + b, zero_is_identity=True)
    def __radd__(self, other): return self._op2(other, lambda a, b: b + a, zero_is_identity=True)
    def __sub__(self, other): return self._op2(other, lambda a, b: a - b, zero_is_identity=True)
    def __rsub__(self, other): return self._op2(other, lambda a, b: b - a)
    def __mul__(self, other): return self._op2(other, lambda a, b: a * b)
    def __rmul__(self, other): return self._op2(other, lambda a, b: b * a)
    def __truediv__(self, other): return self._op2(other, lambda a, b: a / b)
    def __rtruediv__(self, other): return self._op2(other, lambda a, b: b / a)
    def __pow__(self, other): return self._op2(other, lambda a, b: a ** b)
    def __neg__(self): return self._op1(lambda x: -x)
    def __abs__(self): return self._op1(lambda x: abs(x))
    def __gt__(self, other): return self._op2(other, lambda a, b: a > b)
    def __ge__(self, other): return self._op2(other, lambda a, b: a >= b)
    def __lt__(self, other): return self._op2(other, lambda a, b: a < b)
    def __le__(self, other): return self._op2(other, lambda a, b: a <= b)
    def __and__(self, other): return self._op2(other, lambda a, b: a & b)
    def __or__(self, other): return self._op2(other, lambda a, b: a | b)
    def __invert__(self): return self._op1(lambda x: ~x)

    def __matmul__(self, other):
        from ._resample import resample
        return resample(self, other)

    def __getitem__(self, item) -> 'Field':
        item = slicing_dict(self, item)
        if not item:
            return self
        boundary = domain_slice(self._boundary, item, self.boundary_names)
        item_without_vec = {dim: sel for dim, sel in item.items() if dim != 'vector'}
        geometry = self._geometry[item_without_vec] if item_without_vec else self._geometry
        if self.is_staggered and 'vector' in item:
            sel = item['vector']
            labels = self.resolution.names
            if isinstance(sel, int):
                names = [labels[sel]]
            elif isinstance(sel, str):
                names = [n.strip() for n in sel.split(',')]
            elif isinstance(sel, (tuple, list)):
                names = [labels[i] if isinstance(i, int) else i for i in sel]
            else:
                names = list(labels)
            item = dict(item)
            del item['vector']
            item['~vector'] = names[0] if len(names) == 1 else ','.join(names)
            if len(names) == 1:
                geometry = geometry.stagger(names[0], *self._boundary.valid_outer_faces(names[0]))
        values = self._values[{k: v for k, v in item.items() if k in self._values.shape or k == '~vector'}]
        return Field(geometry, values, boundary)

    def dimension(self, name):
        return BoundDim(self, name)

    # --- the differential operators of `_field_math` ---
    def gradient(self, boundary=None, at='center', dims=None, stack_dim=channel('vector'),
                 order=2, implicit=None, scheme=None, upwind=None, gradient_extrapolation=None):
        from ._field_math import spatial_gradient
        return spatial_gradient(self, gradient_extrapolation if gradient_extrapolation is not None else boundary,
                                at=at, dims=dims, stack_dim=stack_dim, order=order, implicit=implicit, upwind=upwind)

    def divergence(self, order=2, implicit=None, upwind=None):
        from ._field_math import divergence
        return divergence(self, order=order, implicit=implicit, upwind=upwind)

    def laplace(self, axes=None, gradient=None, order=2, implicit=None, weights=None, upwind=None, correct_skew=True):
        from ._field_math import laplace
        return laplace(self, axes=axes, gradient=gradient, order=order, implicit=implicit, weights=weights,
                       upwind=upwind, correct_skew=correct_skew)

    def curl(self, at='corner'):
        from ._field_math import curl
        return curl(self, at=at)

    def downsample(self, factor: int) -> 'Field':
        """`downsample2x` applied while `factor` ≥ 2, halving it each time."""
        from ._field_math import downsample2x
        result = self
        while factor >= 2:
            result = downsample2x(result)
            factor /= 2
        return result

    def as_boundary(self) -> Extrapolation:
        """This Field as the boundary of another: a `FieldEmbedding`."""
        from ._embed import FieldEmbedding
        return FieldEmbedding(self)

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)
        if name == 'vector':
            return BoundDim(self, 'vector')
        try:
            shape = self.shape
        except Exception:
            raise AttributeError(name)
        if name in shape:
            return BoundDim(self, name)
        raise AttributeError(f"Field has no attribute '{name}' (shape: {shape})")

    def __eq__(self, other):
        if not isinstance(other, Field):
            return False
        if self._geometry != other._geometry or self._boundary != other._boundary:
            return False
        try:
            return bool(ops.always_close(self._values, other._values))
        except Exception:
            return False

    def __hash__(self):
        return hash((type(self._geometry).__name__,))

    def __repr__(self):
        kind = 'StaggeredGrid' if self.is_staggered and self.is_grid else 'CenteredGrid' if self.is_grid else 'Field'
        try:
            return f"{kind}[{self.shape}, boundary={self._boundary}]"
        except Exception:
            return f"{kind}[{type(self._geometry).__name__}]"

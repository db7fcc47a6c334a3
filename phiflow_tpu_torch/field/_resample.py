"""Resampling on raw tensors: between half-cell-shifted aligned grids, from
particles to a grid (P2G), from a grid to particles (G2P), and of a geometry
onto a cell grid or the face grids (obstacle masks).

`sample_grid_at_centers` is the port of the order-2 branch of
`phiflow_tpu/field/_resample.py::_shift_resample` (`:310-347`) as
`sample_grid_at_centers` (`:234`) uses it: along every axis on which source
and target are staggered differently, pad with the source's extrapolation,
then average neighbours. Faces → centres, faces of one
component → faces of another, and centres → faces (the buoyancy lift) are all
this one operation.

A grid's staggering is its own axis: None for a centred grid, d for the face
component d. Layouts: in the closed box component d holds the interior faces
1..N−1 along axis d (N−1 entries, the walls are the extrapolation); in the
periodic box faces 0..N−1 (N entries).

`scatter_to_grid` ports `scatter_to_grid` / `_scatter_to_centered` with
``scatter=True`` (`:361-411`) for the closed box: the mean of the particles'
values per nearest sample point, through K8 (`ops/p2g.py`) once per target
grid. The face grid of component d is the cell grid shifted by half a cell
along d, one entry shorter there. `sample_grid_at_points` ports the function
of that name (`:251-262`): multilinear interpolation at particle positions, a
gather written with PyTorch indexing (the JAX package has no kernel for it).

`geometry_mask` ports `_geometry_mask` (`:151-158`) and the `at='face'` route
of `sample` (`:77-80`): hard, 1 where a sample point lies inside; soft, the
fraction of the sample point's cell inside. `staggered_cells` gives the face
grids in the layouts above.

The domain's lower corner is the origin.

The Field layer (`resample`, `sample`, `reduce_sample`, `grid_scatter`,
JAX's signatures) unwraps into these: a grid between half-cell-shifted grids
into `half_shift_native`, between any other grids into `math.grid_sample` at
the target's cell centres (`sample_field_at_points`, JAX's
`sample_grid_at_points`); a point
cloud onto a centred or closed-box staggered grid with ``scatter=True``
(`:32-64`, `:361-411`) into `scatter_to_grid` — K8 once per target grid in 3D
on the card — with the base from the point cloud's constant boundary (NaN for
FLIP); a grid at the points of a point cloud, a `Point` or a `Sphere`
(`:196-230`) into `sample_grid_at_points` / `sample_staggered_at_points`.
A mesh Field at points goes to `field/_mesh_math.py::sample_mesh_field`
(`:107-109`); constants and callables at a mesh give values at its cells.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..geom import UniformGrid
from ..geom._geom import Geometry, Point, flat_points
from ..geom._grid import UniformGrid_native
from ..geom._mesh import Mesh
from ..math import Tensor, channel, dual, expand, extrapolation, stack, to_float, wrap
from ..math._shape import concat_shapes
from ..math._extrapolation import ConstantExtrapolation
from ..math._nd import Extrapolation, pad
from ..ops.p2g import p2g_mean
from ._field import Field, FieldInitializer, as_boundary, face_components, face_values
from ._field_math import (_batch_dims, _batch_native, _dx_tuple, _grid_values, _layout, _native_extrap,
                          _plain_values)
from ._grid import expand_staggered

__all__ = ['sample_grid_at_centers', 'half_shift_native', 'scatter_to_grid', 'sample_grid_at_points', 'sample_staggered_at_points',
           'face_grid', 'cell_grid', 'staggered_cells', 'geometry_mask', 'resample', 'sample', 'reduce_sample',
           'grid_scatter', 'sample_field_at_points']


def sample_grid_at_centers(values: torch.Tensor, own_axis: Optional[int], target_axis: Optional[int],
                           extrap: Extrapolation, periodic: bool, ndim: Optional[int] = None) -> torch.Tensor:
    """`values`, staggered along `own_axis` (None: centred), at the sample
    points of a grid staggered along `target_axis`. `extrap` is the source's
    extrapolation; `periodic` says which layout the staggered grids have.
    `ndim`: the grid's axes, the trailing ones (default all; leading axes are
    a batch).

    Per shifted axis, (lower, upper) padding then the 2-point average:
    faces → centres (1, 1) in the closed box, (0, 1) periodic;
    centres → faces (0, 0) in the closed box, (1, 0) periodic."""
    pads = []
    for axis in range(values.ndim if ndim is None else ndim):
        from_faces, to_faces = own_axis == axis, target_axis == axis
        if from_faces == to_faces:
            pads.append(None)
        elif from_faces:
            pads.append((0, 1) if periodic else (1, 1))
        else:
            pads.append((1, 0) if periodic else (0, 0))
    return half_shift_native(values, pads, extrap)


def half_shift_native(values: torch.Tensor, pads: Sequence[Optional[Tuple[int, int]]],
                      extrap: Extrapolation) -> torch.Tensor:
    """`values` at sample points half a cell away along each axis whose entry
    of `pads` is a (lower, upper) padding: pad with `extrap`, then average
    neighbours. Axes with None stay. `pads` has one entry per grid axis, the
    trailing axes of `values`; leading axes are a batch."""
    v = values
    for d, p in enumerate(pads):
        if p is None:
            continue
        axis = d - len(pads)
        padded = pad(v, axis, p[0], p[1], extrap)
        size = padded.shape[axis]
        v = (padded.narrow(axis, 0, size - 1) + padded.narrow(axis, 1, size - 1)) * 0.5
    return v


# ---------------------------------------------------------------------------
# geometry → grid
# ---------------------------------------------------------------------------

def cell_grid(resolution: Sequence[int], dx, device=None) -> UniformGrid_native:
    """The cells of a domain of `resolution` cells of size `dx` from the
    origin, on `device` (None: the card)."""
    f32 = np.float32
    h = _per_axis(dx, len(resolution))
    return UniformGrid_native(resolution, [f32(0.0)] * len(h), [f32(n) * f32(x) for n, x in zip(resolution, h)], device)


def staggered_cells(cells: UniformGrid_native, periodic: bool) -> Tuple[UniformGrid_native, ...]:
    """Per axis the grid of the faces a staggered field stores: the interior
    faces in the closed box, faces 0..N−1 in the periodic box."""
    return tuple(cells.stagger(axis, periodic, False) for axis in range(cells.spatial_rank))


def geometry_mask(geometry: Geometry, target: Union[UniformGrid_native, Sequence[UniformGrid_native]], soft: bool = False,
                  balance: float = 0.5) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """`geometry` sampled on the cells of `target` as float32: 1 where the
    cell's centre lies inside, or with ``soft`` the cell's fraction inside
    (`balance`: of a cell whose centre lies on the surface). A sequence of
    grids — the face grids of `staggered_cells` — gives one mask each."""
    if not isinstance(target, UniformGrid_native):
        return tuple(geometry_mask(geometry, g, soft, balance) for g in target)
    if soft:
        mask = geometry.approximate_fraction_inside(target, balance)
    else:
        mask = geometry.lies_inside(target.center).to(torch.float32)
    return mask.expand(target.resolution)


# ---------------------------------------------------------------------------
# particles ⇄ grid
# ---------------------------------------------------------------------------

def face_grid(resolution: Sequence[int], dx: Sequence[float], axis: Optional[int]):
    """(resolution, lower corner, upper corner) of the sample-point grid
    staggered along `axis` in the closed box (None: the cell grid itself), in
    float32 as the JAX package's `UniformGrid.stagger` computes it."""
    f32 = np.float32
    res = [int(r) for r in resolution]
    lower = [f32(0.0)] * len(res)
    upper = [f32(r) * f32(h) for r, h in zip(res, dx)]
    if axis is not None:
        lower[axis] = lower[axis] + f32(dx[axis]) * f32(0.5)
        upper[axis] = upper[axis] + f32(dx[axis]) * f32(-0.5)
        res[axis] -= 1
    return tuple(res), tuple(lower), tuple(upper)


def _per_axis(dx, ndim: int) -> Tuple[float, ...]:
    return tuple(float(x) for x in dx) if isinstance(dx, (tuple, list)) else (float(dx),) * ndim


def scatter_to_grid(positions: torch.Tensor, values: torch.Tensor, resolution: Sequence[int], dx,
                    outside_handling: str = 'discard',
                    base: float = 0.0) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Mean of the particles' values per nearest sample point of a closed-box
    grid of `resolution` cells of size `dx`; sample points without a particle
    get `base` (the particle field's extrapolation: NaN for a FLIP velocity).

    values (N,): a centred grid. values (N, d): a staggered grid, component a
    of the values onto the faces of axis a — one scatter per face grid, each
    with its own lower corner and resolution. `outside_handling`: 'discard'
    drops particles outside the target grid, 'clamp' keeps them at its border.
    3D CUDA tensors go through K8, one launch per target grid."""
    if outside_handling not in ('discard', 'clamp'):
        raise ValueError(f"outside_handling {outside_handling!r}: 'discard' or 'clamp' expected")
    d = len(resolution)
    h = _per_axis(dx, d)
    clamp = outside_handling == 'clamp'

    def scatter(vals, axis):
        res, lower, _ = face_grid(resolution, h, axis)
        inv_dx = tuple(1.0 / float(np.float32(x)) for x in h)
        return p2g_mean(positions, vals, res, tuple(float(x) for x in lower), inv_dx, clamp, base)

    if values.ndim == 1:
        return scatter(values, None)
    if values.ndim != 2 or values.shape[1] != d:
        raise ValueError(f"values of shape {tuple(values.shape)}: (N,) or (N, {d}) expected")
    return tuple(scatter(values[:, a].contiguous(), a) for a in range(d))


def sample_grid_at_points(values: torch.Tensor, points: torch.Tensor, lower: Sequence[float],
                          upper: Sequence[float], extrap: Extrapolation = 0.0) -> torch.Tensor:
    """Multilinear interpolation of a grid at `points` (N, d). The grid's
    sample points are the centres of values.shape cells dividing the box
    [lower, upper]; beyond them the grid continues with the constant `extrap`.
    Leading axes of `values` beyond the d of `lower` are a batch: the result
    is (*batch, N).

    A corner of weight 0 is left out of the sum instead of multiplied, so a
    NaN there (the unset cells of a FLIP grid) does not reach the result — the
    behaviour of the JAX package's lookup for particle sets."""
    if not isinstance(extrap, (int, float)):
        raise NotImplementedError(f"extrapolation {extrap!r}: only a constant is ported for lookups at points")
    d = len(lower)
    lead = tuple(values.shape[:-d])
    padded = torch.nn.functional.pad(values, (1, 1) * d, value=float(extrap))
    sizes = padded.shape[-d:]
    flat = padded.reshape(lead + (-1,))
    strides = [int(np.prod(sizes[a + 1:])) for a in range(d)]
    base = None     # flat index of each point's lower corner in the padded array
    weights = []    # per axis (weight of the lower corner, of the upper corner)
    for a in range(d):
        box = float(np.float32(upper[a]) - np.float32(lower[a]))
        local = (points[:, a] - float(np.float32(lower[a]))) / box
        coord = local * float(values.shape[a - d]) - 0.5
        pos = torch.clamp(coord + 1.0, 0.0, sizes[a] - 1.0)  # index in the padded array
        i = torch.clamp(torch.floor(pos), 0, sizes[a] - 2)
        frac = pos - i
        weights.append((1.0 - frac, frac))
        term = i.to(torch.int64) * strides[a]
        base = term if base is None else base + term
    result = None
    for corner in itertools.product((0, 1), repeat=d):
        w = weights[0][corner[0]]
        for a in range(1, d):
            w = w * weights[a][corner[a]]
        v = flat[..., base + sum(c * st for c, st in zip(corner, strides))]
        term = torch.where(w > 0, v * w, 0.0)
        result = term if result is None else result + term
    return result


def sample_staggered_at_points(velocity: Sequence[torch.Tensor], points: torch.Tensor, dx,
                               extrap: Extrapolation = 0.0) -> torch.Tensor:
    """The full vector (N, d) of a closed-box staggered grid at `points`: each
    face component interpolated on its own face grid."""
    d = len(velocity)
    h = _per_axis(dx, d)
    # component a holds the N−1 interior faces of axis a (its grid axes are the trailing d)
    resolution = [velocity[a].shape[a - d] + 1 for a in range(d)]
    comps = []
    for a in range(d):
        _, lower, upper = face_grid(resolution, h, a)
        comps.append(sample_grid_at_points(velocity[a], points, lower, upper, extrap))
    return torch.stack(comps, dim=-1)


# ---------------------------------------------------------------------------
# the Field layer: `resample` and `sample` (port of `:13`, `:75`)
# ---------------------------------------------------------------------------

def resample(value, to=None, keep_boundary=False, soft=False, scatter=False,
             outside_handling='discard', balance=0.5, **kwargs):
    """`value` (a Field, geometry, number or Tensor) sampled at the sample
    points of the Field `to`: a Field on `to`'s geometry. A Field keeps
    `to`'s boundary unless ``keep_boundary``."""
    if to is None and 'at' in kwargs:
        to = kwargs.pop('at')
    assert isinstance(to, Field), f"'to' must be a Field but got {type(to)}"
    if isinstance(value, Geometry):
        return to.with_values(sample(value, to.geometry, at=to.sampled_at, boundary=to.boundary, soft=soft,
                                     balance=balance))
    if isinstance(value, (int, float, bool)) or (isinstance(value, Tensor) and not value.shape.spatial
                                                  and not value.shape.instance):
        return to.with_values(value if isinstance(value, Tensor) else wrap(value))
    if isinstance(value, Field) and value.is_point_cloud and not value.is_mesh and not to.is_point_cloud:
        return to.with_values(_scatter_points(value, to, scatter, outside_handling))
    if isinstance(value, Field):
        extrap = value.boundary if keep_boundary else to.boundary
        values = sample(value, to.geometry, at=to.sampled_at, boundary=extrap,
                        dot_face_normal=to.geometry if to.is_staggered else None, **kwargs)
        return Field(to.geometry, values, extrap)
    if isinstance(value, Tensor):
        return to.with_values(value)
    raise NotImplementedError(f"resampling a {type(value).__name__} comes with a later slice of the port")


def sample(value, geometry, at: str = 'center', boundary=None, dot_face_normal=None, soft=False, balance=0.5,
           **kwargs):
    """`value` sampled at the points of a grid (`geometry`: a UniformGrid or a
    grid Field), at its cell centres or (``at='face'``) its faces: a Tensor.
    Grid → grid between half-cell-shifted grids of one cell size (pad and
    average), geometry → grid as a hard or ``soft`` mask, constants expanded,
    a `FieldInitializer` by its `_sample`, a callable on the sample points."""
    if isinstance(geometry, Field):
        at = geometry.sampled_at
        geometry = geometry.geometry
    if isinstance(geometry, Tensor):
        geometry = Point(geometry)
    if isinstance(value, Field) and value.is_mesh:
        from ._mesh_math import sample_mesh_field
        return sample_mesh_field(value, geometry, at, boundary, dot_face_normal)
    if isinstance(geometry, Mesh):
        return _sample_at_mesh(value, geometry)
    if not isinstance(geometry, UniformGrid):
        if isinstance(value, Field) and value.is_grid and isinstance(geometry.center, Tensor):
            return _sample_grid_at_points_field(value, geometry.center)
        raise NotImplementedError(f"sampling a {type(value).__name__} at a {type(geometry).__name__} comes with a "
                                  f"later slice of the port")
    boundary = as_boundary(boundary, geometry) if boundary is not None else None
    if isinstance(value, Geometry):
        if at == 'face':
            return _sample_at_faces(lambda g: _geometry_mask(value, g, soft, balance), geometry, boundary)
        return _geometry_mask(value, geometry, soft, balance)
    if isinstance(value, FieldInitializer):
        if at == 'face' and dot_face_normal is not None:
            return _sample_at_faces(lambda g: value._sample(g, 'center', boundary, **kwargs), geometry, boundary)
        return value._sample(geometry, at, boundary, **kwargs)
    if callable(value) and not isinstance(value, Field):
        if at == 'face':
            return _sample_at_faces(lambda g: _sample_function(value, g), geometry, boundary)
        return _sample_function(value, geometry)
    if isinstance(value, (int, float, bool)):
        value = wrap(value)
    if isinstance(value, (tuple, list)):
        value = wrap(list(value), channel(vector=geometry.shape.get_labels('vector')))
    if isinstance(value, Tensor):
        if at == 'face' and dot_face_normal is not None:
            return expand_staggered(value, geometry.resolution, boundary or extrapolation.ZERO)
        return expand(value, geometry.resolution.without(value.shape.names))
    if isinstance(value, Field) and value.is_grid:
        return _sample_grid_field(value, geometry, at, boundary, dot_face_normal, **kwargs)
    raise NotImplementedError(f"sampling a {type(value).__name__} comes with a later slice of the port")


def _sample_at_mesh(value, mesh: Mesh) -> Tensor:
    """A constant, Tensor or callable of the points at a mesh's cell centres:
    a callable of one parameter takes the centres, of more one component
    each (`phiflow_tpu/geom/_geom.py::sample_function`)."""
    if callable(value) and not isinstance(value, (Field, Tensor)):
        import inspect
        points = mesh.center
        try:
            n_params = len(inspect.signature(value).parameters)
        except (TypeError, ValueError):
            n_params = 1
        value = value(points) if n_params == 1 else value(*[points.vector[i] for i in range(mesh.spatial_rank)])
    if isinstance(value, (int, float, bool)):
        value = wrap(value)
    if isinstance(value, (tuple, list)):
        value = wrap(list(value), channel(vector=mesh.shape.get_labels('vector')))
    if isinstance(value, Tensor):
        return expand(value, mesh.shape.non_channel.without(value.shape.names))
    raise NotImplementedError(f"sampling a {type(value).__name__} at a mesh comes with a later slice of the port")


def _sample_function(f, grid) -> Tensor:
    """`f` of the grid's cell centres (a host Tensor with a `vector` dim),
    or of their components when it takes one argument per axis: the values
    on the host, as the JAX package computes them there."""
    import inspect
    points = grid.center
    try:
        n_params = len(inspect.signature(f).parameters)
    except (TypeError, ValueError):
        n_params = 1
    result = f(points) if n_params == 1 else f(*[points.vector[i] for i in range(points.shape.get_size('vector'))])
    return result if isinstance(result, Tensor) else wrap(result)


def _geometry_mask(geom: Geometry, target, soft: bool, balance):
    """`geometry_mask` on the target's cells, in the current precision."""
    return to_float(Tensor(geometry_mask(geom, target.native(), soft, balance), target.resolution))


def _sample_at_faces(f_on_grid, geometry, boundary):
    """`f_on_grid(face_grid)` for the face grid of each axis, stacked over `~vector`."""
    boundary = boundary or extrapolation.ZERO
    names = geometry.resolution.names
    comps = []
    for dim in names:
        values = f_on_grid(geometry.stagger(dim, *boundary.valid_outer_faces(dim)))
        if 'vector' in values.shape and values.shape.get_labels('vector'):
            values = values[{'vector': dim}]
        comps.append(values)
    return stack(comps, dual(vector=names))


def _sample_grid_field(value, geometry, at: str, boundary, dot_face_normal, order: int = 2, implicit=None,
                       **_ignored):
    boundary = boundary if boundary is not None else value.boundary
    if order != 2:
        raise NotImplementedError("higher-order resampling comes with a later slice of the port")
    if at == 'face':
        names = list(geometry.resolution.names)
        comps = []
        for dim in names:
            face_grid = geometry.stagger(dim, *boundary.valid_outer_faces(dim))
            comp_value = value.vector[dim] if dot_face_normal is not None and 'vector' in value.shape else value
            comps.append(_resample_grid_at_centers(comp_value, face_grid))
        return stack(comps, dual(vector=names))
    if value.is_centered and value.geometry == geometry:
        return value.values
    if value.is_staggered:
        names = value.resolution.names
        return stack({d: _resample_grid_at_centers(value.vector[d], geometry) for d in names}, channel('vector'))
    return _resample_grid_at_centers(value, geometry)


def _resample_grid_at_centers(value, target_grid):
    """A centred (or single-component) grid Field at the cell centres of
    `target_grid`, which is shifted by half a cell against it along some axes
    (the order-2 branch of `_shift_resample`, `:310-347`): `half_shift_native`
    per channel entry."""
    if value.is_staggered:
        return stack({d: _resample_grid_at_centers(value.vector[d], target_grid) for d in value.resolution.names},
                     channel('vector'))
    plan = _half_shift_alignment(value, target_grid)
    if plan is None:  # the JAX package's general route: `math.grid_sample` at the target's cell centres
        return sample_field_at_points(value, target_grid.center)
    names = value.resolution.names
    pads = [plan[d] for d in names]
    extrap = _native_extrap(value.boundary, names)
    return _grid_values(value.values, names, lambda v: half_shift_native(v, pads, extrap))


def sample_field_at_points(value, points: Tensor) -> Tensor:
    """A grid Field (one staggered component, or a centred grid) at world
    points by `math.grid_sample` (the JAX package's `sample_grid_at_points`,
    `:251-262`): the points in the grid's fractional indices, beyond it the
    Field's boundary; a staggered grid gives one `vector` entry a component."""
    from ..math import grid_sample
    if value.is_staggered:
        return stack({d: sample_field_at_points(value.vector[d], points) for d in value.resolution.names},
                     channel('vector'))
    resolution = value.values.shape.spatial
    bounds = value.bounds
    local = (points - bounds.lower) / bounds.size
    coords = local * wrap([float(s) for s in resolution.sizes], channel(vector=resolution.names)) - 0.5
    return grid_sample(value.values, coords, value.boundary)


def reduce_sample(value, points, dim=None) -> Tensor:
    """A Field at `points`; a staggered grid at points that carry its
    `~vector` dim samples each component at its own points."""
    if isinstance(points, Geometry):
        points = points.center
    if not isinstance(value, Field):
        raise ValueError(type(value))
    if value.is_staggered and isinstance(points, Tensor) and points.shape.dual:
        names = value.resolution.names
        return stack([sample_field_at_points(value.vector[d], points[{'~vector': d}]) for d in names],
                     dual(vector=names))
    return sample(value, Point(points) if isinstance(points, Tensor) else points)


def grid_scatter(data: Field, bounds, resolution, outside_handling: str = 'discard', mode='mean') -> Tensor:
    """The values of the point cloud `data` scattered (`math.scatter`, `mode`)
    into the cells of a grid of `resolution` over `bounds` that hold its points."""
    from ..math import _ops as ops
    grid = UniformGrid(resolution, bounds)
    index = ops.to_int32(ops.floor((data.points - grid.bounds.lower) / grid.dx))
    if outside_handling == 'clamp':
        upper = wrap([s - 1 for s in grid.resolution.sizes], channel(vector=grid.resolution.names))
        index = ops.minimum(ops.maximum(index, 0), upper)
    return ops.scatter(ops.zeros(grid.resolution), index, data.values, mode=mode, outside_handling=outside_handling)


def _half_shift_alignment(value, target_grid):
    """Per dim (lower pad, upper pad) that turns `value` into `target_grid`'s
    samples by padding and averaging neighbours (None: aligned dim), or None
    when the grids differ by more than half a cell."""
    source = value.geometry
    if not isinstance(source, UniformGrid):
        return None
    s_res, t_res = source.resolution, target_grid.resolution
    if set(s_res.names) != set(t_res.names):
        return None
    s_dx = np.asarray(source.dx.numpy(source.dx.shape.names))
    t_dx = np.asarray(target_grid.dx.numpy(source.dx.shape.names))
    if s_dx.shape != t_dx.shape or not np.allclose(s_dx, t_dx, rtol=1e-5):
        return None
    offset = (target_grid.bounds.lower.numpy() - source.bounds.lower.numpy()) / s_dx
    plan = {}
    for i, dim in enumerate(s_res.names):
        diff = t_res.get_size(dim) - s_res.get_size(dim)
        off = offset[i]
        if abs(off) < 1e-6 and diff == 0:
            plan[dim] = None
        elif abs(abs(off) - 0.5) < 1e-6 and diff in (-1, 0, 1):
            lp = 1 if off < 0 else 0
            up = diff + 1 - lp
            if up < 0 or up > 1:
                return None
            plan[dim] = (lp, up)
        else:
            return None
    return plan


# ---------------------------------------------------------------------------
# the Field layer: particles ⇄ grids
# ---------------------------------------------------------------------------

def _origin_grid(field, what: str):
    """NotImplementedError unless `field` is a grid whose lower corner is the
    origin — the frame of the array layer's particle transfers."""
    if not field.is_grid or np.any(field.bounds.lower.numpy() != 0):
        raise NotImplementedError(f"{what}: grids whose lower corner is the origin are ported")


def _one_constant(field):
    """The one constant of a grid Field's boundary, over all components of a
    staggered one: the value the array layer's lookups continue with."""
    names = field.resolution.names
    forms = {_native_extrap(field.boundary[{'vector': d}], names) for d in names} if field.is_staggered \
        else {_native_extrap(field.boundary, names)}
    if len(forms) != 1 or not isinstance(next(iter(forms)), float):
        raise NotImplementedError(f"boundary {field.boundary!r}: lookups at points continue a grid with one "
                                  f"constant; other boundaries come with a later slice of the port")
    return forms.pop()


def _closed_staggered(velocity):
    """NotImplementedError unless `velocity` is a closed-box staggered grid from the origin with walls at rest."""
    _origin_grid(velocity, 'particles in a staggered grid')
    if not velocity.is_staggered or _layout(velocity) != 'closed' or _one_constant(velocity) != 0:
        raise NotImplementedError(f"particles in a grid of boundary {velocity.boundary!r}: the closed box's "
                                  f"staggered grid with walls at rest is ported")


def staggered_point_arrays(velocity):
    """(face components, cell size per axis) of a closed-box staggered grid
    from the origin with a zero boundary — what `sample_staggered_at_points`
    and `finite_rk4_native` take; NotImplementedError for any other grid."""
    _closed_staggered(velocity)
    names = velocity.resolution.names
    comps = face_components(velocity.values)
    if not all(_plain_values(c, names) for c in comps):
        raise NotImplementedError(f"values {velocity.values.shape}: grid dims only are ported")
    return [c.torch(names) for c in comps], _dx_tuple(velocity)


def _sample_grid_at_points_field(value, points: Tensor) -> Tensor:
    """The grid Field `value` at `points` (a `vector` dim, any other dims):
    multilinear, continued beyond the grid by its boundary constant. A
    staggered grid gives a `vector` per point. Batch dims of the values
    (not of the points) lead the result, from one lookup."""
    names = value.resolution.names
    if points.shape.get_labels('vector') not in (None, names):
        raise NotImplementedError(f"points with vector {points.shape.get_labels('vector')} in a grid of {names}")
    _origin_grid(value, 'lookups at points')
    flat, _ = flat_points(points)
    lead = points.shape.without('vector')
    tensors = face_components(value.values) if value.is_staggered else [value.values]
    batch = _batch_dims(tensors, names, 'lookups at points')
    if set(batch.names) & set(lead.names):
        raise NotImplementedError(f"values {value.values.shape} at points {points.shape}: the points of one batch "
                                  f"entry each come with a later slice of the port")
    arrays = [_batch_native(t, batch, names) for t in tensors]
    if value.is_staggered:
        _closed_staggered(value)
        out = sample_staggered_at_points(arrays, flat.to(arrays[0].device), _dx_tuple(value))
        return Tensor(out.reshape(batch.sizes + lead.sizes + (len(names),)),
                      concat_shapes(batch, lead, channel(vector=names)))
    out = sample_grid_at_points(arrays[0].to(flat.device), flat, value.bounds.lower.numpy(), value.bounds.upper.numpy(),
                                _one_constant(value))
    return Tensor(out.reshape(batch.sizes + lead.sizes), concat_shapes(batch, lead))


def _point_values(value, n: int, device, vector: bool):
    """The point cloud's values as a torch array (n, d) with `vector`, else
    (n,): one per point, or the one value expanded, contiguous. A host number
    fills its array on the device (no host→device copy)."""
    vals = value.values
    points = value.geometry.center
    inst = points.shape.without('vector').names
    if vals.is_host and vals.rank == 0:
        dtype = torch.float64 if vals.dtype == np.float64 else torch.float32
        return torch.full((n, points.shape.get_size('vector')) if vector else (n,), float(vals), dtype=dtype,
                          device=device)
    if vector and 'vector' in vals.shape:
        if vals.shape.get_labels('vector') not in (None, points.shape.get_labels('vector')):
            raise NotImplementedError(f"values with vector {vals.shape.get_labels('vector')} at points of "
                                      f"{points.shape.get_labels('vector')}")
        arr = vals.torch(inst + ('vector',), device=device).reshape(-1, vals.shape.get_size('vector'))
        return arr.expand(n, arr.shape[1]).contiguous()
    if set(vals.shape.names) - set(inst):
        raise NotImplementedError(f"values {vals.shape} scattered onto a centred grid: one value a point is ported")
    return vals.torch(inst, device=device).reshape(-1).expand(n).contiguous()


def _scatter_points(value, to, scatter: bool, outside_handling: str):
    """The point cloud `value` onto the grid `to` (`scatter_to_grid`): the
    mean of the points' values per nearest sample point, the cloud's
    boundary constant (NaN, 0) where no point lies. A staggered target takes
    component a of a vector value onto the faces of axis a."""
    if not scatter:
        raise NotImplementedError("resample of points onto a grid without scatter (the overlap of the points' "
                                  "geometry with the cells) comes with a later slice of the port")
    _origin_grid(to, 'points onto a grid')
    names = to.resolution.names
    if value.geometry.center.shape.get_labels('vector') not in (None, names):
        raise NotImplementedError(f"points of {value.geometry.center.shape.get_labels('vector')} onto a grid of {names}")
    flat, _ = flat_points(value.geometry.center)
    base = float(value.boundary.value) if isinstance(value.boundary, ConstantExtrapolation) else 0.0
    res = tuple(to.resolution.sizes)
    if to.is_staggered:
        if _layout(to) != 'closed':
            raise NotImplementedError(f"points onto a staggered grid of boundary {to.boundary!r}: the closed "
                                      f"box is ported")
        vals = _point_values(value, flat.shape[0], flat.device, vector=True)
        if vals.ndim == 1:  # one scalar a point onto every face grid
            vals = vals[:, None].expand(-1, len(names))
        comps = scatter_to_grid(flat, vals, res, _dx_tuple(to), outside_handling, base)
        return face_values([Tensor(c, t.shape.only(names, reorder=True))
                            for c, t in zip(comps, face_components(to.values))], to.values)
    vals = _point_values(value, flat.shape[0], flat.device, vector=False)
    return Tensor(scatter_to_grid(flat, vals, res, _dx_tuple(to), outside_handling, base), to.resolution)

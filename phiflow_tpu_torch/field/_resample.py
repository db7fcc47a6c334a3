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
component d. Its faces follow a face layout (`_field_math.face_layout`): in
the closed box component d holds the interior faces 1..N−1 along axis d
(N−1 entries, the walls are the extrapolation); in the periodic box faces
0..N−1 (N entries); an open side stores its outer face too (N + 1 entries
with both).

`scatter_to_grid` ports `scatter_to_grid` / `_scatter_to_centered` with
``scatter=True`` (`:361-411`) for the closed box: the mean of the particles'
values per nearest sample point, through K8 (`ops/p2g.py`) once per target
grid. The face grid of component d is the cell grid shifted by half a cell
along d, one entry shorter there. `sample_grid_at_points` ports the function
of that name (`:251-262`): multilinear interpolation at particle positions, a
gather written with PyTorch indexing (the JAX package has no kernel for it),
the grid continued by any rule of `math._nd` one cell deep, as JAX's
`grid_sample` pads it.

`geometry_mask` ports `_geometry_mask` (`:151-158`) and the `at='face'` route
of `sample` (`:77-80`): hard, 1 where a sample point lies inside; soft, the
fraction of the sample point's cell inside. `staggered_cells` gives the face
grids in the layouts above.

The array layer's particle functions (`scatter_to_grid`,
`sample_staggered_at_points`) take a domain whose lower corner is the
origin; the Field layer passes any grid's own corners.

The Field layer (`resample`, `sample`, `reduce_sample`, `grid_scatter`,
JAX's signatures) unwraps into these: a grid between half-cell-shifted grids
into `half_shift_native`, between any other grids into `math.grid_sample` at
the target's cell centres (`sample_field_at_points`, JAX's
`sample_grid_at_points`); a point
cloud onto a centred or a staggered grid in any face layout with
``scatter=True`` (`:32-64`, `:361-411`) into `p2g_mean` — K8 once per
target grid in 3D on the card — with the base from the point cloud's
constant boundary (NaN for FLIP); a grid at the points of a point cloud, a
`Point` or a `Sphere` (`:196-230`) into `sample_grid_at_points`, each face
component on its own face grid.
A mesh Field at points goes to `field/_mesh_math.py::sample_mesh_field`
(`:107-109`); constants and callables at a mesh give values at its cells.
Between half-shifted grids `order` 4 or 6 applies `_stencil1d.interp_matrix`
along each axis whose sides classify (JAX's `_shift_resample`, `:310`).
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
from ..math._nd import PERIODIC, Extrapolation, PerSide, pad
from ..ops.p2g import p2g_mean
from ._field import Field, FieldInitializer, as_boundary, face_components, face_values
from ._field_math import (_batch_dims, _batch_native, _dx_tuple, _face_layout, _grid_values, _native_extrap,
                          _plain_values, face_layout, stored_faces)
from ._grid import expand_staggered

__all__ = ['sample_grid_at_centers', 'half_shift_native', 'scatter_to_grid', 'sample_grid_at_points', 'sample_staggered_at_points',
           'face_grid', 'cell_grid', 'staggered_cells', 'geometry_mask', 'resample', 'sample', 'reduce_sample',
           'grid_scatter', 'sample_field_at_points']


def sample_grid_at_centers(values: torch.Tensor, own_axis: Optional[int], target_axis: Optional[int],
                           extrap: Extrapolation, faces, ndim: Optional[int] = None, target_faces=None) -> torch.Tensor:
    """`values`, staggered along `own_axis` (None: centred), at the sample
    points of a grid staggered along `target_axis`. `extrap` is the source's
    extrapolation; `faces` is the face layout of the source (`face_layout`;
    True / False: the periodic / closed box), `target_faces` the target's
    where it differs. `ndim`: the grid's axes, the trailing ones (default
    all; leading axes are a batch).

    Per shifted axis, (lower, upper) padding then the 2-point average: faces
    → centres pad the outer faces the source does not store (closed box (1,
    1), open box (0, 0), periodic (0, 1)), centres → faces the outer faces
    the target stores (closed (0, 0), open (1, 1), periodic (1, 0)). Faces
    → faces of one axis in two layouts pad or cut the outer faces (the JAX
    package looks these up by `grid_sample`, `:234-248`: the same values)."""
    nd = values.ndim if ndim is None else ndim
    source = _face_layout_of(faces, nd)
    target = source if target_faces is None else _face_layout_of(target_faces, nd)
    pads = []
    for axis in range(nd):
        from_faces, to_faces = own_axis == axis, target_axis == axis
        if from_faces and to_faces:
            values = _relayout(values, axis - nd, stored_faces(source[axis]), stored_faces(target[axis]), extrap)
            pads.append(None)
        elif from_faces:
            lo, up = stored_faces(source[axis])
            pads.append((int(not lo), int(not up)))
        elif to_faces:
            lo, up = stored_faces(target[axis])
            pads.append((int(lo), int(up)))
        else:
            pads.append(None)
    return half_shift_native(values, pads, extrap)


def _face_layout_of(faces, ndim: int) -> tuple:
    return face_layout(faces, ndim) if isinstance(faces, bool) else tuple(faces)


def _relayout(values: torch.Tensor, axis: int, source: Tuple[bool, bool], target: Tuple[bool, bool],
              extrap: Extrapolation) -> torch.Tensor:
    """The faces of one axis stored as `source` says ((lower, upper) outer
    faces), as `target` stores them: outer faces cut, or padded by `extrap`."""
    lower, upper = int(target[0]) - int(source[0]), int(target[1]) - int(source[1])
    if lower < 0 or upper < 0:
        start = max(-lower, 0)
        values = values.narrow(axis, start, values.shape[axis] - start - max(-upper, 0))
    return pad(values, axis, max(lower, 0), max(upper, 0), extrap)


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
    [lower, upper]; beyond them the grid continues by `extrap`, any rule of
    `math._nd` (a constant, BOUNDARY, a mirror, PerSide), one cell deep as
    the JAX package's `grid_sample` pads it; along a PERIODIC axis the
    points wrap. Leading axes of `values` beyond the d of `lower` are a
    batch: the result is (*batch, N); `points` (*batch, N, d) gives each
    entry its own points.

    A corner of weight 0 is left out of the sum instead of multiplied, so a
    NaN there (the unset cells of a FLIP grid) does not reach the result — the
    behaviour of the JAX package's lookup for particle sets."""
    d = len(lower)
    lead = tuple(values.shape[:-d])
    if points.ndim > 2 and tuple(points.shape[:-2]) != lead:
        raise ValueError(f"points {tuple(points.shape)} for values {tuple(values.shape)}: (N, {d}) or the values' "
                         f"leading axes before (N, {d}) expected")
    padded = values
    for a in range(d):
        rule = extrap[a - d] if isinstance(extrap, PerSide) else (extrap, extrap)
        padded = pad(padded, a - d, 0 if _periodic(rule[0]) else 1, 1, extrap)
    sizes = padded.shape[-d:]
    flat = padded.reshape(lead + (-1,))
    strides = [int(np.prod(sizes[a + 1:])) for a in range(d)]
    base = None     # flat index of each point's lower corner in the padded array
    weights = []    # per axis (weight of the lower corner, of the upper corner)
    for a in range(d):
        n = values.shape[a - d]
        box = float(np.float32(upper[a]) - np.float32(lower[a]))
        local = (points[..., a] - float(np.float32(lower[a]))) / box
        coord = local * float(n) - 0.5
        rule = extrap[a - d] if isinstance(extrap, PerSide) else (extrap, extrap)
        if _periodic(rule[0]):
            pos = torch.remainder(coord, float(n))   # index in the array padded by one wrapped cell above
        else:
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
        idx = base + sum(c * st for c, st in zip(corner, strides))
        v = torch.gather(flat, -1, idx) if points.ndim > 2 else flat[..., idx]
        term = torch.where(w > 0, v * w, 0.0)
        result = term if result is None else result + term
    return result


def _periodic(rule) -> bool:
    return isinstance(rule, str) and rule == PERIODIC


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
        if isinstance(value, Field) and value.is_point_cloud and at != 'face':
            return _sample_points_at_points(value, geometry)
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


def _sample_points_at_points(value: Field, target) -> Tensor:
    """A point cloud's values at the points of another geometry (JAX:
    `_sample_points_at_points`): as they are where both hold as many points
    (the instance dim renamed to the target's), else the value of the nearest
    source point."""
    from ..math import find_closest, gather, rename_dims
    src_pts, tgt_pts = value.geometry.center, target.center
    src_inst = src_pts.shape.instance
    if src_inst and tgt_pts.shape.instance and src_inst.volume == tgt_pts.shape.instance.volume:
        return rename_dims(value.values, src_inst, tgt_pts.shape.instance) \
            if src_inst.names != tgt_pts.shape.instance.names else value.values
    return gather(value.values, find_closest(src_pts, tgt_pts), dims=src_inst)


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
    if at == 'face':
        names = list(geometry.resolution.names)
        comps = []
        for dim in names:
            face_grid = geometry.stagger(dim, *boundary.valid_outer_faces(dim))
            comp_value = value.vector[dim] if dot_face_normal is not None and 'vector' in value.shape else value
            comps.append(_resample_grid_at_centers(comp_value, face_grid, order))
        return stack(comps, dual(vector=names))
    if value.is_centered and value.geometry == geometry:
        return value.values
    if value.is_staggered:
        names = value.resolution.names
        return stack({d: _resample_grid_at_centers(value.vector[d], geometry, order) for d in names},
                     channel('vector'))
    return _resample_grid_at_centers(value, geometry, order)


def _resample_grid_at_centers(value, target_grid, order: int = 2):
    """A centred (or single-component) grid Field at the cell centres of
    `target_grid`, which is shifted by half a cell against it along some axes
    (`_shift_resample`, `:310-347`): per channel entry, along each shifted
    axis the `interp_matrix` of `order` > 2 where both sides of the boundary
    classify (`_stencil1d.classify_side`), else the pad and 2-point average
    of `half_shift_native`. Grids not half a cell apart go through
    `math.grid_sample` at the target's centres, at order 2 whatever `order`
    (the JAX package's route)."""
    if value.is_staggered:
        return stack({d: _resample_grid_at_centers(value.vector[d], target_grid, order)
                      for d in value.resolution.names}, channel('vector'))
    plan = _half_shift_alignment(value, target_grid)
    if plan is None:  # the JAX package's general route: `math.grid_sample` at the target's cell centres
        return sample_field_at_points(value, target_grid.center)
    names = value.resolution.names
    extrap = _native_extrap(value.boundary, names)
    if order <= 2:
        pads = [plan[d] for d in names]
        return _grid_values(value.values, names, lambda v: half_shift_native(v, pads, extrap))
    from ._stencil1d import apply_axis_matrix, classify_side, interp_matrix

    def shift(v):
        for axis, dim in enumerate(names):
            if plan[dim] is None:
                continue
            lp, up = plan[dim]
            lo, hi = classify_side(value.boundary, dim, False), classify_side(value.boundary, dim, True)
            if lo is not None and hi is not None and ('periodic' not in (lo, hi) or lo == hi):
                n = v.shape[axis - len(names)]
                M, affine = interp_matrix(n, order, -0.5 if lp == 1 else 0.5, n + lp + up - 1, lo, hi,
                                          implicit_order=2 if order >= 6 else 0)
                v = apply_axis_matrix(v, v.ndim - len(names) + axis, M, affine)
            else:
                v = half_shift_native(v, [plan[dim] if d == dim else None for d in names], extrap)
        return v
    return _grid_values(value.values, names, shift)


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

def _closed_staggered(velocity) -> bool:
    """Whether `velocity` is a closed-box staggered grid from the origin with
    walls at rest and grid dims only: the grid of the array layer's particle
    functions (`sample_staggered_at_points`, `finite_rk4_native`)."""
    if not velocity.is_grid or not velocity.is_staggered or np.any(velocity.bounds.lower.numpy() != 0):
        return False
    names = velocity.resolution.names
    if _face_layout(velocity.boundary, names, walls=False) != face_layout(False, len(names)):
        return False
    forms = {_native_extrap(velocity.boundary[{'vector': d}], names) for d in names}
    return forms == {0.0} and all(_plain_values(c, names) for c in face_components(velocity.values))


def staggered_point_arrays(velocity):
    """(face components, cell size per axis) of a closed-box staggered grid
    from the origin with a zero boundary — what `sample_staggered_at_points`
    and `finite_rk4_native` take; NotImplementedError for any other grid."""
    if not _closed_staggered(velocity):
        raise NotImplementedError(f"particles in a grid of boundary {velocity.boundary!r}: the array layer takes "
                                  f"the closed box's staggered grid from the origin with walls at rest")
    names = velocity.resolution.names
    return [c.torch(names) for c in face_components(velocity.values)], _dx_tuple(velocity)


def _sample_grid_at_points_field(value, points: Tensor) -> Tensor:
    """The grid Field `value` at `points` (a `vector` dim, any other dims):
    multilinear, continued beyond the grid by its boundary (`sample_grid_at_points`
    on each component's face grid, or each entry of a centred grid's channel
    dim, with that one's extrapolation). A staggered grid gives a `vector`
    per point. The values' batch dims lead the result, from one lookup;
    points that carry some of them give each entry its own points."""
    names = value.resolution.names
    if points.shape.get_labels('vector') not in (None, names):
        raise NotImplementedError(f"points with vector {points.shape.get_labels('vector')} in a grid of {names}")
    lead = points.shape.without('vector')
    if value.is_staggered:
        comps = face_components(value.values)
        batch = _batch_dims(comps, names, 'lookups at points')
        parts = [(c, value.vector[d].bounds, _native_extrap(value.boundary[{'vector': d}], names))
                 for d, c in zip(names, comps)]
        channels = None
    else:
        others = value.values.shape.without(names)
        batch, channels = others.batch, others.without(others.batch)
        if channels.rank > 1 or (channels and not channels.channel):
            raise NotImplementedError(f"values {value.values.shape} at points: the grid dims, batch dims and one "
                                      f"channel dim at most are ported")
        entries = [{}] if not channels else [{channels.name: i} for i in range(channels.size)]
        labels = channels.get_labels(channels.name) if channels else None
        parts = [(value.values[e], value.bounds,
                  _native_extrap(value.boundary[{channels.name: labels[e[channels.name]] if labels else
                                                 e[channels.name]}] if e else value.boundary, names))
                 for e in entries]
    shared = batch.only(lead.names)
    rest = lead.without(batch.names)
    device = parts[0][0].device or points.device
    if shared:
        pts = points.torch(batch.names + rest.names + ('vector',), device)
        pts = pts.expand(tuple(batch.sizes) + tuple(pts.shape[batch.rank:])).reshape(tuple(batch.sizes) + (-1, len(names)))
    else:
        pts = points.torch(rest.names + ('vector',), device).reshape(-1, len(names))
    outs = []
    for t, bounds, extrap in parts:
        arr = _batch_native(t, batch, names)
        out = sample_grid_at_points(arr.to(pts.device), pts, bounds.lower.numpy(), bounds.upper.numpy(), extrap)
        outs.append(Tensor(out.reshape(tuple(batch.sizes) + tuple(rest.sizes)), concat_shapes(batch, rest)))
    if value.is_staggered:
        return stack(outs, channel(vector=names))
    return outs[0] if not channels else stack(outs, channels)


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
    """The point cloud `value` onto the grid `to`: the mean of the points'
    values per nearest sample point (`p2g_mean`, K8 in 3D on the card, once
    per target grid), the cloud's boundary constant (NaN, 0) where no point
    lies. A staggered target, in any face layout, takes component a of a
    vector value onto the face grid of axis a (JAX's `sampled_elements`)."""
    if not scatter:
        raise NotImplementedError("resample of points onto a grid without scatter (the overlap of the points' "
                                  "geometry with the cells) comes with a later slice of the port")
    names = to.resolution.names
    if value.geometry.center.shape.get_labels('vector') not in (None, names):
        raise NotImplementedError(f"points of {value.geometry.center.shape.get_labels('vector')} onto a grid of {names}")
    flat, _ = flat_points(value.geometry.center)
    base = float(value.boundary.value) if isinstance(value.boundary, ConstantExtrapolation) else 0.0
    clamp = outside_handling == 'clamp'
    if outside_handling not in ('discard', 'clamp'):
        raise ValueError(f"outside_handling {outside_handling!r}: 'discard' or 'clamp' expected")
    inv_dx = tuple(1.0 / float(np.float32(h)) for h in _dx_tuple(to))

    def scatter_onto(vals, grid):
        return p2g_mean(flat, vals, tuple(grid.resolution.sizes),
                        tuple(float(x) for x in grid.bounds.lower.numpy()), inv_dx, clamp, base)
    if to.is_staggered:
        vals = _point_values(value, flat.shape[0], flat.device, vector=True)
        if vals.ndim == 1:  # one scalar a point onto every face grid
            vals = vals[:, None].expand(-1, len(names))
        comps = [scatter_onto(vals[:, a].contiguous(), to.geometry.stagger(d, *to.boundary.valid_outer_faces(d)))
                 for a, d in enumerate(names)]
        return face_values([Tensor(c, t.shape.only(names, reorder=True))
                            for c, t in zip(comps, face_components(to.values))], to.values)
    vals = _point_values(value, flat.shape[0], flat.device, vector=False)
    return Tensor(scatter_onto(vals, to.geometry), to.resolution)

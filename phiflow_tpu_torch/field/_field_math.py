"""Differential operators and field arithmetic — port of
`phiflow_tpu/field/_field_math.py`, in two layers.

The array layer (`*_native`, on raw component tensors): `divergence_native`
of a staggered velocity (`:243`) and the face `spatial_gradient_native` of a
centred pressure (`:135`); `finite_fill_native` (`:476-503`), the one-cell
extension of a FLIP velocity grid into its unset (NaN) cells;
`stagger_native` (`:208-236`), a cell mask combined onto the faces;
`safe_mul_native` (`:412-431`); the order-2 `laplace_native` (`:81-106`).
The faces a component stores follow `face_layout`, per axis: periodic
(faces 0..N−1, face N ≡ face 0), or per side a wall (the outer face not
stored; it carries the wall's normal velocity, 0 at rest: the closed box,
interior faces 1..N−1) or an open side (the outer face stored, as a
zero-gradient velocity has it). Ghost cells beyond a stored face come from
the pressure's extrapolation, by side (`math._nd.PerSide`, which also takes
the ghost cells a Field embedding samples). Every array-layer function takes
leading batch axes, each entry a field of its own: the grid is the trailing
`ndim` axes of an array (`ndim` None: all of its axes), or, for a function
of one array per axis (`divergence_native`'s velocity components), as many
axes as there are arrays. A `faces` layout has one entry per grid axis.

The Field layer, with JAX's signatures: `divergence`, `spatial_gradient`,
`stagger`, `laplace`, `fourier_laplace`, `fourier_poisson`, `where`,
`is_finite`, `maximum`, `minimum`, `clip`, `safe_mul`, `finite_fill`, `mean`,
`mask`; and on the named-dim Tensors of the values, as the JAX package
computes them, `curl` (2D), the elementwise functions, `normalize`,
`center_of_mass`, `vec_length`, `vec_squared`, `discretize`, `integrate`,
`pack_dims`, `support`, `data_bounds`, `assert_close`, the losses,
`pad_field`, `downsample2x` (of staggered grids too), `upsample2x`,
`concat_fields`, `stack_fields` (`field.pad`, `field.concat` and
`field.stack`: named so here beside the array layer's `pad` and math's
`stack`) and `bake_extrapolation`. Each unwraps to the array-level
function of the same job, with one cell size per axis and the faces and
ghost cells its boundary gives (`_face_layout`, `_native_sides`: constants,
BOUNDARY, PERIODIC and the mirrors SYMMETRIC, REFLECT, ANTISYMMETRIC,
ANTIREFLECT and SYMMETRIC_GRADIENT, by side too); `stagger` and the face
gradient over a subset of the dims give those components. A case that
function does not cover (a wall of a staggered grid whose normal velocity
is no scalar constant, dims other than the grid's, batch dims and one
channel dim) raises NotImplementedError. Batch dims ride along as the array layer's leading
axes, so an operation runs once for the whole batch. The central differences of `spatial_gradient(at='center')`
(order 2, and order 4 over ghost cells on a periodic box, `:107-121`, `:66-79`
for the Laplacian) have no array-level counterpart and are computed on the
Tensors; orders 4 and 6 elsewhere go through the operator matrices of
`_higher_order.py` (the divergence of a centred grid too, `:265-276`).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..math import Tensor, TensorStack, channel, dual, instance, stack, wrap, _ops as ops
from ..math._extrapolation import (ConstantExtrapolation, _PeriodicExtrapolation, _side_of as _side_ext,
                                   _side_to_native, get_normal, map as map_extrapolation, to_native)
from ..math._nd import PERIODIC, Extrapolation, PerSide, masked_fill_native, pad, shift_zero
from ._field import Field, as_boundary, face_components, face_values

__all__ = ['face_layout', 'stored_faces', 'divergence_native', 'spatial_gradient_native', 'finite_fill_native', 'stagger_native', 'safe_mul_native',
           'laplace_native', 'divergence', 'spatial_gradient', 'stagger', 'laplace', 'fourier_laplace',
           'fourier_poisson', 'where', 'is_finite', 'maximum', 'minimum', 'clip', 'safe_mul', 'finite_fill', 'mean',
           'mask', 'native_call', 'curl', 'abs_', 'sign', 'round_', 'ceil', 'floor', 'sqrt', 'exp', 'sin', 'cos', 'real',
           'imag', 'sigmoid', 'stop_gradient', 'normalize', 'center_of_mass', 'vec_length', 'vec_abs', 'vec_squared',
           'discretize', 'integrate', 'pack_dims', 'support', 'data_bounds', 'assert_close', 'l2_loss', 'l1_loss',
           'frequency_loss', 'pad_field', 'downsample2x', 'upsample2x', 'concat_fields', 'stack_fields',
           'bake_extrapolation']


def _per_axis(dx, ndim: int) -> tuple:
    return tuple(dx) if isinstance(dx, (tuple, list)) else (dx,) * ndim


def face_layout(periodic: bool, ndim: int) -> tuple:
    """The `faces` of the periodic box or of the closed box with its walls at
    rest. A face layout gives the faces a staggered field stores, per axis:
    `'periodic'` (faces 0..N−1, face N ≡ face 0) or a (lower, upper) pair,
    each side None where the outer face is stored (an open side,
    zero-gradient velocity) or the wall's normal velocity (a number) where it
    is not."""
    return ('periodic',) * ndim if periodic else ((0.0, 0.0),) * ndim


def _faces(faces, ndim: int) -> tuple:
    """`faces`, or the closed box at rest where None."""
    return face_layout(False, ndim) if faces is None else tuple(faces)


def stored_faces(axis_faces) -> Tuple[bool, bool]:
    """(lower, upper) outer faces stored along an axis of `face_layout`."""
    if axis_faces == 'periodic':
        return True, False
    return axis_faces[0] is None, axis_faces[1] is None


def divergence_native(velocity: Sequence[torch.Tensor], dx, faces=None) -> torch.Tensor:
    """∇·v at the cell centres: Σ_d (v_d[face c+1] − v_d[face c]) / dx_d
    (`dx`: one cell size, or one per axis; `faces`: the face layout, the
    closed box at rest by default; an outer face not stored carries its
    wall's normal velocity)."""
    nd = len(velocity)
    h = _per_axis(dx, nd)
    layout = _faces(faces, nd)
    result = None
    for d, comp in enumerate(velocity):
        ax = d - nd  # the grid's axes are the trailing ones: leading batch axes ride along
        if layout[d] == 'periodic':
            term = (torch.roll(comp, -1, ax) - comp) / h[d]
        else:
            walls = [None if w is None else torch.full_like(comp.narrow(ax, 0, 1), w) for w in layout[d]]
            padded = torch.cat(([walls[0]] if walls[0] is not None else []) + [comp] +
                               ([walls[1]] if walls[1] is not None else []), dim=ax)
            n = padded.shape[ax] - 1
            term = (padded.narrow(ax, 1, n) - padded.narrow(ax, 0, n)) / h[d]
        result = term if result is None else result + term
    return result


def spatial_gradient_native(p: torch.Tensor, dx, faces=None,
                            extrap: Extrapolation = 0.0, ndim: int = None, axes: Sequence[int] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """∇p at the faces the velocity stores (`faces`, the face layout; the
    closed box of p's rank by default): (p[c] − p[c−1]) /
    dx_d for face c of axis d (`dx`: one cell size, or one per axis); beyond
    a stored outer face the ghost cell comes from `extrap`, p's extrapolation
    (0: ghost cells of 0; `BOUNDARY`: no flux; along a periodic axis of the
    faces, p's own rule gives face 0). `ndim`: the grid's axes, the trailing
    ones (default all; leading axes are a batch). `axes`: the components to
    compute, in their order (default all)."""
    nd = _grid_rank(p, ndim, faces)
    h = _per_axis(dx, nd)
    layout = _faces(faces, nd)
    comps = []
    for d in (range(nd) if axes is None else axes):
        ax = d - nd
        rule = extrap[ax] if isinstance(extrap, PerSide) else (extrap, extrap)
        if layout[d] == 'periodic' and rule == (PERIODIC, PERIODIC):
            comps.append((p - torch.roll(p, 1, ax)) / h[d])
        else:
            lo, up = stored_faces(layout[d])
            q = pad(p, ax, int(lo), int(up), extrap)
            n = q.shape[ax] - 1
            comps.append((q.narrow(ax, 1, n) - q.narrow(ax, 0, n)) / h[d])
    return tuple(comps)


def _grid_rank(values: torch.Tensor, ndim, faces=None) -> int:
    """The grid's axes of `values`: `ndim`, or all of its axes; a `faces` layout must have one entry each."""
    nd = values.ndim if ndim is None else ndim
    if faces is not None and len(faces) != nd:
        raise ValueError(f"a face layout of {len(faces)} axes for a grid of {nd} (values {tuple(values.shape)}, "
                         f"ndim {ndim})")
    return nd


def finite_fill_native(values: torch.Tensor, distance: int = 1, ndim: int = None) -> torch.Tensor:
    """Fill the non-finite cells of one grid array from their finite
    neighbours, `distance` cells deep; a staggered grid is filled component by
    component. A cell with a finite axis neighbour gets the mean of those; a
    cell reached only across a diagonal gets 0 (it has no axis neighbour to
    average); cells further away keep their NaN. That is the JAX package's
    result, diagonal zeros included. `ndim`: the grid's axes, the trailing
    ones (default all)."""
    nd = _grid_rank(values, ndim)
    valid = torch.isfinite(values)
    clean = torch.where(valid, values, torch.zeros_like(values))
    filled, _ = masked_fill_native(clean, valid, distance, nd)
    reach = valid.to(values.dtype)
    for _ in range(distance):
        # axis after axis on the running result: the reach grows to the whole box neighbourhood
        for axis in range(-nd, 0):
            lo, up = shift_zero(reach, axis)
            reach = torch.maximum(reach, torch.maximum(lo, up))
        reach = (reach > 0).to(values.dtype)
    return torch.where(reach > 0, filled, values)


def stagger_native(values: torch.Tensor, face_function: Callable, extrap: Extrapolation,
                   faces=None, ndim: int = None, axes: Sequence[int] = None) -> Tuple[torch.Tensor, ...]:
    """A centred grid at the faces a staggered field stores: each face gets
    `face_function` of its two cells (`torch.minimum` makes a face open only
    where both cells are). `extrap` is the centred grid's extrapolation, which
    gives the cells beyond the outer faces; `faces` is the staggered field's
    face layout (the closed box of the values' rank by default) and decides
    which faces it stores. `ndim`: the grid's axes, the trailing ones
    (default all; leading axes are a batch). `axes`: the components to
    compute, in their order (default all)."""
    nd = _grid_rank(values, ndim, faces)
    layout = _faces(faces, nd)
    comps = []
    for d in (range(nd) if axes is None else axes):
        axis = d - nd
        padded = pad(values, axis, 1, 1, extrap)
        n = values.shape[axis]
        faces_all = face_function(padded.narrow(axis, 0, n + 1), padded.narrow(axis, 1, n + 1))
        lo, up = stored_faces(layout[d])
        comps.append(faces_all.narrow(axis, int(not lo), n + 1 - int(not lo) - int(not up)))
    return tuple(comps)


def stagger_centres_native(values: torch.Tensor, face_function: Callable, extrap: Extrapolation,
                           ndim: int = None, axes: Sequence[int] = None) -> Tuple[torch.Tensor, ...]:
    """`stagger` at the cell centres (JAX's `at='center'`, `:215-224`): per
    axis the face function of the two faces of each cell, each face the face
    function of its two cells, the cells beyond the grid from `extrap`."""
    nd = _grid_rank(values, ndim)
    comps = []
    for d in (range(nd) if axes is None else axes):
        axis = d - nd
        padded = pad(values, axis, 1, 1, extrap)
        n = values.shape[axis]
        lower = face_function(padded.narrow(axis, 0, n), padded.narrow(axis, 1, n))
        upper = face_function(padded.narrow(axis, 1, n), padded.narrow(axis, 2, n))
        comps.append(face_function(lower, upper))
    return tuple(comps)


def safe_mul_native(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b with 0 · NaN = 0 on either side: masking a velocity that holds
    NaN in its unset faces."""
    a_n = torch.where(b == 0, torch.zeros_like(a), a)
    b_n = torch.where(a == 0, torch.zeros_like(b), b)
    return a_n * b_n


def laplace_native(values: torch.Tensor, dx, extrap: Extrapolation, axes: Sequence[int] = None,
                   ndim: int = None) -> torch.Tensor:
    """The order-2 Laplacian of one grid array: per axis of `axes` (default
    all) (v[i−1] + v[i+1] − 2·v[i]) / dx² with ghost cells from `extrap`.
    `ndim`: the grid's axes, the trailing ones (default all; `axes` count
    among them)."""
    nd = _grid_rank(values, ndim)
    h = _per_axis(dx, nd)
    result = None
    for d in (range(nd) if axes is None else axes):
        axis = d - nd
        padded = pad(values, axis, 1, 1, extrap)
        n = values.shape[axis]
        lo, ce, up = padded.narrow(axis, 0, n), padded.narrow(axis, 1, n), padded.narrow(axis, 2, n)
        h_axis = np.float64(h[d]) if values.dtype == torch.float64 else np.float32(h[d])
        term = (lo + up - 2 * ce) / float(h_axis ** 2)
        result = term if result is None else result + term
    return result


# ---------------------------------------------------------------------------
# the Field layer
# ---------------------------------------------------------------------------

def _dx_tuple(field):
    """The cell size per axis, in the resolution's order, as floats."""
    dx = field.dx
    return tuple(float(dx.vector[n]) for n in field.resolution.names)


def _native_form(ext, names):
    try:
        return to_native(ext, names)
    except NotImplementedError:
        return None


def _native_extrap(ext, names):
    """`to_native`, naming the operation that needs it when it fails."""
    return to_native(ext, names)


def _native_sides(field):
    """`field.boundary` as the array layer's extrapolation: `to_native`'s form
    where it has one, else a `PerSide` of its side rules and the ghost cells
    a Field embedding samples (`ghost_cells`)."""
    names = field.resolution.names
    form = _native_form(field.boundary, names)
    if form is not None:
        return form
    sides = []
    for dim in names:
        pair = []
        for upper in (False, True):
            e = _side_ext(field.boundary, dim, upper)
            rule = _side_to_native(e)
            if rule is not None:
                pair.append(rule)
            elif hasattr(e, 'ghost_cells'):
                pair.append(e.ghost_cells(field.geometry, dim, upper))
            else:
                raise NotImplementedError(f"extrapolation {e!r} has no array-layer form: constants, BOUNDARY, "
                                          f"PERIODIC, the mirrors and Field embeddings are ported, by side")
        sides.append(tuple(pair))
    return PerSide(*sides)


def _face_layout(boundary, names, walls: bool = True, or_none: bool = False) -> Optional[tuple]:
    """The `face_layout` of a staggered grid under `boundary`: per axis
    'periodic', else per side None where the outer face is stored, else the
    wall's normal velocity (a scalar constant; with ``walls=False`` any
    extrapolation, read as 0). Where a wall's normal velocity is no scalar
    constant it raises, or with ``or_none`` returns None."""
    layout = []
    for dim in names:
        stored = boundary.valid_outer_faces(dim)
        normal = get_normal(boundary[{'vector': dim}])
        sides = []
        for upper in (False, True):
            e = _side_ext(normal, dim, upper)
            if isinstance(e, _PeriodicExtrapolation):
                sides.append('periodic')
            elif stored[int(upper)]:
                sides.append(None)
            elif isinstance(e, ConstantExtrapolation) and e.value.rank == 0:
                sides.append(float(e.value))
            elif not walls:
                sides.append(0.0)
            elif or_none:
                return None
            else:
                raise NotImplementedError(f"boundary {boundary!r}: the walls' normal velocity along {dim} is not a "
                                          f"scalar constant")
        if 'periodic' in sides:
            if sides != ['periodic', 'periodic']:
                raise NotImplementedError(f"boundary {boundary!r}: periodic on one side of {dim} only")
            layout.append('periodic')
        else:
            layout.append(tuple(sides))
    return tuple(layout)


def _check_staggered_shapes(field, layout):
    """NotImplementedError unless each face component has the length its layout gives along its own axis."""
    names = field.resolution.names
    for axis, (dim, comp) in enumerate(zip(names, face_components(field.values))):
        lo, up = stored_faces(layout[axis])
        if comp.shape.get_size(dim) != field.resolution.get_size(dim) + int(lo) + int(up) - 1:
            raise NotImplementedError(f"staggered component {dim} of {comp.shape} does not store the faces its "
                                      f"boundary {field.boundary!r} gives")


def _plain_values(values, names) -> bool:
    return set(values.shape.names) == set(names)


def _batch_dims(tensors, names, what: str):
    """The batch dims of `tensors` (the values of one Field: a centred grid's,
    or the face components of a staggered one) besides the grid dims
    `names`, merged; NotImplementedError where any has another kind of dim."""
    from ..math._shape import merge_shapes
    others = merge_shapes(*[t.shape.without(names) for t in tensors])
    if others.rank != others.batch.rank:
        raise NotImplementedError(f"{what} of values {', '.join(str(t.shape) for t in tensors)}: the grid dims "
                                  f"{tuple(names)} and batch dims are ported")
    return others


def _batch_native(t, batch, names):
    """`t` as a torch array (*batch, *grid), the batch dims it lacks broadcast (a view)."""
    arr = t.torch(batch.names + tuple(names))
    return arr.expand(tuple(batch.sizes) + tuple(arr.shape[batch.rank:])) if batch else arr


def _batch_tensor(arr, batch, grid):
    """A torch array (*batch, *grid) as a Tensor of `batch` and the grid dims of `grid` at the array's sizes."""
    from ..math._shape import concat_shapes
    return Tensor(arr, concat_shapes(batch, grid.with_sizes(tuple(arr.shape[batch.rank:]))))


def _array_layout(field, dims=None):
    """The array layer's face layout of the staggered `field` (`_face_layout`,
    any wall read as a wall: the extrapolation of each component pads it),
    its components checked to store those faces; NotImplementedError for
    a dims subset."""
    names = field.resolution.names
    if dims is not None and tuple(dims) != tuple(names):
        raise NotImplementedError(f"staggered values over dims {tuple(dims)} of {names}: all grid dims in the "
                                  f"grid's order are ported")
    layout = _face_layout(field.boundary, names, walls=False)
    _check_staggered_shapes(field, layout)
    return layout


def _grid_values(values, names, fn):
    """`fn` (an array (*batch, *grid) with the grid dims in `names`' order
    last → an array of the same rank) on `values`, once per entry of a
    channel dim if it has one: a Tensor of the other dims and the grid dims
    with the sizes `fn` returns. The other dims (batch, instance or dual, as
    the JAX package maps its operators over them) are leading axes of one
    call."""
    others = values.shape.without(names)
    rest = others.channel
    batch = others.without(rest)
    if not set(names) <= set(values.shape.names) or rest.rank > 1:
        raise NotImplementedError(f"values {values.shape}: the grid dims {names} and one channel dim at most are "
                                  f"ported")
    grid = values.shape.only(names, reorder=True)

    def one(v):
        return _batch_tensor(fn(v.torch(batch.names + tuple(names))), batch, grid)
    if not rest:
        return one(values)
    return stack([one(values[{rest.name: i}]) for i in range(rest.size)], rest)


def _staggered(field, comps, boundary, batch=None, dims=None):
    """Face arrays ((*batch,) x, y[, z]) as a staggered Field on `field`'s
    grid: one component per dim of `dims` (default all grid dims)."""
    from ..math._shape import EMPTY_SHAPE
    batch = EMPTY_SHAPE if batch is None else batch
    grid = field.values.shape.only(field.resolution.names, reorder=True)
    return Field(field.geometry, TensorStack([_batch_tensor(c, batch, grid) for c in comps],
                                             dual(vector=list(dims or field.resolution.names))), boundary)


def _dx(field, dim):
    """The cell size along `dim`: a host Tensor."""
    return field.dx.vector[dim]


def _axes_periodic(field, dims) -> bool:
    """Whether `field.boundary` is periodic on both sides of every dim of `dims`."""
    from ._stencil1d import classify_side
    return all(classify_side(field.boundary, d, False) == 'periodic' and
               classify_side(field.boundary, d, True) == 'periodic' for d in dims)


def _use_ghost_pad_order4(field, dims) -> bool:
    """Order 4 takes the ghost-cell stencil where the boundary is periodic
    (exact there) or has no matrix form; the other boundaries take the
    operator matrices of `_higher_order`, one-sided at the walls."""
    from ._higher_order import _axis_bc
    if _axes_periodic(field, dims):
        return True
    return any(_axis_bc(field, d) is None for d in dims)


def _ghost_pad_taps(field, dim):
    """(v[i−2], v[i−1], v[i], v[i+1], v[i+2]) along `dim`, ghost cells from the field's boundary."""
    v = field.values
    padded = ops.pad(v, {dim: (2, 2)}, field.boundary, bounds=field.bounds)
    n = v.shape.get_size(dim)
    return tuple(padded[{dim: slice(k, n + k)}] for k in range(5))


def laplace(field, axes=None, gradient=None, order=2, implicit=None, weights=None, upwind=None, correct_skew=True):
    """Δf of a centred grid. Order 2: `laplace_native` per channel entry
    with ghost cells from `field.boundary`; order 4 on a periodic box: the
    central stencil (−1, 16, −30, 16, −1) / (12 dx²) over ghost cells; other
    orders and boundaries: `higher_order_laplace` (the compact scheme at
    order 6). Its boundary is the gradient's (`spatial_gradient()` of the
    field's). A mesh Field goes to `mesh_laplace`; a grid, as in the JAX
    package, takes `gradient` and `upwind` and ignores them."""
    if field.is_mesh:
        from ._mesh_math import mesh_laplace
        return mesh_laplace(field, gradient=gradient, order=order, upwind=upwind, correct_skew=correct_skew)
    assert field.is_grid and field.is_centered, f"laplace requires a centered grid, got {field}"
    names = field.resolution.names
    dims = [n for n in (axes or names) if n in names]
    if isinstance(weights, Field):
        weights = weights.at(field).values if weights.geometry != field.geometry else weights.values
    if order == 2:
        extrap = _native_sides(field)
        dx = _dx_tuple(field)
        axes = [names.index(n) for n in dims]
        result = _grid_values(field.values, names, lambda v: laplace_native(v, dx, extrap, axes, len(names)))
    elif order == 4 and implicit is None and _use_ghost_pad_order4(field, dims):
        result = None
        for dim in dims:
            m2, m1, ce, p1, p2 = _ghost_pad_taps(field, dim)
            term = (-m2 + 16 * m1 - 30 * ce + 16 * p1 - p2) / (12 * _dx(field, dim) ** 2)
            result = term if result is None else result + term
    else:
        from ._higher_order import higher_order_laplace
        return higher_order_laplace(field, order=order, implicit=implicit)
    if weights is not None:
        result = result * weights
    return Field(field.geometry, result, field.boundary.spatial_gradient())


def spatial_gradient(field, boundary=None, at: str = 'center', dims=None, stack_dim=channel('vector'), order=2,
                     implicit=None, upwind=None, scheme=None):
    """∇f of a centred grid: at the centres (stacked along `stack_dim`,
    default `vector`) by central differences — order 2, or order 4 over
    ghost cells on a periodic box — or at the faces (``at='face'``, a
    staggered grid whose components follow the gradient's boundary) by the
    differences of neighbours (`spatial_gradient_native`); other orders and
    boundaries through `higher_order_gradient` (the compact scheme at order
    6). A mesh Field's gradient is Green-Gauss, or least squares with
    ``scheme='least-squares'``; of a vector Field one per component, stacked
    along `gradient` where `stack_dim` is its own channel dim. A grid takes
    `upwind` and ignores it, as the JAX package does."""
    if field.is_mesh:
        from ._mesh_math import green_gauss_gradient, least_squares_gradient
        grad_fn = least_squares_gradient if scheme in ('least-squares', 'least_squares') else green_gauss_gradient
        if field.shape.channel:
            ch = field.shape.channel[0:1]
            if stack_dim.dims[0].name == ch.name:
                stack_dim = channel('gradient')
            labels = field.shape.get_labels(ch.name) or tuple(range(ch.volume))
            comps = [grad_fn(field[{ch.name: l}], stack_dim=stack_dim, boundary=boundary) for l in labels]
            return Field(field.geometry, stack([c.values for c in comps], ch), comps[0].boundary)
        return grad_fn(field, stack_dim=stack_dim, boundary=boundary)
    assert field.is_grid and field.is_centered, f"spatial_gradient requires a centred grid, got {field}"
    grad_ext = as_boundary(boundary, field.geometry) if boundary is not None else field.boundary.spatial_gradient()
    names = field.resolution.names
    dims = [n for n in (dims or names) if n in names]
    v = field.values
    if at == 'face':
        if order > 2:
            from ._higher_order import higher_order_gradient
            return higher_order_gradient(field, grad_ext, at, dims, stack_dim, order, implicit)
        layout = _face_layout(grad_ext, names, walls=False)
        batch = _batch_dims([v], names, 'the face gradient')
        comps = spatial_gradient_native(_batch_native(v, batch, names), _dx_tuple(field), faces=layout,
                                        extrap=_native_sides(field), ndim=len(names),
                                        axes=[names.index(d) for d in dims])
        return _staggered(field, comps, grad_ext, batch, dims)
    if at != 'center':
        raise ValueError(at)
    comps = {}
    for dim in dims:
        if order == 2:
            padded = ops.pad(v, {dim: (1, 1)}, field.boundary)
            n = v.shape.get_size(dim)
            comps[dim] = (padded[{dim: slice(2, n + 2)}] - padded[{dim: slice(0, n)}]) / (2 * _dx(field, dim))
        elif order == 4 and _use_ghost_pad_order4(field, [dim]):
            m2, m1, _, p1, p2 = _ghost_pad_taps(field, dim)
            comps[dim] = (m2 - 8 * m1 + 8 * p1 - p2) / (12 * _dx(field, dim))
        else:
            from ._higher_order import higher_order_gradient
            return higher_order_gradient(field, grad_ext, at, dims, stack_dim, order, implicit)
    return Field(field.geometry, stack(comps, stack_dim), grad_ext)


def stagger(field, face_function: Callable, boundary, at='face', dims=None):
    """A centred grid at the faces (`stagger_native`): each face gets
    `face_function` of its two cells, the cells beyond the outer faces from
    `field.boundary`; the faces stored follow `boundary`. Over `dims` (all
    grid dims by default) in their order: a staggered grid of those
    components. ``at='center'`` gives each cell the face function of its two
    faces' values (`stagger_centres_native`), stacked along `vector`."""
    boundary = as_boundary(boundary, field.geometry)
    names = field.resolution.names
    assert field.is_centered and field.is_grid
    dims = list(dims or names)
    v = field.values
    batch = _batch_dims([v], names, 'stagger')
    grid = v.shape.only(names, reorder=True)
    axes = [names.index(d) for d in dims]

    def native_fn(lower, upper):
        return _batch_native(face_function(_batch_tensor(lower, batch, grid), _batch_tensor(upper, batch, grid)),
                             batch, names)
    if at == 'center':
        comps = stagger_centres_native(_batch_native(v, batch, names), native_fn, _native_sides(field),
                                       ndim=len(names), axes=axes)
        return Field(field.geometry, stack({d: _batch_tensor(c, batch, grid) for d, c in zip(dims, comps)},
                                           channel('vector')), boundary)
    if at != 'face':
        raise ValueError(at)
    layout = _face_layout(boundary, names, walls=False)
    comps = stagger_native(_batch_native(v, batch, names), native_fn, _native_sides(field), faces=layout,
                           ndim=len(names), axes=axes)
    return _staggered(field, comps, boundary, batch, dims)


def _divergence_padded(field):
    """The divergence of a staggered grid as JAX computes it: each face
    component padded by one face on each side whose outer face is not stored,
    with its own extrapolation (a mirror, a vector constant, a Field), then
    differenced. The path of the boundaries whose walls' normal velocity is
    no scalar constant, where the face layout has no entry."""
    from ..math import pad
    result = None
    for dim, comp in zip(field.resolution.names, face_components(field.values)):
        lo, up = field.boundary.valid_outer_faces(dim)
        padded = pad(comp, {dim: (int(not lo), int(not up))}, field.boundary[{'vector': dim}])
        n = field.resolution.get_size(dim)
        term = (padded[{dim: slice(1, n + 1)}] - padded[{dim: slice(0, n)}]) / _dx(field, dim)
        result = term if result is None else result + term
    return Field(field.geometry, result, field.boundary.spatial_gradient())


def divergence(field, order=2, implicit=None, upwind=None):
    """∇·v at the cell centres: of a staggered grid the differences of each
    component's faces (`divergence_native`, order 2), of a centred vector
    grid the sum of each component's derivative along its own axis
    (`spatial_gradient` at the centres, orders 2, 4 and 6); of a mesh Field
    the flux sum of `mesh_divergence`. A grid takes `upwind` and ignores it,
    as the JAX package does."""
    if field.is_mesh:
        from ._mesh_math import mesh_divergence
        return mesh_divergence(field, order=order, upwind=upwind)
    names = field.resolution.names
    if field.is_staggered:
        if order != 2 or implicit is not None:
            raise NotImplementedError("the divergence of a staggered grid is of order 2, as in the JAX package")
        layout = _face_layout(field.boundary, names, or_none=True)
        if layout is None:  # walls whose normal velocity is no scalar constant: JAX's body, on Tensors
            return _divergence_padded(field)
        _check_staggered_shapes(field, layout)
        comps = face_components(field.values)
        batch = _batch_dims(comps, names, 'divergence')
        result = divergence_native([_batch_native(c, batch, names) for c in comps], _dx_tuple(field), faces=layout)
        return Field(field.geometry, _batch_tensor(result, batch, field.resolution), field.boundary.spatial_gradient())
    assert 'vector' in field.values.shape, "divergence requires a vector field"
    result = None
    for dim in names:
        comp = Field(field.geometry, field.values[{'vector': dim}], field.boundary[{'vector': dim}])
        grad = spatial_gradient(comp, at='center', dims=[dim], order=order, stack_dim=channel('_div'))
        term = grad.values[{'_div': 0}]
        result = term if result is None else result + term
    return Field(field.geometry, result, field.boundary.spatial_gradient())


def fourier_laplace(grid, times=1):
    """The exact Laplacian of a periodic centred grid (`math.fourier_laplace`)."""
    from ..math._nd import fourier_laplace as _fourier_laplace
    return grid.with_values(_fourier_laplace(grid.values, grid.dx, times=times))


def fourier_poisson(grid, times=1):
    """The zero-mean inverse Laplacian of a periodic centred grid (`math.fourier_poisson`)."""
    from ..math._nd import fourier_poisson as _fourier_poisson
    return grid.with_values(_fourier_poisson(grid.values, grid.dx, times=times))


def where(mask, field_true, field_false):
    """Pick from `field_true` where `mask` holds, else from `field_false`
    (Fields, numbers or Tensors); the result lives on the first Field's grid."""
    template = next(x for x in (mask, field_true, field_false) if isinstance(x, Field))

    def val(x):
        if isinstance(x, Field):
            return x.values if x.geometry == template.geometry else x.at(template).values
        return wrap(x)
    values = ops.where(val(mask), val(field_true), val(field_false))
    boundary = field_true.boundary if isinstance(field_true, Field) and isinstance(field_false, Field) \
        else template.boundary
    return Field(template.geometry, values, boundary)


def is_finite(field):
    ext = field.boundary
    if isinstance(ext, ConstantExtrapolation):
        ext = ConstantExtrapolation(ops.is_finite(ext.value))
    return Field(field.geometry, ops.is_finite(field.values), ext)


def _align_fields(f1, f2):
    if isinstance(f1, Field) and isinstance(f2, Field):
        return f1, (f2 if f1.geometry == f2.geometry else f2.at(f1))
    if isinstance(f1, Field):
        return f1, f1.with_values(f2 if isinstance(f2, Tensor) else wrap(f2))
    f2, f1 = _align_fields(f2, f1)
    return f1, f2


def maximum(f1, f2):
    f1, f2 = _align_fields(f1, f2)
    return f1.with_values(ops.maximum(f1.values, f2.values))


def minimum(f1, f2):
    f1, f2 = _align_fields(f1, f2)
    return f1.with_values(ops.minimum(f1.values, f2.values))


def clip(field, lower=0., upper=1.):
    return field.with_values(ops.clip(field.values, lower, upper))


def _safe_mul_values(a, b):
    zero_a = a == 0 if isinstance(a, Tensor) else wrap(a == 0)
    zero_b = b == 0 if isinstance(b, Tensor) else wrap(b == 0)
    an = ops.where(zero_b, ops.zeros_like(a) if isinstance(a, Tensor) else 0, a)
    bn = ops.where(zero_a, ops.zeros_like(b) if isinstance(b, Tensor) else 0, b)
    return an * bn


def safe_mul(a, b):
    """a · b with 0 · NaN = 0 (masking a velocity that holds NaN in unset faces)."""
    if isinstance(a, Field) and isinstance(b, Field):
        return a.with_values(_safe_mul_values(a.values, b.values if a.geometry == b.geometry else b.at(a).values))
    if isinstance(a, Field):
        return a.with_values(_safe_mul_values(a.values, b if isinstance(b, Tensor) else wrap(b)))
    if isinstance(b, Field):
        return b.with_values(_safe_mul_values(a if isinstance(a, Tensor) else wrap(a), b.values))
    return _safe_mul_values(wrap(a), wrap(b))


def finite_fill(grid, distance=1, diagonal=False):
    """Fill the non-finite cells from their finite neighbours, `distance`
    cells deep (`finite_fill_native`, component by component)."""
    assert grid.is_grid
    names = grid.resolution.names

    def fill(values):
        batch = _batch_dims([values], names, 'finite_fill')
        order = batch.names + tuple(n for n in values.shape.names if n in names)
        return Tensor(finite_fill_native(values.torch(order), distance, len(names)),
                      values.shape.only(order, reorder=True))
    if grid.is_staggered:
        return grid.with_values(face_values([fill(c) for c in face_components(grid.values)], grid.values))
    return grid.with_values(fill(grid.values))


def mean(field, dim=None):
    """The mean over the sample points."""
    return ops.mean(field.values, field.values.shape.non_channel.non_batch if dim is None else dim)


def mask(obj):
    """1 where `obj` is defined: at every point of a point cloud, in every
    nonzero cell of a grid (its constant boundaries 0), inside a geometry."""
    from ..geom import Geometry
    if isinstance(obj, Field):
        if obj.is_point_cloud:
            return Field(obj.geometry, wrap(1.), 0.)
        values = ops.to_float(obj.values != 0)
        return Field(obj.geometry, values, map_extrapolation(
            lambda e: ConstantExtrapolation(0.) if isinstance(e, ConstantExtrapolation) else e, obj.boundary))
    assert isinstance(obj, Geometry), f"mask requires a Field or Geometry, got {type(obj)}"
    return Field(obj, wrap(1.), 0.)


def native_call(f, *inputs, channels_last=None, channel_dim='vector', extrapolation=None, **kwargs):
    """Call a native function (a network of `nn`) on grid values: channels
    last unless ``channels_last=False``; the result is a Field on the first
    input's geometry under its boundary, or `extrapolation`. Tensors go
    through `math.native_call`."""
    if isinstance(inputs[0], Field):
        template = inputs[0]
        tensors = [i.values if isinstance(i, Field) else i for i in inputs]
        values = ops.native_call(f, *tensors, channels_last=True if channels_last is None else channels_last,
                                 channel_dim=channel_dim)
        return Field(template.geometry, values, extrapolation if extrapolation is not None else template.boundary)
    return ops.native_call(f, *inputs, channels_last=bool(channels_last), channel_dim=channel_dim)


# ---------------------------------------------------------------------------
# the rest of the Field functions (port of `:41-57`, `:278-310`, `:356-720`)
# ---------------------------------------------------------------------------

def _unary_field(fn):
    def f(field):
        return field._op1(lambda v: fn(v) if isinstance(v, Tensor) else v)
    return f


abs_ = _unary_field(ops.abs_)
sign = _unary_field(ops.sign)
round_ = _unary_field(ops.round_)
ceil = _unary_field(ops.ceil)
floor = _unary_field(ops.floor)
sqrt = _unary_field(ops.sqrt)
exp = _unary_field(ops.exp)
sin = _unary_field(ops.sin)
cos = _unary_field(ops.cos)
sigmoid = _unary_field(ops.sigmoid)
real = _unary_field(ops.real)
imag = _unary_field(ops.imag)
stop_gradient = _unary_field(ops.stop_gradient)


def _padded_grid(grid, widths: dict):
    """The UniformGrid of `grid` grown by (lower, upper) cells along each dim of `widths`."""
    from ..geom import Box, UniformGrid
    names = grid.resolution.names
    dx = np.asarray(grid.dx.numpy(grid.dx.shape.names))
    lower, upper = grid.bounds._lower.copy(), grid.bounds._upper.copy()
    sizes = list(grid.resolution.sizes)
    for i, n in enumerate(names):
        lo, up = widths.get(n, (0, 0))
        lower[i] -= lo * dx[i]
        upper[i] += up * dx[i]
        sizes[i] += lo + up
    return UniformGrid(grid.resolution.with_sizes(sizes), Box._of(lower, upper, names))


def bake_extrapolation(grid):
    """The grid with its boundary written into the values: one ghost cell
    each side of a centred grid (its geometry grown by it), the missing outer
    faces of a staggered one; the boundary becomes NONE."""
    from ..math._extrapolation import NONE
    if grid.boundary == NONE:
        return grid
    names = grid.resolution.names
    if grid.is_staggered:
        comps = []
        for dim in names:
            lo, up = grid.boundary.valid_outer_faces(dim)
            comps.append(ops.pad(grid.vector[dim].values, {dim: (int(not lo), int(not up))},
                                 grid.boundary[{'vector': dim}]))
        return Field(grid.geometry, stack(comps, dual(vector=names)), NONE)
    widths = {d: (1, 1) for d in names}
    return Field(_padded_grid(grid.geometry, widths), ops.pad(grid.values, widths, grid.boundary), NONE)


def curl(field, at='corner'):
    """The 2D curl ∂v_y/∂x − ∂v_x/∂y of a centred vector grid: at the cell
    centres (central differences) or at the cell corners, one more sample
    along each axis; a staggered grid is taken at its centres first."""
    from ..geom import Box, UniformGrid
    from ..math import extrapolation as extrapolation_mod
    assert field.is_grid
    if field.is_centered and field.spatial_rank == 2 and 'vector' in field.values.shape:
        x, y = field.resolution.names
        v, ext = field.values, field.boundary
        if at == 'center':
            vx = Field(field.geometry, v[{'vector': x}], ext[{'vector': x}])
            vy = Field(field.geometry, v[{'vector': y}], ext[{'vector': y}])
            dvy_dx = spatial_gradient(vy, at='center', dims=[x], stack_dim=channel('_c')).values[{'_c': 0}]
            dvx_dy = spatial_gradient(vx, at='center', dims=[y], stack_dim=channel('_c')).values[{'_c': 0}]
            return Field(field.geometry, dvy_dx - dvx_dy, ext.spatial_gradient())
        vx_pad = ops.pad(v[{'vector': x}], {y: (1, 1)}, ext[{'vector': x}])
        vy_pad = ops.pad(v[{'vector': y}], {x: (1, 1)}, ext[{'vector': y}])
        nx, ny = field.resolution.get_size(x), field.resolution.get_size(y)
        dvy_dx = (vy_pad[{x: slice(1, nx + 2)}] - vy_pad[{x: slice(0, nx + 1)}]) / _dx(field, x)
        dvx_dy = (vx_pad[{y: slice(1, ny + 2)}] - vx_pad[{y: slice(0, ny + 1)}]) / _dx(field, y)
        pad_y = ops.pad(dvy_dx, {y: (1, 1)}, ext[{'vector': y}])
        pad_x = ops.pad(dvx_dy, {x: (1, 1)}, ext[{'vector': x}])
        dvy_dx = 0.5 * (pad_y[{y: slice(0, ny + 1)}] + pad_y[{y: slice(1, ny + 2)}])
        dvx_dy = 0.5 * (pad_x[{x: slice(0, nx + 1)}] + pad_x[{x: slice(1, nx + 2)}])
        corners = UniformGrid(field.resolution.with_sizes([s + 1 for s in field.resolution.sizes]),
                              Box(field.bounds.lower - field.dx / 2, field.bounds.upper + field.dx / 2))
        return Field(corners, dvy_dx - dvx_dy, extrapolation_mod.BOUNDARY)
    if field.is_staggered and field.spatial_rank == 2:
        return curl(field.at_centers(), at=at)
    raise NotImplementedError(f"curl of {field}: 2D grids are ported")


def normalize(field, norm=None, epsilon=1e-15):
    """`field` divided by the sum of `norm`'s values (its own by default) over the non-batch dims."""
    source = norm if norm is not None else field
    return field.with_values(ops.safe_div(field.values, ops.sum_(source.values, source.values.shape.non_batch)))


def center_of_mass(density):
    """Σ x·ρ / Σ ρ over the sample points."""
    total = ops.sum_(density.values, density.values.shape.non_batch)
    return ops.sum_(density.center * density.values, density.values.shape.non_batch) / total


def vec_length(field):
    """|v| of a vector Field (a staggered grid at its centres); a vector
    constant boundary becomes its length, any other its absolute value."""
    if field.is_staggered:
        field = field.at_centers()
    return Field(field.geometry, ops.vec_length(field.values), map_extrapolation(
        lambda e: ConstantExtrapolation(ops.vec_length(e.value)) if isinstance(e, ConstantExtrapolation)
        and 'vector' in e.value.shape else abs(e), field.boundary))


vec_abs = vec_length


def vec_squared(field):
    """|v|² of a vector Field (a staggered grid at its centres)."""
    if field.is_staggered:
        field = field.at_centers()
    return field.with_values(ops.vec_squared(field.values))


def discretize(grid, filled_fraction=0.25):
    """1 in the `filled_fraction` of the cells with the largest values, 0 elsewhere."""
    v = np.sort(grid.values.numpy().flatten())
    threshold = v[int((1 - filled_fraction) * len(v))]
    filled = ops.where(grid.values > float(threshold), ops.ones_like(grid.values), ops.zeros_like(grid.values))
    return grid.with_values(filled)


def integrate(field, region=None, **kwargs):
    """∫ f dV over the grid, or over the part of it inside `region` (each
    cell weighted by its fraction inside, `approximate_fraction_inside`)."""
    volume = float(np.prod(field.dx.numpy()))
    dims = field.values.shape.non_channel.non_batch
    if region is None:
        return ops.sum_(field.values * volume, dims)
    device = field.values.device or ops.get_default_device()
    weight = Tensor(region.approximate_fraction_inside(field.geometry.native(device), **kwargs), field.resolution)
    return ops.sum_(field.values * weight * volume, dims)


def pack_dims(field, dims, packed_dim, **kwargs):
    """The values' `dims` packed into `packed_dim` (batch dims: the geometry stays)."""
    return Field(field.geometry, ops.pack_dims(field.values, dims, packed_dim), field.boundary)


def support(field, list_dim=instance('nonzero')):
    """The sample points of the nonzero values, along `list_dim`."""
    return ops.gather(field.center, ops.nonzero(field.values, list_dim=list_dim))


def data_bounds(loc):
    """The bounding Box of a point Tensor (or of a Field's sample points)."""
    from ..geom import Box
    if isinstance(loc, Field):
        loc = loc.center
    dims = loc.shape.non_batch.without('vector')
    return Box(ops.min_(loc, dims), ops.max_(loc, dims))


def assert_close(*fields, rel_tolerance=1e-5, abs_tolerance=0, msg="", verbose=True):
    """`math.assert_close` of the values, each Field first resampled to the first one's geometry."""
    if isinstance(fields[0], Field):
        f0 = fields[0]
        inner = [f.at(f0).values if isinstance(f, Field) and f.geometry != f0.geometry
                 else (f.values if isinstance(f, Field) else wrap(f)) for f in fields]
    else:
        inner = [f.values if isinstance(f, Field) else wrap(f) for f in fields]
    ops.assert_close(*inner, rel_tolerance=rel_tolerance, abs_tolerance=abs_tolerance, msg=msg)


def l2_loss(field):
    """½ Σ v² over the non-batch dims (a staggered grid: over all components)."""
    if isinstance(field, Field):
        field = field.values
    if isinstance(field, TensorStack):
        return sum(l2_loss(c) for c in field.components)
    return ops.sum_(field ** 2, field.shape.non_batch) * 0.5


def l1_loss(field):
    """Σ |v| over the non-batch dims (a staggered grid: over all components)."""
    if isinstance(field, Field):
        field = field.values
    if isinstance(field, TensorStack):
        return sum(l1_loss(c) for c in field.components)
    return ops.sum_(abs(field), field.shape.non_batch)


def frequency_loss(field, frequency_falloff=100, threshold=1e-5, ignore_mean=False):
    """½ Σ |û(k)|²·exp(−½ (k·falloff)²) over the spatial frequencies (k in
    cycles per sample), per batch entry: low frequencies weigh most."""
    values = field.values if isinstance(field, Field) else field
    if isinstance(values, TensorStack):
        return sum(frequency_loss(c, frequency_falloff, threshold, ignore_mean) for c in values.components)
    if ignore_mean:
        values = values - ops.mean(values, values.shape.non_batch)
    native = values.torch(values.shape.names)
    names, dims = values.shape.names, values.shape.spatial.names
    axes = [names.index(d) for d in dims]
    spectrum = torch.fft.fftn(native, dim=axes)
    k2 = None
    for i, ax in enumerate(axes):
        k = (np.fft.fftfreq(native.shape[ax]) ** 2).reshape([-1 if j == i else 1 for j in range(len(axes))])
        k2 = k if k2 is None else k2 + k
    w = torch.as_tensor(np.exp(-0.5 * k2 * frequency_falloff ** 2).astype(np.float32), device=native.device)
    w = w.reshape([native.shape[a] if a in axes else 1 for a in range(native.ndim)])
    sq = (spectrum.real ** 2 + spectrum.imag ** 2) * w
    batch_axes = [i for i, n in enumerate(names) if values.shape.get_dim(n).dim_type == 'batch']
    total = torch.sum(sq, dim=[a for a in range(native.ndim) if a not in batch_axes]) * 0.5
    return Tensor(total, values.shape.batch)


def pad_field(grid, widths):
    """The grid grown by `widths` cells (an int, one (lower, upper) or int
    per dim, or a dict), filled from its boundary; its bounds grow with it."""
    names = grid.resolution.names
    if isinstance(widths, int):
        widths = {d: (widths, widths) for d in names}
    elif isinstance(widths, (tuple, list)):
        widths = {d: (w[0], w[1]) if isinstance(w, (tuple, list)) else (w, w) for d, w in zip(names, widths)}
    assert grid.is_grid
    if grid.is_staggered:
        values = stack([ops.pad(grid.vector[dim].values, dict(widths), grid.boundary[{'vector': dim}])
                        for dim in names], dual(vector=names))
    else:
        values = ops.pad(grid.values, widths, grid.boundary)
    return Field(_padded_grid(grid.geometry, widths), values, grid.boundary)


def downsample2x(grid):
    """Half the resolution: a centred grid averages pairs of cells
    (`math.downsample2x`); a staggered grid keeps every second face of each
    component along its own axis and averages pairs along the others (the
    JAX package's function takes centred grids only)."""
    from ..geom import UniformGrid
    from ..math._nd import downsample2x as downsample_values
    assert grid.is_grid
    names = grid.resolution.names
    geometry = UniformGrid(grid.resolution.with_sizes([(s + 1) // 2 for s in grid.resolution.sizes]), grid.bounds)
    if grid.is_centered:
        return Field(geometry, downsample_values(grid.values, grid.boundary), grid.boundary)
    comps = []
    for dim, comp in zip(names, face_components(grid.values)):
        lower_face, _ = grid.boundary.valid_outer_faces(dim)
        kept = comp[{dim: slice(0 if lower_face else 1, None, 2)}]
        comps.append(downsample_values(kept, grid.boundary[{'vector': dim}], dims=[d for d in names if d != dim]))
    return Field(geometry, stack(comps, dual(vector=names)), grid.boundary)


def upsample2x(grid):
    """Twice the resolution of a centred grid (`math.upsample2x`)."""
    from ..geom import UniformGrid
    from ..math._nd import upsample2x as upsample_values
    assert grid.is_grid and grid.is_centered
    geometry = UniformGrid(grid.resolution.with_sizes([s * 2 for s in grid.resolution.sizes]), grid.bounds)
    return Field(geometry, upsample_values(grid.values, grid.boundary), grid.boundary)


def concat_fields(fields, dim):
    """Fields joined along a non-grid dim; point clouds join their points too."""
    assert len(fields) > 0
    f0 = fields[0]
    name = dim if isinstance(dim, str) else dim.name
    values = ops.concat([f.values for f in fields], dim if not isinstance(dim, str) else f0.values.shape[name])
    if f0.is_grid and name in f0.resolution:
        raise NotImplementedError("spatial concat of grids with bounds fusion")
    if f0.is_point_cloud:
        centers = ops.concat([f.geometry.center for f in fields], dim if not isinstance(dim, str)
                             else f0.geometry.center.shape[name])
        return Field(f0.geometry.at(centers), values, f0.boundary)
    return Field(f0.geometry, values, f0.boundary)


def stack_fields(fields, dim, dim_bounds=None):
    """Fields stacked along a new non-spatial dim: one geometry when all share
    it, one of their type where it stacks (`__field_stack__`: points,
    cylinders), else a `GeometryStack` of them (JAX's rule)."""
    from ..geom import GeometryStack
    from ..math import stack as math_stack
    fields = list(fields)
    f0 = fields[0]
    values = math_stack([f.values for f in fields], dim)
    if dim.dims[0].dim_type == 'spatial':
        raise NotImplementedError("spatial stacking of grids (dim_bounds)")
    geoms = [f.geometry for f in fields]
    if all(g == geoms[0] for g in geoms):
        geometry = geoms[0]
    elif all(type(g) == type(geoms[0]) for g in geoms) and hasattr(geoms[0], '__field_stack__'):
        geometry = geoms[0].__field_stack__(geoms, dim)
    else:
        geometry = GeometryStack(tuple(geoms), dim)
    return Field(geometry, values, f0.boundary)

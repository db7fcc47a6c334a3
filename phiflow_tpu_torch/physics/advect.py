"""Advection — port of `phiflow_tpu/physics/advect.py`, in two layers.

The Field layer, with JAX's signatures: `semi_lagrangian` (`:338`) and
`mac_cormack` (`:393`) of a grid Field through a velocity Field, and
`max_displacement_cells`. With the `euler` integrator and a bounded window
(`max_cells`), a staggered velocity unwraps into `_euler_disp_natives` and
`_window_interp_field_native` below: the same calls of K6 (3D) or K7 (2D) as
the array layer makes. It lies on the field's grid in any face layout
(closed, open or periodic by axis and side; an inflow wall's constant by
component), and a staggered field in its own. A centred velocity (Burgers'
equation advects itself) and the integrators `rk4` and `finite_rk4` go
through their displacement at the field's points (JAX's `_displacement`,
`:120-130`), divided by the cell size, and the same window interpolation,
one array per component. Batch dims of the field, the velocity or both
become leading axes of those calls, each input with the batch dims it has
(size 1 for the others): one launch a lookup for the whole batch, an input
without a batch shared by every entry. ``substeps='auto'`` reads
n = clip(ceil(max|disp| / max_cells), 1, max_substeps) on the host (one
device sync a call) and applies n lookups along disp / n; ``max_cells=None``
is JAX's gather route, `reduce_sample` at the integrator's points
(`math.grid_sample`, no kernel of the port's).

`differential` (`:73-106`) is the term −(v·∇)u of a PDE's right-hand side,
through the Field layer's `spatial_gradient` of orders 2, 4 and 6 on a grid,
and the FVM flux sum on a mesh (`:100-102`).

The array layer (`*_native`) on raw tensors: grids by semi-Lagrangian and
MacCormack lookups, particles by `points_native` with the `finite_rk4_native`
integrator.

The grid schemes port the bounded-window fast path of `phiflow_tpu/physics/advect.py`: the `euler`
integrator with `max_cells` set, which is what `semi_lagrangian` (`:338`,
branch `:362-366`) and `mac_cormack` (`:393`, branch `:412-427`) run for a
uniform grid advected by a staggered velocity of the same resolution.

A field is a tensor (centred) or a sequence of face-component tensors
(staggered, in a face layout of `field/_field_math.py`: the velocity's
`periodic` argument, True / False for the periodic / closed box, or a
layout; a staggered field's own `field_faces` where it differs); the
velocity is always staggered. Either may carry leading batch axes, which broadcast (the
grid's axes are the trailing ones, as many as the velocity has
components). A staggered grid's extrapolation may be a sequence, one entry per
component (the lid of a cavity moves one component's wall value only). The backtrace displacements are built per axis from the velocity
arrays, unscaled — the own component of a staggered target aliases its
velocity array, the others are 2-point averages per shifted axis — and the
window kernels (K6 in 3D, K7 in 2D) apply −dt/dx, the sign and the ±max_cells
clamp in registers.

`points_native` (`:109-117`) and `finite_rk4_native` (`:50-61`) move the
particles of the FLIP model through a closed-box staggered velocity, NaN
velocities (the unset cells of a FLIP grid) counting as zero. Their Field
faces `points` and `finite_rk4` take a point cloud and unwrap into them; the
`euler` and `rk4` integrators of a point cloud look the velocity up at its
points (`sample`, differentiable in the velocity and the points); `advect`
dispatches a point cloud to `points` and a grid to `semi_lagrangian`.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..field._field import Field, face_components, face_values
from ..field._field_math import (_array_layout, _batch_dims, _batch_tensor, _dx_tuple, _native_extrap, face_layout,
                                 spatial_gradient)
from ..field._point_cloud import PointCloud
from ..field._resample import (_closed_staggered, reduce_sample, sample, sample_grid_at_centers,
                               sample_staggered_at_points, staggered_point_arrays)
from ..geom import Geometry, Point
from ..geom._geom import flat_points
from ..math import channel, dual, stack, wrap, _ops as ops
from ..math._nd import PERIODIC, Extrapolation, component_extrapolation, shift_window_interp
from ..math._shape import merge_shapes

__all__ = ['euler', 'rk4', 'finite_rk4', 'advect', 'points', 'differential', 'finite_difference', 'semi_lagrangian', 'mac_cormack',
           'max_displacement_cells',
           'semi_lagrangian_native', 'mac_cormack_native', 'max_displacement_cells_native', 'finite_rk4_native',
           'points_native']

Grid = Union[torch.Tensor, Sequence[torch.Tensor]]


def _is_staggered(field: Grid) -> bool:
    return not isinstance(field, torch.Tensor)


def _per_axis(dx, ndim: int) -> Tuple[float, ...]:
    return tuple(float(x) for x in dx) if isinstance(dx, (tuple, list)) else (float(dx),) * ndim


def _euler_disp_natives(staggered: bool, velocity: Sequence[torch.Tensor], dt_signed: float, dx, faces,
                        velocity_extrap=None, field_faces=None):
    """Per-axis displacement arrays in velocity units at the field's sample
    points, and the scales dt/dx that turn them into cells (applied by the
    window kernel). `faces` is the velocity's face layout (True / False: the
    periodic / closed box), `field_faces` a staggered field's where it
    differs. A staggered field gets one list per component t, whose entry t
    is the velocity array itself where both store the same faces."""
    ndim = len(velocity)
    scales = tuple(float(dt_signed) / h for h in _per_axis(dx, ndim))
    faces = face_layout(faces, ndim) if isinstance(faces, bool) else tuple(faces)
    field_faces = faces if field_faces is None else tuple(field_faces)
    if velocity_extrap is None:
        velocity_extrap = PERIODIC if all(f == 'periodic' for f in faces) else 0.0

    def disp_at(t):
        return [velocity[s] if s == t and field_faces[s] == faces[s] else
                sample_grid_at_centers(velocity[s], s, t, component_extrapolation(velocity_extrap, s), faces, ndim,
                                       field_faces)
                for s in range(ndim)]

    if staggered:
        return [disp_at(t) for t in range(ndim)], scales
    return disp_at(None), scales


def _window_interp_field_native(field: Grid, disp_and_scale, extrap: Extrapolation, max_cells: int,
                                extrema: bool = False, negate: bool = False):
    """Window-interpolate `field` at its own points displaced by the arrays of
    `_euler_disp_natives`. Returns values, or (values, lo, up) with `extrema`;
    per component for a staggered field."""
    disps, scales = disp_and_scale
    if _is_staggered(field):
        results = [shift_window_interp(comp, disps[t], component_extrapolation(extrap, t), max_cells,
                                       compute_extrema=extrema, negate=negate, disp_scale=scales)
                   for t, comp in enumerate(field)]
        if extrema:
            return tuple(tuple(r[i] for r in results) for i in range(3))
        return tuple(results)
    return shift_window_interp(field, disps, extrap, max_cells, compute_extrema=extrema, negate=negate,
                               disp_scale=scales)


def _check(field: Grid, velocity, max_cells, substeps):
    if max_cells is None:
        raise NotImplementedError("max_cells=None is the unbounded gather lookup; it comes with a later "
                                  "slice of the port")
    if not isinstance(substeps, int) or substeps < 1:
        raise NotImplementedError(f"substeps={substeps!r}: only a fixed count is ported "
                                  f"('auto' comes with a later slice)")
    ndim = len(velocity)
    comps = list(field) if _is_staggered(field) else [field]
    if (_is_staggered(field) and len(comps) != ndim) or any(c.ndim < ndim for c in (*comps, *velocity)):
        raise ValueError(f"field of shape(s) {[tuple(c.shape) for c in comps]} with a {ndim}D velocity of "
                         f"shape(s) {[tuple(v.shape) for v in velocity]}")


def semi_lagrangian_native(field: Grid, velocity: Sequence[torch.Tensor], dt: float, dx, extrap,
                           periodic=False, max_cells: int = 2, substeps: int = 1, velocity_extrap=None,
                           field_faces=None) -> Grid:
    """Backtrace + interpolate. `extrap` is the field's extrapolation (for a
    staggered field also one per component); `periodic` the velocity's face
    layout (True / False: the periodic / closed box), `field_faces` a
    staggered field's where it differs. The velocity's extrapolation is
    PERIODIC in the periodic box, else the constant 0 of closed walls, unless
    `velocity_extrap` says otherwise (one per component allowed). Exact
    whenever the CFL number ≤ max_cells; larger displacements are clamped.
    ``substeps=n`` applies n steps of dt/n."""
    _check(field, velocity, max_cells, substeps)
    if substeps > 1:
        for _ in range(substeps):
            field = semi_lagrangian_native(field, velocity, dt / substeps, dx, extrap, periodic, max_cells,
                                           velocity_extrap=velocity_extrap, field_faces=field_faces)
        return field
    fast = _euler_disp_natives(_is_staggered(field), velocity, -dt, dx, periodic, velocity_extrap, field_faces)
    return _window_interp_field_native(field, fast, extrap, max_cells)


def mac_cormack_native(field: Grid, velocity: Sequence[torch.Tensor], dt: float, dx, extrap,
                       periodic=False, correction_strength: float = 1.0, max_cells: int = 2,
                       substeps: int = 1, velocity_extrap=None, field_faces=None) -> Grid:
    """MacCormack advection with the monotonicity clamp: a forward pass with
    the corner extrema, a backward pass along the negated displacement (the
    same arrays, the sign flipped in the kernel), the correction and the clip
    to the forward pass's corner values. The layouts and extrapolations as
    in `semi_lagrangian_native`."""
    _check(field, velocity, max_cells, substeps)
    if substeps != 1:
        for _ in range(substeps):
            field = mac_cormack_native(field, velocity, dt / substeps, dx, extrap, periodic, correction_strength,
                                       max_cells, velocity_extrap=velocity_extrap, field_faces=field_faces)
        return field
    fast = _euler_disp_natives(_is_staggered(field), velocity, -dt, dx, periodic, velocity_extrap,
                               field_faces)  # backward displacement
    fwd, lim_lo, lim_up = _window_interp_field_native(field, fast, extrap, max_cells, extrema=True)
    bwd = _window_interp_field_native(fwd, fast, extrap, max_cells, negate=True)
    half = correction_strength * 0.5

    def combine(f, fw, bw, lo, up):
        return torch.minimum(torch.maximum(fw + half * (f - bw), lo), up)

    if _is_staggered(field):
        return tuple(combine(*parts) for parts in zip(field, fwd, bwd, lim_lo, lim_up))
    return combine(field, fwd, bwd, lim_lo, lim_up)


def max_displacement_cells_native(field: Grid, velocity: Sequence[torch.Tensor], dt: float, dx,
                                  periodic=False, velocity_extrap=None, field_faces=None) -> torch.Tensor:
    """The largest backtrace displacement, in cells, that
    `semi_lagrangian_native(field, velocity, dt)` looks up: a 0-dim tensor. At most
    max_cells certifies that the bounded window is exact."""
    return _max_cells_of(_euler_disp_natives(_is_staggered(field), velocity, -dt, dx, periodic, velocity_extrap,
                                             field_faces), _is_staggered(field))


def _max_cells_of(disp_and_scale, staggered: bool) -> torch.Tensor:
    """max |displacement| in cells over every array of `_euler_disp_natives`' result: a 0-dim tensor."""
    disps, scales = disp_and_scale
    lists = disps if staggered else [disps]
    return torch.stack([torch.max(torch.abs(arr)) * abs(scales[axis]) for per_axis in lists
                        for axis, arr in enumerate(per_axis)]).max()


def _nan_to_0(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def finite_rk4_native(positions: torch.Tensor, velocity: Sequence[torch.Tensor], dt: float, dx) -> torch.Tensor:
    """4th-order Runge–Kutta end points of `positions` (N, d) in the closed-box
    staggered `velocity`, with non-finite velocity samples taken as zero."""
    def sample(pts):
        return _nan_to_0(sample_staggered_at_points(velocity, pts, dx))
    v0 = sample(positions)
    vel_half = sample(positions + 0.5 * dt * v0)
    vel_half2 = sample(positions + 0.5 * dt * vel_half)
    vel_full = sample(positions + dt * vel_half2)
    vel_rk4 = (1 / 6.) * (v0 + 2 * (vel_half + vel_half2) + vel_full)
    return positions + dt * vel_rk4


def points_native(positions: torch.Tensor, velocity: Sequence[torch.Tensor], dt: float, dx,
           integrator=finite_rk4_native) -> torch.Tensor:
    """Lagrangian advection of particle positions (N, d)."""
    return integrator(positions, velocity, dt, dx)


# ---------------------------------------------------------------------------
# the Field layer
# ---------------------------------------------------------------------------

def _sample_velocity(velocity, field):
    """The full velocity vector at the sample points of `field`."""
    return sample(velocity, field.geometry, at=field.sampled_at, boundary=field.boundary)


def euler(field, velocity, dt: float, v0=None):
    """First-order lookup points: field.points + dt·v."""
    if v0 is None:
        v0 = _sample_velocity(velocity, field)
    return field.points + dt * v0


def rk4(field, velocity, dt: float, v0=None):
    """4th-order Runge–Kutta end points of `field`'s sample points (JAX's
    `rk4`, `:27`): the velocity looked up at the points and at three
    intermediate points, through `sample`."""
    if v0 is None:
        v0 = _sample_velocity(velocity, field)
    pts = field.points
    vel_half = sample(velocity, Point(pts + 0.5 * dt * v0))
    vel_half2 = sample(velocity, Point(pts + 0.5 * dt * vel_half))
    vel_full = sample(velocity, Point(pts + dt * vel_half2))
    return pts + dt * ((1 / 6.) * (v0 + 2 * (vel_half + vel_half2) + vel_full))


def finite_rk4(field, velocity, dt: float, v0=None):
    """4th-order Runge–Kutta end points of `field`'s sample points with
    non-finite velocities taken as zero (JAX's `finite_rk4`, `:38`): a
    Tensor of the points' shape. A point cloud in a closed-box staggered
    grid from the origin with walls at rest (FLIP's) unwraps into
    `finite_rk4_native`; any other grid or points go through `sample`."""
    if v0 is None and field.is_point_cloud and _closed_staggered(velocity):
        comps, dx = staggered_point_arrays(velocity)
        flat, like = flat_points(field.points)
        return like(finite_rk4_native(flat, comps, dt, dx))
    if v0 is None:
        v0 = _sample_velocity(velocity, field)
    v0 = ops.nan_to_0(v0)
    pts = field.points
    vel_half = ops.nan_to_0(sample(velocity, Point(pts + 0.5 * dt * v0)))
    vel_half2 = ops.nan_to_0(sample(velocity, Point(pts + 0.5 * dt * vel_half)))
    vel_full = ops.nan_to_0(sample(velocity, Point(pts + dt * vel_half2)))
    return pts + dt * ((1 / 6.) * (v0 + 2 * (vel_half + vel_half2) + vel_full))


def points(points_, velocity, dt: float, integrator=euler):
    """Lagrangian advection of a point cloud (or a geometry or a Tensor of
    points): the geometry moved to the integrator's end points."""
    field = points_ if isinstance(points_, Field) else PointCloud(points_)
    lookup = integrator(field, velocity, dt)
    new_elements = field.geometry.at(lookup)
    result = field.with_geometry(new_elements)
    if isinstance(points_, Field):
        return result
    return result.geometry if isinstance(points_, Geometry) else result.center


def advect(field, velocity, dt, integrator=euler, **kwargs):
    """A point cloud by `points`, a grid by `semi_lagrangian`."""
    if field.is_point_cloud:
        return points(field, velocity, dt=dt, integrator=integrator)
    if field.is_grid:
        return semi_lagrangian(field, velocity, dt=dt, integrator=integrator, **kwargs)
    raise NotImplementedError(f"advection of {field}")


def differential(u, velocity, density: float = 1., order=2, implicit=None, upwind=True):
    """The advection term −(v·∇)u of a PDE's right-hand side on a grid: of a
    centred `u` with the centred gradient of `order` (2, 4 or 6) and the
    velocity at u's cells; of a staggered `u` component by component, the
    velocity sampled at each component's faces; of a mesh Field the
    conservative FVM term −∇·(v ⊗ u) with linear or upwind face values
    (`field/_mesh_math.py::mesh_advection_differential`)."""
    if u.is_mesh:
        from ..field._mesh_math import mesh_advection_differential
        return mesh_advection_differential(u, velocity, density=density, order=order, upwind=upwind)
    names = u.resolution.names
    if u.is_grid and u.is_centered:
        grad = spatial_gradient(u, at='center', order=order, stack_dim=channel('_gradient'))
        vel_c = velocity.at(u, order=order, implicit=implicit) \
            if (velocity.geometry != u.geometry or velocity.is_staggered) else velocity
        total = None
        for i, d in enumerate(names):
            term = vel_c.values[{'vector': d}] * grad.values[{'_gradient': i}]
            total = term if total is None else total + term
        return Field(u.geometry, -total * density, u.boundary)
    if u.is_grid and u.is_staggered:
        comps = []
        for dim in names:
            comp = u.vector[dim]
            grad = spatial_gradient(comp, at='center', order=order, stack_dim=channel('_gradient'))
            vel_at = sample(velocity, comp.geometry, at='center', order=order, implicit=implicit)
            total = None
            for i, d in enumerate(names):
                term = vel_at[{'vector': d}] * grad.values[{'_gradient': i}]
                total = term if total is None else total + term
            comps.append(-total * density)
        return Field(u.geometry, stack(comps, dual(vector=names)), u.boundary)
    raise NotImplementedError(f"advect.differential of a {type(u.geometry).__name__} Field comes with a later slice")


finite_difference = differential


def _check_field_step(field, max_cells, substeps):
    if not field.is_grid:
        raise NotImplementedError("semi_lagrangian / mac_cormack of a non-grid Field: a point cloud moves with "
                                  "`points`")
    if substeps == 'auto':
        if max_cells is None:
            raise ValueError("substeps='auto' requires the bounded window path (max_cells set)")
    elif not isinstance(substeps, int) or substeps < 1:
        raise ValueError(f"substeps={substeps!r}: a count ≥ 1 or 'auto' expected")


def _displacement(field, velocity, dt, integrator, v0=None):
    """The backtrace displacement in world units at `field`'s sample points
    (JAX's `_displacement`, `:120-130`): dt·v for `euler`, else the
    integrator's lookup points less the sample points."""
    if v0 is None:
        v0 = _sample_velocity(velocity, field)
    if integrator is euler:
        return dt * v0
    return integrator(field, velocity, dt, v0=v0) - field.points


def _window_lookup(field, velocity, dt_signed, integrator, max_cells: int):
    """The displacement of a window advection and how to apply it: (max
    |displacement| in cells, a 0-dim tensor; apply(field, scale, extrema,
    negate), the window lookups of `field` along scale × the displacement).
    `euler` in a staggered velocity takes the array layer's arrays
    (`_field_disp_natives`, dt/dx applied in the kernel); any other
    integrator or a centred velocity the displacement Tensor."""
    if integrator is euler and velocity.is_staggered:
        batch = _advect_batch(field, velocity)
        arrays, scales = _field_disp_natives(field, velocity, dt_signed, batch)

        def apply(f, scale=1.0, extrema=False, negate=False):
            return _window_values(f, (arrays, tuple(x * scale for x in scales)), batch, max_cells, extrema, negate)
        return _max_cells_of((arrays, scales), field.is_staggered), apply
    disp = _displacement(field, velocity, dt_signed, integrator)

    def apply(f, scale=1.0, extrema=False, negate=False):
        d = disp * scale if scale != 1.0 else disp
        return _window_interp_field(f, -d if negate else d, max_cells, extrema)
    return _max_cells_of_tensor(disp, field), apply


def _max_cells_of_tensor(displacement, field) -> torch.Tensor:
    """max |displacement / dx| over every component and axis: a 0-dim tensor (JAX's `_max_disp_cells`)."""
    names = field.resolution.names
    items = [displacement[{'~vector': d}] for d in names] if field.is_staggered and '~vector' in \
        displacement.shape else [displacement]
    maxima = []
    for item in items:
        cells = item / field.dx
        for d in names:
            maxima.append(torch.max(torch.abs(cells.vector[d].torch(cells.vector[d].shape.names))))
    return torch.stack(maxima).max()


def _substeps(m: torch.Tensor, max_cells: int, max_substeps: int) -> int:
    """n = clip(ceil(m / max_cells), 1, max_substeps) (JAX's `_auto_substep_window`, `:274-311`), read on
    the host: one device sync a call."""
    return int(min(max(math.ceil(float(m) / max_cells), 1), max_substeps))


def _auto_substeps(field, n: int, step):
    """The values of `step(field, scale)` applied n times with scale 1/n: the
    substeps of a frozen velocity reuse its displacement, divided by n."""
    if n <= 1:
        return step(field, 1.0)
    scale = float(np.float32(1.0) / np.float32(n))
    for _ in range(n):
        field = field.with_values(step(field, scale))
    return field.values


def _advect_batch(field, velocity):
    """The batch dims of an advection of `field` by `velocity`: both Fields'
    batch dims, merged (NotImplementedError for values with dims other than
    the grid's and batch dims)."""
    names = field.resolution.names
    tensors = lambda f: face_components(f.values) if f.is_staggered else [f.values]  # noqa: E731
    return merge_shapes(_batch_dims(tensors(field), names, 'advection'),
                        _batch_dims(tensors(velocity), names, 'advection'))


def _field_disp_natives(field, velocity, dt_signed, batch):
    """`_euler_disp_natives` of the array layer for a staggered velocity
    Field: (arrays, scales), the arrays (*batch, *grid) with the velocity's
    own batch dims of `batch` (size 1 for the others). The velocity lies on
    the field's grid in any face layout (closed, open or periodic by axis
    and side), a staggered field in its own; NotImplementedError for another
    grid."""
    names = field.resolution.names
    if velocity.geometry != field.geometry:
        raise NotImplementedError("advection by a staggered velocity on another grid than the field's comes with "
                                  "a later slice of the port")
    layout = _array_layout(velocity)
    field_layout = _array_layout(field) if field.is_staggered else None
    v_ext = [_native_extrap(velocity.boundary[{'vector': d}], names) for d in names]
    comps = face_components(velocity.values)
    order = batch.names + tuple(names)
    return _euler_disp_natives(field.is_staggered, [c.torch(order) for c in comps], dt_signed, _dx_tuple(field),
                               layout, v_ext, field_layout)


def _wrap_like(field, arrays, batch):
    """Result arrays (*batch, *grid) (one per component of a staggered field) as values of `field`'s grid."""
    names = field.resolution.names
    if field.is_staggered:
        return face_values([_batch_tensor(a, batch, c.shape.only(names, reorder=True)) for a, c in
                            zip(arrays, face_components(field.values))], field.values)
    return _batch_tensor(arrays, batch, field.values.shape.only(names, reorder=True))


def _field_extrap(field):
    names = field.resolution.names
    if field.is_staggered:
        return [_native_extrap(field.boundary[{'vector': d}], names) for d in names]
    return _native_extrap(field.boundary, names)


def _window_values(field, fast, batch, max_cells, extrema=False, negate=False):
    """`_window_interp_field_native` on the Field's arrays (*batch, *grid);
    values of `field`'s grid and `batch`, or (values, lower, upper) with
    `extrema`."""
    order = batch.names + tuple(field.resolution.names)
    arrays = tuple(c.torch(order) for c in face_components(field.values)) if field.is_staggered \
        else field.values.torch(order)
    result = _window_interp_field_native(arrays, fast, _field_extrap(field), max_cells, extrema, negate)
    if extrema:
        return tuple(_wrap_like(field, r, batch) for r in result)
    return _wrap_like(field, result, batch)


def _window_interp_field(field, displacement, max_cells: int, extrema=False):
    """Window-interpolate `field` at its own points displaced by
    `displacement` (world units, a `vector` dim): one array per component,
    and per entry of a centred field's channel dim."""
    names = field.resolution.names

    def window(values, disp, boundary):
        cells = disp / field.dx
        grid_shape = values.shape.only(names, reorder=True)
        channels = values.shape.without(names).without(values.shape.batch)
        batch = merge_shapes(values.shape.batch, cells.shape.batch)
        order = batch.names + tuple(names)
        # the window kernels take contiguous arrays: a component of values laid out with `vector` last is copied
        disps = []
        for n in names:
            c = cells.vector[n].torch(order)
            disps.append(c.expand(tuple(c.shape[:batch.rank]) + tuple(grid_shape.sizes)).contiguous())
        if channels.rank > 1 or (channels and not channels.channel):
            raise NotImplementedError(f"advection of values {values.shape}: batch dims and one channel dim at most "
                                      f"are ported")
        labels = channels.get_labels(channels.name) if channels else None
        entries = [{}] if not channels else [{channels.name: i} for i in range(channels.size)]
        # a vector-valued constant boundary gives each channel entry its component
        outs = [shift_window_interp(values[e].torch(order).contiguous(), disps,
                                    _native_extrap(boundary[{channels.name: labels[e[channels.name]] if labels else
                                                             e[channels.name]}] if e else boundary, names),
                                    max_cells, compute_extrema=extrema)
                for e in entries]
        outs = [o if extrema else (o,) for o in outs]
        result = []
        for k in range(3 if extrema else 1):
            pieces = [_batch_tensor(o[k], batch, grid_shape) for o in outs]
            result.append(pieces[0] if not channels else stack(pieces, channels))
        return tuple(result) if extrema else result[0]

    if field.is_staggered:
        results = [window(field.values[{'~vector': d}],
                          displacement[{'~vector': d}] if '~vector' in displacement.shape else displacement,
                          field.boundary[{'vector': d}])
                   for d in names]
        if extrema:
            return tuple(face_values([r[k] for r in results], field.values) for k in range(3))
        return face_values(results, field.values)
    return window(field.values, displacement, field.boundary)


def semi_lagrangian(field, velocity, dt: float, integrator=euler, max_cells: int = 2, substeps=1,
                    max_substeps: int = 4):
    """Backtrace + interpolate, exact while the CFL number ≤ `max_cells`
    (larger displacements are clamped); ``substeps=n`` applies n steps of
    dt/n, ``substeps='auto'`` n = ceil(max|disp| / max_cells) ≤
    `max_substeps` steps along the displacement / n (one host sync);
    ``max_cells=None`` looks the field up at the integrator's points by
    `reduce_sample` (a gather, JAX's unbounded route). Any integrator
    (`euler`, `rk4`, `finite_rk4`): the window lookups take the displacement
    it gives."""
    _check_field_step(field, max_cells, substeps)
    if substeps == 'auto':
        m, apply = _window_lookup(field, velocity, -dt, integrator, max_cells)
        return field.with_values(_auto_substeps(field, _substeps(m, max_cells, max_substeps),
                                                lambda f, scale: apply(f, scale)))
    if substeps > 1:
        for _ in range(substeps):
            field = semi_lagrangian(field, velocity, dt / substeps, integrator, max_cells)
        return field
    if max_cells is None:
        return field.with_values(reduce_sample(field, integrator(field, velocity, -dt)))
    _, apply = _window_lookup(field, velocity, -dt, integrator, max_cells)
    return field.with_values(apply(field))


def mac_cormack(field, velocity, dt: float, correction_strength=1.0, integrator=euler, max_cells: int = 2,
                substeps=1, max_substeps: int = 4):
    """MacCormack advection with the monotonicity clamp: a forward pass with
    the corner extrema, a backward pass along the negated displacement, the
    correction and the clip to the forward pass's corner values. Substeps
    as in `semi_lagrangian` ('auto' takes the `euler` displacement, as the
    JAX package does); ``max_cells=None`` looks up by `reduce_sample` at the
    integrator's backward and forward points and clamps to the values of
    the backward point's corners (JAX `:430-459`)."""
    _check_field_step(field, max_cells, substeps)
    if substeps == 'auto':
        m, apply = _window_lookup(field, velocity, -dt, euler, max_cells)
        return field.with_values(_auto_substeps(field, _substeps(m, max_cells, max_substeps),
                                                lambda f, scale: _mac_cormack_values(f, apply, scale,
                                                                                     correction_strength)))
    if substeps != 1:
        for _ in range(substeps):
            field = mac_cormack(field, velocity, dt / substeps, correction_strength, integrator, max_cells)
        return field
    if max_cells is None:
        return _mac_cormack_gather(field, velocity, dt, correction_strength, integrator)
    if integrator is euler:
        _, apply = _window_lookup(field, velocity, -dt, integrator, max_cells)
        return field.with_values(_mac_cormack_values(field, apply, 1.0, correction_strength))
    v0 = _sample_velocity(velocity, field)
    disp_bwd = _displacement(field, velocity, -dt, integrator, v0=v0)
    disp_fwd = _displacement(field, velocity, dt, integrator, v0=v0)
    fwd_vals, lim_lo, lim_up = _window_interp_field(field, disp_bwd, max_cells, extrema=True)
    fwd_adv = field.with_values(fwd_vals)
    bwd_adv = fwd_adv.with_values(_window_interp_field(fwd_adv, disp_fwd, max_cells))
    return field.with_values(_corrected(field, fwd_adv, bwd_adv, lim_lo, lim_up, correction_strength))


def _mac_cormack_values(field, apply, scale, correction_strength):
    """The values of one MacCormack step along scale × the displacement of
    `apply` (the forward pass along the negated one)."""
    fwd_vals, lim_lo, lim_up = apply(field, scale, extrema=True)
    fwd_adv = field.with_values(fwd_vals)
    bwd_adv = fwd_adv.with_values(apply(fwd_adv, scale, negate=True))
    return _corrected(field, fwd_adv, bwd_adv, lim_lo, lim_up, correction_strength)


def _corrected(field, fwd_adv, bwd_adv, lim_lo, lim_up, correction_strength):
    """fwd + strength/2 · (field − bwd), clipped to [lim_lo, lim_up] (component by component)."""
    new_field = fwd_adv + correction_strength * 0.5 * (field - bwd_adv)
    if field.is_staggered:
        names = field.resolution.names
        return stack([ops.clip(new_field.vector[d].values, lim_lo[{'~vector': d}], lim_up[{'~vector': d}])
                      for d in names], dual(vector=names))
    return ops.clip(new_field.values, lim_lo, lim_up)


def _mac_cormack_gather(field, velocity, dt, correction_strength, integrator):
    """MacCormack by gathers (JAX's `max_cells=None` route): `reduce_sample`
    at the backward and forward points, the clamp to the 2^d values around
    each backward point (`math.closest_grid_values`)."""
    v0 = _sample_velocity(velocity, field)
    points_bwd = integrator(field, velocity, -dt, v0=v0)
    points_fwd = integrator(field, velocity, dt, v0=v0)
    fwd_adv = field.with_values(reduce_sample(field, points_bwd))
    bwd_adv = fwd_adv.with_values(reduce_sample(fwd_adv, points_fwd))
    new_field = fwd_adv + correction_strength * 0.5 * (field - bwd_adv)
    names = field.resolution.names
    closest = [f"closest_{d}" for d in names]

    def limits(comp, pts):
        res = comp.values.shape.spatial
        local = (pts - comp.bounds.lower) / comp.bounds.size * wrap([float(n) for n in res.sizes],
                                                                    channel(vector=res.names)) - 0.5
        neighbours = ops.closest_grid_values(comp.values, local, comp.boundary, 'closest_')
        return ops.min_(neighbours, closest), ops.max_(neighbours, closest)

    if field.is_staggered:
        comps = []
        for d in names:
            pts = points_bwd[{'~vector': d}] if '~vector' in points_bwd.shape else points_bwd
            lo, up = limits(field.vector[d], pts)
            comps.append(ops.clip(new_field.vector[d].values, lo, up))
        return Field(field.geometry, stack(comps, dual(vector=names)), field.boundary)
    lo, up = limits(field, points_bwd)
    return new_field.with_values(ops.clip(new_field.values, lo, up))


def max_displacement_cells(field, velocity, dt, integrator=euler):
    """The largest backtrace displacement, in cells, that
    `semi_lagrangian(field, velocity, dt)` looks up: a 0-dim tensor on the
    velocity's device. At most max_cells certifies that the window is exact."""
    _check_field_step(field, 1, 1)
    return _window_lookup(field, velocity, -dt, integrator, 1)[0]

"""Advection — port of `phiflow_tpu/physics/advect.py`, in two layers.

The Field layer, with JAX's signatures: `semi_lagrangian` (`:338`) and
`mac_cormack` (`:393`) of a grid Field through a velocity Field, and
`max_displacement_cells`. With the `euler` integrator and a bounded window
(`max_cells`), a staggered velocity unwraps into `_euler_disp_natives` and
`_window_interp_field_native` below: the same calls of K6 (3D) or K7 (2D) as
the array layer makes. It must lie on the field's grid in a layout the array
layer has (the closed box or the periodic box); any other staggered velocity
raises NotImplementedError. A centred velocity (Burgers' equation advects
itself), which the array layer does not take, goes through the displacement
dt·v sampled at the field's points, divided by the cell size, and the same
window interpolation, one array per component. Batch dims of the field,
the velocity or both become leading axes of those calls, each input with
the batch dims it has (size 1 for the others): one launch a lookup for
the whole batch, an input without a batch shared by every entry.
`substeps='auto'`, the gather lookups (`max_cells=None`) and the
integrators other than `euler` come with a later slice.

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
(staggered, in the layout of `field/_resample.py`); the velocity is always
staggered. Either may carry leading batch axes, which broadcast (the
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

from typing import Sequence, Tuple, Union

import torch

from ..field._field import Field, face_components, face_values
from ..field._field_math import (_array_layout, _batch_dims, _batch_tensor, _dx_tuple, _layout, _native_extrap,
                                 spatial_gradient)
from ..field._point_cloud import PointCloud
from ..field._resample import sample, sample_grid_at_centers, sample_staggered_at_points, staggered_point_arrays
from ..geom import Geometry, Point
from ..geom._geom import flat_points
from ..math import Tensor, channel, dual, stack, _ops as ops
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


def _euler_disp_natives(staggered: bool, velocity: Sequence[torch.Tensor], dt_signed: float, dx, periodic: bool,
                        velocity_extrap=None):
    """Per-axis displacement arrays in velocity units at the field's sample
    points, and the scales dt/dx that turn them into cells (applied by the
    window kernel). A staggered field gets one list per component t, whose
    entry t is the velocity array itself."""
    ndim = len(velocity)
    scales = tuple(float(dt_signed) / h for h in _per_axis(dx, ndim))
    if velocity_extrap is None:
        velocity_extrap = PERIODIC if periodic else 0.0

    def disp_at(t):
        return [velocity[s] if s == t else
                sample_grid_at_centers(velocity[s], s, t, component_extrapolation(velocity_extrap, s), periodic,
                                       ndim)
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
                    periodic: bool = False, max_cells: int = 2, substeps: int = 1, velocity_extrap=None) -> Grid:
    """Backtrace + interpolate. `extrap` is the field's extrapolation (for a
    staggered field also one per component), `periodic` the velocity's box.
    The velocity's extrapolation is PERIODIC there, else the constant 0 of
    closed walls, unless `velocity_extrap` says otherwise (one per component
    allowed). Exact whenever the CFL number ≤ max_cells; larger displacements
    are clamped. ``substeps=n`` applies n steps of dt/n."""
    _check(field, velocity, max_cells, substeps)
    if substeps > 1:
        for _ in range(substeps):
            field = semi_lagrangian_native(field, velocity, dt / substeps, dx, extrap, periodic, max_cells,
                                    velocity_extrap=velocity_extrap)
        return field
    fast = _euler_disp_natives(_is_staggered(field), velocity, -dt, dx, periodic, velocity_extrap)
    return _window_interp_field_native(field, fast, extrap, max_cells)


def mac_cormack_native(field: Grid, velocity: Sequence[torch.Tensor], dt: float, dx, extrap,
                periodic: bool = False, correction_strength: float = 1.0, max_cells: int = 2,
                substeps: int = 1) -> Grid:
    """MacCormack advection with the monotonicity clamp: a forward pass with
    the corner extrema, a backward pass along the negated displacement (the
    same arrays, the sign flipped in the kernel), the correction and the clip
    to the forward pass's corner values."""
    _check(field, velocity, max_cells, substeps)
    if substeps != 1:
        for _ in range(substeps):
            field = mac_cormack_native(field, velocity, dt / substeps, dx, extrap, periodic, correction_strength,
                                max_cells)
        return field
    fast = _euler_disp_natives(_is_staggered(field), velocity, -dt, dx, periodic)  # backward displacement
    fwd, lim_lo, lim_up = _window_interp_field_native(field, fast, extrap, max_cells, extrema=True)
    bwd = _window_interp_field_native(fwd, fast, extrap, max_cells, negate=True)
    half = correction_strength * 0.5

    def combine(f, fw, bw, lo, up):
        return torch.minimum(torch.maximum(fw + half * (f - bw), lo), up)

    if _is_staggered(field):
        return tuple(combine(*parts) for parts in zip(field, fwd, bwd, lim_lo, lim_up))
    return combine(field, fwd, bwd, lim_lo, lim_up)


def max_displacement_cells_native(field: Grid, velocity: Sequence[torch.Tensor], dt: float, dx,
                           periodic: bool = False) -> torch.Tensor:
    """The largest backtrace displacement, in cells, that
    `semi_lagrangian_native(field, velocity, dt)` looks up: a 0-dim tensor. At most
    max_cells certifies that the bounded window is exact."""
    disps, scales = _euler_disp_natives(_is_staggered(field), velocity, -dt, dx, periodic)
    lists = disps if _is_staggered(field) else [disps]
    maxima = [torch.max(torch.abs(arr)) * abs(scales[axis]) for per_axis in lists
              for axis, arr in enumerate(per_axis)]
    return torch.stack(maxima).max()


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
    """4th-order Runge–Kutta end points of a point cloud's points in the
    staggered `velocity`, non-finite velocities taken as zero
    (`finite_rk4_native`): a Tensor of the points' shape."""
    if v0 is not None:
        raise NotImplementedError("finite_rk4 from a caller's v0 comes with a later slice of the port")
    if not field.is_point_cloud:
        raise NotImplementedError("finite_rk4 of a grid Field comes with a later slice of the port")
    comps, dx = staggered_point_arrays(velocity)
    flat, like = flat_points(field.points)
    return like(finite_rk4_native(flat, comps, dt, dx))


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


def _check_field_step(field, max_cells, substeps, integrator):
    if substeps == 'auto':
        raise NotImplementedError("substeps='auto' picks the substep count on the device; it comes with a later "
                                  "slice of the port (pass a fixed count)")
    if not field.is_grid:
        raise NotImplementedError("semi_lagrangian / mac_cormack of a non-grid Field: a point cloud moves with "
                                  "`points`")
    if max_cells is None:
        raise NotImplementedError("max_cells=None is the unbounded gather lookup; it comes with a later slice")
    if integrator is not euler:
        raise NotImplementedError("integrators other than `euler` come with a later slice of the port")


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
    the field's grid in the closed box or the periodic box, and a staggered
    field has its layout; NotImplementedError otherwise."""
    names = field.resolution.names
    if velocity.geometry != field.geometry:
        raise NotImplementedError("advection by a staggered velocity on another grid than the field's comes with "
                                  "a later slice of the port")
    layout = _array_layout(velocity, names)
    if field.is_staggered and _layout(field) != layout:
        raise NotImplementedError(f"a staggered field of boundary {field.boundary!r} in a velocity of boundary "
                                  f"{velocity.boundary!r}: one face layout for both is ported")
    v_ext = [_native_extrap(velocity.boundary[{'vector': d}], names) for d in names]
    comps = face_components(velocity.values)
    order = batch.names + tuple(names)
    return _euler_disp_natives(field.is_staggered, [c.torch(order) for c in comps], dt_signed, _dx_tuple(field),
                               layout == 'periodic', v_ext)


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
    ext = _field_extrap(field)

    def window(values, disp, extrap):
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
        parts = [values] if not channels else [values[{channels.name: i}] for i in range(channels.size)]
        outs = [shift_window_interp(p.torch(order).contiguous(), disps, extrap, max_cells, compute_extrema=extrema)
                for p in parts]
        outs = [o if extrema else (o,) for o in outs]
        result = []
        for k in range(3 if extrema else 1):
            pieces = [_batch_tensor(o[k], batch, grid_shape) for o in outs]
            result.append(pieces[0] if not channels else stack(pieces, channels))
        return tuple(result) if extrema else result[0]

    if field.is_staggered:
        results = [window(field.values[{'~vector': d}],
                          displacement[{'~vector': d}] if '~vector' in displacement.shape else displacement, e)
                   for d, e in zip(names, ext)]
        if extrema:
            return tuple(face_values([r[k] for r in results], field.values) for k in range(3))
        return face_values(results, field.values)
    return window(field.values, displacement, ext)


def semi_lagrangian(field, velocity, dt: float, integrator=euler, max_cells: int = 2, substeps=1,
                    max_substeps: int = 4):
    """Backtrace + interpolate, exact while the CFL number ≤ `max_cells`
    (larger displacements are clamped); ``substeps=n`` applies n steps of dt/n."""
    _check_field_step(field, max_cells, substeps, integrator)
    if substeps > 1:
        for _ in range(substeps):
            field = semi_lagrangian(field, velocity, dt / substeps, integrator, max_cells)
        return field
    if velocity.is_staggered:
        batch = _advect_batch(field, velocity)
        return field.with_values(_window_values(field, _field_disp_natives(field, velocity, -dt, batch), batch,
                                                max_cells))
    disp = -dt * _sample_velocity(velocity, field)
    return field.with_values(_window_interp_field(field, disp, max_cells))


def mac_cormack(field, velocity, dt: float, correction_strength=1.0, integrator=euler, max_cells: int = 2,
                substeps=1, max_substeps: int = 4):
    """MacCormack advection with the monotonicity clamp: a forward pass with
    the corner extrema, a backward pass along the negated displacement, the
    correction and the clip to the forward pass's corner values."""
    _check_field_step(field, max_cells, substeps, integrator)
    if substeps != 1:
        for _ in range(substeps):
            field = mac_cormack(field, velocity, dt / substeps, correction_strength, integrator, max_cells)
        return field
    if velocity.is_staggered:
        batch = _advect_batch(field, velocity)
        fast = _field_disp_natives(field, velocity, -dt, batch)
        fwd_vals, lim_lo, lim_up = _window_values(field, fast, batch, max_cells, extrema=True)
        fwd_adv = field.with_values(fwd_vals)
        bwd_adv = fwd_adv.with_values(_window_values(fwd_adv, fast, batch, max_cells, negate=True))
    else:
        v0 = _sample_velocity(velocity, field)
        fwd_vals, lim_lo, lim_up = _window_interp_field(field, -dt * v0, max_cells, extrema=True)
        fwd_adv = field.with_values(fwd_vals)
        bwd_adv = fwd_adv.with_values(_window_interp_field(fwd_adv, dt * v0, max_cells))
    new_field = fwd_adv + correction_strength * 0.5 * (field - bwd_adv)
    if field.is_staggered:
        names = field.resolution.names
        comps = [ops.clip(new_field.vector[d].values, lim_lo[{'~vector': d}], lim_up[{'~vector': d}]) for d in names]
        return field.with_values(stack(comps, dual(vector=names)))
    return field.with_values(ops.clip(new_field.values, lim_lo, lim_up))


def max_displacement_cells(field, velocity, dt, integrator=euler):
    """The largest backtrace displacement, in cells, that
    `semi_lagrangian(field, velocity, dt)` looks up: a 0-dim tensor on the
    velocity's device. At most max_cells certifies that the window is exact."""
    _check_field_step(field, 1, 1, integrator)
    if velocity.is_staggered:
        disps, scales = _field_disp_natives(field, velocity, -dt, _advect_batch(field, velocity))
        lists = disps if field.is_staggered else [disps]
        return torch.stack([torch.max(torch.abs(arr)) * abs(scales[axis]) for per_axis in lists
                            for axis, arr in enumerate(per_axis)]).max()
    cells = (-dt * _sample_velocity(velocity, field)) / field.dx
    return ops.max_(abs(cells), None).torch()

"""Advection on raw tensors: grids by semi-Lagrangian and MacCormack lookups,
particles by `points` with the `finite_rk4` integrator.

The grid schemes port the bounded-window fast path of `phiflow_tpu/physics/advect.py`: the `euler`
integrator with `max_cells` set, which is what `semi_lagrangian` (`:338`,
branch `:362-366`) and `mac_cormack` (`:393`, branch `:412-427`) run for a
uniform grid advected by a staggered velocity of the same resolution.

A field is a tensor (centred) or a sequence of face-component tensors
(staggered, in the layout of `field/_resample.py`); the velocity is always
staggered. A staggered grid's extrapolation may be a sequence, one entry per
component (the lid of a cavity moves one component's wall value only). The backtrace displacements are built per axis from the velocity
arrays, unscaled — the own component of a staggered target aliases its
velocity array, the others are 2-point averages per shifted axis — and the
window kernels (K6 in 3D, K7 in 2D) apply −dt/dx, the sign and the ±max_cells
clamp in registers.

`points` (`:109-117`) and `finite_rk4` (`:50-61`) move the particles of the
FLIP model through a closed-box staggered velocity, NaN velocities (the unset
cells of a FLIP grid) counting as zero.

Not ported yet, waiting for the named-dim core: the integrators `euler` and
`rk4` for points and lookups, `substeps='auto'`, `differential`, and the gather
branches (`max_cells=None`).
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from ..field._resample import sample_grid_at_centers, sample_staggered_at_points
from ..math._nd import PERIODIC, Extrapolation, component_extrapolation, shift_window_interp

__all__ = ['semi_lagrangian', 'mac_cormack', 'max_displacement_cells', 'finite_rk4', 'points']

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
                sample_grid_at_centers(velocity[s], s, t, component_extrapolation(velocity_extrap, s), periodic)
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
    if (_is_staggered(field) and len(comps) != ndim) or any(c.ndim != ndim for c in comps):
        raise NotImplementedError(
            f"field of shape(s) {[tuple(c.shape) for c in comps]} with a {ndim}D velocity: leading batch "
            f"axes come with the batched-smoke slice of the port")


def semi_lagrangian(field: Grid, velocity: Sequence[torch.Tensor], dt: float, dx, extrap,
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
            field = semi_lagrangian(field, velocity, dt / substeps, dx, extrap, periodic, max_cells,
                                    velocity_extrap=velocity_extrap)
        return field
    fast = _euler_disp_natives(_is_staggered(field), velocity, -dt, dx, periodic, velocity_extrap)
    return _window_interp_field_native(field, fast, extrap, max_cells)


def mac_cormack(field: Grid, velocity: Sequence[torch.Tensor], dt: float, dx, extrap,
                periodic: bool = False, correction_strength: float = 1.0, max_cells: int = 2,
                substeps: int = 1) -> Grid:
    """MacCormack advection with the monotonicity clamp: a forward pass with
    the corner extrema, a backward pass along the negated displacement (the
    same arrays, the sign flipped in the kernel), the correction and the clip
    to the forward pass's corner values."""
    _check(field, velocity, max_cells, substeps)
    if substeps != 1:
        for _ in range(substeps):
            field = mac_cormack(field, velocity, dt / substeps, dx, extrap, periodic, correction_strength,
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


def max_displacement_cells(field: Grid, velocity: Sequence[torch.Tensor], dt: float, dx,
                           periodic: bool = False) -> torch.Tensor:
    """The largest backtrace displacement, in cells, that
    `semi_lagrangian(field, velocity, dt)` looks up: a 0-dim tensor. At most
    max_cells certifies that the bounded window is exact."""
    disps, scales = _euler_disp_natives(_is_staggered(field), velocity, -dt, dx, periodic)
    lists = disps if _is_staggered(field) else [disps]
    maxima = [torch.max(torch.abs(arr)) * abs(scales[axis]) for per_axis in lists
              for axis, arr in enumerate(per_axis)]
    return torch.stack(maxima).max()


def _nan_to_0(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def finite_rk4(positions: torch.Tensor, velocity: Sequence[torch.Tensor], dt: float, dx) -> torch.Tensor:
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


def points(positions: torch.Tensor, velocity: Sequence[torch.Tensor], dt: float, dx,
           integrator=finite_rk4) -> torch.Tensor:
    """Lagrangian advection of particle positions (N, d)."""
    return integrator(positions, velocity, dt, dx)

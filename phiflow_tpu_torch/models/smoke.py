"""Buoyant smoke plume in 2D and 3D — port of
`phiflow_tpu/models/smoke.py::SmokePlume`.

One step: MacCormack advection of the smoke with a soft-sphere inflow,
semi-Lagrangian self-advection of the staggered velocity with buoyancy along
the last axis, then the pressure projection (CG, preconditioned by the
multigrid V-cycle). The advection takes one of two paths, chosen as the JAX
model chooses:

* the fused path (`_fused_advect`: three calls of K5) for a 3D grid the fused
  kernel supports, unless the step is differentiated (K5 has no backward);
* the per-phase path (`advect_smoke`, `advect_velocity` through
  `physics/advect.py`: K6 in 3D, K7 in 2D) for everything else, a batched
  state among them (JAX's gate refuses batch dims).

`batch_shape` (a batch Shape, as JAX's `expand(smoke0.values, batch_shape)`
takes it) gives the initial smoke those batch dims; the velocity and the
pressure start without them and take them from the smoke through the
buoyancy. Every phase runs once for the whole batch: one launch of each
kernel a lookup, a smooth, a transfer or a matvec, one CG loop for all
entries (`physics/fluid.py`). In the array layer the batch is the leading
axes of every array (one axis for `initial_state_native`, the batch's
entries flattened), an array without them shared by every entry.

`initial_state()`, `step(velocity, smoke, pressure)` and the phases are JAX's,
on Fields: the velocity a StaggeredGrid, the smoke and the pressure
CenteredGrids. They unwrap into the array layer below: `_fused_advect` into
`_fused_advect_native` (K5), the per-phase methods into the Field functions
of `physics/advect.py` and `physics/fluid.py`, which reach the same kernels.
The array layer's methods end in `_native` and take JAX's raw layout:
``velocity`` is a tuple of the face components as
``velocity.vector[d].values.native(order)`` gives them — in the closed box
N−1 interior faces on the own axis, in the periodic box N — and ``smoke`` and
``pressure`` are (N,)·dims float32. `state_fields` / `state_natives` cross
between the two without a copy.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..field import CenteredGrid, Field, StaggeredGrid, face_layout, resample
from ..field._resample import sample_grid_at_centers
from ..geom import Box, Sphere
from ..math import EMPTY_SHAPE, ConvergenceException, Solve, dual, expand, extrapolation, stack
from ..math._nd import BOUNDARY, PERIODIC
from ..ops.advect3d import OutSpec, Source, fused_advect_3d
from ..physics import advect, fluid
from ._fields import cell_native, cell_values, staggered_natives, staggered_values

__all__ = ['SmokePlume', 'state_from_numpy', 'state_to_numpy']

Velocity = Tuple[torch.Tensor, ...]


def _fused_advect_supported(N, K: int) -> bool:
    """The gate of `phiflow_tpu/ops/advect3d.py::supported`, kept so that the
    port takes the fused path exactly where the JAX model does."""
    return min(N) >= 8 and N[2] >= 64 and 1 <= K <= 7


class SmokePlume:
    """2D/3D buoyant smoke in a closed or periodic box: MacCormack smoke
    advection + semi-Lagrangian self-advection + pressure projection (CG,
    tolerance cg_tol).

    The constructor takes JAX's arguments. Float32 runs, batched or not;
    `max_cells=None` is JAX's unbounded lookup: both advection phases gather
    at the back-traced points (`physics/advect.py`, no window kernel), and
    the fused path is gated off, as JAX's `_fused_advect_available` does."""

    def __init__(self, resolution: int = 64, dims: int = 2, buoyancy: float = 0.1,
                 inflow_rate: float = 0.2, dt: float = 0.5, cg_tol: float = 1e-3,
                 max_iterations: int = 1000, batch_shape=None, max_cells: int = 1,
                 size: float = None, periodic: bool = False, device=None):
        if dims not in (2, 3):
            raise ValueError(f"dims must be 2 or 3, got {dims}")
        self.device = resolve_device(device)
        names = ['x', 'y', 'z'][:dims]
        sizes = {n: resolution for n in names}
        size = float(resolution) if size is None else float(size)
        bounds = Box(**{n: size for n in names})
        self.buoyancy_dir = tuple(0. if i < dims - 1 else buoyancy for i in range(dims))
        inflow_center = {n: size / 2 for n in names}
        inflow_center[names[-1]] = size / 8
        self.inflow = Sphere(radius=size / 10, **inflow_center)
        v_bc = extrapolation.PERIODIC if periodic else 0.
        s_bc = extrapolation.PERIODIC if periodic else extrapolation.BOUNDARY
        self.velocity0 = StaggeredGrid(0., v_bc, bounds=bounds, **sizes)
        smoke0 = CenteredGrid(0., s_bc, bounds=bounds, **sizes)
        if batch_shape is not None:
            smoke0 = smoke0.with_values(expand(smoke0.values, batch_shape))
        self.smoke0 = smoke0
        self.batch_shape = EMPTY_SHAPE if batch_shape is None else smoke0.values.shape.batch
        self.pressure0 = CenteredGrid(0., extrapolation.PERIODIC if periodic else extrapolation.BOUNDARY,
                                      bounds=bounds, **sizes)
        self._names = names
        self.dims = dims
        self.periodic = periodic
        self.dt = dt
        self.max_cells = max_cells
        self.cg_tol = cg_tol
        self.max_iterations = max_iterations
        self.buoyancy = buoyancy
        self.inflow_rate = inflow_rate
        self._resolution = resolution
        self._dx = size / resolution
        self._inflow_center = (size / 2,) * (dims - 1) + (size / 8,)
        self._inflow_radius = size / 10
        self._inflow_mask = None  # built at first use, on the state's device
        self.last_solve = None  # fluid SolveResult of the latest projection

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def _shapes(self):
        """(component shapes, cell shape) of this model's layout."""
        N = (self._resolution,) * self.dims
        comps = []
        for d in range(self.dims):
            shape = list(N)
            if not self.periodic:
                shape[d] -= 1
            comps.append(tuple(shape))
        return comps, N

    def initial_state_native(self) -> Tuple[Velocity, torch.Tensor, torch.Tensor]:
        """Zeros: the smoke with one leading axis of the batch's entries when
        the model is batched, the velocity and the pressure without."""
        comps, N = self._shapes()
        zeros = lambda shape: torch.zeros(shape, dtype=torch.float32, device=self.device)  # noqa: E731
        lead = (self.batch_shape.volume,) if self.batch_shape else ()
        return tuple(zeros(s) for s in comps), zeros(lead + N), zeros(N)

    def _state_matches(self, velocity: Velocity, smoke: torch.Tensor) -> bool:
        """Float32 arrays of this model's layout, each with leading batch axes or without."""
        comps, N = self._shapes()
        d = self.dims
        return (len(velocity) == d and all(tuple(v.shape[-d:]) == s for v, s in zip(velocity, comps))
                and tuple(smoke.shape[-d:]) == N and all(t.ndim >= d for t in (*velocity, smoke))
                and all(t.dtype == torch.float32 for t in (*velocity, smoke)))

    def _batched_native(self, *arrays) -> bool:
        return any(t is not None and t.ndim > self.dims for t in arrays)

    def _batch_of(self, *arrays):
        """The batch dims of arrays with leading batch axes: the model's
        `batch_shape` where its rank matches, else one dim `batch`."""
        from ..math import batch as batch_dims
        lead = next(t.shape[:-self.dims] for t in arrays if t is not None and t.ndim > self.dims)
        if self.batch_shape.rank == len(lead):
            return self.batch_shape.with_sizes(tuple(lead))
        if len(lead) != 1:
            raise ValueError(f"arrays with leading axes {tuple(lead)}: give the model a batch_shape of that rank")
        return batch_dims(batch=lead[0])

    # ------------------------------------------------------------------
    # the fused path: both advection phases through three calls of K5
    # ------------------------------------------------------------------
    def _fused_advect_available_native(self, velocity: Velocity, smoke: torch.Tensor) -> bool:
        """JAX's gate: 3D, a bounded window, and a grid the fused kernel
        supports (`_fused_advect_supported`); and no gradient asked of the
        step: K5 is forward-only, so a step under grad whose state requires
        grad takes the per-phase path (K6 and K6ᵀ), as the JAX model does
        wherever it does not run its Pallas kernel. Decided by grad mode
        alone."""
        if torch.is_grad_enabled() and any(t.requires_grad for t in (*velocity, smoke)):
            return False
        if self._batched_native(*velocity, smoke):
            return False  # JAX's gate refuses batch dims (`phiflow_tpu/models/smoke.py:109`)
        return (self.dims == 3 and self.max_cells is not None
                and _fused_advect_supported((self._resolution,) * 3, self.max_cells))

    def _fused_advect_native(self, velocity: Velocity, smoke: torch.Tensor) -> Tuple[Velocity, torch.Tensor]:
        """Both advection phases through three fused calls. Returns (velocity', smoke')."""
        N = (self._resolution,) * 3
        K = self.max_cells
        dx = self._dx
        scales = (-self.dt / dx,) * 3  # velocity units → cells
        v_mode, s_mode = ('wrap', 'wrap') if self.periodic else ('const', 'edge')
        vel = [Source(velocity[d], own_axis=d, mode=v_mode, const=0.0) for d in range(3)]
        # --- call 1: MacCormack forward pass of the smoke + clamp extrema ---
        [(fwd, lo, up)] = fused_advect_3d(vel + [Source(smoke, mode=s_mode)], N, K,
                                          [OutSpec(slab=3, extrema=True)], scales)
        # --- call 2: backward pass + combine + clamp + inflow + lift plane ---
        # lift row a pairs with face a+1; its last row wraps, ½(s[N−1] + s[0]),
        # which is the periodic box's face N ≡ face 0 (the closed box has no such row)
        ball = tuple(c / dx for c in self._inflow_center) + (self._inflow_radius / dx, self.inflow_rate)
        [(smoke_new, lift)] = fused_advect_3d(
            vel + [Source(fwd, mode=s_mode)], N, K,
            [OutSpec(slab=3, negate=True, combine=(0, 1, 2, 1.0), add_ball=ball,
                     emit_lift=(2, self.buoyancy * self.dt))],
            scales, blocked_extras=[smoke, lo, up])
        # --- call 3: staggered self-advection + buoyancy on the last axis ---
        outs = [OutSpec(slab=d, d_own=d) for d in range(3)]
        outs[2] = outs[2]._replace(add_blocked=(0, 1.0))
        new_velocity = fused_advect_3d(vel, N, K, outs, scales, blocked_extras=[lift])
        if self.periodic:
            # rows are faces 1..N with face N ≡ face 0: roll to faces 0..N−1
            new_velocity = [torch.roll(c, 1, d) for d, c in enumerate(new_velocity)]
        return tuple(new_velocity), smoke_new

    # ------------------------------------------------------------------
    # the per-phase path: K6 (3D) / K7 (2D) through physics/advect.py
    # ------------------------------------------------------------------
    def _inflow_mask_values_native(self, smoke: torch.Tensor) -> torch.Tensor:
        """Soft inflow mask: the fraction of each cell inside the inflow
        sphere, a smooth band one cell wide; coordinates are physical,
        (i+½)·dx. Built once per model and device."""
        if self._inflow_mask is None or self._inflow_mask.device != smoke.device:
            dx = self._dx
            d2 = None
            for ax in range(self.dims):
                c = (torch.arange(self._resolution, dtype=torch.float32, device=smoke.device) + 0.5) * dx
                c = c.reshape((-1,) + (1,) * (self.dims - ax - 1))
                t = (c - self._inflow_center[ax]) ** 2
                d2 = t if d2 is None else d2 + t
            dist = torch.sqrt(d2)
            self._inflow_mask = torch.clamp(0.5 + (self._inflow_radius - dist) / dx, 0., 1.)
        return self._inflow_mask

    def advect_smoke_native(self, velocity: Velocity, smoke: torch.Tensor) -> torch.Tensor:
        """Phase 1: MacCormack smoke advection + soft inflow."""
        adv = advect.mac_cormack_native(smoke, velocity, self.dt, self._dx, PERIODIC if self.periodic else BOUNDARY,
                                        self.periodic, max_cells=self.max_cells)
        return adv + self.inflow_rate * self._inflow_mask_values_native(smoke)

    def advect_velocity_native(self, velocity: Velocity, smoke: torch.Tensor) -> Velocity:
        """Phase 2: semi-Lagrangian self-advection + buoyancy. Buoyancy acts
        along the last axis only, so the smoke is averaged onto that
        component's faces alone."""
        adv = advect.semi_lagrangian_native(velocity, velocity, self.dt, self._dx,
                                            PERIODIC if self.periodic else 0.0, self.periodic,
                                            max_cells=self.max_cells)
        up = self.dims - 1
        lift = sample_grid_at_centers(smoke * (self.buoyancy * self.dt), None, up,
                                      PERIODIC if self.periodic else BOUNDARY, self.periodic, self.dims)
        return tuple(c + lift if d == up else c for d, c in enumerate(adv))

    def project_native(self, velocity: Velocity, pressure: Optional[torch.Tensor]):
        """Phase 3: pressure projection (MG-preconditioned CG); the solve's
        result is kept in `last_solve`."""
        velocity, pressure, self.last_solve = fluid.make_incompressible_native(
            velocity, pressure, self._dx, rel_tol=self.cg_tol, abs_tol=0.,
            max_iterations=self.max_iterations, faces=face_layout(self.periodic, self.dims))
        return velocity, pressure

    def step_native(self, velocity: Velocity, smoke: torch.Tensor, pressure: Optional[torch.Tensor]):
        if not self._state_matches(velocity, smoke):
            raise ValueError("state does not match this model's float32 layout "
                             f"(components {self._shapes()[0]}, cells {self._shapes()[1]})")
        if self._fused_advect_available_native(velocity, smoke):
            velocity, smoke = self._fused_advect_native(velocity, smoke)
        else:
            smoke = self.advect_smoke_native(velocity, smoke)
            velocity = self.advect_velocity_native(velocity, smoke)
        velocity, pressure = self.project_native(velocity, pressure)
        return velocity, smoke, pressure

    # ------------------------------------------------------------------
    # JAX's face: Fields, unwrapping into the array layer above
    # ------------------------------------------------------------------
    def initial_state(self) -> Tuple[Field, Field, Field]:
        from . import to_device
        return to_device((self.velocity0, self.smoke0, self.pressure0), self.device)

    def state_fields(self, velocity: Velocity, smoke: torch.Tensor, pressure: Optional[torch.Tensor]):
        """The array state as JAX's Fields, the tensors kept as they are; a
        pressure of None stays None. Leading batch axes become the model's
        batch dims (`_batch_of`)."""
        b = self._batch_of(*velocity, smoke, pressure) if self._batched_native(*velocity, smoke, pressure) \
            else EMPTY_SHAPE
        return (self.velocity0.with_values(staggered_values(self.velocity0, velocity, b)),
                self.smoke0.with_values(cell_values(self.smoke0, smoke, b)),
                None if pressure is None else self.pressure0.with_values(cell_values(self.pressure0, pressure, b)))

    def state_natives(self, velocity: Field, smoke: Field, pressure: Optional[Field]):
        """The Fields' raw tensors: (face components, smoke, pressure)."""
        return staggered_natives(velocity), cell_native(smoke), None if pressure is None else cell_native(pressure)

    def _inflow_mask_values(self, smoke: Field) -> Field:
        """The soft inflow mask of `_inflow_mask_values_native` as a Field on the smoke's grid."""
        return smoke.with_values(cell_values(smoke, self._inflow_mask_values_native(cell_native(smoke))))

    def _in_model_layout(self, velocity: Field, smoke: Field) -> bool:
        """Whether the Fields lie on this model's grid under its boundaries —
        the layout `_fused_advect_native` takes."""
        v_bc = extrapolation.PERIODIC if self.periodic else extrapolation.ZERO
        s_bc = extrapolation.PERIODIC if self.periodic else extrapolation.BOUNDARY
        return (velocity.is_grid and smoke.is_grid and velocity.is_staggered and smoke.is_centered
                and velocity.geometry == self.velocity0.geometry == smoke.geometry
                and velocity.boundary == v_bc and smoke.boundary == s_bc
                and not velocity.values.shape.batch and not smoke.values.shape.batch)

    def _fused_advect_available(self, velocity: Field, smoke: Field) -> bool:
        """JAX's gate on Fields. Its `pallas_ok()` term is the kernel's
        presence, which the port always has: on the CPU the plain twin is the
        CUDA kernel's oracle and runs in its place."""
        return self._in_model_layout(velocity, smoke) and self._fused_advect_available_native(
            staggered_natives(velocity), cell_native(smoke))

    def _fused_advect(self, velocity: Field, smoke: Field):
        """Both advection phases through three fused calls of K5
        (`_fused_advect_native` on the Fields' tensors). Returns (velocity', smoke')."""
        new_velocity, new_smoke = self._fused_advect_native(staggered_natives(velocity), cell_native(smoke))
        return (velocity.with_values(staggered_values(velocity, new_velocity)),
                smoke.with_values(cell_values(smoke, new_smoke)))

    def advect_smoke(self, velocity: Field, smoke: Field) -> Field:
        """Phase 1: MacCormack smoke advection + soft inflow."""
        return advect.mac_cormack(smoke, velocity, self.dt, max_cells=self.max_cells) + \
            self.inflow_rate * self._inflow_mask_values(smoke)

    def advect_velocity(self, velocity: Field, smoke: Field) -> Field:
        """Phase 2: buoyancy + semi-Lagrangian self-advection. Buoyancy acts
        along the last axis only, so only that face component takes the lift."""
        adv = advect.semi_lagrangian(velocity, velocity, self.dt, max_cells=self.max_cells)
        up = self._names[-1]
        lift = resample(smoke * (self.buoyancy_dir[-1] * self.dt), to=adv.vector[up])
        comps = [adv.vector[d].values + lift.values if d == up else adv.vector[d].values
                 for d in self._names]
        return adv.with_values(stack(comps, dual(vector=self._names)))

    def project(self, velocity: Field, pressure: Optional[Field]):
        """Phase 3: pressure projection (MG-preconditioned CG)."""
        return fluid.make_incompressible(
            velocity, (), Solve('CG', self.cg_tol, 0., x0=pressure, max_iterations=self.max_iterations,
                                suppress=(ConvergenceException,)))

    def step(self, velocity: Field, smoke: Field, pressure: Optional[Field]):
        if self._fused_advect_available(velocity, smoke):
            velocity, smoke = self._fused_advect(velocity, smoke)
        else:
            smoke = self.advect_smoke(velocity, smoke)
            velocity = self.advect_velocity(velocity, smoke)
        velocity, pressure = self.project(velocity, pressure)
        return velocity, smoke, pressure


def state_from_numpy(*arrays, device=None):
    """((v_0, …, v_{d−1}), smoke, pressure) as contiguous float32 tensors on
    `device` (CUDA by default) from numpy arrays in JAX's raw layout, given in
    this order: the 2 or 3 velocity components (closed-box or periodic
    layout), smoke, pressure."""
    if len(arrays) not in (4, 5):
        raise ValueError(f"expected 2 or 3 velocity components, smoke and pressure; got {len(arrays)} arrays")
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    *velocity, smoke, pressure = (t(a) for a in arrays)
    return tuple(velocity), smoke, pressure


def state_to_numpy(state):
    """(v_0, …, v_{d−1}, smoke, pressure) numpy float32 arrays of a model state."""
    velocity, smoke, pressure = state
    return tuple(a.detach().cpu().numpy() for a in (*velocity, smoke, pressure))

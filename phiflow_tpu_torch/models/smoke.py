"""Buoyant smoke plume in 2D and 3D — port of
`phiflow_tpu/models/smoke.py::SmokePlume`.

One step: MacCormack advection of the smoke with a soft-sphere inflow,
semi-Lagrangian self-advection of the staggered velocity with buoyancy along
the last axis, then the pressure projection (CG, preconditioned by the
multigrid V-cycle). The advection takes one of two paths, chosen as the JAX
model chooses:

* the fused path (`_fused_advect`: three calls of K5) for a 3D grid the fused
  kernel supports;
* the per-phase path (`advect_smoke`, `advect_velocity` through
  `physics/advect.py`: K6 in 3D, K7 in 2D) for everything else.

The state is JAX's raw layout: ``velocity`` is a tuple of the face components
as ``velocity.vector[d].values.native(order)`` gives them — in the closed box
N−1 interior faces on the own axis, in the periodic box N — and ``smoke`` and
``pressure`` are (N,)·dims float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..field._resample import sample_grid_at_centers
from ..math._nd import BOUNDARY, PERIODIC
from ..ops.advect3d import OutSpec, Source, fused_advect_3d
from ..physics import advect, fluid

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

    The constructor takes JAX's arguments. Unbatched float32 with `max_cells`
    ≥ 1 runs; `batch_shape` and `max_cells=None` raise NotImplementedError
    naming the later slice that brings them."""

    def __init__(self, resolution: int = 64, dims: int = 2, buoyancy: float = 0.1,
                 inflow_rate: float = 0.2, dt: float = 0.5, cg_tol: float = 1e-3,
                 max_iterations: int = 1000, batch_shape=None, max_cells: int = 1,
                 size: float = None, periodic: bool = False, device=None):
        if dims not in (2, 3):
            raise ValueError(f"dims must be 2 or 3, got {dims}")
        if batch_shape is not None:
            raise NotImplementedError("batched smoke needs the batched CG, V-cycle and projection and "
                                      "window interpolation with leading batch axes: a later slice")
        if max_cells is None:
            raise NotImplementedError("max_cells=None is the unbounded gather lookup (no window "
                                      "kernel): it comes with a later slice of the port")
        self.device = resolve_device(device)
        size = float(resolution) if size is None else float(size)
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

    def initial_state(self) -> Tuple[Velocity, torch.Tensor, torch.Tensor]:
        comps, N = self._shapes()
        zeros = lambda shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        return tuple(zeros(s) for s in comps), zeros(N), zeros(N)

    def _state_matches(self, velocity: Velocity, smoke: torch.Tensor) -> bool:
        comps, N = self._shapes()
        return (len(velocity) == self.dims and all(tuple(v.shape) == s for v, s in zip(velocity, comps))
                and tuple(smoke.shape) == N
                and all(t.dtype == torch.float32 for t in (*velocity, smoke)))

    # ------------------------------------------------------------------
    # the fused path: both advection phases through three calls of K5
    # ------------------------------------------------------------------
    def _fused_advect_available(self, velocity: Velocity, smoke: torch.Tensor) -> bool:
        """JAX's gate: 3D, a bounded window, and a grid the fused kernel
        supports (`_fused_advect_supported`)."""
        return (self.dims == 3 and self.max_cells is not None
                and _fused_advect_supported((self._resolution,) * 3, self.max_cells))

    def _fused_advect(self, velocity: Velocity, smoke: torch.Tensor) -> Tuple[Velocity, torch.Tensor]:
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
    def _inflow_mask_values(self, smoke: torch.Tensor) -> torch.Tensor:
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

    def advect_smoke(self, velocity: Velocity, smoke: torch.Tensor) -> torch.Tensor:
        """Phase 1: MacCormack smoke advection + soft inflow."""
        adv = advect.mac_cormack_native(smoke, velocity, self.dt, self._dx, PERIODIC if self.periodic else BOUNDARY,
                                 self.periodic, max_cells=self.max_cells)
        return adv + self.inflow_rate * self._inflow_mask_values(smoke)

    def advect_velocity(self, velocity: Velocity, smoke: torch.Tensor) -> Velocity:
        """Phase 2: semi-Lagrangian self-advection + buoyancy. Buoyancy acts
        along the last axis only, so the smoke is averaged onto that
        component's faces alone."""
        adv = advect.semi_lagrangian_native(velocity, velocity, self.dt, self._dx, PERIODIC if self.periodic else 0.0,
                                     self.periodic, max_cells=self.max_cells)
        up = self.dims - 1
        lift = sample_grid_at_centers(smoke * (self.buoyancy * self.dt), None, up,
                                      PERIODIC if self.periodic else BOUNDARY, self.periodic)
        return tuple(c + lift if d == up else c for d, c in enumerate(adv))

    def project(self, velocity: Velocity, pressure: Optional[torch.Tensor]):
        """Phase 3: pressure projection (MG-preconditioned CG); the solve's
        result is kept in `last_solve`."""
        velocity, pressure, self.last_solve = fluid.make_incompressible_native(
            velocity, pressure, self._dx, rel_tol=self.cg_tol, abs_tol=0.,
            max_iterations=self.max_iterations, periodic=self.periodic)
        return velocity, pressure

    def step(self, velocity: Velocity, smoke: torch.Tensor, pressure: Optional[torch.Tensor]):
        if not self._state_matches(velocity, smoke):
            raise ValueError("state does not match this model's float32 layout "
                             f"(components {self._shapes()[0]}, cells {self._shapes()[1]})")
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

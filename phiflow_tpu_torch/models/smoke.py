"""Buoyant 3D smoke plume — port of `phiflow_tpu/models/smoke.py::SmokePlume`.

One step: MacCormack advection of the smoke with a soft-sphere inflow and
semi-Lagrangian self-advection of the staggered velocity with buoyancy (three
calls of the fused advection, K5), then the pressure projection (CG on K1,
preconditioned by the V-cycle on K2–K4).

The state is JAX's raw layout: ``velocity`` is a tuple of the x, y, z face
components as ``velocity.vector[d].values.native(('x', 'y', 'z'))`` gives them
(closed box: N−1 interior faces on the own axis), ``smoke`` and ``pressure``
are (N, N, N) float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.advect3d import OutSpec, Source, fused_advect_3d
from ..physics import fluid

__all__ = ['SmokePlume', 'state_from_numpy', 'state_to_numpy']

Velocity = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class SmokePlume:
    """3D buoyant smoke in a closed box: MacCormack smoke advection +
    semi-Lagrangian self-advection + pressure projection (CG, tolerance cg_tol).

    The constructor takes JAX's arguments. This port covers the closed box with
    `max_cells` ≥ 1 in 3D, unbatched, float32; the other configurations raise
    NotImplementedError naming the later slice that brings them."""

    def __init__(self, resolution: int = 64, dims: int = 2, buoyancy: float = 0.1,
                 inflow_rate: float = 0.2, dt: float = 0.5, cg_tol: float = 1e-3,
                 max_iterations: int = 1000, batch_shape=None, max_cells: int = 1,
                 size: float = None, periodic: bool = False, device=None):
        if dims != 3:
            raise NotImplementedError("2D smoke comes with the slice of the 2D models "
                                      "(window_interp_2d, K7); this port runs dims=3")
        if batch_shape is not None:
            raise NotImplementedError("batched smoke takes the per-phase advection path "
                                      "(window_interp_3d, K6), a later slice")
        if max_cells is None:
            raise NotImplementedError("max_cells=None (adaptive window) takes the per-phase "
                                      "advection path (window_interp_3d, K6), a later slice")
        if periodic:
            raise NotImplementedError("the periodic box comes with a later slice of the 3D smoke model")
        self.device = resolve_device(device)
        size = float(resolution) if size is None else float(size)
        self.dt = dt
        self.max_cells = max_cells
        self.cg_tol = cg_tol
        self.max_iterations = max_iterations
        self.buoyancy = buoyancy
        self.inflow_rate = inflow_rate
        self._resolution = resolution
        self._dx = size / resolution
        self._inflow_center = (size / 2, size / 2, size / 8)
        self._inflow_radius = size / 10
        self.last_solve = None  # fluid SolveResult of the latest projection

    def initial_state(self) -> Tuple[Velocity, torch.Tensor, torch.Tensor]:
        N = self._resolution
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        velocity = (zeros(N - 1, N, N), zeros(N, N - 1, N), zeros(N, N, N - 1))
        return velocity, zeros(N, N, N), zeros(N, N, N)

    def _fused_advect_available(self, velocity: Velocity, smoke: torch.Tensor) -> bool:
        """Whether the state is one the fused advection takes: the closed
        box's component shapes and an (N, N, N) float32 smoke."""
        N = self._resolution
        shapes = [(N - 1, N, N), (N, N - 1, N), (N, N, N - 1)]
        return (len(velocity) == 3 and all(tuple(v.shape) == s for v, s in zip(velocity, shapes))
                and tuple(smoke.shape) == (N, N, N)
                and all(t.dtype == torch.float32 for t in (*velocity, smoke)))

    def _fused_advect(self, velocity: Velocity, smoke: torch.Tensor) -> Tuple[Velocity, torch.Tensor]:
        """Both advection phases through three fused calls. Returns (velocity', smoke')."""
        N = (self._resolution,) * 3
        K = self.max_cells
        dx = self._dx
        scales = (-self.dt / dx,) * 3  # velocity units → cells
        vel = [Source(velocity[d], own_axis=d, mode='const', const=0.0) for d in range(3)]
        # --- call 1: MacCormack forward pass of the smoke + clamp extrema ---
        [(fwd, lo, up)] = fused_advect_3d(vel + [Source(smoke, mode='edge')], N, K,
                                          [OutSpec(slab=3, extrema=True)], scales)
        # --- call 2: backward pass + combine + clamp + inflow + lift plane ---
        ball = tuple(c / dx for c in self._inflow_center) + (self._inflow_radius / dx, self.inflow_rate)
        [(smoke_new, lift)] = fused_advect_3d(
            vel + [Source(fwd, mode='edge')], N, K,
            [OutSpec(slab=3, negate=True, combine=(0, 1, 2, 1.0), add_ball=ball,
                     emit_lift=(2, self.buoyancy * self.dt))],
            scales, blocked_extras=[smoke, lo, up])
        # --- call 3: staggered self-advection + buoyancy on the last axis ---
        outs = [OutSpec(slab=d, d_own=d) for d in range(3)]
        outs[2] = outs[2]._replace(add_blocked=(0, 1.0))
        new_velocity = tuple(fused_advect_3d(vel, N, K, outs, scales, blocked_extras=[lift]))
        return new_velocity, smoke_new

    def project(self, velocity: Velocity, pressure: Optional[torch.Tensor]):
        """Pressure projection (MG-preconditioned CG); the solve's result is
        kept in `last_solve`."""
        velocity, pressure, self.last_solve = fluid.make_incompressible(
            velocity, pressure, self._dx, rel_tol=self.cg_tol, abs_tol=0.,
            max_iterations=self.max_iterations)
        return velocity, pressure

    def step(self, velocity: Velocity, smoke: torch.Tensor, pressure: Optional[torch.Tensor]):
        if not self._fused_advect_available(velocity, smoke):
            raise ValueError("state does not match this model's closed-box float32 layout")
        velocity, smoke = self._fused_advect(velocity, smoke)
        velocity, pressure = self.project(velocity, pressure)
        return velocity, smoke, pressure


def state_from_numpy(vx, vy, vz, smoke, pressure, device=None):
    """((vx, vy, vz), smoke, pressure) as contiguous float32 tensors on `device`
    (CUDA by default) from numpy arrays in JAX's raw layout."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    return (t(vx), t(vy), t(vz)), t(smoke), t(pressure)


def state_to_numpy(state):
    """(vx, vy, vz, smoke, pressure) numpy float32 arrays of a model state."""
    (vx, vy, vz), smoke, pressure = state
    return tuple(a.detach().cpu().numpy() for a in (vx, vy, vz, smoke, pressure))

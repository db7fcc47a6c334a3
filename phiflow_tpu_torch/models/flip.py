"""FLIP liquid in a closed box, 2D and 3D — port of
`phiflow_tpu/models/flip.py::FlipLiquid`.

One step: scatter the particle velocities onto the staggered grid (P2G: one
mean scatter per face grid, K8 in 3D) and extend them one cell into the empty
faces; scatter the occupancy onto the cells; add gravity and project with the
occupied cells active (CG on K1's masked form, Chebyshev-preconditioned, warm
started at the previous pressure); give the particles the grid's velocity
change (G2P, the FLIP update), move them with `finite_rk4` through the new
grid velocity and pull those that left the box back in.

`initial_state()` and `step(particles, pressure)` are JAX's, on Fields: the
particles a point cloud (spheres at a Tensor of points, one velocity
vector a point, a NaN boundary), the pressure a CenteredGrid. The body is
JAX's, line by line: `resample(particles, StaggeredGrid, scatter=True)` and
`resample(mask(particles), CenteredGrid, scatter=True)` unwrap into
`scatter_to_grid` (K8), `advect.points` with `finite_rk4` into
`finite_rk4_native`, `boundary_push` into `box_push`.

The array layer (`*_native`): ``positions`` and ``velocities`` are (N, dims)
float32, ``pressure`` is (resolution,)·dims float32. The grid velocity inside
a step is JAX's raw staggered layout (`models/smoke.py`). Empty grid faces
hold NaN, as in the JAX package: NaN is data on this path. `state_fields` /
`state_natives` cross between the two.

In 2D the same code runs through the plain PyTorch routes on any device, as
the JAX package runs 2D FLIP through XLA.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..field import CenteredGrid, StaggeredGrid, distribute_points, finite_fill, mask, resample
from ..field._field_math import finite_fill_native
from ..field._point_cloud import distribute_points_native
from ..field._resample import sample_staggered_at_points, scatter_to_grid
from ..geom import Box
from ..geom._geom import flat_points
from ..math import ConvergenceException, Solve, channel, default_device, instance, wrap
from ..physics import advect, fluid
from ..physics.fluid import _pressure_extrapolation
from ._fields import cell_native, cell_values

__all__ = ['FlipLiquid', 'state_from_numpy', 'state_to_numpy']

Particles = Tuple[torch.Tensor, torch.Tensor]


class FlipLiquid:
    """Dam-break FLIP liquid in a closed box (2D or 3D), one unit a cell.

    ``block`` gives per-axis (lo, hi) extents of the initial liquid block as
    fractions of the domain: flat ``(x0, x1, y0, y1[, z0, z1])``. Gravity acts
    along the last axis. The constructor takes JAX's arguments, and `seed` for
    the particles' jitter (0 is the JAX package's draw)."""

    def __init__(self, resolution: int = 64, dims: int = 2, block=None, gravity: float = -9.81,
                 dt: float = 0.1, points_per_cell: int = 8, cg_tol: float = 1e-4, max_iterations: int = 200,
                 device=None, seed: int = 0):
        if dims not in (2, 3):
            raise ValueError(f"dims must be 2 or 3, got {dims}")
        self.device = resolve_device(device)
        self.resolution = resolution
        names = ['x', 'y', 'z'][:dims]
        self.bounds = Box(**{n: float(resolution) for n in names})
        self.dims = dims
        self.gravity = gravity
        self.dt = dt
        self.cg_tol = cg_tol
        self.max_iterations = max_iterations
        self._dx = 1.0
        self._size = (float(resolution),) * dims
        if block is None:
            block = (0.15, 0.55) * (dims - 1) + (0.45, 0.85)  # raised block, falls under gravity
        if len(block) != 2 * dims:
            raise ValueError(f"block needs {2 * dims} entries, got {len(block)}")
        extents = {n: (block[2 * i] * resolution, block[2 * i + 1] * resolution) for i, n in enumerate(names)}
        sizes = {n: resolution for n in names}
        with default_device(self.device):  # the occupancy mask is sampled on the model's device
            self.particles0 = distribute_points(
                Box(**extents), points_per_cell=points_per_cell, **sizes) * ((0,) * dims)
        self._names = names
        if seed == 0:  # the JAX package's draw
            self.positions0 = np.array(self.particles0.points.numpy(('points', 'vector')))
        else:
            self.positions0 = distribute_points_native([block[2 * i] * resolution for i in range(dims)],
                                                       [block[2 * i + 1] * resolution for i in range(dims)],
                                                       (resolution,) * dims, points_per_cell=points_per_cell,
                                                       seed=seed)
            self.particles0 = self.particles0.with_geometry(self.particles0.geometry.at(self._points(self.positions0)))
        self.last_solve = None  # fluid SolveResult of the latest projection

    # ------------------------------------------------------------------
    # JAX's face: Fields
    # ------------------------------------------------------------------
    def _pressure0(self):
        sizes = {n: self.resolution for n in self._names}
        v0 = StaggeredGrid(0, 0, self.bounds, **sizes)
        return CenteredGrid(0., _pressure_extrapolation(v0.boundary), self.bounds, **sizes)

    def initial_state(self):
        from . import to_device
        return to_device((self.particles0, self._pressure0()), self.device)

    def step(self, particles, pressure=None):
        r = self.resolution
        sizes = {n: r for n in self._names}
        grid_v = prev_v = finite_fill(resample(
            particles, StaggeredGrid(0, 0, self.bounds, **sizes), scatter=True, outside_handling='clamp'))
        occupied = resample(mask(particles),
                            CenteredGrid(0, grid_v.boundary.spatial_gradient(), self.bounds, **sizes),
                            scatter=True)
        g_vec = (0,) * (len(self._names) - 1) + (self.gravity * self.dt,)
        # warm-start the free-surface solve at the previous step's pressure
        grid_v, pressure = fluid.make_incompressible(
            grid_v + g_vec, [], active=occupied,
            solve=Solve('CG', self.cg_tol, 0., x0=pressure, max_iterations=self.max_iterations,
                        suppress=(ConvergenceException,)))
        particles = particles + resample(grid_v - prev_v, particles)  # FLIP velocity update
        particles = advect.points(particles, grid_v, self.dt, advect.finite_rk4)
        particles = fluid.boundary_push(particles, [~self.bounds])
        return particles, pressure

    def _points(self, array):
        """An (N, dims) array as a Tensor of points."""
        return wrap(array, instance('points'), channel(vector=self._names))

    def state_fields(self, particles: Particles, pressure: Optional[torch.Tensor]):
        """The array state ((positions, velocities), pressure) as JAX's
        Fields, the tensors kept as they are; a pressure of None stays None."""
        positions, velocities = particles
        cloud = self.particles0.with_geometry(self.particles0.geometry.at(self._points(positions)))
        if pressure is not None:
            p0 = self._pressure0()
            pressure = p0.with_values(cell_values(p0, pressure))
        return cloud.with_values(self._points(velocities)), pressure

    def state_natives(self, particles, pressure):
        """The Fields' raw tensors: ((positions, velocities), pressure); a
        velocity shared by all particles is expanded to one a particle."""
        positions, _ = flat_points(particles.points)
        values = particles.values.torch(('points', 'vector'), device=positions.device)
        return (positions, values.expand(positions.shape).contiguous()), \
            None if pressure is None else cell_native(pressure)

    # ------------------------------------------------------------------
    # the array layer
    # ------------------------------------------------------------------
    def initial_state_native(self) -> Tuple[Particles, torch.Tensor]:
        """((positions, velocities), pressure): the block at rest, zero pressure."""
        positions = torch.from_numpy(self.positions0).to(self.device)
        pressure = torch.zeros((self.resolution,) * self.dims, dtype=torch.float32, device=self.device)
        return (positions, torch.zeros_like(positions)), pressure

    # ------------------------------------------------------------------
    # the phases of a step
    # ------------------------------------------------------------------
    def particles_to_grid_native(self, particles: Particles):
        """P2G: (grid velocity, occupied). The velocity is the mean of the
        particles' per nearest face (particles outside the face grid clamped to
        its border), NaN where no particle lies, then extended by one cell;
        `occupied` is 1 in the cells that hold a particle. In 3D on the card:
        four launches of K8, three face grids and the cells."""
        positions, velocities = particles
        N = (self.resolution,) * self.dims
        grid_v = scatter_to_grid(positions, velocities, N, self._dx, outside_handling='clamp', base=float('nan'))
        grid_v = tuple(finite_fill_native(c) for c in grid_v)
        occupied = scatter_to_grid(positions, torch.ones_like(positions[:, 0]), N, self._dx,
                                   outside_handling='discard', base=0.0)
        return grid_v, occupied

    def project_native(self, grid_v, occupied, pressure: Optional[torch.Tensor]):
        """Gravity, then the free-surface projection; the solve's result is
        kept in `last_solve`."""
        up = self.dims - 1
        forced = tuple(c + self.gravity * self.dt if d == up else c for d, c in enumerate(grid_v))
        new_v, pressure, self.last_solve = fluid.make_incompressible_native(
            forced, pressure, self._dx, rel_tol=self.cg_tol, abs_tol=0., max_iterations=self.max_iterations,
            active=occupied)
        return new_v, pressure

    def grid_to_particles_native(self, particles: Particles, grid_v, prev_v) -> Particles:
        """G2P: the FLIP velocity update, RK4 advection and the push back
        into the box."""
        positions, velocities = particles
        change = tuple(a - b for a, b in zip(grid_v, prev_v))
        velocities = velocities + sample_staggered_at_points(change, positions, self._dx)
        positions = advect.points_native(positions, grid_v, self.dt, self._dx, advect.finite_rk4_native)
        positions = fluid.boundary_push_native(positions, self._size)
        return positions, velocities

    def step_native(self, particles: Particles, pressure: Optional[torch.Tensor] = None):
        positions, velocities = particles
        if (positions.ndim != 2 or positions.shape[1] != self.dims or velocities.shape != positions.shape
                or positions.dtype != torch.float32 or velocities.dtype != torch.float32):
            raise ValueError(f"particles: two float32 arrays (N, {self.dims}) expected, got "
                             f"{tuple(positions.shape)} {positions.dtype} and {tuple(velocities.shape)} "
                             f"{velocities.dtype}")
        prev_v, occupied = self.particles_to_grid_native(particles)
        grid_v, pressure = self.project_native(prev_v, occupied, pressure)
        particles = self.grid_to_particles_native(particles, grid_v, prev_v)
        return particles, pressure


def state_from_numpy(positions, velocities, pressure, device=None):
    """((positions, velocities), pressure) as contiguous float32 tensors on
    `device` (CUDA by default) from numpy arrays."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    return (t(positions), t(velocities)), t(pressure)


def state_to_numpy(state):
    """(positions, velocities, pressure) numpy float32 arrays of a model state."""
    (positions, velocities), pressure = state
    return tuple(a.detach().cpu().numpy() for a in (positions, velocities, pressure))

"""Moving and rotating obstacles in a periodic 2D box — port of
`phiflow_tpu/models/moving_obstacle.py::MovingObstacles`.

A 100 × 100 periodic domain with a cuboid translating along x and a sphere
that translates and spins. One step: move every obstacle by its own velocity
(wrapped into the domain), MacCormack self-advection of the velocity (K7 on
the card), then the projection with the obstacles' velocities imposed and the
masked stencil (2D: the wrappers' PyTorch route). The obstacles are part of
the state; their numbers live on the host in float32, as the JAX package
computes them, so the masks are rebuilt every step from the same centres.

`initial_state()` and `step(v, p, *obstacles)` are JAX's, on Fields: a
periodic StaggeredGrid and the CenteredGrid pressure, then the obstacles in
the constructor's order. `initial_state_native()` and `step_native(...)` are
the array layer's: the two face components in the periodic layout (N × N
each), the pressure (N × N), then the same obstacles. `state_fields` /
`state_natives` cross between the two.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..field import CenteredGrid, StaggeredGrid, face_layout
from ..geom import Box, Cuboid, Sphere
from ..math import ConvergenceException, Solve, extrapolation, vec
from ..math._nd import PERIODIC
from ..physics import advect, fluid
from ..physics.fluid import Obstacle, _pressure_extrapolation
from ._fields import cell_native, cell_values, staggered_natives, staggered_values

__all__ = ['MovingObstacles', 'state_from_numpy', 'state_to_numpy']


class MovingObstacles:
    """Periodic box with a translating cuboid and a translating, rotating
    sphere. The constructor takes JAX's arguments."""

    def __init__(self, resolution: int = 100, dt: float = 0.5, angular_velocity: float = 0.5,
                 cg_tol: float = 1e-4, max_iterations: int = 500, device=None):
        self.device = resolve_device(device)
        self.resolution = resolution
        self.dt = dt
        self.cg_tol = cg_tol
        self.max_iterations = max_iterations
        r = resolution
        self.domain = Box(x=100., y=100.)
        self.obstacles0 = (
            Obstacle(Cuboid(vec(x=20., y=80.), x=20., y=20.), velocity=vec(x=5., y=0.)),
            Obstacle(Sphere(x=20., y=20., radius=10.), velocity=vec(x=1., y=4.),
                     angular_velocity=angular_velocity),
        )
        self.v0 = StaggeredGrid(0., extrapolation.PERIODIC, bounds=self.domain, x=r, y=r)
        self.p0 = CenteredGrid(0., _pressure_extrapolation(self.v0.boundary), bounds=self.domain, x=r, y=r)
        self.size = np.array([100., 100.], np.float32)  # the array layer's domain
        self._dx = 100. / resolution
        self.last_solve = None  # fluid SolveResult of the latest projection

    # ------------------------------------------------------------------
    # JAX's face: Fields
    # ------------------------------------------------------------------
    def initial_state(self):
        from . import to_device
        return to_device((self.v0, self.p0) + self.obstacles0, self.device)

    def move_obstacle(self, obs: Obstacle) -> Obstacle:
        """Advance the obstacle by its own velocity, wrapping periodically:
        float32 arithmetic on the host, so its centre stays the JAX package's
        number."""
        x = (obs.geometry.center + obs.velocity * self.dt) % self.domain.size
        return obs.at(x)

    def step(self, v, p, *obstacles):
        obstacles = tuple(self.move_obstacle(o) for o in obstacles)
        v = advect.mac_cormack(v, v, self.dt)
        v, p = fluid.make_incompressible(
            v, obstacles, Solve('CG', self.cg_tol, 0., x0=p, max_iterations=self.max_iterations,
                                suppress=(ConvergenceException,)))
        return (v, p) + obstacles

    def state_fields(self, v, p, *obstacles):
        """The array state (face components, pressure, *obstacles) as JAX's
        Fields, the tensors kept as they are."""
        return (self.v0.with_values(staggered_values(self.v0, v)),
                self.p0.with_values(cell_values(self.p0, p))) + obstacles

    def state_natives(self, v, p, *obstacles):
        """The Fields' raw tensors: (face components, pressure, *obstacles)."""
        return (staggered_natives(v), cell_native(p)) + obstacles

    # ------------------------------------------------------------------
    # the array layer
    # ------------------------------------------------------------------
    def initial_state_native(self):
        """(velocity, pressure, *obstacles): the fluid at rest."""
        shape = (self.resolution,) * 2
        zeros = lambda: torch.zeros(shape, dtype=torch.float32, device=self.device)
        return ((zeros(), zeros()), zeros()) + self.obstacles0

    def step_native(self, v, p, *obstacles):
        obstacles = tuple(self.move_obstacle(o) for o in obstacles)
        v = advect.mac_cormack_native(v, v, self.dt, self._dx, PERIODIC, periodic=True)
        v, p, self.last_solve = fluid.make_incompressible_native(
            v, p, self._dx, rel_tol=self.cg_tol, abs_tol=0., max_iterations=self.max_iterations,
            faces=face_layout(True, 2), obstacles=obstacles)
        return (v, p) + obstacles


def state_from_numpy(velocity, pressure, obstacles, device=None):
    """(velocity, pressure, *obstacles) with the arrays as contiguous float32
    tensors on `device` (CUDA by default); `obstacles` are `Obstacle`s — a
    model's `obstacles0[i].at(centre)` places one."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    return (tuple(t(c) for c in velocity), t(pressure)) + tuple(obstacles)


def state_to_numpy(state):
    """(velocity components, pressure, obstacle centres (n, 2)) as numpy
    float32 arrays."""
    v, p, *obstacles = state
    return (tuple(c.detach().cpu().numpy() for c in v), p.detach().cpu().numpy(),
            np.stack([o.geometry.center for o in obstacles]).astype(np.float32))

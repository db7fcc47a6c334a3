"""Moving and rotating obstacles in a periodic 2D box — port of
`phiflow_tpu/models/moving_obstacle.py::MovingObstacles`.

A 100 × 100 periodic domain with a cuboid translating along x and a sphere
that translates and spins. One step: move every obstacle by its own velocity
(wrapped into the domain), MacCormack self-advection of the velocity (K7 on
the card), then the projection with the obstacles' velocities imposed and the
masked stencil (2D: the wrappers' PyTorch route). The obstacles are part of
the state; their numbers live on the host in float32, as the JAX package
computes them, so the masks are rebuilt every step from the same centres.

The state is ``(velocity, pressure, *obstacles)``: the two face components in
the periodic layout (N × N each), the pressure (N × N), then the obstacles in
the constructor's order.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..geom import Cuboid, Sphere
from ..math._nd import PERIODIC
from ..physics import advect, fluid
from ..physics.fluid import Obstacle

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
        self.size = np.array([100., 100.], np.float32)
        self._dx = 100. / resolution
        self.obstacles0 = (
            Obstacle(Cuboid([20., 80.], [20., 20.]), velocity=[5., 0.]),
            Obstacle(Sphere([20., 20.], radius=10.), velocity=[1., 4.], angular_velocity=angular_velocity),
        )
        self.last_solve = None  # fluid SolveResult of the latest projection

    def initial_state(self):
        """(velocity, pressure, *obstacles): the fluid at rest."""
        shape = (self.resolution,) * 2
        zeros = lambda: torch.zeros(shape, dtype=torch.float32, device=self.device)
        return ((zeros(), zeros()), zeros()) + self.obstacles0

    def move_obstacle(self, obs: Obstacle) -> Obstacle:
        """Advance the obstacle by its own velocity, wrapping periodically;
        float32 arithmetic, so its centre stays the JAX package's number."""
        return obs.at((obs.geometry.center + obs.velocity * np.float32(self.dt)) % self.size)

    def step(self, v, p, *obstacles):
        obstacles = tuple(self.move_obstacle(o) for o in obstacles)
        v = advect.mac_cormack_native(v, v, self.dt, self._dx, PERIODIC, periodic=True)
        v, p, self.last_solve = fluid.make_incompressible_native(
            v, p, self._dx, rel_tol=self.cg_tol, abs_tol=0., max_iterations=self.max_iterations, periodic=True,
            obstacles=obstacles)
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

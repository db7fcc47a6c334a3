"""Lid-driven cavity in 2D — port of `phiflow_tpu/models/cavity.py::LidDrivenCavity`.

A closed box of one unit a cell whose upper wall (y+) slides along x. One
step: semi-Lagrangian self-advection of the velocity (K7 on the card),
explicit diffusion, then the projection — with ``obstacle=True`` around a
sphere in the middle, through the masked stencil (2D: the wrappers' PyTorch
route). The wall values differ by side and component — the x-velocity is
`lid_speed` beyond y+, everything else 0.

`initial_state()` and `step(v, p)` are JAX's, on Fields: the velocity a
StaggeredGrid under `combine_sides` with the lid, the pressure a CenteredGrid
under the boundary the projection derives from it. `initial_state_native()`
and `step_native(v, p)` are the array layer's: the face components in the
closed-box layout ((N−1) × N and N × (N−1)) and the pressure (N × N), the
lid a `PerSide` per component. `state_fields` / `state_natives` cross
between the two.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..field import CenteredGrid, StaggeredGrid
from ..geom import Box, Sphere
from ..math import ConvergenceException, Solve, extrapolation, vec
from ..math._nd import PerSide
from ..physics import advect, diffuse, fluid
from ..physics.fluid import Obstacle, _pressure_extrapolation
from ._fields import cell_native, cell_values, staggered_natives, staggered_values

__all__ = ['LidDrivenCavity', 'state_from_numpy', 'state_to_numpy']


class LidDrivenCavity:
    """Closed box with a moving lid and an optional obstacle. The constructor
    takes JAX's arguments."""

    def __init__(self, resolution: int = 64, lid_speed: float = 1., viscosity: float = 0.01, dt: float = 0.5,
                 obstacle: bool = False, cg_tol: float = 1e-4, max_iterations: int = 500, device=None):
        r = resolution
        self.device = resolve_device(device)
        self.resolution = r
        self.dt = dt
        self.viscosity = viscosity
        self.cg_tol = cg_tol
        self.max_iterations = max_iterations
        self._dx = 1.0
        bounds = Box(x=float(r), y=float(r))
        # no-slip walls; the lid (y+) moves with lid_speed in x
        boundary = {'x-': 0., 'x+': 0., 'y-': 0., 'y+': vec(x=lid_speed, y=0.)}
        self.v0 = StaggeredGrid(0., extrapolation.combine_sides(**boundary), bounds=bounds, x=r, y=r)
        self.p0 = CenteredGrid(0., _pressure_extrapolation(self.v0.boundary), bounds=bounds, x=r, y=r)
        self.obstacles = [Obstacle(Sphere(x=r / 2, y=r / 2, radius=r / 8))] if obstacle else []
        self.boundary = (PerSide((0., 0.), (0., lid_speed)), PerSide((0., 0.), (0., 0.)))  # the array layer's lid
        self.last_solve = None  # fluid SolveResult of the latest projection

    # ------------------------------------------------------------------
    # JAX's face: Fields
    # ------------------------------------------------------------------
    def initial_state(self):
        from . import to_device
        return to_device((self.v0, self.p0), self.device)

    def step(self, v, p):
        v = advect.semi_lagrangian(v, v, self.dt)
        v = diffuse.explicit(v, self.viscosity, self.dt)
        v, p = fluid.make_incompressible(v, self.obstacles,
                                         Solve('CG', self.cg_tol, 0., x0=p,
                                               max_iterations=self.max_iterations,
                                               suppress=(ConvergenceException,)))
        return v, p

    def state_fields(self, v, p):
        """The array state (face components, pressure) as JAX's Fields, the
        tensors kept as they are."""
        return (self.v0.with_values(staggered_values(self.v0, v)),
                self.p0.with_values(cell_values(self.p0, p)))

    def state_natives(self, v, p):
        """The Fields' raw tensors: (face components, pressure)."""
        return staggered_natives(v), cell_native(p)

    # ------------------------------------------------------------------
    # the array layer
    # ------------------------------------------------------------------
    def initial_state_native(self):
        """(velocity, pressure): the fluid at rest."""
        r = self.resolution
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        return (zeros(r - 1, r), zeros(r, r - 1)), zeros(r, r)

    def step_native(self, v, p):
        v = advect.semi_lagrangian_native(v, v, self.dt, self._dx, self.boundary, velocity_extrap=self.boundary)
        v = diffuse.explicit_native(v, self.viscosity, self.dt, self._dx, self.boundary)
        v, p, self.last_solve = fluid.make_incompressible_native(
            v, p, self._dx, rel_tol=self.cg_tol, abs_tol=0., max_iterations=self.max_iterations,
            obstacles=self.obstacles)
        return v, p


def state_from_numpy(velocity, pressure, device=None):
    """(velocity, pressure) as contiguous float32 tensors on `device` (CUDA
    by default) from numpy arrays."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
    return tuple(t(c) for c in velocity), t(pressure)


def state_to_numpy(state):
    """(velocity components, pressure) as numpy float32 arrays."""
    v, p = state
    return tuple(c.detach().cpu().numpy() for c in v), p.detach().cpu().numpy()

"""Lid-driven cavity in 2D — port of `phiflow_tpu/models/cavity.py::LidDrivenCavity`.

A closed box of one unit a cell whose upper wall (y+) slides along x. One
step: semi-Lagrangian self-advection of the velocity (K7 on the card),
explicit diffusion, then the projection — with ``obstacle=True`` around a
sphere in the middle, through the masked stencil (2D: the wrappers' PyTorch
route). The wall values differ by side and component — the x-velocity is
`lid_speed` beyond y+, everything else 0 — which `PerSide` describes.

The state is ``(velocity, pressure)``: the face components in the closed-box
layout ((N−1) × N and N × (N−1)) and the pressure (N × N).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..geom import Sphere
from ..math._nd import PerSide
from ..physics import advect, diffuse, fluid
from ..physics.fluid import Obstacle

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
        # no-slip walls; the lid (y+) moves with lid_speed in x
        self.boundary = (PerSide((0., 0.), (0., lid_speed)), PerSide((0., 0.), (0., 0.)))
        self.obstacles = [Obstacle(Sphere([r / 2, r / 2], radius=r / 8))] if obstacle else []
        self.last_solve = None  # fluid SolveResult of the latest projection

    def initial_state(self):
        """(velocity, pressure): the fluid at rest."""
        r = self.resolution
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        return (zeros(r - 1, r), zeros(r, r - 1)), zeros(r, r)

    def step(self, v, p):
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

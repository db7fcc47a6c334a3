"""Burgers' equation — port of `phiflow_tpu/models/burgers.py::Burgers`.

A centred, vector-valued velocity on a periodic box of one unit a cell,
started from `Noise` (scale 10, doubled) drawn from the model's own seed. One
step: semi-Lagrangian self-advection (the displacement −dt·v in cells, the
window interpolation with K = 2 and the periodic halo: K7 once per component
in 2D on the card, K6 in 3D), then diffusion — explicit Euler, or with
``implicit=True`` backward Euler solved by CG (`Solve('CG', 1e-5, 1e-5)`).
Displacements beyond two cells are clamped to ±2, as in the JAX package.

`initial_state()` and `step(v)` are JAX's, on Fields; `step` returns `(v,)`.
`initial_state_native()` and `step_native(v)` are the array layer's: `v` the
tuple of the d component arrays. `state_fields` / `state_natives` cross
between the two; `state_from_numpy` / `state_to_numpy` take and give
component arrays as numpy (JAX's `v0` in the tests).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..field import CenteredGrid, Noise
from ..field._field_math import laplace_native
from ..geom import Box
from ..math import Solve, Tensor, channel, default_float, extrapolation, stack, transpose
from ..math._nd import PERIODIC, shift_window_interp
from ..math._ops import using_generator
from ..math._solve import cg, finish_solve
from ..physics import advect, diffuse

__all__ = ['Burgers', 'state_from_numpy', 'state_to_numpy']

MAX_CELLS = 2  # the window of `advect.semi_lagrangian`'s default


class Burgers:
    """The constructor takes JAX's arguments, then `device` (CUDA unless
    'cpu') and `seed` (of the initial noise)."""

    def __init__(self, resolution: int = 128, dims: int = 2, viscosity: float = 0.1, dt: float = 0.5,
                 implicit=False, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.resolution = resolution
        self.names = ['x', 'y', 'z'][:dims]
        sizes = {n: resolution for n in self.names}
        bounds = Box(**{n: float(resolution) for n in self.names})
        self.viscosity = viscosity
        self.dt = dt
        self.implicit = implicit
        self.solve = Solve('CG', 1e-5, 1e-5)
        with using_generator(torch.Generator().manual_seed(seed)):
            v0 = CenteredGrid(Noise(vector=','.join(self.names)), extrapolation.PERIODIC, bounds=bounds, **sizes) * 2
        # `vector` first, as a step leaves it: each component a contiguous array, as the window kernel takes it
        self.v0 = v0.with_values(transpose(v0.values, ('vector',) + tuple(self.names)))
        self._dx = tuple(float(x) for x in self.v0.dx.numpy())
        self.last_solve = None  # the SolveResult of the latest implicit diffusion (step_native)

    # ------------------------------------------------------------------
    # JAX's face: Fields
    # ------------------------------------------------------------------
    def initial_state(self):
        from . import to_device
        return to_device((self.v0,), self.device)

    def step(self, v):
        v = advect.semi_lagrangian(v, v, self.dt)
        if self.implicit:
            v = diffuse.implicit(v, self.viscosity, self.dt, Solve('CG', 1e-5, 1e-5))
        else:
            v = diffuse.explicit(v, self.viscosity, self.dt)
        return (v,)

    def state_fields(self, v):
        """The component arrays as JAX's Field state `(v,)`."""
        grid = self.v0.values.shape.only(self.names, reorder=True)
        return (self.v0.with_values(stack([Tensor(c, grid) for c in v], channel(vector=self.names))),)

    def state_natives(self, v):
        """The component arrays of the Field `v`, in the grid's dim order."""
        return tuple(v.values[{'vector': d}].native(self.names) for d in self.names)

    # ------------------------------------------------------------------
    # the array layer
    # ------------------------------------------------------------------
    def initial_state_native(self):
        return self.state_natives(self.initial_state()[0])

    def step_native(self, v):
        """The Field step's operations on the component arrays: the
        displacement (−dt·v_a)/dx_a, the window of each component (K7 / K6),
        then `laplace_native` per component — explicit, or as the operator
        1 − ν·dt·Δ of CG on the stacked components."""
        disps = [(-self.dt * c) / h for c, h in zip(v, self._dx)]
        v = tuple(shift_window_interp(c.contiguous(), disps, PERIODIC, MAX_CELLS) for c in v)
        amount = self.viscosity * self.dt
        if not self.implicit:
            return tuple(c + laplace_native(c, self._dx, PERIODIC) * amount for c in v)
        y = torch.stack(v)

        def A(x):
            return torch.stack([c + laplace_native(c, self._dx, PERIODIC) * (-amount) for c in x]), None
        solve = self.solve.with_defaults('solve')
        result = cg(A, y, y, solve.rel_tol, solve.abs_tol, solve.max_iterations)
        finish_solve(solve, result.x, result)
        self.last_solve = result
        return tuple(result.x)


def state_from_numpy(velocity, device=None):
    """The component arrays (d arrays of the grid's shape, JAX's `v0` by
    component) as contiguous tensors of the current precision on `device`
    (CUDA by default)."""
    dev = resolve_device(device)
    dtype = np.dtype(default_float())
    return tuple(torch.from_numpy(np.array(c, dtype=dtype)).to(dev) for c in velocity)


def state_to_numpy(velocity):
    """The component arrays as numpy."""
    return tuple(c.detach().cpu().numpy() for c in velocity)

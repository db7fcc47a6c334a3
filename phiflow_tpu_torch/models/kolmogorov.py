"""Higher-order Kolmogorov flow — port of
`phiflow_tpu/models/kolmogorov.py::KolmogorovFlow`.

Two-dimensional periodic turbulence on a box of side 2π driven by the body
force (sin(k·y), 0): centred grids, order-`order` differential advection and
diffusion (`advect.differential`, `diffuse.differential` through the
operator matrices of `field/_higher_order.py` at order 6, the ghost-cell
stencil at order 4), integrated by `fluid.incompressible_rk4` with the
wide-stencil projection of the same order inside each of its four stages
(unpreconditioned CG, `cg_tol`, at most `max_iterations`, not converging
allowed). The velocity starts from `Noise` (scale 10, halved) of the model's
own seed, the pressure at 0. No kernel of the port's runs on this path: its
work is dense per-axis matrix products and PyTorch elementwise operations.

`initial_state()` and `step(v, p)` are JAX's, on Fields.
`initial_state_native()` and `step_native(v, p)` are the array layer's on
the component arrays of the velocity and the pressure array, the same
operators written on raw tensors (`_NativeOps`). `state_fields` /
`state_natives`, `state_from_numpy` / `state_to_numpy` cross between them.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..field import CenteredGrid, Noise
from ..field._stencil1d import apply_axis_matrix, derivative_matrix
from ..geom import Box
from ..math import ConvergenceException, Solve, Tensor, channel, default_float, extrapolation, sin, stack
from ..math._ops import using_generator
from ..math._solve import cg, finish_solve, sub_mean
from ..physics import advect, diffuse, fluid

__all__ = ['KolmogorovFlow', 'state_from_numpy', 'state_to_numpy']


class KolmogorovFlow:
    """2D periodic turbulence driven by a sinusoidal body force. The
    constructor takes JAX's arguments, then `device` (CUDA unless 'cpu') and
    `seed` (of the initial noise)."""

    def __init__(self, resolution: int = 128, reynolds: float = 1000., forcing_wavenumber: int = 4,
                 dt: float = 0.005, order: int = 6, cg_tol: float = 1e-4, max_iterations: int = 200,
                 device=None, seed: int = 0):
        from . import to_device
        self.device = resolve_device(device)
        self.resolution = resolution
        self.order = order
        self.dt = dt
        self.viscosity = 1.0 / reynolds
        L = 2 * np.pi
        bounds = Box(x=L, y=L)
        self.solve_params = dict(cg_tol=cg_tol, max_iterations=max_iterations)
        k = forcing_wavenumber
        forcing = CenteredGrid(
            lambda pos: stack({'x': sin(k * pos.vector['y']), 'y': pos.vector['x'] * 0}, channel(vector='x,y')),
            extrapolation.PERIODIC, x=resolution, y=resolution, bounds=bounds)
        # a constant of every PDE evaluation: on the device once (the JAX package embeds it as a literal)
        self.forcing = to_device(forcing, self.device)
        with using_generator(torch.Generator().manual_seed(seed)):
            self.v0 = CenteredGrid(Noise(vector='x,y'), extrapolation.PERIODIC,
                                   x=resolution, y=resolution, bounds=bounds) * 0.5
        self.p0 = CenteredGrid(0., extrapolation.PERIODIC, x=resolution, y=resolution, bounds=bounds)
        self._native = None
        self.last_solves = []  # the SolveResults of the latest step_native's four projections

    # ------------------------------------------------------------------
    # JAX's face: Fields
    # ------------------------------------------------------------------
    def initial_state(self):
        from . import to_device
        return to_device((self.v0, self.p0), self.device)

    def pde(self, v):
        adv = advect.differential(v, v, order=min(self.order, 4) if not _periodic_only(v) else self.order)
        diff = diffuse.differential(v, self.viscosity, order=self.order)
        return adv + diff + self.forcing

    def step(self, v, p):
        solve = Solve('CG', self.solve_params['cg_tol'], 0.,
                      max_iterations=self.solve_params['max_iterations'],
                      suppress=(ConvergenceException,))
        return fluid.incompressible_rk4(self.pde, v, p, self.dt, pressure_order=self.order, pressure_solve=solve)

    def state_fields(self, v, p):
        """(component arrays, pressure array) as JAX's Field state `(v, p)`."""
        grid = self.p0.values.shape.only(('x', 'y'), reorder=True)
        velocity = self.v0.with_values(stack([Tensor(c, grid) for c in v], channel(vector='x,y')))
        return velocity, self.p0.with_values(Tensor(p, grid))

    def state_natives(self, v, p):
        """The Fields' arrays: (the velocity's components, the pressure), in the grid's dim order."""
        return tuple(v.values[{'vector': d}].native(('x', 'y')) for d in ('x', 'y')), p.values.native(('x', 'y'))

    # ------------------------------------------------------------------
    # the array layer
    # ------------------------------------------------------------------
    def initial_state_native(self):
        return self.state_natives(*self.initial_state())

    def step_native(self, v, p):
        """`step` on the arrays: the same RK4 stages, projections and
        operators (`_NativeOps`), one CG a stage."""
        if self._native is None:
            self._native = _NativeOps(self)
        self.last_solves = []
        return self._native.rk4(v, p, self.dt, self.last_solves)


class _NativeOps:
    """The periodic operators of `KolmogorovFlow` on raw arrays (x, y): the
    centred first and second derivatives of `order` — the ghost-cell stencil
    (torch.roll) at orders 2 and 4, the compact scheme's operator matrices at
    6, as the Field layer computes them — and the RK4 with the wide-stencil
    projection in each stage."""

    def __init__(self, model: KolmogorovFlow):
        self.order = model.order
        self.nu = model.viscosity
        self.h = tuple(np.float64(x) if model.v0.values.dtype == np.float64 else np.float32(x)
                       for x in model.v0.dx.numpy())
        self.n = model.resolution
        self.forcing = tuple(model.forcing.values[{'vector': d}].native(('x', 'y')) for d in ('x', 'y'))
        self.cg_tol, self.max_iterations = model.solve_params['cg_tol'], model.solve_params['max_iterations']

    def d1(self, f, axis):
        h = self.h[axis]
        if self.order == 2:
            return (torch.roll(f, -1, axis) - torch.roll(f, 1, axis)) / float(2 * h)
        if self.order == 4:
            m2, m1, p1, p2 = (torch.roll(f, s, axis) for s in (2, 1, -1, -2))
            return (m2 - 8 * m1 + 8 * p1 - p2) / float(12 * h)
        M, aff = derivative_matrix(self.n, 1, self.order, float(h), 'periodic', 'periodic', implicit_order=2)
        return apply_axis_matrix(f, axis, M, aff)

    def d2(self, f, axis):
        h = self.h[axis]
        if self.order == 2:
            return (torch.roll(f, 1, axis) + torch.roll(f, -1, axis) - 2 * f) / float(h ** 2)
        if self.order == 4:
            m2, m1, p1, p2 = (torch.roll(f, s, axis) for s in (2, 1, -1, -2))
            return (-m2 + 16 * m1 - 30 * f + 16 * p1 - p2) / float(12 * h ** 2)
        M, aff = derivative_matrix(self.n, 2, self.order, float(h), 'periodic', 'periodic', implicit_order=2)
        return apply_axis_matrix(f, axis, M, aff)

    def pde(self, v):
        """−(v·∇)v + ν·Δv + forcing, per component."""
        out = []
        for c, u in enumerate(v):
            adv = v[0] * self.d1(u, 0) + v[1] * self.d1(u, 1)
            out.append(-adv + (self.d2(u, 0) + self.d2(u, 1)) * self.nu + self.forcing[c])
        return out

    def project(self, v, solves):
        """The wide-stencil projection: (divergence-free v, pressure)."""
        div = self.d1(v[0], 0) + self.d1(v[1], 1)
        rhs = sub_mean(div - torch.mean(div))

        def A(p):
            return self.d1(self.d1(p, 0), 0) + self.d1(self.d1(p, 1), 1), None
        result = cg(A, rhs, torch.zeros_like(rhs), self.cg_tol, 0., self.max_iterations)
        finish_solve(Solve('CG', self.cg_tol, 0., max_iterations=self.max_iterations,
                           suppress=(ConvergenceException,)), result.x, result)
        solves.append(result)
        p = sub_mean(result.x)
        return [v[0] - self.d1(p, 0), v[1] - self.d1(p, 1)], p

    def rk4(self, v, p, dt, solves):
        v0 = list(v)

        def stage(stage_dt, rhs, p_prev):
            projected, correction = self.project([a + stage_dt * b for a, b in zip(v0, rhs)], solves)
            return projected, p_prev + correction / stage_dt

        def momentum(u, q):
            return [a - self.d1(q, axis) for axis, a in enumerate(self.pde(u))]

        k1 = momentum(v0, p)
        v_half, p_half = stage(dt / 2, k1, p)
        k2 = momentum(v_half, p_half)
        v_half2, p_half2 = stage(dt / 2, k2, p_half)
        k3 = momentum(v_half2, p_half2)
        v_full, p_full = stage(dt, k3, p_half2)
        k4 = momentum(v_full, p_full)
        incr = [(a + 2 * b + 2 * c + d) / 6 for a, b, c, d in zip(k1, k2, k3, k4)]
        v_next, p_next = stage(dt, incr, (p + 2 * p_half + 2 * p_half2 + p_full) / 6)
        return tuple(v_next), p_next


def _periodic_only(v) -> bool:
    return v.boundary == extrapolation.PERIODIC


def state_from_numpy(velocity, pressure, device=None):
    """(component arrays, pressure) as contiguous tensors of the current
    precision on `device` (CUDA by default) from numpy arrays."""
    dev = resolve_device(device)
    dtype = np.dtype(default_float())
    t = lambda a: torch.from_numpy(np.array(a, dtype=dtype)).to(dev)
    return tuple(t(c) for c in velocity), t(pressure)


def state_to_numpy(state):
    """(component arrays, pressure) as numpy."""
    v, p = state
    return tuple(c.detach().cpu().numpy() for c in v), p.detach().cpu().numpy()

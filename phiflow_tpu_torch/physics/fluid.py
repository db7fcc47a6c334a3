"""Pressure projection — port of `phiflow_tpu/physics/fluid.py::make_incompressible`
(`:164-272`): the staggered branches, with obstacles (`Obstacle`,
`apply_boundary_conditions`) and free surfaces, and the centred velocity's
wide-stencil projection of orders 2, 4 and 6 with all cells active
(`_make_incompressible_centred`); the projection of a velocity on an
unstructured mesh (`_make_incompressible_mesh`: BiCGStab on the FVM
Laplacian, `masked_laplace`, preconditioned by Chebyshev(Jacobi) on its
analytic diagonal, `_mesh_chebyshev_preconditioner`, all PyTorch
operations); and `incompressible_rk4` (`:671-701`), RK4 with the projection
inside every stage.

`make_incompressible(velocity, obstacles, solve, active)` and
`apply_boundary_conditions(velocity, obstacles)` take Fields with JAX's
signatures and unwrap into the array layer's `make_incompressible_native` and
`apply_boundary_conditions_native` on the raw face components, described
below. `boundary_push(particles, obstacles, separation)` moves a point
cloud's points with each geometry's `push` (`box_push` for boxes). The solve's tolerances, `x0` and `max_iterations` carry through; the
pressure comes back as a Field, the solve's `SolveInfo` on every active
`SolveTape`, and `NotConverged` / `Diverged` are raised unless the solve
suppresses them. The divergence is balanced and the solve's rank deficiency
handled by the array layer, once.

All cells active, no obstacle: divergence → `_balance_divergence` → CG on the
Poisson stencil (K1), preconditioned by the multigrid V-cycle (K2–K4) from
x0 = the previous pressure → subtract the pressure gradient. Closed box or
periodic box.

With `active` (a free surface: 1 in the cells the liquid occupies, 0
elsewhere): divergence · active, non-finite entries zeroed → CG on K1's masked
form (inactive cells are identity rows), preconditioned by Chebyshev(Jacobi)
on the exact masked diagonal, from x0 = the previous pressure; the system is
nonsingular, so no mean is removed anywhere. `boundary_push` keeps particles
inside the domain and outside box obstacles.

With `obstacles`: the cells outside every obstacle are `accessible`; a face is
open (`hard_bcs`) where both its cells are. The obstacles' velocities are
blended into the field, the open-face masks are staged once per solve into
K1's coefficient arrays (`mA`, `c0`) and the accessible cells are its
`active` cells, so every matvec is one launch of K1's masked form with all
seven arrays; the pressure gradient is subtracted on open faces only. Without
a caller's `active` the closed or periodic box stays singular and is treated
as the JAX package treats it: the right-hand side is balanced over the
accessible cells, and the plain mean over all cells is removed from it, from
every preconditioner output and from the result. `MASKED_PRECONDITIONER`
chooses the masked systems' preconditioner.

2D or 3D: the kernels are 3D; a 2D solve runs the same code through the
wrappers' PyTorch route (`ops/poisson.py`).

Every projection is differentiable in the velocity: its CG (and the mesh's
BiCGStab, through `solve_linear`) is differentiated implicitly
(`math/_solve.py::implicit_solve`), so a backward runs one adjoint solve on
the same kernels (K1, K1m, K2–K4) under `no_grad`, and the gradient reaches
the velocity through the divergence and the pressure-gradient subtraction,
which autograd follows. The previous pressure (x0) gets no gradient.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field._angular_velocity import angular_velocity_at_faces
from ..field._field import Field, face_components, face_values
from ..field._field_math import (
    divergence, divergence_native, laplace, mean as field_mean, safe_mul_native, spatial_gradient,
    spatial_gradient_native, stagger_native, _array_layout, _isotropic_dx, _normal_walls_at_rest, _plain_values,
)
from ..field._resample import cell_grid, geometry_mask, staggered_cells
from ..geom._box import Box, Cuboid, box_push
from ..geom._geom import Geometry, host_vec, union, vector_tensor
from ..math import EMPTY_SHAPE, Tensor, copy_solve, extrapolation, jit_compile_linear, solve_linear, wrap
from ..math import _ops as ops
from ..math._extrapolation import (
    ConstantExtrapolation, _AntiReflectExtrapolation, _AntiSymmetricExtrapolation, _BoundaryExtrapolation,
    _MixedExtrapolation, _PeriodicExtrapolation, _ReflectExtrapolation, _SymmetricExtrapolation,
)
from ..math._multigrid import make_poisson_vcycle
from ..math._nd import BOUNDARY, PERIODIC as PERIODIC_EXTRAPOLATION, Extrapolation
from ..math._solve import (CG_METHODS, Solve, SolveResult, cg, check_method, finish_solve, implicit_solve,
                           record_adjoint, sub_mean)
from ..ops.poisson import NEUMANN, PERIODIC, poisson_apply, stage_masks

__all__ = ['Obstacle', 'make_incompressible', 'masked_laplace', 'apply_boundary_conditions', 'boundary_push',
           'incompressible_rk4',
           'make_incompressible_native', 'apply_boundary_conditions_native', 'boundary_push_native',
           'MASKED_PRECONDITIONER']

MASKED_PRECONDITIONER = 'chebyshev'  # 'chebyshev' | 'vcycle' | None — the masked systems' preconditioner


class Obstacle:
    """Boundary conditions inside a geometry that may move and rotate:
    `velocity` a vector, `angular_velocity` a scalar in 2D and a rotation
    vector in 3D; 0 is at rest in both. Numbers and sequences are kept as
    float32 host vectors, Tensors in their own precision; the attributes are
    host Tensors."""

    def __init__(self, geometry: Geometry, velocity=0, angular_velocity=0):
        d = geometry.spatial_rank
        self.geometry = geometry
        self._velocity, _ = host_vec(velocity, d)
        w = angular_velocity.numpy() if hasattr(angular_velocity, 'numpy') else angular_velocity
        w = np.asarray(w, np.float64 if getattr(w, 'dtype', None) == np.float64 else np.float32)
        if d == 3 and w.ndim == 0 and w == 0:
            w = np.zeros(3, w.dtype)
        if w.shape != (() if d == 2 else (3,)):
            raise ValueError(f"angular_velocity of shape {w.shape} for a {d}D obstacle: a scalar in 2D, "
                             f"a vector of 3 entries in 3D")
        self._angular_velocity = w

    @property
    def velocity(self):
        return vector_tensor(self._velocity, self.geometry.names)

    @property
    def angular_velocity(self):
        w = self._angular_velocity
        return Tensor(w, EMPTY_SHAPE) if w.ndim == 0 else vector_tensor(w, None)

    @property
    def is_stationary(self) -> bool:
        return not self.is_moving and not self.is_rotating

    @property
    def is_rotating(self) -> bool:
        return bool(np.any(self._angular_velocity != 0))

    @property
    def is_moving(self) -> bool:
        return bool(np.any(self._velocity != 0))

    def with_geometry(self, geometry: Geometry) -> 'Obstacle':
        obstacle = Obstacle.__new__(Obstacle)
        obstacle.geometry, obstacle._velocity, obstacle._angular_velocity = \
            geometry, self._velocity, self._angular_velocity
        return obstacle

    def shifted(self, delta) -> 'Obstacle':
        return self.with_geometry(self.geometry.shifted(delta))

    def at(self, position) -> 'Obstacle':
        return self.with_geometry(self.geometry.at(position))

    def rotated(self, angle) -> 'Obstacle':
        return self.with_geometry(self.geometry.rotated(angle))

    def __repr__(self):
        return f"Obstacle({self.geometry!r})"


def _get_obstacles_for(obstacles) -> List[Obstacle]:
    """A bare geometry is a stationary obstacle; one obstacle is a list of one."""
    if isinstance(obstacles, (Obstacle, Geometry)):
        obstacles = [obstacles]
    if not isinstance(obstacles, (tuple, list)):
        raise TypeError(f"obstacles: an Obstacle, a Geometry or a sequence of them expected, got {type(obstacles)}")
    return [Obstacle(o) if isinstance(o, Geometry) else o for o in obstacles]


def _accessible_extrapolation(vext: Extrapolation) -> Extrapolation:
    """The extrapolation of the accessible-cells mask from the velocity's:
    beyond a wall (a constant velocity) nothing is accessible, beyond an open
    (zero-gradient) side everything, a periodic box wraps."""
    if vext == PERIODIC_EXTRAPOLATION:
        return PERIODIC_EXTRAPOLATION
    if vext == BOUNDARY:
        return 1.0
    return 0.0


def _resolution(velocity: Sequence[torch.Tensor], periodic: bool) -> Tuple[int, ...]:
    """The cells of a staggered velocity's domain: in the closed box component
    0 lacks one entry along its own axis."""
    return tuple(n + (1 if a == 0 and not periodic else 0) for a, n in enumerate(velocity[0].shape))


def apply_boundary_conditions_native(velocity: Sequence[torch.Tensor], obstacles, dx,
                              periodic: bool = False) -> Tuple[torch.Tensor, ...]:
    """Blend the obstacles' velocities into the staggered `velocity`: on the
    share of each face that an obstacle covers (the soft mask with
    ``balance=1``: a face whose centre lies on the surface counts as covered)
    the obstacle's own velocity, translation plus rotation, replaces the
    fluid's; a stationary obstacle leaves 0."""
    obstacles = _get_obstacles_for(obstacles)
    faces = staggered_cells(cell_grid(_resolution(velocity, periodic), dx, velocity[0].device), periodic)
    velocity = tuple(velocity)
    for obstacle in obstacles:
        obs_mask = geometry_mask(obstacle.geometry, faces, soft=True, balance=1)
        if obstacle.is_stationary:
            velocity = tuple(safe_mul_native(1 - m, v) for m, v in zip(obs_mask, velocity))
            continue
        if obstacle.is_rotating:
            angular = angular_velocity_at_faces(faces, obstacle.geometry._center, obstacle._angular_velocity)
        else:
            angular = tuple(v * 0 for v in velocity)
        velocity = tuple(safe_mul_native(1 - m, v) + safe_mul_native(m, (w + float(u)).expand(m.shape))
                         for m, v, w, u in zip(obs_mask, velocity, angular, obstacle._velocity))
    return velocity


def _classify_pressure_bc(periodic: bool, ndim: int = 3):
    """Per-axis (lower, upper) modes of the pressure operator: a closed box
    (constant velocity, its outer face flux dropped) is neumann on every side,
    a periodic box periodic."""
    mode = PERIODIC if periodic else NEUMANN
    return ((mode, mode),) * ndim


def _balance_divergence(div: torch.Tensor, active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Subtract the mean so the singular Poisson system is solvable; with
    `active`, spread it over the active cells only."""
    if active is not None:
        return div - active * (torch.mean(div) / torch.mean(active))
    return div - torch.mean(div)


def _grid_multigrid_preconditioner(resolution, dx: float, bcs, device):
    """The V-cycle preconditioner M(r) -> (z, None) with z projected onto
    zero mean (rank deficiency 1), or None below 16 cells per axis, where
    plain CG converges in a handful of iterations."""
    if max(resolution) < 16:
        return None
    vcycle = make_poisson_vcycle(tuple(resolution), (dx,) * len(resolution), bcs, device)

    def preconditioner(r: torch.Tensor):
        # CG takes ⟨r, z⟩ after the mean projection of z, on every device. K2
        # can emit the dot before it (the order of JAX on the chip), but the
        # two differ by mean(z)·Σr: Σr is the float32 roundoff of the first
        # residuals and does not shrink with r, so near tolerance the early
        # dot was off by 12× its value at 256³ (`chip_smoke.py::cg_dot_probe`)
        # and α grew without bound: the card's CG diverged (2D at 1024² and
        # 4096², 3D at 256³).
        z, _ = vcycle(r)
        return sub_mean(z), None

    return preconditioner


def _masked_diagonal(apply_A: Callable, template: torch.Tensor, bcs) -> Optional[torch.Tensor]:
    """The exact diagonal of a masked pressure operator by checkerboard
    probing: the operator couples a cell only to its axis neighbours, which
    have the other parity, so A·e_c is the diagonal wherever the cell has
    parity c. Two matvecs give all of it, identity rows and boundary rows
    included. None where parity is ill-defined (a periodic axis of odd size)."""
    sizes = tuple(template.shape)
    if any(lo == PERIODIC and n % 2 for (lo, _), n in zip(bcs, sizes)):
        return None
    idx = sum(torch.arange(n, device=template.device).reshape([n if j == i else 1 for j in range(len(sizes))])
              for i, n in enumerate(sizes))
    parity = (idx % 2).to(template.dtype)
    d_even = apply_A(1. - parity)
    d_odd = apply_A(parity)
    return (1. - parity) * d_even + parity * d_odd


CHEBYSHEV_DEGREE = 4       # of the masked preconditioner's polynomial: degree − 1 matvecs an application
CHEBYSHEV_EIG_RATIO = 30.  # its eigenvalue bounds are [2 / ratio, 2]


def _masked_chebyshev_preconditioner(apply_A: Callable, template: torch.Tensor, bcs):
    """Chebyshev(Jacobi) preconditioner M(r) -> (z, None) for a masked
    pressure system: a polynomial in B = D⁻¹A with D the exact masked
    diagonal. Identity rows have eigenvalue 1 and active rows are diagonally
    dominant, so B's spectrum lies in (0, 2] and fixed bounds need no power
    iteration. Two matvecs to build, three an application. None where the
    diagonal cannot be probed."""
    diag = _masked_diagonal(apply_A, template, bcs)
    if diag is None:
        return None
    eps = 1e-30
    nonzero = torch.abs(diag) > eps
    inv_diag = torch.where(nonzero, 1. / torch.where(nonzero, diag, torch.ones_like(diag)), torch.ones_like(diag))
    lmax = 2.0
    a, b = lmax / CHEBYSHEV_EIG_RATIO, lmax
    theta, delta = (b + a) / 2., (b - a) / 2.
    sigma1 = theta / delta

    def preconditioner(r: torch.Tensor):
        rs = r * inv_diag
        z = rs / theta
        d = z
        rho = 1. / sigma1
        for _ in range(CHEBYSHEV_DEGREE - 1):
            Bz = apply_A(z) * inv_diag
            rho_new = 1. / (2. * sigma1 - rho)
            d = rho_new * rho * d + (2. * rho_new / delta) * (rs - Bz)
            z = z + d
            rho = rho_new
        return z, None

    return preconditioner


def _masked_vcycle_preconditioner(resolution, dx: float, bcs, active: torch.Tensor):
    """Projected multigrid for masked systems: z = P·V(P·r) + (I − P)·r with P
    the active-cell projection and V the unmasked Poisson V-cycle (K2–K4).
    Identity rows are exact; next to an obstacle V only approximates, which
    slows CG down and does not break it. None below 16 cells per axis."""
    if max(resolution) < 16:
        return None
    vcycle = make_poisson_vcycle(tuple(resolution), (dx,) * len(resolution), bcs, active.device)

    def preconditioner(r: torch.Tensor):
        z, _ = vcycle(r * active)
        return z * active + r * (1. - active), None

    return preconditioner


def _full_face_masks(hard_bcs: Sequence[torch.Tensor], periodic: bool):
    """The open-face masks over every face of each axis, as `stage_masks`
    takes them: the outer faces that a closed box's velocity does not store
    are closed (their flux is dropped), so they enter as 0."""
    if periodic:
        return list(hard_bcs)
    full = []
    for axis, m in enumerate(hard_bcs):
        zero = torch.zeros_like(m.narrow(axis, 0, 1))
        full.append(torch.cat([zero, m, zero], dim=axis))
    return full


def _project_masked(velocity, div, pressure, active, hard_bcs, singular, dx, inv_dx2, bcs, periodic, rel_tol,
                    abs_tol, max_iterations):
    """The masked branches of `make_incompressible`: a free surface
    (`active`), obstacles (`hard_bcs` and `active`), or both. `singular`: the
    box is closed or periodic with every cell the caller's, so the constant
    is in the operator's null space as the JAX package sees it."""
    mA_list = c0 = None
    if hard_bcs is not None:
        # staged once per solve: contiguous float32 arrays of the cells' shape, which the kernel's wrapper
        # passes on as they are at every launch
        mA_list, c0 = stage_masks(_full_face_masks(hard_bcs, periodic), bcs, inv_dx2)
    rhs = div
    if singular:
        rhs = sub_mean(_balance_divergence(div, active))
    x0 = torch.zeros_like(div) if pressure is None else pressure

    def apply_A(p):
        return poisson_apply(p, inv_dx2, bcs, mA_list=mA_list, c0=c0, active=active)

    def A(p):
        return poisson_apply(p, inv_dx2, bcs, mA_list=mA_list, c0=c0, active=active, with_dot=True)

    M = None
    if MASKED_PRECONDITIONER == 'vcycle':
        M = _masked_vcycle_preconditioner(tuple(div.shape), dx, bcs, active)
    elif MASKED_PRECONDITIONER == 'chebyshev':
        M = _masked_chebyshev_preconditioner(apply_A, div, bcs)
    elif MASKED_PRECONDITIONER is not None:
        raise ValueError(f"MASKED_PRECONDITIONER {MASKED_PRECONDITIONER!r}: 'chebyshev', 'vcycle' or None expected")
    if singular and M is not None:
        inner = M

        def M(r):
            return sub_mean(inner(r)[0]), None

    # the singular masked operator's null space: the constants on the active cells (identity rows elsewhere)
    result = _solve(A, rhs, x0, rel_tol, abs_tol, max_iterations, M, singular, active if singular else None, active)
    p = result.x
    grad = spatial_gradient_native(p, dx, periodic)
    if hard_bcs is not None:
        grad = tuple(g * m for g, m in zip(grad, hard_bcs))
    return tuple(v - g for v, g in zip(velocity, grad)), p, result


def _solve(A, rhs, x0, rel_tol, abs_tol, max_iterations, M, rank_deficient, null_space=None,
           active=None) -> SolveResult:
    """CG on a pressure system, differentiable implicitly (`implicit_solve`):
    the adjoint solve takes the same operator, preconditioner and tolerances,
    and records a SolveInfo on the active `SolveTape`s."""
    solve = Solve('CG', rel_tol, abs_tol, max_iterations=max_iterations)
    return implicit_solve(cg, A, rhs, x0, rel_tol, abs_tol, max_iterations, M, rank_deficient=rank_deficient,
                          null_space=null_space, active=active, on_adjoint=lambda r: record_adjoint(solve, r))


def make_incompressible_native(velocity: Sequence[torch.Tensor], pressure: Optional[torch.Tensor], dx: float,
                        rel_tol: float = 1e-5, abs_tol: float = 1e-5, max_iterations: int = 1000,
                        periodic: bool = False, active: Optional[torch.Tensor] = None, obstacles=()
                        ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, SolveResult]:
    """Project the staggered velocity (raw components x, y[, z]) onto its
    divergence-free part. `pressure` is the solve's initial guess x0 (zeros
    when None). `active` (cells' shape, 1 or 0) restricts the system to the
    active cells; elsewhere the pressure solves p = 0 and the velocity may
    hold NaN. `obstacles`: `Obstacle`s or bare geometries (stationary); their
    velocities are imposed on the faces they cover and no flux crosses a face
    next to a cell whose centre lies inside one. Returns (velocity, pressure,
    solve result); not converging within max_iterations is not an error, as
    for the models' solves."""
    obstacles = _get_obstacles_for(obstacles)
    resolution = _resolution(velocity, periodic)
    bcs = _classify_pressure_bc(periodic, len(resolution))
    inv_dx2 = (1.0 / (dx * dx),) * len(resolution)
    if active is not None and tuple(active.shape) != resolution:
        raise ValueError(f"active: shape {tuple(active.shape)} != the cells' {resolution}")
    all_active = active is None
    hard_bcs = None
    if obstacles:
        cells = cell_grid(resolution, dx, velocity[0].device)
        accessible = geometry_mask(~union([o.geometry for o in obstacles]), cells).contiguous()
        v_extrap = PERIODIC_EXTRAPOLATION if periodic else 0.0
        hard_bcs = stagger_native(accessible, torch.minimum, _accessible_extrapolation(v_extrap), periodic)
        active = accessible if active is None else active * accessible
        velocity = apply_boundary_conditions_native(velocity, obstacles, dx, periodic)
    div = divergence_native(velocity, dx, periodic)
    if active is not None:
        # JAX's order: the product first (0 · NaN is NaN), then, for a caller's active cells, non-finite entries to 0
        div = div * active
        if not all_active:
            div = torch.where(torch.isfinite(div), div, torch.zeros_like(div))
        return _project_masked(velocity, div, pressure, active, hard_bcs, all_active, dx, inv_dx2, bcs, periodic,
                               rel_tol, abs_tol, max_iterations)
    rhs = sub_mean(_balance_divergence(div))  # rank deficiency 1: project onto range(A)
    x0 = torch.zeros_like(div) if pressure is None else pressure
    M = _grid_multigrid_preconditioner(resolution, dx, bcs, div.device)

    def A(p):
        return poisson_apply(p, inv_dx2, bcs, with_dot=True)

    result = _solve(A, rhs, x0, rel_tol, abs_tol, max_iterations, M, True)
    p = result.x
    grad = spatial_gradient_native(p, dx, periodic)
    velocity = tuple(v - g for v, g in zip(velocity, grad))
    return velocity, p, result


def boundary_push_native(positions: torch.Tensor, domain_size: Sequence[float], separation: float = 0.5,
                  obstacles=()) -> torch.Tensor:
    """Push particles out of the box obstacles (`Box`, `Cuboid`, or
    `Obstacle`s of them; the box's axes, as the JAX package pushes), then pull
    those that left the domain [0, domain_size] back inside; both to
    `separation` from the surface — `boundary_push(particles, [*obstacles,
    ~bounds])` of the JAX package. Other geometries have no exact push."""
    for obj in obstacles:
        geometry = obj.geometry if isinstance(obj, Obstacle) else obj
        if not isinstance(geometry, (Box, Cuboid)):
            raise NotImplementedError(f"boundary_push: {type(geometry).__name__} has no exact push; only boxes are ported")
        positions = box_push(positions, np.asarray(geometry.lower), np.asarray(geometry.upper), outward=True,
                             shift_amount=separation)
    return box_push(positions, (0.0,) * len(domain_size), tuple(domain_size), outward=False,
                    shift_amount=separation)


# ---------------------------------------------------------------------------
# the Field layer
# ---------------------------------------------------------------------------

def _box_of(velocity) -> Tuple[bool, float]:
    """(periodic, dx) of a staggered velocity Field the array layer covers:
    a closed box with walls at rest across them or a periodic box, one cell
    size."""
    if not (velocity.is_grid and velocity.is_staggered):
        raise NotImplementedError("the projection of a centred or non-grid velocity comes with a later slice")
    names = velocity.resolution.names
    layout = _array_layout(velocity, names)
    if layout == 'closed' and not _normal_walls_at_rest(velocity):
        raise NotImplementedError(f"velocity boundary {velocity.boundary!r}: walls with a normal velocity come "
                                  f"with a later slice of the port")
    dx = _isotropic_dx(velocity)
    if dx is None:
        raise NotImplementedError("cells of different sizes along the axes come with a later slice")
    if not all(_plain_values(c, names) for c in face_components(velocity.values)):
        raise NotImplementedError(f"velocity values {velocity.values.shape}: grid dims only are ported")
    return layout == 'periodic', dx


def _faces(velocity):
    return face_components(velocity.values)


def _pressure_extrapolation(vext):
    """The pressure's boundary from the velocity's."""
    if vext == extrapolation.PERIODIC:
        return extrapolation.PERIODIC
    if vext == extrapolation.BOUNDARY:
        return extrapolation.ZERO
    if isinstance(vext, ConstantExtrapolation):
        return extrapolation.BOUNDARY
    return extrapolation.map(_pressure_extrapolation, vext)


def _component_values(velocity, arrays):
    names = velocity.resolution.names
    return face_values([Tensor(a, c.shape.only(names, reorder=True))
                        for a, c in zip(arrays, face_components(velocity.values))], velocity.values)


def make_incompressible(velocity, obstacles=(), solve: Solve = Solve(), active=None, order: int = 2,
                        correct_skew=False, wide_stencil: bool = None):
    """Project the velocity Field onto its divergence-free part. Returns
    (velocity, pressure) as Fields; the pressure is the solve's x0's Field
    (boundary and grid) with the solution, or a new Field under the pressure
    boundary derived from the velocity's. `correct_skew` is taken and unused,
    as in the JAX package.

    A staggered velocity (order 2, the compact stencil) unwraps into
    `make_incompressible_native`; a true `wide_stencil` raises there. A
    centred velocity is projected with the wide stencil of `order` (2, 4 or
    6): `_make_incompressible_centred`; a velocity on a mesh by
    `_make_incompressible_mesh`."""
    if velocity.is_mesh:
        return _make_incompressible_mesh(velocity, obstacles, solve, active, order)
    if velocity.is_grid and velocity.is_centered:
        return _make_incompressible_centred(velocity, obstacles, solve, active, order, wide_stencil)
    if order != 2:
        raise NotImplementedError("the projection of a staggered velocity is of order 2: higher orders come with "
                                  "a later slice of the port")
    if wide_stencil:
        raise NotImplementedError("the wide-stencil Laplacian (the divergence of centred gradients) of a staggered "
                                  "velocity comes with a later slice of the port: its projection solves the compact "
                                  "stencil")
    periodic, dx = _box_of(velocity)
    solve = solve.with_defaults('solve')
    check_method(solve)
    if solve.method not in CG_METHODS:
        raise NotImplementedError(f"solve method {solve.method!r} for the projection of a staggered velocity: its "
                                  f"array layer solves by CG; BiCGStab there comes with a later slice of the port")
    if callable(solve.preconditioner):
        raise NotImplementedError("a caller's preconditioner for the projection comes with a later slice")
    names = velocity.resolution.names
    x0 = solve.x0
    pressure0 = None
    if x0 is not None:
        x0_values = x0.values if isinstance(x0, Field) else x0
        pressure0 = x0_values.torch(names).contiguous()
    active_native = None
    if active is not None:
        active_native = (active.values if isinstance(active, Field) else active).torch(names).contiguous()
    comps = [c.torch(names) for c in _faces(velocity)]
    v, p, result = make_incompressible_native(comps, pressure0, dx, solve.rel_tol, solve.abs_tol,
                                              solve.max_iterations, periodic, active_native, obstacles)
    if isinstance(x0, Field):
        pressure = x0.with_values(Tensor(p, x0.values.shape.only(names, reorder=True)))
    else:
        pressure = Field(velocity.geometry, Tensor(p, velocity.resolution), _pressure_extrapolation(velocity.boundary))
    finish_solve(solve, pressure, result)
    return velocity.with_values(_component_values(velocity, v)), pressure


def _balance_divergence_field(div, active):
    """The Field form of `_balance_divergence`: the mean subtracted (over the
    active cells with `active`)."""
    if active is not None:
        return div - active * (field_mean(div) / field_mean(active))
    return div - field_mean(div)


@jit_compile_linear
def _wide_laplace(pressure, v_boundary, order=2):
    """The wide-stencil Laplacian, the CG matvec of a centred projection: the
    divergence of the pressure's centred gradient, both of `order`
    (`phiflow_tpu/physics/fluid.py:296-299`)."""
    grad = spatial_gradient(pressure, v_boundary, at='center', order=order)
    grad = grad.with_boundary(extrapolation.remove_constant_offset(grad.boundary))
    return divergence(grad, order=order)


def _make_incompressible_centred(velocity, obstacles, solve: Solve, active, order: int, wide_stencil):
    """The projection of a centred velocity with all cells active and no
    obstacle (`phiflow_tpu/physics/fluid.py:203-213`): the divergence of
    `order`, balanced and with rank deficiency 1 unless the boundary lets
    flux out, solved by `solve_linear` over `_wide_laplace` — unpreconditioned
    CG, as the JAX package chooses for the wide stencil, x0 = 0 under the
    pressure boundary unless `solve` has one — and the pressure's centred
    gradient subtracted."""
    if _get_obstacles_for(obstacles) or active is not None:
        raise NotImplementedError("obstacles or active cells with a centred velocity come with a later slice of the "
                                  "port")
    if wide_stencil is False:
        raise NotImplementedError("the compact stencil for a centred velocity comes with a later slice of the port: "
                                  "its projection solves the wide stencil")
    check_method(solve)
    div = divergence(velocity, order=order)
    if not velocity.boundary.is_flexible:
        solve = solve.with_preprocessing(_balance_divergence_field, None)
        if solve.rank_deficiency is None:
            solve = copy_solve(solve, rank_deficiency=1)
    if solve.x0 is None:
        solve = copy_solve(solve, x0=Field(div.geometry, wrap(0.), _pressure_extrapolation(velocity.boundary)))
    if not callable(solve.preconditioner):
        solve = copy_solve(solve, preconditioner=None)
    pressure = solve_linear(_wide_laplace, div, solve, velocity.boundary, order=order, assume_homogeneous=True)
    grad_pressure = spatial_gradient(pressure, velocity.boundary, at='center', order=order)
    return (velocity - grad_pressure).with_boundary(velocity.boundary), pressure


@jit_compile_linear(auxiliary_args='wide_stencil,order', forget_traces=True)
def masked_laplace(pressure, v_boundary, hard_bcs, active, wide_stencil=False, order=2):
    """The Laplacian of the pressure, the matvec of a projection at the Field
    level: on a mesh its FVM Laplacian (`mesh_laplace`, skew-corrected). A
    grid's stencils are the array layer's (`make_incompressible_native`) and
    `_wide_laplace`."""
    if not pressure.is_mesh:
        raise NotImplementedError("masked_laplace of a grid: the projection of a grid velocity solves the array "
                                  "layer's stencils (make_incompressible_native, _wide_laplace)")
    return laplace(pressure, order=order)


def _is_homogeneous_pressure_bc(ext) -> bool:
    """Whether padding a zero field with `ext` gives zeros, so that
    masked_laplace(0) = 0 and no offset f(0) need be subtracted."""
    if ext is None or isinstance(ext, (_PeriodicExtrapolation, _BoundaryExtrapolation, _SymmetricExtrapolation,
                                       _ReflectExtrapolation, _AntiSymmetricExtrapolation,
                                       _AntiReflectExtrapolation)):
        return True
    if isinstance(ext, ConstantExtrapolation):
        return ops.always_close(ext.value, 0)
    if isinstance(ext, _MixedExtrapolation):
        return all(_is_homogeneous_pressure_bc(e) for pair in ext.ext.values() for e in pair)
    return False


def _mesh_chebyshev_preconditioner(x0, order: int = 2, degree: int = 4, eig_ratio: float = 30.):
    """Chebyshev(Jacobi) preconditioner of a mesh pressure system
    (`phiflow_tpu/physics/fluid.py:428-461`): z ≈ A⁻¹r by a polynomial of
    `degree` in B = D⁻¹A, D the analytic diagonal (`mesh_laplace_diagonal`),
    on the fixed interval [2 / eig_ratio, 2] — degree − 1 Laplacians an
    application, nothing at setup."""
    from ..field._mesh_math import mesh_laplace_diagonal
    inv_diag = 1. / mesh_laplace_diagonal(x0)
    lmax = 2.0
    a, b = lmax / eig_ratio, lmax
    theta, delta = (b + a) / 2., (b - a) / 2.
    sigma1 = theta / delta

    def preconditioner(r):
        rs = r.values * inv_diag
        z = rs / theta
        d = z
        rho = 1. / sigma1
        for _ in range(degree - 1):
            Bz = laplace(r.with_values(z), order=order).values * inv_diag
            rho_new = 1. / (2. * sigma1 - rho)
            d = rho_new * rho * d + (2. * rho_new / delta) * (rs - Bz)
            z = z + d
            rho = rho_new
        return r.with_values(z)

    return preconditioner


def _make_incompressible_mesh(velocity, obstacles, solve: Solve, active, order: int):
    """The projection of a velocity on a mesh (`phiflow_tpu/physics/fluid.py`
    `:228-272`, its mesh branch `:243-250`): the FVM divergence, balanced with
    rank deficiency 1 unless the boundary lets flux out; x0 = 0 under the
    pressure boundary derived from the velocity's unless `solve` has one;
    with no preconditioner or 'auto' the mesh Chebyshev preconditioner, and
    'auto' becomes BiCGStab (A = V⁻¹L is nonsymmetric); `masked_laplace`
    solved without the offset f(0) where the pressure boundary is
    homogeneous; the Green-Gauss gradient of the pressure subtracted."""
    if _get_obstacles_for(obstacles) or active is not None:
        raise NotImplementedError("obstacles or active cells with a velocity on a mesh come with a later slice of "
                                  "the port")
    div = divergence(velocity, order=order)
    if not velocity.boundary.is_flexible:
        solve = solve.with_preprocessing(_balance_divergence_field, None)
        if solve.rank_deficiency is None:
            solve = copy_solve(solve, rank_deficiency=1)
    if solve.x0 is None:
        solve = copy_solve(solve, x0=Field(div.geometry, wrap(0.), _pressure_extrapolation(velocity.boundary)))
    if solve.preconditioner in (None, 'auto'):
        solve = copy_solve(solve, preconditioner=_mesh_chebyshev_preconditioner(solve.x0, order=order))
        if solve.method == 'auto':
            solve = copy_solve(solve, method='biCG-stab')
    elif not callable(solve.preconditioner):
        solve = copy_solve(solve, preconditioner=None)
    homogeneous = _is_homogeneous_pressure_bc(solve.x0.boundary if isinstance(solve.x0, Field) else None)
    pressure = solve_linear(masked_laplace, div, solve, velocity.boundary, None, None, wide_stencil=False,
                            order=order, assume_homogeneous=homogeneous)
    grad_pressure = spatial_gradient(pressure, velocity.boundary, at=velocity.sampled_at, order=order)
    return (velocity - grad_pressure).with_boundary(velocity.boundary), pressure


def incompressible_rk4(pde: Callable, velocity, pressure, dt, pressure_order=4, pressure_solve=Solve('CG'),
                       **pde_aux_kwargs):
    """RK4 with the pressure projection inside every stage: each stage
    advances a trial velocity by the stage step along the PDE's right-hand
    side minus the current pressure gradient and projects it; the stage
    pressure adds the projection's pressure over the stage step (the solve
    returns step·Δp)."""
    at = velocity.sampled_at

    def stage(stage_dt, rhs, p_prev):
        trial = velocity + stage_dt * rhs
        projected, correction = make_incompressible(trial, solve=pressure_solve, order=pressure_order)
        return projected, p_prev + correction / stage_dt

    def momentum(v, p):
        return pde(v, **pde_aux_kwargs) - p.gradient(at=at, order=pressure_order)

    k1 = momentum(velocity, pressure)
    v_half, p_half = stage(dt / 2, k1, pressure)
    k2 = momentum(v_half, p_half)
    v_half2, p_half2 = stage(dt / 2, k2, p_half)
    k3 = momentum(v_half2, p_half2)
    v_full, p_full = stage(dt, k3, p_half2)
    k4 = momentum(v_full, p_full)
    return stage(dt, (k1 + 2 * k2 + 2 * k3 + k4) / 6, (pressure + 2 * p_half + 2 * p_half2 + p_full) / 6)


def apply_boundary_conditions(velocity, obstacles):
    """Blend the obstacles' velocities into the staggered velocity Field
    (`apply_boundary_conditions_native` on its components)."""
    periodic, dx = _box_of(velocity)
    names = velocity.resolution.names
    comps = apply_boundary_conditions_native([c.torch(names) for c in _faces(velocity)], obstacles, dx,
                                             periodic)
    return velocity.with_values(_component_values(velocity, comps))


def boundary_push(particles, obstacles, separation: float = 0.5):
    """Push a point cloud's points out of the obstacles — `~bounds` pulls them
    back into the domain — each geometry's `push` in turn, to `separation`
    from its surface."""
    pos = particles.geometry.center
    for obj in obstacles:
        geometry = obj.geometry if isinstance(obj, Obstacle) else obj
        assert isinstance(geometry, Geometry), f"expected Geometry, got {type(obj)}"
        pos = geometry.push(pos, shift_amount=separation)
    return particles.with_geometry(particles.geometry.at(pos))

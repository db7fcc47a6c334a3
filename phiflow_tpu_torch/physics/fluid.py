"""Pressure projection — port of `phiflow_tpu/physics/fluid.py::make_incompressible`
(`:164-304`): a staggered velocity in every box the JAX package projects —
walls at rest or with a normal velocity, open sides (both outer faces
stored, the pressure 0 beyond them), periodic axes, cells of unequal size —
with obstacles (`Obstacle`, `apply_boundary_conditions`) and free surfaces,
by any solve method and preconditioner; the centred velocity's wide-stencil
projection of orders 2, 4 and 6 (`_make_incompressible_centred`) and its
compact stencil; a nested domain, whose pressure boundary samples a coarser
Field (`field/_embed.py`); the projection of a velocity on an unstructured
mesh (`_make_incompressible_mesh`: BiCGStab on the FVM Laplacian,
preconditioned by Chebyshev(Jacobi) on its analytic diagonal, all PyTorch
operations); `solve_pressure_field`; and `incompressible_rk4` (`:671-701`),
RK4 with the projection inside every stage.

`make_incompressible(velocity, obstacles, solve, active)` and
`apply_boundary_conditions(velocity, obstacles)` take Fields with JAX's
signatures. Where `_classify_pressure_bc` gives the pressure operator's mode
on every side (periodic, neumann, ghost0), a staggered velocity unwraps into
the array layer's `make_incompressible_native` on its raw face components
(its `face_layout`, one cell size per axis), described below; otherwise (a
Field embedding as the pressure's boundary) and for a centred velocity's
compact stencil the Field-level body of the JAX package runs on Fields,
`solve_linear` over `masked_laplace`, which is `poisson_apply` wherever the
boundary classifies and the face gradient, mask and divergence elsewhere.
`boundary_push(particles, obstacles, separation)` moves a point cloud's
points with each geometry's `push` (`box_push` for boxes). The solve's
tolerances, `x0` and `max_iterations` carry through; the pressure comes
back as a Field, the solve's `SolveInfo` on every active `SolveTape`, and
`NotConverged` / `Diverged` are raised unless the solve suppresses them.

The solve: the method dispatches as `math.solve_linear` does (CG,
CG-adaptive, BiCGStab, BiCGStab(2), direct through `_stencil_matrix`, CG
for an unknown name); the preconditioner follows JAX's rule
(`_preconditioner`): the projection's own for None / 'auto' / 'multigrid'
under the CG family, a caller's callable as given, none otherwise.

All cells active, no obstacle: divergence (the walls' normal velocity
included) → in a box with no open side `_balance_divergence` and rank
deficiency 1 → the solve on the Poisson stencil (K1), preconditioned by the
multigrid V-cycle (K2–K4) from x0 = the previous pressure → subtract the
pressure gradient.

With `active` (a free surface: 1 in the cells the liquid occupies, 0
elsewhere): divergence · active, non-finite entries zeroed → the solve on
K1's masked form (inactive cells are identity rows), preconditioned by
Chebyshev(Jacobi) on the exact masked diagonal; the system is nonsingular,
so no mean is removed anywhere. `boundary_push` keeps particles inside the
domain and outside box obstacles.

With `obstacles`: the cells outside every obstacle are `accessible`; a face is
open (`hard_bcs`) where both its cells are. The obstacles' velocities are
blended into the field, the open-face masks are staged once per solve into
K1's coefficient arrays (`mA`, `c0`) and the accessible cells are its
`active` cells, so every matvec is one launch of K1's masked form with all
seven arrays; the pressure gradient is subtracted on open faces only. Without
a caller's `active` a box with no open side stays singular and is treated
as the JAX package treats it: the right-hand side is balanced over the
accessible cells, and the plain mean over all cells is removed from it, from
every preconditioner output and from the result. `MASKED_PRECONDITIONER`
chooses the masked systems' preconditioner. The array layer's origin is the
grid's lower corner: the Field layer shifts the obstacles there.

2D or 3D: the kernels are 3D; a 2D solve runs the same code through the
wrappers' PyTorch route (`ops/poisson.py`).

Batches: the velocity's components (and the previous pressure) may carry
leading batch axes, the JAX package's batch dims, each entry its own system.
All entries run through one CG loop (`math._solve.cg` with nb axes: a
converged system frozen while the others go on, the loop ending when all
have converged), each with its own balanced divergence, tolerance and mean
removed from every preconditioner output; every kernel launch (K1–K4, K1m)
covers the whole batch. Obstacles and `active` are shared by the batch (K1m
reads one set of masks for every entry, the Chebyshev preconditioner one
diagonal); masks with batch dims of their own raise ValueError, as the JAX
package fails on them. A centred velocity's batch and a mesh velocity's go
through `solve_linear`, one system an entry.

Every projection is differentiable in the velocity: its solve is
differentiated implicitly (`math/_solve.py::implicit_solve`), so a backward
runs one adjoint solve on the same kernels (K1, K1m, K2–K4) under
`no_grad`, and the gradient reaches the velocity through the divergence and
the pressure-gradient subtraction, which autograd follows. The previous
pressure (x0) gets no gradient.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field._angular_velocity import angular_velocity_at_faces
from ..field._field import Field, face_components, face_values
from ..field._field_math import (
    _batch_dims, _batch_native, _batch_tensor, _dx_tuple, _face_layout, _faces, _per_axis, _side_ext, divergence,
    divergence_native, laplace,
    mean as field_mean, safe_mul_native, spatial_gradient, spatial_gradient_native,
    stagger, stagger_native, stored_faces, where as field_where, is_finite as field_is_finite,
)
from ..field._resample import cell_grid, geometry_mask
from ..geom._box import Box, Cuboid, box_push
from ..geom._geom import Geometry, host_vec, vector_tensor
from ..geom._geom_ops import union
from ..math import (EMPTY_SHAPE, Shape, Tensor, channel, copy_solve, extrapolation, instance, jit_compile_linear,
                    solve_linear, wrap)
from ..math._shape import merge_shapes
from ..math import _ops as ops
from ..math._extrapolation import (
    ConstantExtrapolation, _AntiReflectExtrapolation, _AntiSymmetricExtrapolation, _BoundaryExtrapolation,
    _MixedExtrapolation, _PeriodicExtrapolation, _ReflectExtrapolation, _SymmetricExtrapolation,
)
from ..math._multigrid import make_poisson_vcycle
from ..math._nd import BOUNDARY, PERIODIC as PERIODIC_EXTRAPOLATION, Extrapolation, PerSide
from ..math._solve import (PRECONDITIONED_METHODS, Direct, Solve, SolveResult, _bc, bicgstab, finish_solve,
                           implicit_solve, krylov_of, record_adjoint, reroute_direct, sub_mean)
from ..ops.poisson import GHOST0, NEUMANN, PERIODIC, per_entry, poisson_apply, stage_masks

__all__ = ['Obstacle', 'make_incompressible', 'masked_laplace', 'apply_boundary_conditions', 'boundary_push',
           'incompressible_rk4',
           'solve_pressure_field', 'make_incompressible_native', 'apply_boundary_conditions_native',
           'boundary_push_native', 'MASKED_PRECONDITIONER']

MASKED_PRECONDITIONER = 'chebyshev'  # 'chebyshev' | 'vcycle' | None — the masked systems' preconditioner
# masks that differ between a batch's systems: the JAX package's projection fails on them
BATCHED_MASKS = (": masks with batch dims (an obstacle or active cells per entry) are not projected: the JAX "
                 "package's `make_incompressible` fails there (an AssertionError in its `_fused_masked_laplace`, "
                 "phiflow_tpu/math/_tensor.py:547)")


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


def _accessible_sides(layout) -> Extrapolation:
    """`_accessible_extrapolation` by side from a velocity's `face_layout`:
    0 behind a wall (a face not stored), 1 beyond an open side, periodic
    axes wrap."""
    if all(f == 'periodic' for f in layout):
        return PERIODIC_EXTRAPOLATION
    sides = [(PERIODIC_EXTRAPOLATION,) * 2 if f == 'periodic' else
             tuple(_accessible_extrapolation(BOUNDARY if w is None else w) for w in f) for f in layout]
    if all(side == (0.0, 0.0) for side in sides):
        return 0.0
    return PerSide(*sides)


def _resolution(velocity: Sequence[torch.Tensor], faces) -> Tuple[int, ...]:
    """The cells of a staggered velocity's domain: component 0 stores
    N + (outer faces stored) − 1 faces along its own axis (the grid's axes
    are the trailing ones)."""
    nd = len(velocity)
    lo, up = stored_faces(_faces(faces, nd)[0])
    return tuple(n + (1 - int(lo) - int(up) if a == 0 else 0) for a, n in enumerate(velocity[0].shape[-nd:]))


def apply_boundary_conditions_native(velocity: Sequence[torch.Tensor], obstacles, dx,
                                     faces=None) -> Tuple[torch.Tensor, ...]:
    """Blend the obstacles' velocities into the staggered `velocity` (`faces`:
    its face layout, the closed box by default): on the share of each face that an
    obstacle covers (the soft mask with ``balance=1``: a face whose centre
    lies on the surface counts as covered) the obstacle's own velocity,
    translation plus rotation, replaces the fluid's; a stationary obstacle
    leaves 0."""
    obstacles = _get_obstacles_for(obstacles)
    layout = _faces(faces, len(velocity))
    cells = cell_grid(_resolution(velocity, layout), dx, velocity[0].device)
    face_grids = tuple(cells.stagger(axis, *stored_faces(layout[axis])) for axis in range(len(velocity)))
    velocity = tuple(velocity)
    for obstacle in obstacles:
        obs_mask = geometry_mask(obstacle.geometry, face_grids, soft=True, balance=1)
        if obstacle.is_stationary:
            velocity = tuple(safe_mul_native(1 - m, v) for m, v in zip(obs_mask, velocity))
            continue
        if obstacle.is_rotating:
            angular = angular_velocity_at_faces(face_grids, obstacle.geometry._center, obstacle._angular_velocity)
        else:
            angular = tuple(v * 0 for v in velocity)
        velocity = tuple(safe_mul_native(1 - m, v) +
                         safe_mul_native(m, (w + float(u)).expand(torch.broadcast_shapes(w.shape, m.shape)))
                         for m, v, w, u in zip(obs_mask, velocity, angular, obstacle._velocity))
    return velocity


def pressure_modes(layout) -> tuple:
    """The pressure operator's (lower, upper) mode per axis for a velocity's
    `face_layout` and the pressure boundary derived from it: periodic, neumann
    behind a wall (its face not stored: no flux), ghost0 beyond an open side
    (the pressure is 0 there)."""
    return tuple((PERIODIC, PERIODIC) if f == 'periodic' else tuple(NEUMANN if w is not None else GHOST0 for w in f)
                 for f in layout)


def _pressure_ghosts(bcs):
    """The pressure's extrapolation for the face gradient in the modes `bcs`:
    0 beyond a ghost0 side, a copy of the edge (no flux) beyond a neumann one."""
    return PerSide(*[(PERIODIC_EXTRAPOLATION,) * 2 if lo == PERIODIC else
                     tuple(0.0 if m == GHOST0 else BOUNDARY for m in (lo, hi)) for lo, hi in bcs])


def _balance_divergence(div: torch.Tensor, active: Optional[torch.Tensor] = None, nb: int = 0) -> torch.Tensor:
    """Subtract the mean so the singular Poisson system is solvable, per
    system of the `nb` leading axes (each mean taken as an unbatched one
    is); with `active` (shared by the systems), spread it over the active
    cells only."""
    if active is not None:
        mean = per_entry(torch.mean, nb, div)
        return div - active * _bc(mean / torch.mean(active), div, nb)
    return sub_mean(div, nb)


def _grid_multigrid_preconditioner(resolution, dx, bcs, device, singular: bool = True, nb: int = 0):
    """The V-cycle preconditioner M(r) -> (z, None) (`dx`: one cell size, or
    one per axis), z projected onto zero mean (per system of the `nb` leading
    axes) for a `singular` system (rank deficiency 1), or None below 16 cells
    per axis, where plain CG converges in a handful of iterations."""
    if max(resolution) < 16:
        return None
    vcycle = make_poisson_vcycle(tuple(resolution), _per_axis(dx, len(resolution)), bcs, device)

    def preconditioner(r: torch.Tensor):
        # CG takes ⟨r, z⟩ after the mean projection of z, on every device. K2
        # can emit the dot before it (the order of JAX on the chip), but the
        # two differ by mean(z)·Σr: Σr is the float32 roundoff of the first
        # residuals and does not shrink with r, so near tolerance the early
        # dot was off by 12× its value at 256³ (`chip_smoke.py::cg_dot_probe`)
        # and α grew without bound: the card's CG diverged (2D at 1024² and
        # 4096², 3D at 256³).
        z, _ = vcycle(r)
        return (sub_mean(z, nb) if singular else z), None

    return preconditioner


def _masked_diagonal(apply_A: Callable, template: torch.Tensor, bcs) -> Optional[torch.Tensor]:
    """The exact diagonal of a masked pressure operator by checkerboard
    probing: the operator couples a cell only to its axis neighbours, which
    have the other parity, so A·e_c is the diagonal wherever the cell has
    parity c. Two matvecs give all of it, identity rows and boundary rows
    included. None where parity is ill-defined (a periodic axis of odd size)."""
    sizes = tuple(template.shape[template.ndim - len(bcs):])  # the grid's: one diagonal for a batch's systems
    if any(lo == PERIODIC and n % 2 for (lo, _), n in zip(bcs, sizes)):
        return None
    idx = sum(torch.arange(n, device=template.device).reshape([n if j == i else 1 for j in range(len(sizes))])
              for i, n in enumerate(sizes))
    parity = (idx % 2).to(template.dtype)
    d_even = apply_A(1. - parity)
    d_odd = apply_A(parity)
    return (1. - parity) * d_even + parity * d_odd


def _stencil_matrix(bcs):
    """`matrix(A, b, nb)` of a `Direct` solve for a nearest-neighbour
    operator A on b's grid: A applied to one probe per colour of a colouring
    in which a cell and its axis neighbours all differ (residues per axis:
    3, or along a periodic axis the smallest divisor ≥ 3 of its size), each
    row's entries read off the probes of its neighbours' colours. Exact, as
    the JAX package's A of the identity's columns, in Π k_d matvecs (9 in
    2D, 27 in 3D) through the operator's own kernel. With `nb` leading batch
    axes the one matrix serves every system: the unmasked operator is the
    same for all."""
    def matrix(A, b, nb):
        shape, dev = tuple(b.shape[nb:]), b.device
        ks = [next(k for k in range(min(3, n), n + 1) if bc[0] != PERIODIC or n % k == 0) for n, bc in zip(shape, bcs)]
        grids = torch.meshgrid(*[torch.arange(n, device=dev) for n in shape], indexing='ij')
        color = torch.zeros(shape, dtype=torch.int64, device=dev)
        for g, k in zip(grids, ks):
            color = color * k + g % k
        n = int(np.prod(shape))
        probes = torch.stack([A((color == c).to(b.dtype))[0] for c in range(int(np.prod(ks)))]).reshape(-1, n)
        rows = torch.arange(n, device=dev)
        mat = torch.zeros((n, n), dtype=b.dtype, device=dev)
        offsets = [None] + [(d, s) for d in range(len(shape)) for s in (-1, 1)]
        for off in offsets:
            j = [g.reshape(-1) for g in grids]
            valid = torch.ones(n, dtype=torch.bool, device=dev)
            if off is not None:
                d, step = off
                j[d] = j[d] + step
                if bcs[d][0] == PERIODIC:
                    j[d] = j[d] % shape[d]
                else:
                    valid = (j[d] >= 0) & (j[d] < shape[d])
                    j[d] = j[d].clamp(0, shape[d] - 1)
            col = torch.zeros(n, dtype=torch.int64, device=dev)
            for d, jd in enumerate(j):
                col = col * shape[d] + jd
            vals = probes[color.reshape(-1)[col], rows]
            mat[rows[valid], col[valid]] = vals[valid]
        return mat
    return matrix


CHEBYSHEV_DEGREE = 4       # of the masked preconditioner's polynomial: degree − 1 matvecs an application
CHEBYSHEV_EIG_RATIO = 30.  # its eigenvalue bounds are [2 / ratio, 2]


def _masked_chebyshev_preconditioner(apply_A: Callable, template: torch.Tensor, bcs):
    """Chebyshev(Jacobi) preconditioner M(r) -> (z, None) for a masked
    pressure system: a polynomial in B = D⁻¹A with D the exact masked
    diagonal. Identity rows have eigenvalue 1 and active rows are diagonally
    dominant, so B's spectrum lies in (0, 2] and fixed bounds need no power
    iteration. Two matvecs to build, three an application. None where the
    diagonal cannot be probed. A batch of systems sharing their masks shares
    the diagonal (probed on the grid alone, as the JAX package probes it on
    its unbatched x0) and applies the polynomial to r's leading axes."""
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


def _masked_vcycle_preconditioner(resolution, dx, bcs, active: torch.Tensor):
    """Projected multigrid for masked systems: z = P·V(P·r) + (I − P)·r with P
    the active-cell projection and V the unmasked Poisson V-cycle (K2–K4).
    Identity rows are exact; next to an obstacle V only approximates, which
    slows CG down and does not break it. None below 16 cells per axis. r may
    carry leading batch axes (one V-cycle launch a level for the batch, P
    shared)."""
    if max(resolution) < 16:
        return None
    vcycle = make_poisson_vcycle(tuple(resolution), _per_axis(dx, len(resolution)), bcs, active.device)

    def preconditioner(r: torch.Tensor):
        z, _ = vcycle(r * active)
        return z * active + r * (1. - active), None

    return preconditioner


def _full_face_masks(hard_bcs: Sequence[torch.Tensor], faces=None):
    """The open-face masks over every face of each axis, as `stage_masks`
    takes them (`faces`: the velocity's face layout, the closed box by
    default): the outer faces that the velocity does not store (behind a
    wall) are closed (their flux is dropped), so they enter as 0."""
    layout = _faces(faces, len(hard_bcs))
    full = []
    for axis, m in enumerate(hard_bcs):
        if layout[axis] == 'periodic':
            full.append(m)
            continue
        lo, up = stored_faces(layout[axis])
        zero = torch.zeros_like(m.narrow(axis, 0, 1))
        full.append(torch.cat(([] if lo else [zero]) + [m] + ([] if up else [zero]), dim=axis))
    return full


def _masked_preconditioner(apply_A, div, dx, bcs, active):
    """`MASKED_PRECONDITIONER`'s preconditioner of a masked system (`div`: a
    template, its trailing axes the grid's)."""
    if MASKED_PRECONDITIONER == 'vcycle':
        return _masked_vcycle_preconditioner(tuple(div.shape[div.ndim - len(bcs):]), dx, bcs, active)
    if MASKED_PRECONDITIONER == 'chebyshev':
        return _masked_chebyshev_preconditioner(apply_A, div, bcs)
    if MASKED_PRECONDITIONER is not None:
        raise ValueError(f"MASKED_PRECONDITIONER {MASKED_PRECONDITIONER!r}: 'chebyshev', 'vcycle' or None expected")
    return None


def _project_masked(velocity, div, pressure, active, hard_bcs, singular, dx, inv_dx2, bcs, layout, rel_tol,
                    abs_tol, max_iterations, method, preconditioner, nb: int = 0):
    """The masked branches of `make_incompressible`: a free surface
    (`active`), obstacles (`hard_bcs` and `active`), or both. `singular`: the
    box is closed or periodic with every cell the caller's, so the constant
    is in the operator's null space as the JAX package sees it. `nb` leading
    batch axes of the velocity, `div` and `pressure` hold one system an
    entry, all sharing the masks: each balanced and projected on its own
    means (`per_entry`), one CG loop, every K1m launch for the batch."""
    mA_list = c0 = None
    if hard_bcs is not None:
        # staged once per solve: contiguous float32 arrays of the cells' shape, which the kernel's wrapper
        # passes on as they are at every launch
        mA_list, c0 = stage_masks(_full_face_masks(hard_bcs, layout), bcs, inv_dx2)
    rhs = div
    if singular:
        rhs = sub_mean(_balance_divergence(div, active, nb), nb)
    x0 = torch.zeros_like(div) if pressure is None else pressure

    def apply_A(p):
        return poisson_apply(p, inv_dx2, bcs, mA_list=mA_list, c0=c0, active=active)

    def A(p):
        return poisson_apply(p, inv_dx2, bcs, mA_list=mA_list, c0=c0, active=active, with_dot=True)

    def default():
        M = _masked_preconditioner(apply_A, div, dx, bcs, active)
        if not singular or M is None:
            return M
        return lambda r: (sub_mean(M(r)[0], nb), None)

    M = _preconditioner(method, preconditioner, singular, default, nb)
    # the singular masked operator's null space: the constants on the active cells (identity rows elsewhere)
    result = _solve(A, rhs, x0, rel_tol, abs_tol, max_iterations, M, singular, active if singular else None, active,
                    method, bcs, nb)
    p = result.x
    grad = spatial_gradient_native(p, dx, faces=layout, extrap=_pressure_ghosts(bcs), ndim=len(layout))
    if hard_bcs is not None:
        grad = tuple(g * m for g, m in zip(grad, hard_bcs))
    return tuple(v - g for v, g in zip(velocity, grad)), p, result


def _preconditioner(method: str, preconditioner, singular: bool, default: Callable, nb: int = 0):
    """JAX's rule (`phiflow_tpu/physics/fluid.py:220-254`): the projection's
    own preconditioner (`default()`) for None / 'auto' / 'multigrid' under
    the CG family; a callable M(r) -> z as given (its output without its mean,
    per system of the `nb` leading axes, for a `singular` system); no
    preconditioner otherwise ('ilu' included)."""
    if preconditioner in (None, 'auto', 'multigrid') and method in PRECONDITIONED_METHODS:
        return default()
    if callable(preconditioner):
        def M(r):
            z = preconditioner(r)
            return (sub_mean(z, nb) if singular else z), None
        return M
    return None


def _solve(A, rhs, x0, rel_tol, abs_tol, max_iterations, M, rank_deficient, null_space=None,
           active=None, method: str = 'CG', bcs=None, nb: int = 0) -> SolveResult:
    """The solve's `method` on a pressure system (JAX's dispatch,
    `math._solve.krylov_of`; a direct solve through `_stencil_matrix`),
    differentiable implicitly (`implicit_solve`): the adjoint solve takes the
    same operator, preconditioner and tolerances, and records a SolveInfo on
    the active `SolveTape`s. `nb` leading batch axes hold independent
    systems, solved in one loop."""
    solve = Solve(method, rel_tol, abs_tol, max_iterations=max_iterations)
    krylov = krylov_of(method)
    if krylov is None:
        rerouted = reroute_direct(solve, int(np.prod(rhs.shape[nb:])))
        if rerouted is not None:
            solve, krylov = rerouted, bicgstab
        else:
            krylov = Direct(_stencil_matrix(bcs), rank_deficient)
    return implicit_solve(krylov, A, rhs, x0, solve.rel_tol, solve.abs_tol, max_iterations, M,
                          rank_deficient=rank_deficient, null_space=null_space, active=active,
                          on_adjoint=lambda r: record_adjoint(solve, r), nb=nb)


def make_incompressible_native(velocity: Sequence[torch.Tensor], pressure: Optional[torch.Tensor], dx,
                               rel_tol: float = 1e-5, abs_tol: float = 1e-5, max_iterations: int = 1000,
                               faces=None, active: Optional[torch.Tensor] = None, obstacles=(),
                               method: str = 'CG', preconditioner='auto', bcs=None
                               ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, SolveResult]:
    """Project the staggered velocity (raw components x, y[, z]) onto its
    divergence-free part. `dx`: one cell size or one per axis. `pressure` is
    the solve's initial guess x0 (zeros when None). `active` (cells' shape, 1
    or 0) restricts the system to the active cells; elsewhere the pressure
    solves p = 0 and the velocity may hold NaN. `obstacles`: `Obstacle`s or
    bare geometries (stationary); their velocities are imposed on the faces
    they cover and no flux crosses a face next to a cell whose centre lies
    inside one.

    The box: `faces`, the face layout (per axis periodic, or per side a wall
    with its normal velocity, which enters the divergence, or an open side
    whose outer face the velocity stores; `face_layout(True, d)` is the
    periodic box); the closed box at rest by default. `bcs`: the pressure
    operator's modes per axis and side (`pressure_modes(faces)` by default:
    ghost0 beyond an open side). A box with no open side is singular: its
    divergence is balanced and the constant removed. `method`: the solve's (JAX's dispatch); `preconditioner`
    by JAX's rule (`_preconditioner`): the V-cycle (K2–K4), or with masks
    `MASKED_PRECONDITIONER`'s, for the CG family; a callable on arrays.
    Leading batch axes of the components and the pressure broadcast: one
    system an entry, one CG loop (module docstring); the solve result's
    `residual` has the batch's shape. `active` and the obstacles are shared
    by the batch; an `active` with batch axes raises ValueError, as the JAX
    package fails there (an AssertionError).
    Returns (velocity, pressure, solve result); not converging within
    max_iterations is not an error, as for the models' solves."""
    obstacles = _get_obstacles_for(obstacles)
    nd = len(velocity)
    layout = _faces(faces, nd)
    resolution = _resolution(velocity, layout)
    lead = tuple(torch.broadcast_shapes(*[v.shape[:-nd] for v in velocity],
                                        *([] if pressure is None else [pressure.shape[:-nd]])))
    nb = len(lead)
    if nb:
        velocity = tuple(v.expand(lead + tuple(v.shape[-nd:])) for v in velocity)
        if pressure is not None:
            pressure = pressure.expand(lead + resolution).contiguous()
    bcs = pressure_modes(layout) if bcs is None else tuple(tuple(b) for b in bcs)
    h = _per_axis(dx, len(resolution))
    inv_dx2 = tuple(1.0 / (x * x) for x in h)
    singular = not any(f != 'periodic' and None in f for f in layout)  # the JAX package's `not is_flexible`
    if active is not None and tuple(active.shape) != resolution:
        raise ValueError(f"active: shape {tuple(active.shape)} != the cells' {resolution}"
                         f"{BATCHED_MASKS if active.ndim > nd else ''}")
    all_active = active is None
    hard_bcs = None
    if obstacles:
        cells = cell_grid(resolution, dx, velocity[0].device)
        accessible = geometry_mask(~union([o.geometry for o in obstacles]), cells).contiguous()
        if tuple(accessible.shape) != resolution:
            raise ValueError(f"obstacles of mask shape {tuple(accessible.shape)}, cells {resolution}{BATCHED_MASKS}")
        hard_bcs = stagger_native(accessible, torch.minimum, _accessible_sides(layout), faces=layout)
        active = accessible if active is None else active * accessible
        velocity = apply_boundary_conditions_native(velocity, obstacles, dx, layout)
    div = divergence_native(velocity, dx, faces=layout)
    if active is not None:
        # JAX's order: the product first (0 · NaN is NaN), then, for a caller's active cells, non-finite entries to 0
        div = div * active
        if not all_active:
            div = torch.where(torch.isfinite(div), div, torch.zeros_like(div))
        return _project_masked(velocity, div, pressure, active, hard_bcs, all_active and singular, dx, inv_dx2, bcs,
                               layout, rel_tol, abs_tol, max_iterations, method, preconditioner, nb)
    # rank deficiency 1: project onto range(A)
    rhs = sub_mean(_balance_divergence(div, nb=nb), nb) if singular else div
    x0 = torch.zeros_like(div) if pressure is None else pressure
    M = _preconditioner(method, preconditioner, singular,
                        lambda: _grid_multigrid_preconditioner(resolution, h, bcs, div.device, singular, nb), nb)

    def A(p):
        return poisson_apply(p, inv_dx2, bcs, with_dot=True)

    result = _solve(A, rhs, x0, rel_tol, abs_tol, max_iterations, M, singular, method=method, bcs=bcs, nb=nb)
    p = result.x
    grad = spatial_gradient_native(p, dx, faces=layout, extrap=_pressure_ghosts(bcs), ndim=len(layout))
    velocity = tuple(v - g for v, g in zip(velocity, grad))
    return velocity, p, result


def boundary_push_native(positions: torch.Tensor, domain_size: Sequence[float], separation: float = 0.5,
                  obstacles=()) -> torch.Tensor:
    """Push particles (N, d) out of the obstacles (geometries or `Obstacle`s),
    then pull those that left the domain [0, domain_size] back inside; both to
    `separation` from the surface — `boundary_push(particles, [*obstacles,
    ~bounds])` of the JAX package. Boxes take their exact axis-wise push
    (`box_push`), any other geometry its `push` along the finite-difference
    normal of its signed distance (`Geometry.push`)."""
    for obj in obstacles:
        geometry = obj.geometry if isinstance(obj, Obstacle) else obj
        if isinstance(geometry, (Box, Cuboid)):
            positions = box_push(positions, np.asarray(geometry.lower), np.asarray(geometry.upper), outward=True,
                                 shift_amount=separation)
            continue
        labels = tuple(geometry.names or ('x', 'y', 'z')[:positions.shape[-1]])
        points = Tensor(positions, instance(points=positions.shape[0]) & channel(vector=labels))
        positions = geometry.push(points, shift_amount=separation).native(('points', 'vector'))
    return box_push(positions, (0.0,) * len(domain_size), tuple(domain_size), outward=False,
                    shift_amount=separation)


# ---------------------------------------------------------------------------
# the Field layer
# ---------------------------------------------------------------------------

def _box_of(velocity) -> Tuple[tuple, tuple, Shape]:
    """(`face_layout`, dx per axis, batch dims) of a staggered velocity Field
    the array layer covers: per axis periodic, or per side a wall (a scalar
    constant, its normal velocity) or an open side (a stored outer face);
    values over the grid dims and batch dims."""
    if not (velocity.is_grid and velocity.is_staggered):
        raise NotImplementedError("the array layer projects a staggered velocity on a grid")
    names = velocity.resolution.names
    batch = _batch_dims(face_components(velocity.values), names, 'the projection')
    return _face_layout(velocity.boundary, names), _dx_tuple(velocity), batch


def _pressure_extrapolation(vext):
    """The pressure's boundary from the velocity's."""
    from ..field._embed import FieldEmbedding
    if vext == extrapolation.PERIODIC:
        return extrapolation.PERIODIC
    if vext == extrapolation.BOUNDARY:
        return extrapolation.ZERO
    if isinstance(vext, (ConstantExtrapolation, FieldEmbedding)):
        return extrapolation.BOUNDARY
    return extrapolation.map(_pressure_extrapolation, vext)


def _accessible_extrapolation_field(vext):
    """The accessible-cells mask's boundary from the velocity's: ONE beyond
    an open side (or an embedding), ZERO behind a wall, periodic wraps."""
    from ..field._embed import FieldEmbedding
    vext = extrapolation.get_normal(vext)
    if vext == extrapolation.PERIODIC:
        return extrapolation.PERIODIC
    if vext == extrapolation.BOUNDARY or isinstance(vext, FieldEmbedding):
        return extrapolation.ONE
    if isinstance(vext, ConstantExtrapolation):
        return extrapolation.ZERO
    return extrapolation.map(_accessible_extrapolation_field, vext)


def _native_frame(obstacles, grid):
    """The obstacles in the array layer's frame, whose origin is the grid's lower corner."""
    obstacles = _get_obstacles_for(obstacles)
    lower = grid.bounds.lower.numpy()
    if not obstacles or not np.any(lower != 0):
        return obstacles
    return [o.shifted(-lower) for o in obstacles]


def _component_values(velocity, arrays, batch=EMPTY_SHAPE):
    """Face arrays ((*batch,) *grid) as the values of `velocity`'s grid."""
    names = velocity.resolution.names
    return face_values([_batch_tensor(a, batch, c.shape.only(names, reorder=True))
                        for a, c in zip(arrays, face_components(velocity.values))], velocity.values)


def _classify_pressure_bc(p_ext, v_ext, dims) -> Optional[tuple]:
    """The pressure operator's (lower, upper) mode per axis (JAX's
    `_classify_pressure_bc`, `:307-356`), or None where the extrapolations
    fall outside {periodic, constant, zero-gradient}: a side is periodic
    where the velocity wraps, neumann where its outer face flux vanishes (a
    constant velocity drops the face; a stored face with zero-gradient
    pressure), ghost0 where the face is stored and the pressure pads 0."""
    bc = []
    for dim in dims:
        sides = []
        for upper in (False, True):
            v_dim = v_ext[{'vector': dim}] if 'vector' in getattr(v_ext, 'shape', ()) else v_ext
            v = _side_ext(extrapolation.get_normal(v_dim), dim, upper)
            p = _side_ext(p_ext, dim, upper)
            if isinstance(v, _PeriodicExtrapolation):
                if not isinstance(p, _PeriodicExtrapolation):
                    return None
                sides.append(PERIODIC)
            elif isinstance(v, ConstantExtrapolation):
                sides.append(NEUMANN)
            elif isinstance(v, _BoundaryExtrapolation):
                if isinstance(p, ConstantExtrapolation) and ops.always_close(p.value, 0):
                    sides.append(GHOST0)
                elif isinstance(p, _BoundaryExtrapolation):
                    sides.append(NEUMANN)
                else:
                    return None
            else:
                return None
        if PERIODIC in sides and sides[0] != sides[1]:
            return None
        bc.append(tuple(sides))
    return tuple(bc)


def _linearize_pressure_bc(ext):
    """The homogeneous linear part of a pressure extrapolation: sides whose
    values do not depend on the pressure (a Field embedding, a nonzero
    constant) only add an offset, so their linear part is a zero ghost.
    Preconditioners apply this boundary (`:97-112`)."""
    if isinstance(ext, ConstantExtrapolation):
        return ext if ops.always_close(ext.value, 0) else extrapolation.ZERO
    if isinstance(ext, _MixedExtrapolation):
        return _MixedExtrapolation({dim: (_linearize_pressure_bc(lo), _linearize_pressure_bc(hi))
                                    for dim, (lo, hi) in ext.ext.items()})
    if _is_homogeneous_pressure_bc(ext):
        return ext
    return extrapolation.ZERO


def make_incompressible(velocity, obstacles=(), solve: Solve = Solve(), active=None, order: int = 2,
                        correct_skew=False, wide_stencil: bool = None):
    """Project the velocity Field onto its divergence-free part. Returns
    (velocity, pressure) as Fields; the pressure is the solve's x0's Field
    (boundary and grid) with the solution, or a new Field under the pressure
    boundary derived from the velocity's. `correct_skew` is taken and unused,
    as in the JAX package.

    A staggered velocity (order 2, the compact stencil) whose pressure
    boundary `_classify_pressure_bc` classifies unwraps into
    `make_incompressible_native` (walls at rest or with a normal velocity,
    open sides, periodic axes, one cell size per axis; any solve method and
    preconditioner); otherwise (a nested domain: x0's boundary a Field
    embedding) it is solved on Fields, `_make_incompressible_fields`. A
    centred velocity is projected with the wide stencil of `order` (2, 4 or
    6), `_make_incompressible_centred`, or with ``wide_stencil=False`` by
    the compact stencil on Fields; a velocity on a mesh by
    `_make_incompressible_mesh`. The cases the JAX package fails on raise:
    a staggered velocity at order > 2 or with the wide stencil, a centred
    one with obstacles or `active`. Batch dims are projected as one batch of
    systems (module docstring), a staggered velocity's with obstacles and
    `active` shared by the batch; obstacles or `active` with batch dims of
    their own raise ValueError, as the JAX package fails on them."""
    _check_batch(obstacles, active)
    if velocity.is_mesh:
        return _make_incompressible_mesh(velocity, obstacles, solve, active, order)
    if velocity.is_grid and velocity.is_centered:
        if wide_stencil is False:
            if _get_obstacles_for(obstacles) or active is not None:
                raise NotImplementedError("obstacles or active cells with a centred velocity: the JAX package fails "
                                          "there too")
            return _make_incompressible_fields(velocity, [], solve, None, order, False)
        return _make_incompressible_centred(velocity, obstacles, solve, active, order, wide_stencil)
    if order != 2:
        raise NotImplementedError("the projection of a staggered velocity is of order 2: at higher orders the JAX "
                                  "package fails too")
    if wide_stencil:
        raise NotImplementedError("the wide-stencil Laplacian of a staggered velocity: the JAX package's projection "
                                  "diverges there; the compact stencil is ported")
    layout, dx, batch = _box_of(velocity)
    solve = solve.with_defaults('solve')
    names = velocity.resolution.names
    x0 = solve.x0
    p_ext = x0.boundary if isinstance(x0, Field) else _pressure_extrapolation(velocity.boundary)
    bcs = _classify_pressure_bc(p_ext, velocity.boundary, names)
    if bcs is None:
        return _make_incompressible_fields(velocity, _get_obstacles_for(obstacles), solve, active, order, False)
    pressure0 = None
    if x0 is not None:
        x0_values = x0.values if isinstance(x0, Field) else x0
        batch = merge_shapes(batch, _batch_dims([x0_values], names, 'the projection'))
        pressure0 = x0_values.torch(batch.names + names).contiguous()
    active_native = None
    if active is not None:
        active_native = (active.values if isinstance(active, Field) else active).torch(names).contiguous()
    preconditioner = solve.preconditioner
    if callable(preconditioner):
        field_preconditioner = preconditioner

        def preconditioner(r):  # the caller's M on the pressure Field
            template = x0 if isinstance(x0, Field) else Field(velocity.geometry, wrap(0.), p_ext)
            shape = template.values.shape.only(names, reorder=True)
            z = field_preconditioner(template.with_values(_batch_tensor(r, batch, shape))).values
            return _batch_native(z, batch, names)
    comps = [c.torch(batch.names + names) for c in face_components(velocity.values)]
    v, p, result = make_incompressible_native(comps, pressure0, dx, solve.rel_tol, solve.abs_tol,
                                              solve.max_iterations, layout, active_native,
                                              _native_frame(obstacles, velocity), solve.method, preconditioner,
                                              bcs)
    if isinstance(x0, Field):
        pressure = x0.with_values(_batch_tensor(p, batch, x0.values.shape.only(names, reorder=True)))
    else:
        pressure = Field(velocity.geometry, _batch_tensor(p, batch, velocity.resolution), p_ext)
    finish_solve(solve, pressure, result)
    return velocity.with_values(_component_values(velocity, v, batch)), pressure


def _check_batch(obstacles, active):
    """ValueError for masks with batch dims (an obstacle geometry or an
    `active` Field per entry): the JAX package's projection does not compute
    them."""
    for o in _get_obstacles_for(obstacles):
        if o.geometry.shape.batch:
            raise ValueError(f"an obstacle of shape {o.geometry.shape}{BATCHED_MASKS}")
    values = active.values if isinstance(active, Field) else active
    if isinstance(values, Tensor) and values.shape.batch:
        raise ValueError(f"active cells of shape {values.shape}{BATCHED_MASKS}")


def _balance_divergence_field(div, active):
    """The Field form of `_balance_divergence`: the mean subtracted (over the
    active cells with `active`)."""
    if active is not None:
        return div - active * (field_mean(div) / field_mean(active))
    return div - field_mean(div)


def _field_preconditioner(x0, native_M):
    """A preconditioner of arrays M(r) -> (z, ·) as one of pressure Fields;
    batch dims of r are the arrays' leading axes."""
    names = x0.resolution.names

    def preconditioner(r):
        batch = _batch_dims([r.values], names, 'a preconditioner')
        z = native_M(_batch_native(r.values, batch, names).contiguous())[0]
        return r.with_values(_batch_tensor(z, batch, r.values.shape.only(names, reorder=True)))
    return preconditioner


def _native_masks(x0_lin, v_boundary, hard_bcs, active):
    """(bcs, inv_dx2, mA, c0, active array) of the masked operator on the linearized pressure `x0_lin`, or None
    where its boundary does not classify."""
    names = x0_lin.resolution.names
    bcs = _classify_pressure_bc(x0_lin.boundary, v_boundary, names)
    if bcs is None:
        return None
    inv_dx2 = tuple(1. / d ** 2 for d in _dx_tuple(x0_lin))
    mA = c0 = act = None
    if hard_bcs is not None:
        layout = _face_layout(v_boundary, names, walls=False)
        masks = [c.torch(names) for c in face_components(hard_bcs.values)]
        mA, c0 = stage_masks(_full_face_masks(masks, layout), bcs, inv_dx2)
    if active is not None:
        act = active.values.torch(names).contiguous()
    return bcs, inv_dx2, mA, c0, act


def _make_incompressible_fields(velocity, obstacles, solve: Solve, active, order: int, wide_stencil: bool):
    """The JAX package's `make_incompressible` body (`:189-272`) on Fields:
    the cases whose pressure boundary the array layer cannot classify (a
    nested domain), and a centred velocity's compact stencil. The matvec is
    `masked_laplace`, K1 / K1m (`poisson_apply`) where the boundary
    classifies, else the face gradient, the open-face mask and the
    divergence; every preconditioner acts on x0's linearized boundary, and
    the solve subtracts f(0) unless the boundary is homogeneous."""
    input_velocity = velocity
    vb = input_velocity.boundary
    names = velocity.resolution.names
    all_active = active is None
    hard_bcs = None
    if obstacles:
        accessible = Field(velocity.geometry, ~union([o.geometry for o in obstacles]),
                           _accessible_extrapolation_field(vb))
        hard_bcs = stagger(accessible, ops.minimum, vb, at=velocity.sampled_at, dims=names)
        active = accessible.with_boundary(extrapolation.NONE) if active is None else active * accessible
        velocity = apply_boundary_conditions(velocity, obstacles)
    div = divergence(velocity, order=order)
    if active is not None:
        div = div * active
    if not all_active:
        div = field_where(field_is_finite(div), div, 0)
    pressure = _solve_pressure(div, vb, solve, hard_bcs, active, all_active, wide_stencil, order)
    grad_pressure = spatial_gradient(pressure, vb, at=velocity.sampled_at, order=order)
    if hard_bcs is not None:
        grad_pressure = grad_pressure * hard_bcs
    return (velocity - grad_pressure).with_boundary(vb), pressure


def _solve_pressure(div, v_boundary, solve: Solve, hard_bcs=None, active=None, balance: bool = True,
                    wide_stencil: bool = False, order: int = 2):
    """The pressure solve of the JAX package's Field-level projection
    (`solve_pressure_field`, `:115-139`, and `make_incompressible`,
    `:214-272`): with `balance`, a box with no open side balanced (over
    `active`) with rank deficiency 1; x0 under the pressure boundary derived
    from the velocity's; for the CG family the V-cycle, or with masks
    `MASKED_PRECONDITIONER`'s, on x0's linearized boundary where it
    classifies; a caller's callable as given; `masked_laplace` solved without
    f(0) where x0's boundary is homogeneous."""
    if balance and not v_boundary.is_flexible:
        solve = solve.with_preprocessing(_balance_divergence_field, active)
        if solve.rank_deficiency is None:
            solve = copy_solve(solve, rank_deficiency=1)
    if solve.x0 is None:
        solve = copy_solve(solve, x0=Field(div.geometry, wrap(0.), _pressure_extrapolation(v_boundary)))
    M = None
    if solve.preconditioner in (None, 'auto', 'multigrid') and solve.method in PRECONDITIONED_METHODS:
        x0_lin = solve.x0.with_boundary(_linearize_pressure_bc(solve.x0.boundary))
        native = _native_masks(x0_lin, v_boundary, hard_bcs, active)
        names = x0_lin.resolution.names
        if native is not None and hard_bcs is None and active is None:
            M = _grid_multigrid_preconditioner(tuple(x0_lin.resolution.sizes), _dx_tuple(x0_lin), native[0],
                                               div.values.torch(div.values.shape.names).device, singular=False)
        elif native is not None:
            bcs, inv_dx2, mA, c0, act = native

            def apply_A(p):
                return poisson_apply(p, inv_dx2, bcs, mA_list=mA, c0=c0, active=act)
            template = div.values.torch(div.values.shape.without(names).names + tuple(names))  # batch leading
            M = _masked_preconditioner(apply_A, template, _dx_tuple(x0_lin), bcs, act)
    solve = copy_solve(solve, preconditioner=_field_preconditioner(solve.x0, M) if M is not None else
                       (solve.preconditioner if callable(solve.preconditioner) else None))
    homogeneous = _is_homogeneous_pressure_bc(solve.x0.boundary if isinstance(solve.x0, Field) else None)
    return solve_linear(masked_laplace, div, solve, v_boundary, hard_bcs, active, wide_stencil=wide_stencil,
                        order=order, assume_homogeneous=homogeneous)


def solve_pressure_field(div, v_boundary, solve: Solve):
    """The unmasked pressure solve of `make_incompressible` from a ready
    divergence Field (JAX's `solve_pressure_field`, `:115-139`;
    `_solve_pressure`)."""
    return _solve_pressure(div, v_boundary, solve)


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
    obstacle by the wide stencil (`phiflow_tpu/physics/fluid.py:203-213`):
    the divergence of `order`, balanced and with rank deficiency 1 unless
    the boundary lets flux out, solved by `solve_linear` over `_wide_laplace`
    — unpreconditioned, as the JAX package chooses for the wide stencil,
    x0 = 0 under the pressure boundary unless `solve` has one — and the
    pressure's centred gradient subtracted."""
    if _get_obstacles_for(obstacles) or active is not None:
        raise NotImplementedError("obstacles or active cells with a centred velocity: the JAX package fails there "
                                  "too")
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


def _fused_masked_laplace(pressure, v_boundary, hard_bcs, active):
    """The masked pressure Laplacian as one `poisson_apply` (K1, or K1m with
    masks, on the card in 3D) where `_classify_pressure_bc` classifies the
    boundary (JAX's `_fused_masked_laplace`, `:358-409`); None otherwise."""
    from ..geom._grid import UniformGrid
    if not isinstance(pressure.geometry, UniformGrid) or not pressure.is_centered:
        return None
    names = pressure.resolution.names
    batch = pressure.values.shape.without(names)
    if batch.rank != batch.batch.rank:
        return None
    native = _native_masks(pressure, v_boundary, hard_bcs, active)
    if native is None:
        return None
    bcs, inv_dx2, mA, c0, act = native
    result = poisson_apply(pressure.values.torch(batch.names + names).contiguous(), inv_dx2, bcs, mA_list=mA, c0=c0,
                           active=act)
    bout = extrapolation.remove_constant_offset(v_boundary).spatial_gradient()
    return Field(pressure.geometry, _batch_tensor(result, batch, pressure.values.shape.only(names, reorder=True)),
                 bout)


@jit_compile_linear(auxiliary_args='wide_stencil,order', forget_traces=True)
def masked_laplace(pressure, v_boundary, hard_bcs, active, wide_stencil=False, order=2):
    """The Laplacian of the pressure respecting obstacle masks, the matvec of
    a projection on Fields (`:276-304`): on a mesh its FVM Laplacian; at order
    2 with the compact stencil `_fused_masked_laplace` where it applies; the
    wide stencil `_wide_laplace`; else the face gradient, masked by
    `hard_bcs`, its divergence, and the identity on inactive cells."""
    if pressure.is_mesh or (order > 2 and not wide_stencil):
        return laplace(pressure, order=order)
    if order == 2 and not wide_stencil:
        fused = _fused_masked_laplace(pressure, v_boundary, hard_bcs, active)
        if fused is not None:
            return fused
    if wide_stencil and hard_bcs is None and active is None:
        return _wide_laplace.f(pressure, v_boundary, order)
    grad = spatial_gradient(pressure, v_boundary, at='face', order=2)
    valid_grad = grad * hard_bcs if hard_bcs is not None else grad
    valid_grad = valid_grad.with_boundary(extrapolation.remove_constant_offset(valid_grad.boundary))
    div = divergence(valid_grad)
    return field_where(active, div, pressure) if active is not None else div


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
    (`apply_boundary_conditions_native` on its components; batch dims lead,
    the obstacles the same for every entry)."""
    layout, dx, batch = _box_of(velocity)
    names = velocity.resolution.names
    comps = apply_boundary_conditions_native([_batch_native(c, batch, names) for c in face_components(velocity.values)],
                                             _native_frame(obstacles, velocity), dx, faces=layout)
    return velocity.with_values(_component_values(velocity, comps, batch))


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

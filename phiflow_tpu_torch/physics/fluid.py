"""Pressure projection — port of the staggered branches of
`phiflow_tpu/physics/fluid.py::make_incompressible` (`:164-272`) without
obstacles.

All cells active: divergence → `_balance_divergence` → CG on the Poisson
stencil (K1), preconditioned by the multigrid V-cycle (K2–K4) from x0 = the
previous pressure → subtract the pressure gradient. Closed box or periodic box.

With `active` (a free surface: 1 in the cells the liquid occupies, 0
elsewhere): divergence · active, non-finite entries zeroed → CG on K1's masked
form (inactive cells are identity rows), preconditioned by Chebyshev(Jacobi)
on the exact masked diagonal, from x0 = the previous pressure; the system is
nonsingular, so no mean is removed anywhere. `boundary_push` keeps particles
inside the domain.

2D or 3D: the kernels are 3D; a 2D solve runs the same code through the
wrappers' PyTorch route (`ops/poisson.py`). Obstacles — the path that feeds K1's
masked form its coefficient arrays — are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..field._field_math import divergence, spatial_gradient
from ..geom._box import box_push
from ..math._multigrid import make_poisson_vcycle
from ..math._solve import SolveResult, cg, sub_mean
from ..ops.poisson import NEUMANN, PERIODIC, poisson_apply

__all__ = ['make_incompressible', 'boundary_push']


def _classify_pressure_bc(periodic: bool, ndim: int = 3):
    """Per-axis (lower, upper) modes of the pressure operator: a closed box
    (constant velocity, its outer face flux dropped) is neumann on every side,
    a periodic box periodic."""
    mode = PERIODIC if periodic else NEUMANN
    return ((mode, mode),) * ndim


def _balance_divergence(div: torch.Tensor) -> torch.Tensor:
    """Subtract the mean so the singular Poisson system is solvable."""
    return div - torch.mean(div)


def _grid_multigrid_preconditioner(resolution, dx: float, bcs, device):
    """The V-cycle preconditioner M(r) -> (z, ⟨r, z⟩ or None) with z projected
    onto zero mean (rank deficiency 1), or None below 16 cells per axis, where
    plain CG converges in a handful of iterations."""
    if max(resolution) < 16:
        return None
    vcycle = make_poisson_vcycle(tuple(resolution), (dx,) * len(resolution), bcs, device)

    def preconditioner(r: torch.Tensor):
        # On CUDA ⟨z, r⟩ comes from the V-cycle's last smoother kernel, before
        # the mean projection of z (the order of JAX on the chip); on the CPU
        # CG takes it after the projection, as JAX does there. The two differ
        # by mean(z)·Σr, at roundoff level since r has zero mean.
        z, rz = vcycle(r, emit_dot=r.is_cuda)
        return sub_mean(z), rz

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


def _project_free_surface(velocity, div, pressure, active, dx, inv_dx2, bcs, periodic, rel_tol, abs_tol,
                          max_iterations):
    """The `active` branch of `make_incompressible`."""
    # JAX's order: the product first (0 · NaN is NaN), then non-finite entries to 0
    div = div * active
    rhs = torch.where(torch.isfinite(div), div, torch.zeros_like(div))
    x0 = torch.zeros_like(div) if pressure is None else pressure

    def apply_A(p):
        return poisson_apply(p, inv_dx2, bcs, active=active)

    def A(p):
        return poisson_apply(p, inv_dx2, bcs, active=active, with_dot=True)

    M = _masked_chebyshev_preconditioner(apply_A, div, bcs)
    result = cg(A, rhs, x0, rel_tol, abs_tol, max_iterations, M)
    grad = spatial_gradient(result.x, dx, periodic)
    return tuple(v - g for v, g in zip(velocity, grad)), result.x, result


def make_incompressible(velocity: Sequence[torch.Tensor], pressure: Optional[torch.Tensor], dx: float,
                        rel_tol: float = 1e-5, abs_tol: float = 1e-5, max_iterations: int = 1000,
                        periodic: bool = False, active: Optional[torch.Tensor] = None
                        ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, SolveResult]:
    """Project the staggered velocity (raw components x, y[, z]) onto its
    divergence-free part. `pressure` is the solve's initial guess x0 (zeros
    when None). `active` (cells' shape, 1 or 0) restricts the system to the
    active cells; elsewhere the pressure solves p = 0 and the velocity may
    hold NaN. Returns (velocity, pressure, solve result); not converging
    within max_iterations is not an error, as for the models' solves."""
    div = divergence(velocity, dx, periodic)
    resolution = tuple(div.shape)
    bcs = _classify_pressure_bc(periodic, div.ndim)
    inv_dx2 = (1.0 / (dx * dx),) * div.ndim
    if active is not None:
        if tuple(active.shape) != resolution:
            raise ValueError(f"active: shape {tuple(active.shape)} != the cells' {resolution}")
        return _project_free_surface(velocity, div, pressure, active, dx, inv_dx2, bcs, periodic, rel_tol, abs_tol,
                                     max_iterations)
    rhs = sub_mean(_balance_divergence(div))  # rank deficiency 1: project onto range(A)
    x0 = torch.zeros_like(div) if pressure is None else pressure
    M = _grid_multigrid_preconditioner(resolution, dx, bcs, div.device)

    def A(p):
        return poisson_apply(p, inv_dx2, bcs, with_dot=True)

    result = cg(A, rhs, x0, rel_tol, abs_tol, max_iterations, M)
    p = sub_mean(result.x)
    grad = spatial_gradient(p, dx, periodic)
    velocity = tuple(v - g for v, g in zip(velocity, grad))
    return velocity, p, result._replace(x=p)


def boundary_push(positions: torch.Tensor, domain_size: Sequence[float], separation: float = 0.5) -> torch.Tensor:
    """Pull particles that left the domain [0, domain_size] back inside, to
    `separation` from the wall — `boundary_push(particles, [~bounds])` of the
    JAX package; obstacles are not ported yet."""
    return box_push(positions, (0.0,) * len(domain_size), tuple(domain_size), outward=False,
                    shift_amount=separation)

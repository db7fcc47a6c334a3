"""Pressure projection — port of the unmasked staggered branch of
`phiflow_tpu/physics/fluid.py::make_incompressible` (`:164-272`).

divergence → `_balance_divergence` → CG on the Poisson stencil (K1),
preconditioned by the multigrid V-cycle (K2–K4) from x0 = the previous
pressure → subtract the pressure gradient. Closed box or periodic box, 2D or
3D (the kernels are 3D; a 2D solve runs the same code through the wrappers'
PyTorch route, `ops/poisson.py`), no obstacles, no free surface: the obstacle /
FLIP branch (K1's masked form) comes with a later slice.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..field._field_math import divergence, spatial_gradient
from ..math._multigrid import make_poisson_vcycle
from ..math._solve import SolveResult, cg, sub_mean
from ..ops.poisson import NEUMANN, PERIODIC, poisson_apply

__all__ = ['make_incompressible']


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


def make_incompressible(velocity: Sequence[torch.Tensor], pressure: Optional[torch.Tensor], dx: float,
                        rel_tol: float = 1e-5, abs_tol: float = 1e-5, max_iterations: int = 1000,
                        periodic: bool = False) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, SolveResult]:
    """Project the staggered velocity (raw components x, y[, z]) onto its
    divergence-free part. `pressure` is the solve's initial guess x0 (zeros
    when None). Returns (velocity, pressure, solve result); not converging
    within max_iterations is not an error, as for the smoke model's solve."""
    div = divergence(velocity, dx, periodic)
    resolution = tuple(div.shape)
    bcs = _classify_pressure_bc(periodic, div.ndim)
    inv_dx2 = (1.0 / (dx * dx),) * div.ndim
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

"""Diffusion — port of `phiflow_tpu/physics/diffuse.py` (`:17-145`).

`explicit`: explicit Euler, u + ν·dt·Δu, of a grid Field (centred, or
staggered component by component under each component's boundary) through
the Field layer's `laplace` of orders 2, 4 and 6; `explicit_native` does the
same at order 2 on the raw face components of a staggered grid. `implicit`:
backward Euler, (1 − ν·dt·Δ)·u' = u solved by `solve_linear` (CG on the
centred values, one residual norm over all channel entries) from x0 = u.
`differential`: the term ν·Δu of a PDE's right-hand side. `fourier`: the
exact decay û·exp(−4π²k²·ν·dt) of a periodic centred grid, its spectrum
built on the host and applied with `torch.fft`.
"""
from __future__ import annotations

import warnings
from typing import Sequence, Tuple

import numpy as np
import torch

from ..field import Field
from ..field._field_math import laplace, laplace_native
from .. import math
from ..math import Solve, copy_solve, dual, jit_compile_linear, solve_linear, stack
from ..math._nd import _k_grids, _spectral_separable, component_extrapolation

__all__ = ['explicit', 'implicit', 'differential', 'fourier', 'explicit_native']


def explicit_native(u: Sequence[torch.Tensor], diffusivity: float, dt: float, dx, extrap,
             substeps: int = 1) -> Tuple[torch.Tensor, ...]:
    """`substeps` explicit Euler steps of u ← u + (ν·dt/substeps)·Δu on the
    face components `u` of a staggered grid; `extrap` is u's extrapolation,
    or one per component. Stable while ν·dt/substeps ≤ dx²/(2·d)."""
    amount = diffusivity * (dt / substeps)
    comps = tuple(u)
    for _ in range(substeps):
        comps = tuple(c + laplace_native(c, dx, component_extrapolation(extrap, i)) * amount
                      for i, c in enumerate(comps))
    return comps


def explicit(u, diffusivity, dt, substeps: int = 1, order: int = 2, implicit=None, gradient=None, upwind=None,
             correct_skew=True):
    """`substeps` explicit Euler steps of u ← u + (ν·dt/substeps)·Δu on a grid
    Field, the Laplacian of `order`; a diffusivity Field is sampled at u's
    points and multiplies Δu there. Warns when the largest ν·dt/substeps
    exceeds the stability limit dx²/(2·d). `implicit` is taken and unused, as
    in the JAX package."""
    amount = diffusivity * (dt / substeps)
    if isinstance(amount, Field):
        amount = amount.at(u)
        a_max = float(math.max(abs(amount.values)))
    else:
        a_max = abs(float(amount))
    limit = 0.5 * float(np.min(u.dx.numpy())) ** 2 / len(u.resolution)
    if a_max > limit:
        warnings.warn(f"diffuse.explicit: amount {a_max} exceeds CFL limit {limit}; increase substeps for "
                      f"stability", stacklevel=2)
    factor = amount.values if isinstance(amount, Field) else amount
    for _ in range(substeps):
        if u.is_staggered:
            names = u.resolution.names
            comps = []
            for dim in names:
                comp = u.vector[dim]
                comps.append(comp.values + laplace(comp, order=order).values * factor)
            u = Field(u.geometry, stack(comps, dual(vector=names)), u.boundary)
        else:
            delta = laplace(u, order=order, gradient=gradient, upwind=upwind, correct_skew=correct_skew)
            u = u.with_values(u.values + delta.values * factor)
    return u


def implicit(u, diffusivity, dt, solve: Solve = Solve('CG'), order: int = 1, gradient=None, upwind=None,
             correct_skew=True):
    """Backward Euler: solve (1 − ν·dt·Δ)·u' = u for u' by `solve_linear`,
    from x0 = u unless `solve` has one; the operator is `explicit` with −dt
    (the Laplacian of order 2 for `order` 1 or 2)."""
    @jit_compile_linear
    def sharpen(x):
        return explicit(x, diffusivity, -dt, order=order if order >= 2 else 2, gradient=gradient, upwind=upwind,
                        correct_skew=correct_skew)

    if solve.x0 is None:
        solve = copy_solve(solve, x0=u)
    return solve_linear(sharpen, y=u, solve=solve)


def differential(u, diffusivity, gradient=None, order: int = 2, implicit=None, upwind=None, correct_skew=True):
    """The diffusion term ν·Δu of a PDE's right-hand side, the Laplacian of
    `order`; a staggered grid component by component."""
    if isinstance(diffusivity, Field):  # the weighted Laplacian, the diffusivity at u's points
        return laplace(u, order=order, weights=diffusivity)
    if u.is_staggered:
        comps = [laplace(u.vector[dim], order=order).values * diffusivity for dim in u.resolution.names]
        return Field(u.geometry, stack(comps, dual(vector=u.resolution.names)), u.boundary)
    return Field(u.geometry, laplace(u, order=order).values * diffusivity, u.boundary)


def fourier(u, diffusivity, dt):
    """Exact diffusion of a periodic centred grid: û·exp(−4π²k²·ν·dt), one
    factor per axis. `diffusivity·dt` is one number."""
    assert u.is_grid and u.is_centered, "fourier diffusion requires a centered grid"
    amount = diffusivity * dt
    amount = float(amount.numpy() if hasattr(amount, 'numpy') else amount)
    ks = _k_grids(u.values, u.dx)
    spectra = {d: np.exp(-(4 * np.pi ** 2) * k ** 2 * amount) for d, k in ks.items()}
    return u.with_values(_spectral_separable(u.values, spectra, 'mul'))

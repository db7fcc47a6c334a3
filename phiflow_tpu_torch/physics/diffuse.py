"""Diffusion — port of `phiflow_tpu/physics/diffuse.py::explicit` (`:17-54`) at
order 2: explicit Euler, u + ν·dt·Δu. `explicit` takes a grid Field (centred,
or staggered component by component under each component's boundary) and
unwraps into the Field layer's `laplace`; `explicit_native` does the same on
the raw face components of a staggered grid.
"""
from __future__ import annotations

import warnings
from typing import Sequence, Tuple

import numpy as np
import torch

from ..field import Field
from ..field._field_math import laplace, laplace_native
from ..math import dual, stack
from ..math._nd import component_extrapolation

__all__ = ['explicit', 'explicit_native']


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
    Field; warns when ν·dt/substeps exceeds the stability limit dx²/(2·d)."""
    if order != 2 or implicit is not None or gradient is not None or upwind is not None:
        raise NotImplementedError("explicit diffusion of order 2 only comes with this slice of the port")
    if isinstance(diffusivity, Field):
        raise NotImplementedError("a diffusivity Field comes with a later slice of the port")
    amount = diffusivity * (dt / substeps)
    limit = 0.5 * float(np.min(u.dx.numpy())) ** 2 / len(u.resolution)
    if abs(float(amount)) > limit:
        warnings.warn(f"diffuse.explicit: amount {amount} exceeds CFL limit {limit}; increase substeps for "
                      f"stability", stacklevel=2)
    for _ in range(substeps):
        if u.is_staggered:
            names = u.resolution.names
            comps = []
            for dim in names:
                comp = u.vector[dim]
                comps.append(comp.values + laplace(comp, order=order).values * amount)
            u = Field(u.geometry, stack(comps, dual(vector=names)), u.boundary)
        else:
            u = u.with_values(u.values + laplace(u, order=order).values * amount)
    return u

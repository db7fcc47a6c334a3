"""Diffusion — port of `phiflow_tpu/physics/diffuse.py::explicit` (`:17-54`) at
order 2 for a staggered grid on raw tensors: explicit Euler, u + ν·dt·Δu,
component by component, each under its own extrapolation.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..field._field_math import laplace
from ..math._nd import component_extrapolation

__all__ = ['explicit']


def explicit(u: Sequence[torch.Tensor], diffusivity: float, dt: float, dx, extrap,
             substeps: int = 1) -> Tuple[torch.Tensor, ...]:
    """`substeps` explicit Euler steps of u ← u + (ν·dt/substeps)·Δu on the
    face components `u` of a staggered grid; `extrap` is u's extrapolation,
    or one per component. Stable while ν·dt/substeps ≤ dx²/(2·d)."""
    amount = diffusivity * (dt / substeps)
    comps = tuple(u)
    for _ in range(substeps):
        comps = tuple(c + laplace(c, dx, component_extrapolation(extrap, i)) * amount for i, c in enumerate(comps))
    return comps

"""Staggered (MAC) differential operators on raw component tensors — the part
of `phiflow_tpu/field/_field_math.py` the pressure projection uses:
`divergence` of a staggered velocity (`:243`) and the face `spatial_gradient`
of a centred pressure (`:135`), for the closed box and the periodic box — and
`finite_fill` (`:476-503`), the one-cell extension of a FLIP velocity grid
into its unset (NaN) cells. For obstacles: `stagger` (`:208-236`), a cell
mask combined onto the faces, and `safe_mul` (`:412-431`); for diffusion the
order-2 `laplace` (`:81-106`).

Closed box: component d holds the interior faces 1..N−1 along axis d (N−1
entries); the outer faces carry the wall's zero normal velocity. Periodic:
component d holds faces 0..N−1, face N ≡ face 0.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..math._nd import Extrapolation, masked_fill, pad, shift_zero

__all__ = ['divergence', 'spatial_gradient', 'finite_fill', 'stagger', 'safe_mul', 'laplace']


def divergence(velocity: Sequence[torch.Tensor], dx: float, periodic: bool = False) -> torch.Tensor:
    """∇·v at the cell centres: Σ_d (v_d[face c+1] − v_d[face c]) / dx."""
    result = None
    for d, comp in enumerate(velocity):
        if periodic:
            term = (torch.roll(comp, -1, d) - comp) / dx
        else:
            zero = torch.zeros_like(comp.narrow(d, 0, 1))
            padded = torch.cat([zero, comp, zero], dim=d)
            n = comp.shape[d] + 1
            term = (padded.narrow(d, 1, n) - padded.narrow(d, 0, n)) / dx
        result = term if result is None else result + term
    return result


def spatial_gradient(p: torch.Tensor, dx: float, periodic: bool = False) -> Tuple[torch.Tensor, ...]:
    """∇p at the faces the velocity stores: (p[c] − p[c−1]) / dx for face c."""
    comps = []
    for d in range(p.ndim):
        if periodic:
            comps.append((p - torch.roll(p, 1, d)) / dx)
        else:
            n = p.shape[d] - 1
            comps.append((p.narrow(d, 1, n) - p.narrow(d, 0, n)) / dx)
    return tuple(comps)


def finite_fill(values: torch.Tensor, distance: int = 1) -> torch.Tensor:
    """Fill the non-finite cells of one grid array from their finite
    neighbours, `distance` cells deep; a staggered grid is filled component by
    component. A cell with a finite axis neighbour gets the mean of those; a
    cell reached only across a diagonal gets 0 (it has no axis neighbour to
    average); cells further away keep their NaN. That is the JAX package's
    result, diagonal zeros included."""
    valid = torch.isfinite(values)
    clean = torch.where(valid, values, torch.zeros_like(values))
    filled, _ = masked_fill(clean, valid, distance)
    reach = valid.to(values.dtype)
    for _ in range(distance):
        # axis after axis on the running result: the reach grows to the whole box neighbourhood
        for axis in range(values.ndim):
            lo, up = shift_zero(reach, axis)
            reach = torch.maximum(reach, torch.maximum(lo, up))
        reach = (reach > 0).to(values.dtype)
    return torch.where(reach > 0, filled, values)


def stagger(values: torch.Tensor, face_function: Callable, extrap: Extrapolation,
            periodic: bool = False) -> Tuple[torch.Tensor, ...]:
    """A centred grid at the faces a staggered field stores: each face gets
    `face_function` of its two cells (`torch.minimum` makes a face open only
    where both cells are). `extrap` is the centred grid's extrapolation, which
    gives the cells beyond the outer faces; `periodic` is the staggered
    field's box and decides which outer faces it stores."""
    comps = []
    for axis in range(values.ndim):
        padded = pad(values, axis, 1, 1, extrap)
        n = values.shape[axis]
        faces = face_function(padded.narrow(axis, 0, n + 1), padded.narrow(axis, 1, n + 1))
        comps.append(faces.narrow(axis, 0, n) if periodic else faces.narrow(axis, 1, n - 1))
    return tuple(comps)


def safe_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b with 0 · NaN = 0 on either side: masking a velocity that holds
    NaN in its unset faces."""
    a_n = torch.where(b == 0, torch.zeros_like(a), a)
    b_n = torch.where(a == 0, torch.zeros_like(b), b)
    return a_n * b_n


def laplace(values: torch.Tensor, dx, extrap: Extrapolation) -> torch.Tensor:
    """The order-2 Laplacian of one grid array: per axis
    (v[i−1] + v[i+1] − 2·v[i]) / dx² with ghost cells from `extrap`."""
    h = tuple(dx) if isinstance(dx, (tuple, list)) else (dx,) * values.ndim
    result = None
    for axis in range(values.ndim):
        padded = pad(values, axis, 1, 1, extrap)
        n = values.shape[axis]
        lo, ce, up = padded.narrow(axis, 0, n), padded.narrow(axis, 1, n), padded.narrow(axis, 2, n)
        term = (lo + up - 2 * ce) / float(np.float32(h[axis]) ** 2)
        result = term if result is None else result + term
    return result

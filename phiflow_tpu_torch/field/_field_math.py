"""Staggered (MAC) differential operators on raw component tensors — the part
of `phiflow_tpu/field/_field_math.py` the pressure projection uses:
`divergence` of a staggered velocity (`:243`) and the face `spatial_gradient`
of a centred pressure (`:135`), for the closed box and the periodic box.

Closed box: component d holds the interior faces 1..N−1 along axis d (N−1
entries); the outer faces carry the wall's zero normal velocity. Periodic:
component d holds faces 0..N−1, face N ≡ face 0.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ['divergence', 'spatial_gradient']


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

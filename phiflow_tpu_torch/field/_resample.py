"""Resampling between half-cell-shifted aligned grids on raw tensors — port of
the order-2 branch of `phiflow_tpu/field/_resample.py::_shift_resample`
(`:310-347`) as `sample_grid_at_centers` (`:234`) uses it: along every axis on
which source and target are staggered differently, pad with the source's
extrapolation, then average neighbours. Faces → centres, faces of one
component → faces of another, and centres → faces (the buoyancy lift) are all
this one operation.

A grid's staggering is its own axis: None for a centred grid, d for the face
component d. Layouts: in the closed box component d holds the interior faces
1..N−1 along axis d (N−1 entries, the walls are the extrapolation); in the
periodic box faces 0..N−1 (N entries).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..math._nd import BOUNDARY, PERIODIC, Extrapolation

__all__ = ['sample_grid_at_centers']


def _pad_axis(v: torch.Tensor, axis: int, lower: int, upper: int, extrap: Extrapolation) -> torch.Tensor:
    """`v` extended by `lower` / `upper` (0 or 1) entries along `axis`."""
    n = v.shape[axis]
    first, last = v.narrow(axis, 0, 1), v.narrow(axis, n - 1, 1)
    if extrap == PERIODIC:
        lo, hi = last, first
    elif extrap == BOUNDARY:
        lo, hi = first, last
    else:
        lo = hi = torch.full_like(first, float(extrap))
    parts = ([lo] if lower else []) + [v] + ([hi] if upper else [])
    return torch.cat(parts, dim=axis) if len(parts) > 1 else v


def sample_grid_at_centers(values: torch.Tensor, own_axis: Optional[int], target_axis: Optional[int],
                           extrap: Extrapolation, periodic: bool) -> torch.Tensor:
    """`values`, staggered along `own_axis` (None: centred), at the sample
    points of a grid staggered along `target_axis`. `extrap` is the source's
    extrapolation; `periodic` says which layout the staggered grids have.

    Per shifted axis, (lower, upper) padding then the 2-point average:
    faces → centres (1, 1) in the closed box, (0, 1) periodic;
    centres → faces (0, 0) in the closed box, (1, 0) periodic."""
    v = values
    for axis in range(values.ndim):
        from_faces, to_faces = own_axis == axis, target_axis == axis
        if from_faces == to_faces:
            continue
        if from_faces:
            lower, upper = (0, 1) if periodic else (1, 1)
        else:
            lower, upper = (1, 0) if periodic else (0, 0)
        padded = _pad_axis(v, axis, lower, upper, extrap)
        size = padded.shape[axis]
        v = (padded.narrow(axis, 0, size - 1) + padded.narrow(axis, 1, size - 1)) * 0.5
    return v

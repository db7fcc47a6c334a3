"""Grid functions on raw tensors: `shift_window_interp` and `masked_fill`.

Window-shift interpolation of a grid at its own displaced lattice — port of
`phiflow_tpu/math/_nd.py::shift_window_interp` (`:468-623`).

The grid's extrapolation describes its halo to the kernel, which resolves it by
index: a constant (a float: the closed box's velocity, 0 at the walls),
`BOUNDARY` (zero gradient: the smoke) or `PERIODIC`. No padded copy is made.

One kernel per call, whatever K: the TPU route picks between a K=1 and a K
window at run time (`:554-578`) because its cost grows with (2K+1)^d. A corner
gather costs the same for every K and both windows give the same result
wherever both are exact, so the port takes no min/max pass and no host sync
for that choice.

`masked_fill` ports the function of that name (`:443-461`): the flood fill
behind `field.finite_fill`, PyTorch operations on any device.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from ..ops.interp import window_interp_2d, window_interp_3d

__all__ = ['BOUNDARY', 'PERIODIC', 'shift_window_interp', 'masked_fill', 'shift_zero']

BOUNDARY, PERIODIC = 'boundary', 'periodic'
Extrapolation = Union[float, str]  # a constant value, BOUNDARY or PERIODIC


def shift_window_interp(grid: torch.Tensor, displacement_cells: Sequence[torch.Tensor],
                        extrap: Extrapolation, max_cells: int = 2, compute_extrema: bool = False,
                        negate: bool = False, disp_scale: Sequence[float] = None):
    """Linear interpolation of `grid` at its own sample lattice displaced by
    `displacement_cells`: one array per axis of the grid, in cells after
    ``disp_scale`` (and ``negate``) are applied. Displacements beyond
    ±max_cells are clamped (stable, slightly diffusive).

    Returns interp, or (interp, corner_min, corner_max) with
    ``compute_extrema`` — the MacCormack clamp values.

    A CUDA grid goes through K6 (3D) or K7 (2D), a CPU grid through their plain
    twin (`ops/interp.py`)."""
    d = len(displacement_cells)
    if grid.ndim != d:
        raise NotImplementedError(
            f"grid of rank {grid.ndim} with {d} displacement axes: leading batch axes come with the "
            f"batched-smoke slice of the port")
    if d not in (2, 3):
        raise NotImplementedError(f"{d}D grids come with a later slice of the port (2D and 3D are ported)")
    fn = window_interp_3d if d == 3 else window_interp_2d
    if extrap == BOUNDARY:
        halo = dict(halo='edge')
    elif extrap == PERIODIC:
        halo = dict(halo='wrap')
    elif isinstance(extrap, (int, float)):
        halo = dict(const_pad=float(extrap))
    else:
        raise ValueError(f"extrapolation {extrap!r}: a constant value, BOUNDARY or PERIODIC expected")
    return fn(grid, list(displacement_cells), max_cells, compute_extrema=compute_extrema, negate=negate,
              disp_scale=disp_scale, **halo)


def shift_zero(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x[i−1], x[i+1]) along `axis`, 0 beyond the ends."""
    n = x.shape[axis]
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    lower = torch.cat([zero, x.narrow(axis, 0, n - 1)], dim=axis)
    upper = torch.cat([x.narrow(axis, 1, n - 1), zero], dim=axis)
    return lower, upper


def masked_fill(values: torch.Tensor, valid: torch.Tensor, distance: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Propagate values into invalid cells as the mean of their valid axis
    neighbours, `distance` times. Returns (filled values, new validity)."""
    valid_f = valid.to(values.dtype)
    for _ in range(distance):
        values_v = values * valid_f
        neighbor_sum = torch.zeros_like(values_v)
        neighbor_count = torch.zeros_like(valid_f)
        for axis in range(values.ndim):
            lo, up = shift_zero(values_v, axis)
            vlo, vup = shift_zero(valid_f, axis)
            neighbor_sum = neighbor_sum + (lo + up)
            neighbor_count = neighbor_count + (vlo + vup)
        none = neighbor_count == 0
        avg = torch.where(none, torch.zeros_like(neighbor_sum),
                          neighbor_sum / torch.where(none, torch.ones_like(neighbor_count), neighbor_count))
        values = torch.where(valid_f != 0, values, avg)
        valid_f = torch.maximum(valid_f, torch.clamp(neighbor_count, max=1.0))
    return values, valid_f != 0

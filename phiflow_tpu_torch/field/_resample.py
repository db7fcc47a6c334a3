"""Resampling on raw tensors: between half-cell-shifted aligned grids, from
particles to a grid (P2G) and from a grid to particles (G2P).

`sample_grid_at_centers` is the port of the order-2 branch of
`phiflow_tpu/field/_resample.py::_shift_resample` (`:310-347`) as
`sample_grid_at_centers` (`:234`) uses it: along every axis on which source
and target are staggered differently, pad with the source's extrapolation,
then average neighbours. Faces → centres, faces of one
component → faces of another, and centres → faces (the buoyancy lift) are all
this one operation.

A grid's staggering is its own axis: None for a centred grid, d for the face
component d. Layouts: in the closed box component d holds the interior faces
1..N−1 along axis d (N−1 entries, the walls are the extrapolation); in the
periodic box faces 0..N−1 (N entries).

`scatter_to_grid` ports `scatter_to_grid` / `_scatter_to_centered` with
``scatter=True`` (`:361-411`) for the closed box: the mean of the particles'
values per nearest sample point, through K8 (`ops/p2g.py`) once per target
grid. The face grid of component d is the cell grid shifted by half a cell
along d, one entry shorter there. `sample_grid_at_points` ports the function
of that name (`:251-262`): multilinear interpolation at particle positions, a
gather written with PyTorch indexing (the JAX package has no kernel for it).

The domain's lower corner is the origin.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..math._nd import BOUNDARY, PERIODIC, Extrapolation
from ..ops.p2g import p2g_mean

__all__ = ['sample_grid_at_centers', 'scatter_to_grid', 'sample_grid_at_points', 'sample_staggered_at_points',
           'face_grid']


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


# ---------------------------------------------------------------------------
# particles ⇄ grid
# ---------------------------------------------------------------------------

def face_grid(resolution: Sequence[int], dx: Sequence[float], axis: Optional[int]):
    """(resolution, lower corner, upper corner) of the sample-point grid
    staggered along `axis` in the closed box (None: the cell grid itself), in
    float32 as the JAX package's `UniformGrid.stagger` computes it."""
    f32 = np.float32
    res = [int(r) for r in resolution]
    lower = [f32(0.0)] * len(res)
    upper = [f32(r) * f32(h) for r, h in zip(res, dx)]
    if axis is not None:
        lower[axis] = lower[axis] + f32(dx[axis]) * f32(0.5)
        upper[axis] = upper[axis] + f32(dx[axis]) * f32(-0.5)
        res[axis] -= 1
    return tuple(res), tuple(lower), tuple(upper)


def _per_axis(dx, ndim: int) -> Tuple[float, ...]:
    return tuple(float(x) for x in dx) if isinstance(dx, (tuple, list)) else (float(dx),) * ndim


def scatter_to_grid(positions: torch.Tensor, values: torch.Tensor, resolution: Sequence[int], dx,
                    outside_handling: str = 'discard',
                    base: float = 0.0) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Mean of the particles' values per nearest sample point of a closed-box
    grid of `resolution` cells of size `dx`; sample points without a particle
    get `base` (the particle field's extrapolation: NaN for a FLIP velocity).

    values (N,): a centred grid. values (N, d): a staggered grid, component a
    of the values onto the faces of axis a — one scatter per face grid, each
    with its own lower corner and resolution. `outside_handling`: 'discard'
    drops particles outside the target grid, 'clamp' keeps them at its border.
    3D CUDA tensors go through K8, one launch per target grid."""
    if outside_handling not in ('discard', 'clamp'):
        raise ValueError(f"outside_handling {outside_handling!r}: 'discard' or 'clamp' expected")
    d = len(resolution)
    h = _per_axis(dx, d)
    clamp = outside_handling == 'clamp'

    def scatter(vals, axis):
        res, lower, _ = face_grid(resolution, h, axis)
        inv_dx = tuple(1.0 / float(np.float32(x)) for x in h)
        return p2g_mean(positions, vals, res, tuple(float(x) for x in lower), inv_dx, clamp, base)

    if values.ndim == 1:
        return scatter(values, None)
    if values.ndim != 2 or values.shape[1] != d:
        raise ValueError(f"values of shape {tuple(values.shape)}: (N,) or (N, {d}) expected")
    return tuple(scatter(values[:, a].contiguous(), a) for a in range(d))


def sample_grid_at_points(values: torch.Tensor, points: torch.Tensor, lower: Sequence[float],
                          upper: Sequence[float], extrap: Extrapolation = 0.0) -> torch.Tensor:
    """Multilinear interpolation of a grid at `points` (N, d). The grid's
    sample points are the centres of values.shape cells dividing the box
    [lower, upper]; beyond them the grid continues with the constant `extrap`.

    A corner of weight 0 is left out of the sum instead of multiplied, so a
    NaN there (the unset cells of a FLIP grid) does not reach the result — the
    behaviour of the JAX package's lookup for particle sets."""
    if not isinstance(extrap, (int, float)):
        raise NotImplementedError(f"extrapolation {extrap!r}: only a constant is ported for lookups at points")
    d = values.ndim
    padded = torch.nn.functional.pad(values, (1, 1) * d, value=float(extrap))
    sizes = padded.shape
    flat = padded.reshape(-1)
    strides = [int(np.prod(sizes[a + 1:])) for a in range(d)]
    base = None     # flat index of each point's lower corner in the padded array
    weights = []    # per axis (weight of the lower corner, of the upper corner)
    for a in range(d):
        box = float(np.float32(upper[a]) - np.float32(lower[a]))
        local = (points[:, a] - float(np.float32(lower[a]))) / box
        coord = local * float(values.shape[a]) - 0.5
        pos = torch.clamp(coord + 1.0, 0.0, sizes[a] - 1.0)  # index in the padded array
        i = torch.clamp(torch.floor(pos), 0, sizes[a] - 2)
        frac = pos - i
        weights.append((1.0 - frac, frac))
        term = i.to(torch.int64) * strides[a]
        base = term if base is None else base + term
    result = None
    for corner in itertools.product((0, 1), repeat=d):
        w = weights[0][corner[0]]
        for a in range(1, d):
            w = w * weights[a][corner[a]]
        v = flat[base + sum(c * st for c, st in zip(corner, strides))]
        term = torch.where(w > 0, v * w, 0.0)
        result = term if result is None else result + term
    return result


def sample_staggered_at_points(velocity: Sequence[torch.Tensor], points: torch.Tensor, dx,
                               extrap: Extrapolation = 0.0) -> torch.Tensor:
    """The full vector (N, d) of a closed-box staggered grid at `points`: each
    face component interpolated on its own face grid."""
    d = len(velocity)
    h = _per_axis(dx, d)
    resolution = [velocity[a].shape[a] + 1 for a in range(d)]  # component a holds the N−1 interior faces of axis a
    comps = []
    for a in range(d):
        _, lower, upper = face_grid(resolution, h, a)
        comps.append(sample_grid_at_points(velocity[a], points, lower, upper, extrap))
    return torch.stack(comps, dim=1)

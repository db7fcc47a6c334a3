"""Grid functions on raw tensors: `shift_window_interp` and `masked_fill`;
and the spectral functions of periodic grids on named-dim Tensors.

Window-shift interpolation of a grid at its own displaced lattice — port of
`phiflow_tpu/math/_nd.py::shift_window_interp` (`:468-623`).

The grid's extrapolation describes its halo to the kernel, which resolves it by
index: a constant (a float: the closed box's velocity, 0 at the walls),
`BOUNDARY` (zero gradient: the smoke) or `PERIODIC`. No padded copy is made.
`PerSide` is a constant that differs by side (a moving lid); such a grid is
padded here, side by side, and the kernel takes the padded array.

One kernel per call, whatever K: the TPU route picks between a K=1 and a K
window at run time (`:554-578`) because its cost grows with (2K+1)^d. A corner
gather costs the same for every K and both windows give the same result
wherever both are exact, so the port takes no min/max pass and no host sync
for that choice.

`masked_fill_native` ports `masked_fill` (`:443-461`): the flood fill behind
`field.finite_fill`, PyTorch operations on any device; `masked_fill` is the
same on named-dim Tensors.

`fourier_laplace` and `fourier_poisson` port the functions of those names
(`:375-400`) with the helpers `_k_grids`, `_spectral_separable` and
`_spectral_pointwise` (`:303-372`): a filter F⁻¹·diag(s(k))·F of a periodic
grid, its spectrum built on the host in numpy as the JAX package builds it.
The JAX package applies it as per-axis circulant or DFT matrices because its
TPU runtime has no FFT; here `torch.fft` computes the same function.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.interp import window_interp_2d, window_interp_3d

__all__ = ['BOUNDARY', 'PERIODIC', 'PerSide', 'pad', 'component_extrapolation', 'shift_window_interp', 'masked_fill',
           'masked_fill_native', 'shift_zero', 'fourier_laplace', 'fourier_poisson']

BOUNDARY, PERIODIC = 'boundary', 'periodic'


class PerSide(tuple):
    """A constant extrapolation with its own value on every side: one
    (lower, upper) pair of floats per axis — `combine_sides` of the JAX
    package for constants."""

    def __new__(cls, *sides):
        return super().__new__(cls, tuple((float(lo), float(up)) for lo, up in sides))


Extrapolation = Union[float, str, PerSide]  # a constant value, BOUNDARY, PERIODIC, or constants per side


def component_extrapolation(extrap, component: int) -> Extrapolation:
    """The extrapolation of one component of a staggered grid: `extrap` itself,
    or its entry where it is a sequence with one extrapolation per component."""
    if isinstance(extrap, (list, tuple)) and not isinstance(extrap, PerSide):
        return extrap[component]
    return extrap


def pad(v: torch.Tensor, axis: int, lower: int, upper: int, extrap: Extrapolation) -> torch.Tensor:
    """`v` extended by `lower` / `upper` entries along `axis`."""
    if not lower and not upper:
        return v
    n = v.shape[axis]
    if extrap == PERIODIC:
        lo, hi = v.narrow(axis, n - lower, lower), v.narrow(axis, 0, upper)
    elif extrap == BOUNDARY:
        lo = v.narrow(axis, 0, 1).expand(*[lower if a == axis else -1 for a in range(v.ndim)])
        hi = v.narrow(axis, n - 1, 1).expand(*[upper if a == axis else -1 for a in range(v.ndim)])
    else:
        c_lo, c_hi = extrap[axis] if isinstance(extrap, PerSide) else (extrap, extrap)
        shape = list(v.shape)
        shape[axis] = lower
        lo = torch.full(shape, float(c_lo), dtype=v.dtype, device=v.device)
        shape[axis] = upper
        hi = torch.full(shape, float(c_hi), dtype=v.dtype, device=v.device)
    return torch.cat(([lo] if lower else []) + [v] + ([hi] if upper else []), dim=axis)


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
    twin (`ops/interp.py`). Every route is differentiable in the grid and the
    displacements (K6ᵀ / K7ᵀ on CUDA); a PerSide halo is padded here by
    PyTorch operations, which autograd follows."""
    d = len(displacement_cells)
    if grid.ndim != d:
        raise NotImplementedError(
            f"grid of rank {grid.ndim} with {d} displacement axes: leading batch axes come with the "
            f"batched-smoke slice of the port")
    if d not in (2, 3):
        raise NotImplementedError(f"{d}D grids come with a later slice of the port (2D and 3D are ported)")
    fn = window_interp_3d if d == 3 else window_interp_2d
    if isinstance(extrap, PerSide):
        # axis after axis, so a corner of the halo holds the later axis' value
        for axis in range(d):
            grid = pad(grid, axis, max_cells, max_cells, extrap)
        halo = {}
    elif extrap == BOUNDARY:
        halo = dict(halo='edge')
    elif extrap == PERIODIC:
        halo = dict(halo='wrap')
    elif isinstance(extrap, torch.Tensor):
        raise TypeError("a constant halo is a number: no gradient reaches it, as the JAX package's 3D kernel takes "
                        "it as a Python float; pad the grid with the tensor instead")
    elif isinstance(extrap, (int, float)):
        halo = dict(const_pad=float(extrap))
    else:
        raise ValueError(f"extrapolation {extrap!r}: a constant value, BOUNDARY, PERIODIC or PerSide expected")
    return fn(grid, list(displacement_cells), max_cells, compute_extrema=compute_extrema, negate=negate,
              disp_scale=disp_scale, **halo)


def shift_zero(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x[i−1], x[i+1]) along `axis`, 0 beyond the ends."""
    n = x.shape[axis]
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    lower = torch.cat([zero, x.narrow(axis, 0, n - 1)], dim=axis)
    upper = torch.cat([x.narrow(axis, 1, n - 1), zero], dim=axis)
    return lower, upper


def masked_fill_native(values: torch.Tensor, valid: torch.Tensor, distance: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
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


def masked_fill(values, valid, distance=1):
    """`masked_fill_native` on named-dim Tensors of spatial dims only:
    (filled values, new validity)."""
    from ._tensor import Tensor
    if values.shape.non_spatial:
        raise NotImplementedError(f"masked_fill of {values.shape}: spatial dims only are ported")
    order = values.shape.names
    filled, new_valid = masked_fill_native(values.torch(order), valid.torch(order, values.device), distance)
    return Tensor(filled, values.shape), Tensor(new_valid, values.shape)


# ---------------------------------------------------------------------------
# spectral filters of periodic grids
# ---------------------------------------------------------------------------

def _spectral_native(grid):
    """The grid's native as a torch tensor (a host array on the default device)."""
    from ._tensor import to_torch
    return to_torch(grid.native())


def _axis_spectrum(spectrum: np.ndarray, axis: int, like: torch.Tensor) -> torch.Tensor:
    dtype = torch.float64 if like.dtype == torch.float64 else torch.float32
    return torch.as_tensor(np.asarray(spectrum, np.float64), dtype=dtype, device=like.device).reshape(
        [-1 if a == axis else 1 for a in range(like.ndim)])


def _spectral_separable(grid, per_axis_spectra: dict, combine: str):
    """F⁻¹·diag(Π_d s_d(k_d)) ·F (``combine='mul'``) or Σ_d F_d⁻¹·diag(s_d)·F_d
    (``'sum'``) of `grid` along the dims of `per_axis_spectra`."""
    from ._tensor import Tensor
    native = _spectral_native(grid)
    names = grid.shape.names
    if combine == 'mul':
        axes = [names.index(dim) for dim in per_axis_spectra]
        factor = None
        for dim, spec in per_axis_spectra.items():
            f = _axis_spectrum(spec, names.index(dim), native)
            factor = f if factor is None else factor * f
        out = torch.fft.ifftn(torch.fft.fftn(native, dim=axes) * factor, dim=axes).real
    else:
        out = None
        for dim, spec in per_axis_spectra.items():
            axis = names.index(dim)
            term = torch.fft.ifft(torch.fft.fft(native, dim=axis) * _axis_spectrum(spec, axis, native), dim=axis).real
            out = term if out is None else out + term
    return Tensor(out.to(native.dtype), grid.shape)


def _spectral_pointwise(grid, factor_nd: np.ndarray, dims):
    """F⁻¹·diag(factor)·F of `grid` over `dims`, `factor_nd` one entry per
    wavenumber of those dims in the grid's order."""
    from ._tensor import Tensor
    native = _spectral_native(grid)
    names = grid.shape.names
    axes = [names.index(d) for d in dims]
    fshape = [native.shape[a] if a in axes else 1 for a in range(native.ndim)]
    dtype = torch.float64 if native.dtype == torch.float64 else torch.float32
    factor = torch.as_tensor(np.asarray(factor_nd, np.float64), dtype=dtype, device=native.device).reshape(fshape)
    out = torch.fft.ifftn(torch.fft.fftn(native, dim=axes) * factor, dim=axes).real
    return Tensor(out.to(native.dtype), grid.shape)


def _k_grids(grid, dx):
    """Per-axis wavenumbers k_d (cycles per unit length) as numpy."""
    dims = grid.shape.spatial.names
    if hasattr(dx, 'native'):
        dx_arr = np.asarray(dx.numpy(dx.shape.names), np.float64).reshape(-1)
    else:
        dx_arr = np.asarray(dx, np.float64).reshape(-1)
    if dx_arr.size == 1:
        dx_arr = np.repeat(dx_arr, len(dims))
    return {d: np.fft.fftfreq(grid.shape.get_size(d), d=dx_arr[i]) for i, d in enumerate(dims)}


def _k_squared(ks: dict) -> np.ndarray:
    return sum(np.square(k).reshape([-1 if i == j else 1 for j in range(len(ks))]) for i, k in enumerate(ks.values()))


def fourier_laplace(grid, dx, times=1):
    """The exact Laplacian of a periodic grid, F⁻¹·(−(2πk)²)ⁿ·F: one sum of
    per-axis filters for ``times=1``, the n-th power as one filter."""
    ks = _k_grids(grid, dx)
    if times == 1:
        return _spectral_separable(grid, {d: -4 * np.pi ** 2 * k ** 2 for d, k in ks.items()}, 'sum')
    return _spectral_pointwise(grid, (-4 * np.pi ** 2 * _k_squared(ks)) ** times, list(ks))


def fourier_poisson(grid, dx, times=1):
    """The zero-mean inverse Laplacian of a periodic grid: the filter
    1 / (−(2πk)²)ⁿ with the k = 0 mode set to 0."""
    ks = _k_grids(grid, dx)
    lap = (-4 * np.pi ** 2 * _k_squared(ks)) ** times
    with np.errstate(divide='ignore', invalid='ignore'):
        inv = np.where(lap != 0, 1.0 / np.where(lap == 0, 1.0, lap), 0.0)
    return _spectral_pointwise(grid, inv, list(ks))

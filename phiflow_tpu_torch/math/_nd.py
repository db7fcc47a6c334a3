"""Grid functions on raw tensors: `shift_window_interp` and `masked_fill`;
and the spectral functions of periodic grids on named-dim Tensors.

Window-shift interpolation of a grid at its own displaced lattice — port of
`phiflow_tpu/math/_nd.py::shift_window_interp` (`:468-623`).

The grid's extrapolation describes its halo to the kernel, which resolves it by
index: a constant (a float: the closed box's velocity, 0 at the walls),
`BOUNDARY` (zero gradient: the smoke) or `PERIODIC`. No padded copy is made.
Every other rule — the mirrors (`SYMMETRIC`, `REFLECT`, `ANTISYMMETRIC`,
`ANTIREFLECT`, `SYMMETRIC_GRADIENT`) and `PerSide`, a rule by side (a moving
lid, an inflow wall beside an open outflow, an open top) — is the JAX
package's own route (`make_padded`, `:505-528`): the grid is padded here by
max_cells cells, axis after axis, and the kernel takes the padded array. The
grid and the displacements may carry leading batch axes (one launch for the
batch; an input without them is shared by every entry).

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

On named-dim Tensors too: `grid_sample_tensor` and
`closest_grid_values_tensor` (`math.grid_sample`, `math.closest_grid_values`;
`_grid_sample_xla` `:32-176` with its slab route, `_closest_grid_values`
`:185-245`) gather with PyTorch indexing, differentiably; the Tensor-level
`spatial_gradient_t`, `laplace_t`, `downsample2x` and `upsample2x`
(`:257-441`) shift and pad with the named-dim extrapolations.
"""
from __future__ import annotations

import itertools
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.interp import window_interp_2d, window_interp_3d

__all__ = ['BOUNDARY', 'PERIODIC', 'SYMMETRIC', 'REFLECT', 'ANTISYMMETRIC', 'ANTIREFLECT', 'SYMMETRIC_GRADIENT',
           'MIRRORS', 'PerSide', 'pad', 'component_extrapolation', 'shift_window_interp', 'masked_fill',
           'masked_fill_native', 'shift_zero', 'fourier_laplace', 'fourier_poisson', 'grid_sample_tensor',
           'closest_grid_values_tensor', 'slab_route', 'spatial_gradient_t', 'laplace_t', 'downsample2x', 'upsample2x']

BOUNDARY, PERIODIC = 'boundary', 'periodic'
# the mirror rules of the JAX package's extrapolations of these names (`math/_extrapolation.py:299-400`):
# symmetric (… b a | a b …), reflect (… c b | b c …, the edge not repeated), antisymmetric (the symmetric
# ghosts negated), antireflect and symmetric-gradient (both 2·edge − the reflected ghosts)
SYMMETRIC, REFLECT, ANTISYMMETRIC = 'symmetric', 'reflect', 'antisymmetric'
ANTIREFLECT, SYMMETRIC_GRADIENT = 'antireflect', 'symmetric-gradient'
MIRRORS = (SYMMETRIC, REFLECT, ANTISYMMETRIC, ANTIREFLECT, SYMMETRIC_GRADIENT)


class PerSide(tuple):
    """An extrapolation with its own rule on every side: one (lower, upper)
    pair per axis — `combine_sides` of the JAX package. A side is a number
    (a constant), `BOUNDARY`, `PERIODIC` (both sides of its axis), one of
    the `MIRRORS`, or a torch tensor of the ghost cells themselves (one plane
    across the axis, as a Field embedding samples them)."""

    def __new__(cls, *sides):
        return super().__new__(cls, tuple((_side(lo), _side(up)) for lo, up in sides))


def _side(e):
    return e if isinstance(e, (str, torch.Tensor)) else float(e)


Extrapolation = Union[float, str, PerSide]  # a constant value, BOUNDARY, PERIODIC, a mirror, or a rule per side


def component_extrapolation(extrap, component: int) -> Extrapolation:
    """The extrapolation of one component of a staggered grid: `extrap` itself,
    or its entry where it is a sequence with one extrapolation per component."""
    if isinstance(extrap, (list, tuple)) and not isinstance(extrap, PerSide):
        return extrap[component]
    return extrap


def _ghosts(v: torch.Tensor, axis: int, width: int, upper: bool, e) -> torch.Tensor:
    """`width` ghost entries of `v` beyond its lower or upper end along `axis` by the side rule `e`."""
    axis %= v.ndim
    n = v.shape[axis]
    if isinstance(e, str) and e == PERIODIC:
        return v.narrow(axis, 0, width) if upper else v.narrow(axis, n - width, width)
    if isinstance(e, str) and e == BOUNDARY:
        return v.narrow(axis, n - 1 if upper else 0, 1).expand(*[width if a == axis else -1 for a in range(v.ndim)])
    if isinstance(e, str) and e in MIRRORS:
        # numpy's index pattern of its 'symmetric' / 'reflect' pad of one side, as `jnp.pad` takes it
        mode = SYMMETRIC if e in (SYMMETRIC, ANTISYMMETRIC) else REFLECT
        idx = np.pad(np.arange(n), (0, width) if upper else (width, 0), mode=mode)
        idx = idx[n:] if upper else idx[:width]
        mirrored = torch.index_select(v, axis, torch.from_numpy(idx).to(v.device))
        if e == ANTISYMMETRIC:
            return -mirrored
        if e in (ANTIREFLECT, SYMMETRIC_GRADIENT):
            return 2 * v.narrow(axis, n - 1 if upper else 0, 1) - mirrored
        return mirrored
    if isinstance(e, str):
        raise ValueError(f"side rule {e!r}: a number, BOUNDARY, PERIODIC, {', '.join(MIRRORS)} or a tensor expected")
    shape = list(v.shape)
    shape[axis] = width
    if isinstance(e, torch.Tensor):
        return e.to(v.dtype).expand(shape)
    return torch.full(shape, float(e), dtype=v.dtype, device=v.device)


def pad(v: torch.Tensor, axis: int, lower: int, upper: int, extrap: Extrapolation) -> torch.Tensor:
    """`v` extended by `lower` / `upper` entries along `axis`. A `PerSide`
    rule is looked up by `axis` among its axes: an array with leading batch
    axes gives a negative axis, counted from its last. A `PerSide` pads the
    lower side first and takes the upper ghosts from that padded array, as
    the JAX package's `combine_sides` pads (`_MixedExtrapolation.pad`): a
    PERIODIC side by side wraps its upper ghosts from the lower ghosts
    (ROADMAP §3, 3.11); a PERIODIC rule of its own wraps both from `v`."""
    if not lower and not upper:
        return v
    if isinstance(extrap, PerSide):
        lo_e, up_e = extrap[axis]
        if lower:
            v = torch.cat([_ghosts(v, axis, lower, False, lo_e), v], dim=axis)
        return torch.cat([v, _ghosts(v, axis, upper, True, up_e)], dim=axis) if upper else v
    return torch.cat(([_ghosts(v, axis, lower, False, extrap)] if lower else []) + [v] +
                     ([_ghosts(v, axis, upper, True, extrap)] if upper else []), dim=axis)


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
    displacements (K6ᵀ / K7ᵀ on CUDA); a mirror or PerSide halo is padded
    here by PyTorch operations, which autograd follows. Leading batch axes of the
    grid or of the displacements (the last d axes are the grid's) broadcast:
    the result has the batch, from one launch."""
    d = len(displacement_cells)
    if grid.ndim < d or any(c.ndim < d for c in displacement_cells):
        raise ValueError(f"grid of rank {grid.ndim} with {d} displacement axes of ranks "
                         f"{[c.ndim for c in displacement_cells]}")
    if d not in (2, 3):
        raise NotImplementedError(f"{d}D grids come with a later slice of the port (2D and 3D are ported)")
    fn = window_interp_3d if d == 3 else window_interp_2d
    if isinstance(extrap, PerSide) or (isinstance(extrap, str) and extrap in MIRRORS):
        # axis after axis, so a corner of the halo holds the later axis' value
        for axis in range(-d, 0):
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
        raise ValueError(f"extrapolation {extrap!r}: a constant value, BOUNDARY, PERIODIC, a mirror or PerSide "
                         f"expected")
    # the kernels take contiguous arrays: a Field's constant values arrive as broadcast views
    lead = torch.broadcast_shapes(*[c.shape[:-d] for c in displacement_cells])
    displacement_cells = [c.expand(lead + c.shape[-d:]) for c in displacement_cells]
    return fn(grid.contiguous(), [c.contiguous() for c in displacement_cells], max_cells,
              compute_extrema=compute_extrema, negate=negate, disp_scale=disp_scale, **halo)


def shift_zero(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x[i−1], x[i+1]) along `axis`, 0 beyond the ends."""
    n = x.shape[axis]
    zero = torch.zeros_like(x.narrow(axis, 0, 1))
    lower = torch.cat([zero, x.narrow(axis, 0, n - 1)], dim=axis)
    upper = torch.cat([x.narrow(axis, 1, n - 1), zero], dim=axis)
    return lower, upper


def masked_fill_native(values: torch.Tensor, valid: torch.Tensor, distance: int = 1,
                       ndim: int = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Propagate values into invalid cells as the mean of their valid axis
    neighbours, `distance` times. Returns (filled values, new validity).
    `ndim`: the grid's axes, the trailing ones (default all; leading axes
    are a batch)."""
    nd = values.ndim if ndim is None else ndim
    valid_f = valid.to(values.dtype)
    for _ in range(distance):
        values_v = values * valid_f
        neighbor_sum = torch.zeros_like(values_v)
        neighbor_count = torch.zeros_like(valid_f)
        for axis in range(-nd, 0):
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
    """`masked_fill_native` on named-dim Tensors of spatial and batch dims:
    (filled values, new validity); the batch dims lead, each entry filled on
    its own."""
    from ._tensor import Tensor
    if values.shape.non_spatial.non_batch:
        raise NotImplementedError(f"masked_fill of {values.shape}: spatial and batch dims are ported")
    order = values.shape.batch.names + values.shape.spatial.names
    v = values.torch(order)
    filled, new_valid = masked_fill_native(v, valid.torch(order, values.device).expand(v.shape), distance,
                                           values.shape.spatial.rank)
    shape = values.shape.only(order, reorder=True)
    return Tensor(filled, shape), Tensor(new_valid, shape)


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


# ---------------------------------------------------------------------------
# interpolation of named-dim grids (port of `_grid_sample_xla`, `:32-176`,
# and `_closest_grid_values`, `:185-245`)
# ---------------------------------------------------------------------------

def _periodic_along(extrap, dim) -> bool:
    """Whether `extrap` is periodic at the lower side of `dim`."""
    from ._extrapolation import PERIODIC as PERIODIC_EXTRAPOLATION
    if extrap is None:
        return False
    if extrap == PERIODIC_EXTRAPOLATION:
        return True
    try:
        return extrap._get(dim, False) == PERIODIC_EXTRAPOLATION
    except Exception:
        return False


def _lookup_setup(grid, coordinates, extrap):
    """The padded grid flattened to (rows, *kept), the query coordinates as a
    torch array (..., d) on its device, and the layout of both."""
    from ._tensor import TensorStack, to_torch
    if isinstance(grid, TensorStack):
        grid = grid._contiguous()
    ch = coordinates.shape.channel
    assert ch.rank == 1, f"coordinates must have one channel dim, got {coordinates.shape}"
    dims = ch.labels[0] or grid.shape.spatial.names
    d = len(dims)
    periodic = [_periodic_along(extrap, n) for n in dims]
    if extrap is not None and not all(periodic):
        grid_p = extrap.pad(grid, {n: ((0, 0) if p else (1, 1)) for n, p in zip(dims, periodic)})
        offsets = [0 if p else 1 for p in periodic]
    else:
        grid_p, offsets = grid, [0] * d
    if isinstance(grid_p, TensorStack):
        grid_p = grid_p._contiguous()
    p_sizes = [grid_p.shape.get_size(n) for n in dims]
    kept = grid_p.shape.without(dims)
    out_dims = coordinates.shape.without(ch.name)
    shared = [n for n in kept.names if n in out_dims]
    kept_rest = kept.without(shared)
    shared_sizes = [kept.get_size(n) for n in shared]
    spatial_vol = int(np.prod(p_sizes))
    coords = coordinates.native(out_dims.names + (ch.name,))
    device = coords.device if isinstance(coords, torch.Tensor) else grid_p.device
    coords = to_torch(coords, device)
    flat = to_torch(grid_p._transposed(tuple(shared) + tuple(dims) + kept_rest.names).native(), coords.device)
    flat = flat.reshape((int(np.prod(shared_sizes)) * spatial_vol if shared else spatial_vol,) + tuple(kept_rest.sizes))
    labels = ch.labels[0]
    if labels and tuple(labels) != tuple(dims):
        coords = coords[..., [labels.index(n) for n in dims]]
    out_sizes = tuple(out_dims.sizes)
    shared_lin = None
    for n, size in zip(shared, shared_sizes):
        axis = out_dims.index(n)
        iota = torch.arange(out_dims.get_size(n), device=coords.device).reshape(
            [-1 if a == axis else 1 for a in range(len(out_sizes))]).expand(out_sizes)
        shared_lin = iota if shared_lin is None else shared_lin * size + iota
    return dict(flat=flat, coords=coords, dims=dims, periodic=periodic, offsets=offsets, p_sizes=p_sizes,
                kept_rest=kept_rest, out_dims=out_dims, out_sizes=out_sizes, shared_lin=shared_lin,
                spatial_vol=spatial_vol)


def _corner_index(lo, corner, s, k):
    ik = lo[..., k] + corner[k] + s['offsets'][k]
    n = s['p_sizes'][k]
    return torch.remainder(ik, n) if s['periodic'][k] else torch.clamp(ik, 0, n - 1)


def _take(flat, idx, kept_rest):
    vals = torch.index_select(flat, 0, idx.reshape(-1))
    return vals.reshape(tuple(idx.shape) + tuple(kept_rest.sizes))


def _slab_sample(s):
    """The JAX package's slab route: one row of 2^(d−1)·Z values for each
    (x, y) corner pair, the weights of all taps in that row layout, and
    zero-weight taps masked out, so that a NaN in the row (a grid's NaN
    ghost cells) reaches no query whose weights miss it."""
    d, p_sizes, coords, offsets = len(s['dims']), s['p_sizes'], s['coords'], s['offsets']
    g = s['flat'].reshape(tuple(p_sizes))
    pos = [torch.clamp(coords[..., k] + offsets[k], 0., p_sizes[k] - 1.) for k in range(d)]
    zp = p_sizes[-1]
    zf = torch.clamp(pos[-1].reshape(-1), 0., zp - 1.)
    if d == 3:
        xp, yp = p_sizes[0], p_sizes[1]
        ix = torch.clamp(torch.floor(pos[0]), 0, xp - 2).to(torch.int64)
        iy = torch.clamp(torch.floor(pos[1]), 0, yp - 2).to(torch.int64)
        fx = (pos[0] - ix).to(g.dtype).reshape(-1, 1)
        fy = (pos[1] - iy).to(g.dtype).reshape(-1, 1)
        table = torch.stack([g[:-1, :-1], g[:-1, 1:], g[1:, :-1], g[1:, 1:]], dim=2).reshape((xp - 1) * (yp - 1), 4 * zp)
        rows = torch.index_select(table, 0, (ix * (yp - 1) + iy).reshape(-1))
        j = torch.arange(4 * zp, device=g.device).reshape(1, -1)
        zlane = (j % zp).to(g.dtype)
        c = j // zp
        wzl = torch.clamp(1. - torch.abs(zlane - zf[:, None].to(g.dtype)), min=0.)
        w = torch.where(c >= 2, fx, 1. - fx) * torch.where(c % 2 == 1, fy, 1. - fy) * wzl
    else:
        xp = p_sizes[0]
        ix = torch.clamp(torch.floor(pos[0]), 0, xp - 2).to(torch.int64)
        fx = (pos[0] - ix).to(g.dtype).reshape(-1, 1)
        table = torch.stack([g[:-1], g[1:]], dim=1).reshape(xp - 1, 2 * zp)
        rows = torch.index_select(table, 0, ix.reshape(-1))
        j = torch.arange(2 * zp, device=g.device).reshape(1, -1)
        zlane = (j % zp).to(g.dtype)
        wzl = torch.clamp(1. - torch.abs(zlane - zf[:, None].to(g.dtype)), min=0.)
        w = torch.where(j // zp == 1, fx, 1. - fx) * wzl
    w = w.to(g.dtype)
    result = torch.sum(torch.where(w > 0, rows * w, torch.zeros((), dtype=g.dtype, device=g.device)), dim=-1)
    return result.reshape(s['out_sizes'])


def slab_route(s) -> bool:
    """The JAX package's rule for its slab route: 2D or 3D, no periodic dim,
    no dims beyond the grid's, at least 2048 queries, and the table and the
    rows within 64 Mi and 128 Mi entries."""
    d, n_query = len(s['dims']), int(np.prod(s['out_sizes'])) if s['out_sizes'] else 1
    corners = 4 if d == 3 else 2
    return (d in (2, 3) and not any(s['periodic']) and s['kept_rest'].rank == 0 and s['shared_lin'] is None
            and n_query >= 2048 and s['spatial_vol'] * corners <= 64 * 1024 * 1024
            and n_query * s['p_sizes'][-1] * corners <= 128 * 1024 * 1024)


def _corner_sample(s):
    """The JAX package's generic route: one gather of all 2^d corners, whose
    weights multiply the values (a NaN corner of weight 0 gives NaN there,
    as in JAX)."""
    coords, flat, kept_rest = s['coords'], s['flat'], s['kept_rest']
    lo_f = torch.floor(coords)
    frac = coords - lo_f
    lo = lo_f.to(torch.int64)
    d = len(s['dims'])
    result = None
    for corner in itertools.product((0, 1), repeat=d):
        idx, w = None, None
        for k in range(d):
            ik = _corner_index(lo, corner, s, k)
            idx = ik if idx is None else idx * s['p_sizes'][k] + ik
            wk = frac[..., k] if corner[k] else 1.0 - frac[..., k]
            w = wk if w is None else w * wk
        if s['shared_lin'] is not None:
            idx = idx.expand(s['out_sizes']) + s['shared_lin'] * s['spatial_vol']
        vals = _take(flat, idx, kept_rest)
        contrib = vals * w.reshape(tuple(w.shape) + (1,) * kept_rest.rank).to(vals.dtype)
        result = contrib if result is None else result + contrib
    return result


def grid_sample_tensor(grid, coordinates, extrap):
    """`math.grid_sample`: multilinear interpolation of a named-dim grid at
    fractional indices, as the JAX package's `_grid_sample_xla`: the grid
    padded by one cell of `extrap` along its non-periodic dims, then its
    slab route where `slab_route` takes it, else the per-corner route.
    Differentiable in the grid and the coordinates."""
    from ._shape import concat_shapes
    from ._tensor import Tensor
    s = _lookup_setup(grid, coordinates, extrap)
    result = _slab_sample(s) if slab_route(s) else _corner_sample(s)
    return Tensor(result, concat_shapes(s['out_dims'], s['kept_rest']))


def closest_grid_values_tensor(grid, coordinates, extrap, stack_dim_prefix='closest_'):
    """`math.closest_grid_values`: the 2^d values around each coordinate,
    stacked along channel dims `<prefix><dim>` of size 2 (lower, upper)."""
    from ._ops import stack
    from ._shape import channel, concat_shapes
    from ._tensor import Tensor
    s = _lookup_setup(grid, coordinates, extrap)
    lo = torch.floor(s['coords']).to(torch.int64)
    d = len(s['dims'])
    corners = {}
    for corner in itertools.product((0, 1), repeat=d):
        idx = None
        for k in range(d):
            ik = _corner_index(lo, corner, s, k)
            idx = ik if idx is None else idx * s['p_sizes'][k] + ik
        if s['shared_lin'] is not None:
            idx = idx.expand(s['out_sizes']) + s['shared_lin'] * s['spatial_vol']
        corners[corner] = Tensor(_take(s['flat'], idx, s['kept_rest']), concat_shapes(s['out_dims'], s['kept_rest']))

    def build(prefix):
        if len(prefix) == d:
            return corners[prefix]
        return stack([build(prefix + (0,)), build(prefix + (1,))],
                     channel(**{f"{stack_dim_prefix}{s['dims'][len(prefix)]}": 2}))
    return build(())


# ---------------------------------------------------------------------------
# stencils of named-dim tensors (port of `:257-441`)
# ---------------------------------------------------------------------------

from ._extrapolation import BOUNDARY as _ZERO_GRADIENT  # noqa: E402 — the named-dim extrapolations import nothing of this module
from ._shape import channel as _channel  # noqa: E402


def _extrapolation_of(padding):
    from ._extrapolation import as_extrapolation
    return as_extrapolation(padding)


def spatial_gradient_t(grid, dx=1, difference='central', padding=_ZERO_GRADIENT, dims=None,
                       stack_dim=_channel('gradient')):
    """`math.spatial_gradient`: finite differences of a Tensor along its
    spatial dims ('central', 'forward' or 'backward'), stacked along
    `stack_dim`."""
    from ._ops import shift
    from ._tensor import wrap
    dims = grid.shape.spatial.names if dims is None else dims
    offsets = {'central': (-1, 1), 'forward': (0, 1), 'backward': (-1, 0)}
    if difference not in offsets:
        raise ValueError(difference)
    lo, up = shift(grid, offsets[difference], dims, _extrapolation_of(padding), stack_dim=stack_dim)
    return (up - lo) / ((2 if difference == 'central' else 1) * wrap(dx))


def laplace_t(x, dx=1, padding=_ZERO_GRADIENT, dims=None, weights=None):
    """`math.laplace`: the second-order Laplacian of a Tensor over its spatial dims."""
    from ._ops import rename_dims, shift, sum_
    from ._shape import channel
    from ._tensor import wrap
    dims = x.shape.spatial.names if dims is None else dims
    dx_t = wrap(dx)
    lo, ce, up = shift(x, (-1, 0, 1), dims, _extrapolation_of(padding), stack_dim=channel('_lap'))
    result = (lo + up - 2 * ce) * weights if weights is not None else lo + up - 2 * ce
    if dx_t.shape.channel:
        result = result / rename_dims(dx_t * dx_t, dx_t.shape.channel, channel('_lap'))
    else:
        result = result / (dx_t * dx_t)
    return sum_(result, '_lap')


def downsample2x(grid, padding=_ZERO_GRADIENT, dims=None):
    """Half the resolution along `dims`: the mean of each pair of cells (an
    odd size padded by one cell of `padding` first)."""
    padding = _extrapolation_of(padding)
    for dim in (grid.shape.spatial.names if dims is None else dims):
        size = grid.shape.get_size(dim)
        if size % 2:
            grid = padding.pad(grid, {dim: (0, 1)})
            size += 1
        grid = (grid[{dim: slice(0, size, 2)}] + grid[{dim: slice(1, size, 2)}]) * 0.5
    return grid


def upsample2x(grid, padding=_ZERO_GRADIENT, dims=None):
    """Twice the resolution along `dims`: each cell splits into two, ¾ of
    it and ¼ of its neighbour on that side (`padding` beyond the ends)."""
    from ._tensor import Tensor, _is_host
    padding = _extrapolation_of(padding)
    for dim in (grid.shape.spatial.names if dims is None else dims):
        padded = padding.pad(grid, {dim: (1, 1)})
        size = grid.shape.get_size(dim)
        left, center, right = (padded[{dim: slice(k, size + k)}] for k in range(3))
        a, b = 0.25 * left + 0.75 * center, 0.75 * center + 0.25 * right
        an, bn = a.native(), b._transposed(a.shape.names).native()
        axis = a.shape.index(dim)
        stacked = np.stack([an, bn], axis=axis + 1) if _is_host(an) else torch.stack([an, bn], dim=axis + 1)
        new_sizes = list(a.shape.sizes)
        new_sizes[axis] = size * 2
        grid = Tensor(stacked.reshape(new_sizes), a.shape.with_dim_size(dim, size * 2))
    return grid

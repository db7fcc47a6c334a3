"""Bounded window-shift interpolation — port of `phiflow_tpu/ops/interp.py`,
the backtrace lookup of the per-phase advection path.

A grid is interpolated linearly at its own lattice displaced by a per-cell
displacement (one array per axis, in any unit):

    δ_a  = clip((±scale_a)·disp_a, −K, K)                      (cells)
    out  = Σ_{s∈[−K,K]^d} Π_a max(0, 1 − |δ_a − s_a|) · grid[c + s]

and with ``compute_extrema`` also lo / up, the min / max of grid[c + s] over
the taps with |δ_a − s_a| < 1 on every axis — the MacCormack clamp bounds. An
integer δ_a (0 from rest, ±K at the clip) has one such tap on its axis, not two.

`window_interp_3d` (K6) and `window_interp_2d` (K7) launch one kernel
(`csrc/interp.cu`): a thread gathers the 2^d taps that carry weight for four
neighbouring outputs of a row, so the cost does not depend on K and any
float32 grid size is taken — the size limits, tile picker and slab staging of
the TPU kernels have no counterpart. Displacements are loaded and results
stored as float4 where `vector_route` allows it, and blocks whose taps lie
inside the grid skip the halo's resolution. Their plain twin
`_window_interp_plain` is the window sum itself
(the `fori_loop` of `phiflow_tpu/math/_nd.py:584-622`), written for d axes. A
wrapper takes the twin only for tensors on the CPU; for CUDA tensors it
launches its kernel or raises.

Batches: the grid and the displacements may carry leading batch axes,
(*batch, *grid); the result has the batch both broadcast to. On CUDA one
launch covers the batch: an input without the batch axes (or with axes of
size 1) is shared by every entry, read at an entry stride of 0 and never
expanded into a copy; K6ᵀ / K7ᵀ sum a shared input's gradient over the
batch. The twins take the batch by broadcasting, as the JAX package's window
sum does.

The grid comes either padded, K halo cells on every side (the TPU kernels'
input), or raw with its halo described: ``const_pad=c`` (a constant, as the
TPU 3D kernel takes it) or ``halo='edge'`` / ``'wrap'`` (zero gradient /
periodic), which the kernel resolves by index without a padding pass.

Both are differentiable in the grid and the displacements (`_WindowInterp`,
a `torch.autograd.Function`): the forward is the route above, the backward
is K6ᵀ / K7ᵀ (`csrc/interp.cu`: `window_interp_disp_grad_kernel` and
`window_interp_grid_grad_kernel`, one launch a call) on CUDA and the
twin's VJP (autograd of `_window_interp_plain`, recomputed, with JAX's d_disp
at a NaN displacement, `_nan_disp_grads`) on the CPU. The
TPU kernels have no VJP; the JAX package's gradient of the same function is
XLA's AD of its window sum, and the twin is written so that autograd follows
JAX's rules where the weights have kinks: |x| as ``where(x >= 0, x, −x)``
(slope +1 at 0), the tent as ``maximum(0, 1 − a)`` and the clip as
``minimum(maximum(x, −K), K)`` (ties split in half), the extrema chain in
JAX's tap order. At an integer displacement (0 from rest) the taps beside it
carry no weight but half a slope each. Forward values are those of
``abs`` / ``clamp``, bit for bit.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

__all__ = ['window_interp_3d', 'window_interp_2d', 'vector_route']

_BIG = 3.4e38
_PAD_MODE = {'edge': 'replicate', 'wrap': 'circular'}


def window_interp_3d(grid: torch.Tensor, disp3, K: int, compute_extrema: bool = False,
                     negate: bool = False, const_pad: Optional[float] = None,
                     disp_scale: Optional[Sequence[float]] = None, halo: Optional[str] = None):
    """K6. grid: (X+2K, Y+2K, Z+2K) padded, or the raw (X, Y, Z) grid with
    ``const_pad`` or ``halo``; disp3: (3, X, Y, Z) stacked or three (X, Y, Z)
    arrays. Either may carry leading batch axes (module docstring).
    ``negate`` flips the displacement sign, ``disp_scale`` converts the
    displacement to cells per axis. Returns out, or (out, lo, up) with
    ``compute_extrema``; all (*batch, X, Y, Z) float32."""
    return _window_interp(3, grid, disp3, K, compute_extrema, negate, const_pad, disp_scale, halo)


def window_interp_2d(grid: torch.Tensor, disp2, K: int, compute_extrema: bool = False,
                     negate: bool = False, const_pad: Optional[float] = None,
                     disp_scale: Optional[Sequence[float]] = None, halo: Optional[str] = None):
    """K7: `window_interp_3d` for a 2D grid and two displacement arrays."""
    return _window_interp(2, grid, disp2, K, compute_extrema, negate, const_pad, disp_scale, halo)


def _f32(x: float) -> float:
    return float(np.float32(x))


def _window_interp(d, grid, disps, K, compute_extrema, negate, const_pad, disp_scale, halo):
    name = f'window_interp_{d}d'
    if len(disps) != d:
        raise ValueError(f"{name} takes {d} displacement arrays, got {len(disps)}")
    disps = [disps[i] for i in range(d)]
    if K < 1:
        raise ValueError(f"window K must be >= 1, got {K}")
    if const_pad is not None and halo is not None:
        raise ValueError("pass const_pad or halo, not both")
    if halo is not None and halo not in _PAD_MODE:
        raise ValueError(f"halo {halo!r} not in {tuple(_PAD_MODE)}")
    mode = 'const' if const_pad is not None else halo  # None: the grid is padded
    if grid.ndim < d or disps[0].ndim < d:
        raise ValueError(f"{name} takes {d}D grids, got shapes {tuple(grid.shape)} / {tuple(disps[0].shape)}")
    if any(dd.shape != disps[0].shape for dd in disps):
        raise ValueError(f"displacement shapes differ: {[tuple(dd.shape) for dd in disps]}")
    out_shape = tuple(disps[0].shape[-d:])
    expected = out_shape if mode is not None else tuple(n + 2 * K for n in out_shape)
    if tuple(grid.shape[-d:]) != expected:
        raise ValueError(f"grid shape {tuple(grid.shape)} != {expected} for displacements {out_shape}, K={K}"
                         f"{'' if mode is not None else ' (padded)'}")
    try:
        torch.broadcast_shapes(grid.shape[:-d], disps[0].shape[:-d])
    except RuntimeError:
        raise ValueError(f"{name}: the batch axes of the grid {tuple(grid.shape[:-d])} and of the displacements "
                         f"{tuple(disps[0].shape[:-d])} do not broadcast") from None
    if mode == 'wrap' and min(out_shape) < K:
        raise ValueError(f"a wrapped grid needs at least K={K} cells per axis, got {out_shape}")
    sgn = -1.0 if negate else 1.0
    scale = tuple(_f32(sgn * float(s)) for s in (disp_scale or (1.0,) * d))
    if len(scale) != d:
        raise ValueError(f"disp_scale needs {d} entries, got {disp_scale}")
    if isinstance(const_pad, torch.Tensor):
        raise TypeError(f"{name}: const_pad is a number (no gradient reaches a constant halo), got a tensor")
    const = 0.0 if const_pad is None else _f32(const_pad)
    args = (name, K, compute_extrema, scale, mode, const)
    if torch.is_grad_enabled() and (grid.requires_grad or any(dd.requires_grad for dd in disps)):
        return _WindowInterp.apply(args, grid, *disps)
    return _forward(grid, disps, *args)


def _forward(grid, disps, name, K, compute_extrema, scale, mode, const, verdict=None):
    if grid.is_cuda:
        return _window_interp_cuda(name, grid, disps, K, compute_extrema, scale, mode, const, verdict)
    return _window_interp_plain(grid, disps, K, compute_extrema, scale, mode, const)


class _WindowInterp(torch.autograd.Function):
    """K6 / K7 with their backward: K6ᵀ / K7ᵀ on CUDA, the twin's VJP on
    the CPU. Saves the inputs and, on CUDA, the forward's verdict on the grid
    (one int: whether it held a NaN or an infinity), so that the backward
    does not test the grid again; the backward recomputes the taps. The
    saved grid is the one the forward read (autograd's version counter
    refuses a backward after it changed in place)."""

    @staticmethod
    def forward(ctx, args, grid, *disps):
        ctx.args = args
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(grid, *disps)
        # written by the forward's fix kernel, so nothing is filled
        ctx.verdict = torch.empty(1, dtype=torch.int32, device=grid.device) if grid.is_cuda else None
        return _forward(grid.detach(), [dd.detach() for dd in disps], *args, verdict=ctx.verdict)

    @staticmethod
    def backward(ctx, *grads):
        grid, *disps = ctx.saved_tensors
        name, K, compute_extrema, scale, mode, const = ctx.args
        need_grid, need_disp = ctx.needs_input_grad[1], any(ctx.needs_input_grad[2:])
        if grid.is_cuda:
            d_grid, d_disps = _window_interp_grad_cuda(name, grid, disps, K, compute_extrema, scale, mode, const,
                                                       grads, need_grid, need_disp, verdict=ctx.verdict)
        else:
            d_grid, d_disps = _window_interp_vjp_plain(grid, disps, K, compute_extrema, scale, mode, const,
                                                       grads, need_grid, need_disp)
        return (None, d_grid, *d_disps)


# ---------------------------------------------------------------------------
# plain PyTorch twin (CPU path; the kernels' oracle on the card)
# ---------------------------------------------------------------------------

def _pad(grid: torch.Tensor, K: int, mode: str, const: float, d: int) -> torch.Tensor:
    """The `d` trailing axes of `grid` padded by K cells on every side."""
    widths = (K, K) * d
    if mode == 'const':
        return F.pad(grid, widths, value=const)
    lead, spatial = grid.shape[:-d], grid.shape[-d:]
    padded = F.pad(grid.reshape((-1, 1) + tuple(spatial)), widths, mode=_PAD_MODE[mode])
    return padded.reshape(tuple(lead) + tuple(padded.shape[2:]))


def _window_interp_plain(grid, disps, K, compute_extrema, scale, mode, const):
    """The window sum over all (2K+1)^d taps, on any device. `scale` holds the
    sign; `mode` None takes `grid` as padded. Leading batch axes of the grid
    and the displacements broadcast."""
    d = len(disps)
    spatial = tuple(disps[0].shape[-d:])
    out_shape = tuple(torch.broadcast_shapes(grid.shape[:-d], disps[0].shape[:-d])) + spatial
    dtype = torch.float64 if grid.dtype == torch.float64 else torch.float32  # float64 only on the CPU
    padded = (grid if mode is None else _pad(grid, K, mode, const, d)).to(dtype)
    W = 2 * K + 1
    # JAX's AD conventions at the kinks (module docstring); the values are those of clamp / abs
    lo_k, hi_k, zero = (torch.full((), v, dtype=dtype, device=grid.device) for v in (-float(K), float(K), 0.0))
    delta = [torch.minimum(torch.maximum(scale[i] * disps[i].to(dtype), lo_k), hi_k) for i in range(d)]
    dist = [[_abs(delta[i] - float(s)) for s in range(-K, K + 1)] for i in range(d)]
    total = torch.zeros(out_shape, dtype=dtype, device=grid.device)
    if compute_extrema:
        big = torch.tensor(_BIG, dtype=dtype, device=grid.device)
        lo_acc = torch.full(out_shape, _BIG, dtype=dtype, device=grid.device)
        up_acc = torch.full(out_shape, -_BIG, dtype=dtype, device=grid.device)
    for k in range(W ** d):
        kk, w, cm, index = k, None, None, []
        for i in range(d):
            j = kk % W  # tap s = j − K along axis i, axis 0 fastest
            kk //= W
            index.append(slice(j, j + spatial[i]))
            wi = torch.maximum(zero, 1.0 - dist[i][j])  # hat function = linear-interpolation weight
            w = wi if w is None else w * wi
            if compute_extrema:
                ci = dist[i][j] < 1.0
                cm = ci if cm is None else cm & ci
        window = padded[(Ellipsis, *index)]
        total = total + window * w
        if compute_extrema:
            lo_acc = torch.minimum(lo_acc, torch.where(cm, window, big))
            up_acc = torch.maximum(up_acc, torch.where(cm, window, -big))
    return (total, lo_acc, up_acc) if compute_extrema else total


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with slope +1 at 0, as `jnp.abs` under `jax.grad`."""
    return torch.where(x >= 0, x, -x)


def _window_interp_vjp_plain(grid, disps, K, compute_extrema, scale, mode, const, grads, need_grid, need_disp):
    """The twin's VJP: (d_grid or None, [d_disp or None] * d) of the
    upstream `grads` (out[, lo, up]; None entries are zero), by autograd of
    `_window_interp_plain` recomputed; the oracle of K6ᵀ / K7ᵀ."""
    d = len(disps)
    # a NaN or an infinity in the grid: d_disp of the outputs whose window holds one is JAX's (_nonfinite_disp_grads),
    # computed per output, so the displacements are expanded to the outputs first
    nonfinite = need_disp and grads[0] is not None and not (
        bool(torch.isfinite(grid).all()) and (mode != 'const' or np.isfinite(const)))
    out_shape = tuple(torch.broadcast_shapes(grid.shape[:-d], disps[0].shape[:-d])) + tuple(disps[0].shape[-d:])
    with torch.enable_grad():
        g_in = grid.detach().requires_grad_(need_grid)
        d_in = [(dd.detach().expand(out_shape).contiguous() if nonfinite else dd.detach()).requires_grad_(need_disp)
                for dd in disps]
        outs = _window_interp_plain(g_in, d_in, K, compute_extrema, scale, mode, const)
        outs = outs if compute_extrema else (outs,)
        # lo / up NaN (a NaN corner with weight): JAX's min / max chain passes them no gradient at all, where
        # autograd's rule lets it through
        grads = [g if i == 0 or g is None else torch.where(torch.isnan(o), torch.zeros_like(g), g)
                 for i, (o, g) in enumerate(zip(outs, grads))]
        pairs = [(o, g.to(o.dtype)) for o, g in zip(outs, grads) if g is not None]
        inputs = [t for t in (g_in, *d_in) if t.requires_grad]
        if not pairs or not inputs:
            return None, [None] * d
        res = list(torch.autograd.grad([o for o, _ in pairs], inputs, [g for _, g in pairs], allow_unused=True))
    d_grid = res.pop(0) if need_grid else None
    d_disps = [res.pop(0) for _ in range(d)] if need_disp else [None] * d
    fill = lambda r, like: torch.zeros_like(like) if r is None else r.to(like.dtype)
    d_disps = [fill(r, dd) if need_disp else None for r, dd in zip(d_disps, d_in)]
    if need_disp and grads[0] is not None:
        d_disps = _nan_disp_grads(d_disps, d_in, scale)
    if nonfinite:
        d_disps = _nonfinite_disp_grads(d_disps, grid, d_in, K, scale, mode, const, grads[0])
        d_disps = [r.sum_to_size(dd.shape) for r, dd in zip(d_disps, disps)]
    return (fill(d_grid, grid) if need_grid else None), d_disps


def _nonfinite_disp_grads(d_disps, grid, disps, K, scale, mode, const, g):
    """JAX's d_disp at the outputs whose window holds a NaN or an infinity of
    the grid, where autograd's `maximum` rule drops the 0 · NaN of a tap of
    weight 0: AD of the window sum multiplies each tap's g · value by the
    other axes' tent weights and by the tent's slope (1, 1/2 at the kink, 0
    past it), signed by δ − s, and the sum by the clip's derivative and the
    scale, so 0 · inf and 0 · NaN are NaN. Per output (`disps` expanded to
    the outputs); other outputs keep `d_disps`."""
    d = len(disps)
    spatial = tuple(disps[0].shape[-d:])
    dtype = d_disps[0].dtype
    padded = (grid if mode is None else _pad(grid, K, mode, const, d)).to(dtype)
    kf = float(K)
    x = [scale[i] * dd.detach().to(dtype) for i, dd in enumerate(disps)]
    m = [torch.maximum(xi, torch.full_like(xi, -kf)) for xi in x]
    delta = [torch.minimum(mi, torch.full_like(mi, kf)) for mi in m]
    slope_max = lambda a, b: torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0)).to(dtype)
    dclip = [slope_max(torch.full_like(mi, kf), mi) * slope_max(xi, torch.full_like(xi, -kf)) for xi, mi in zip(x, m)]
    g = g.to(dtype)
    acc = [torch.zeros_like(xi) for xi in x]
    bad = torch.zeros(x[0].shape, dtype=torch.bool, device=x[0].device)
    W = 2 * K + 1
    for k in range(W ** d):
        kk, index, w, slope = k, [], [], []
        for i in range(d):
            j = kk % W
            kk //= W
            s = float(j - K)
            index.append(slice(j, j + spatial[i]))
            u = 1.0 - torch.abs(delta[i] - s)
            w.append(torch.maximum(torch.zeros_like(u), u))
            slope.append(slope_max(u, torch.zeros_like(u)) * torch.where(delta[i] - s >= 0, -1.0, 1.0).to(dtype))
        window = padded[(Ellipsis, *index)]
        bad = bad | ~torch.isfinite(window)
        gv = g * window
        for i in range(d):
            term = gv
            for f in range(d - 1, -1, -1):
                if f != i:
                    term = term * w[f]
            acc[i] = acc[i] + term * slope[i]
    return [torch.where(bad, a * c * scale[i], r) for i, (a, c, r) in enumerate(zip(acc, dclip, d_disps))]


def _nan_disp_grads(d_disps, disps, scale):
    """JAX's d_disp at an output with a NaN displacement, where autograd's
    `maximum` rule lets a slope through: NaN on an axis whose displacement
    is finite, 0 on a NaN axis unless another axis is NaN too (its weights
    are NaN and `jnp.clip`'s derivative 0 there)."""
    nan = [torch.isnan(s * x) for s, x in zip(scale, disps)]
    if not any(bool(m.any()) for m in nan):
        return d_disps
    out = []
    for e, g in enumerate(d_disps):
        others = functools.reduce(torch.logical_or, [m for i, m in enumerate(nan) if i != e])
        rule = torch.where(others, torch.full_like(g, float('nan')), torch.zeros_like(g))
        out.append(torch.where(others | nan[e], rule, g))
    return out


# ---------------------------------------------------------------------------
# K6 / K7 on CUDA
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _ctypes_args():
    import ctypes
    I, F_, P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

    class InterpArgs(ctypes.Structure):
        _fields_ = [('grid', _build.src_struct()), ('disp', P * 3), ('scale', F_ * 3),
                    ('out', P), ('out_lo', P), ('out_up', P), ('o', I * 3), ('K', I), ('extrema', I),
                    ('nb', I), ('grid_stride', ctypes.c_longlong), ('disp_stride', ctypes.c_longlong),
                    ('flag', P), ('verdict', P)]
    return InterpArgs


@functools.lru_cache(maxsize=1)
def _ctypes_grad_args():
    import ctypes
    I, F_, P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

    class InterpGradArgs(ctypes.Structure):
        _fields_ = [('grid', _build.src_struct()), ('disp', P * 3), ('scale', F_ * 3),
                    ('g_out', P), ('g_lo', P), ('g_up', P), ('d_grid', P), ('d_disp', P * 3),
                    ('o', I * 3), ('K', I), ('nb', I), ('grid_stride', ctypes.c_longlong),
                    ('disp_stride', ctypes.c_longlong), ('chunk', I), ('ring', I), ('flag', P), ('verdict', P)]
    return InterpGradArgs


def _lib():
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    return _build.library('interp', {'window_interp': [P, I, I, P], 'window_interp_grad': [P, I, I, P]})


def vector_route(out_shape: Sequence[int], arrays) -> bool:
    """Whether the kernel reads the displacements and writes its results as
    float4: every row (the last axis) holds a multiple of 4 outputs and every
    displacement and output array starts on a 16-byte boundary. Otherwise
    it loads and stores one value at a time and masks a row's ragged tail."""
    return out_shape[-1] % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in arrays)


# K6ᵀ / K7ᵀ's slot window (`csrc/interp.cu`: wg_rows, wg_cols, wg_threads): in 3D a tile of 32 columns (16 for
# K > 5) with its K-wide halo by as many rows as 512 threads hold, in 2D one row of 256; a thread a slot


def _grad_window(dims: int, K: int):
    """(rows, columns, threads) of K6ᵀ / K7ᵀ's slot window."""
    if dims == 2:
        return 1, 256, 256
    cols = (32 if K <= 5 else 16) + 2 * K
    return 512 // cols, cols, 512


def tiled_route(dims: int, K: int) -> bool:
    """Whether K6ᵀ / K7ᵀ's d_grid takes the slot window (`csrc/interp.cu`
    tiled_route): its window holds K on both in-plane axes and its byte-packed
    offsets K ≤ 32 (3D K ≤ 7, 2D K ≤ 32). Past it, the wide kernel: a thread a
    cell, reading the outputs within K of it from global memory."""
    rows, cols, _ = _grad_window(dims, K)
    return 1 <= K <= 32 and 2 * K < cols and (dims == 2 or 2 * K < rows)


_GRAD_CHUNKS = (1, 2, 4, 8, 16, 32, 64, 128)
_GRAD_BLOCKS_PER_SM = 2  # the slot kernel's launch bounds: two blocks of 512 threads an SM (64 registers)
_WIDE_TILE = (8, 32)     # the wide kernel's block: 8 rows of 32 cells (`csrc/interp.cu` WW_TY, WW_TX)


@functools.lru_cache(maxsize=16)
def sm_budget(index: int):
    """(SMs, shared-memory bytes an SM) of CUDA device `index`, which K6ᵀ /
    K7ᵀ's plan fills; a PyTorch without the latter property gives Hopper's
    228 KB."""
    p = torch.cuda.get_device_properties(index)
    return p.multi_processor_count, int(getattr(p, 'shared_memory_per_multiprocessor', 233472))


@functools.lru_cache(maxsize=256)
def grad_plan(dims: int, K: int, shape: Sequence[int], nb: int = 1, shared_grid: bool = False, *,
              sms: int, smem_per_sm: int) -> dict:
    """K6ᵀ / K7ᵀ's d_grid launch for `nb` entries of a raw grid of `shape`
    (its `dims` trailing axes; a padded grid's padded shape) and window K;
    `shared_grid`: one grid for every entry, whose blocks walk the entries;
    `sms`, `smem_per_sm`: the card's (`sm_budget`). The C entry derives the
    same ring and grid from K, the shape and the chunk; the chunk is the
    plan's one choice, and the rest describes the kernel's layout.

    ``route`` 'tiled' (`tiled_route`): a thread computes one slot of a
    plane's window (``window``: rows × columns; ``threads`` a block, those
    past the window idle) and owns the cell at its position unless it lies
    in the window's K-wide halo: a block owns ``tile`` cells in-plane (the
    window less 2K an axis: 32 columns in 3D, 16 past K = 5) over ``chunk``
    planes of axis 0. ``ring`` slot planes stay in shared memory: 2K + 2
    (each computed once) where they fit in `_build.SMEM_LIMIT`, else 1 (each
    recomputed for every plane it serves). ``smem``: their bytes, a slot 4
    bytes of floors, 4 of its corner offset and 4 a corner. The chunk
    minimises the estimated plane steps in series, as
    `poisson._march_plan`'s does. ``grid``: (column tiles, row tiles (1 in
    2D), chunks × entries (× 1 for a shared grid)).

    ``route`` 'wide': a thread a cell, a block ``tile`` cells (8 rows of 32)
    of one plane; ``grid``: (column tiles, row tiles, planes (1 in 2D) ×
    entries (× 1 for a shared grid)); no shared memory.

    Cached; the returned dict is shared, not to be modified."""
    if K < 1:
        raise ValueError(f"window_interp_{dims}d's backward takes K >= 1, got K={K}")
    shape = tuple(int(n) for n in shape)
    entries = 1 if shared_grid else nb
    if not tiled_route(dims, K):
        ty, tx = _WIDE_TILE
        grid = (-(-shape[-1] // tx), -(-shape[-2] // ty), entries * (shape[0] if dims == 3 else 1))
        if grid[1] > 65535 or grid[2] > 65535:
            raise ValueError(f"window_interp_{dims}d's backward: a grid {grid} past the launch limit of 65535")
        return dict(route='wide', window=None, tile=_WIDE_TILE, chunk=1, ring=0, smem=0, threads=ty * tx,
                    grid=grid, blocks=grid[0] * grid[1] * grid[2])
    sy, sz, threads = _grad_window(dims, K)
    plane = threads * 4 * (2 + 2 ** dims)
    ring = 2 * K + 2 if (2 * K + 2) * plane <= _build.SMEM_LIMIT else 1
    smem = ring * plane
    tile = ((sy - 2 * K,) if dims == 3 else ()) + (sz - 2 * K,)
    gx = -(-shape[-1] // tile[-1])
    gy = -(-shape[1] // tile[0]) if dims == 3 else 1
    walks = nb if shared_grid else 1  # entries a block walks
    per_sm = max(1, min(smem_per_sm // (smem + 1024), _GRAD_BLOCKS_PER_SM))  # 1 KB reserved a block

    def cost(c):
        steps = c + 2 * K if ring > 1 else c * (2 * K + 1)
        return -(-gx * gy * entries * -(-shape[0] // c) // (sms * per_sm)) * steps * walks
    chunk = min((c for c in _GRAD_CHUNKS if c <= max(shape[0], 1)), key=cost)
    grid = (gx, gy, entries * -(-shape[0] // chunk))
    if grid[1] > 65535 or grid[2] > 65535:
        raise ValueError(f"window_interp_{dims}d's backward: a grid {grid} past the launch limit of 65535")
    return dict(route='tiled', window=(sy, sz), tile=tile, chunk=chunk, ring=ring, smem=smem, threads=threads,
                grid=grid, blocks=grid[0] * grid[1] * grid[2])


def _check_f32(name, t):
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous float32 CUDA tensor, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ', not contiguous'}")


def _check_inputs(grid, disps):
    _check_f32('grid', grid)
    for i, dd in enumerate(disps):
        _check_f32(f'disp[{i}]', dd)
        if dd.device != grid.device:
            raise ValueError(f"disp[{i}] is on {dd.device}, the grid on {grid.device}")


def _batch(grid, disps, d):
    """The batch of a call: (lead, nb, grid, grid's entry stride, displacements, their entry stride). An input
    with one entry is shared (stride 0) and read in place; one whose batch axes are neither one entry nor the
    whole batch is expanded to the batch."""
    lead = tuple(torch.broadcast_shapes(grid.shape[:-d], disps[0].shape[:-d]))
    nb = int(np.prod(lead, dtype=np.int64))

    def strided(t):
        own = tuple(t.shape[:-d])
        if int(np.prod(own, dtype=np.int64)) == 1:
            return t.reshape(t.shape[-d:]), 0
        if own != lead:
            t = t.expand(lead + tuple(t.shape[-d:])).contiguous()
        return t, int(np.prod(t.shape[-d:], dtype=np.int64))
    grid, g_stride = strided(grid)
    strided_disps = [strided(dd) for dd in disps]
    return lead, nb, grid, g_stride, [t for t, _ in strided_disps], strided_disps[0][1]


def _fill_src(src, grid, K, mode, const, d):
    """`Src` of the grid's `d` trailing axes (one entry's shape; the kernel adds the entry's offset)."""
    for ax in range(d):
        src.n[ax] = grid.shape[grid.ndim - d + ax]
        # a padded array holds logical index l at raw index l + K; its edge
        # mode only resolves the zero-weight upper tap of δ = +K
        src.shift[ax] = -K if mode is None else 0
    src.p = grid.data_ptr()
    src.mode = _build.SRC_MODE['edge' if mode is None else mode]
    src.c = const


def _window_interp_cuda(name, grid, disps, K, compute_extrema, scale, mode, const, verdict=None):
    """K6 / K7. `verdict`: None, or a one-int CUDA tensor into which the
    call's fix kernel writes whether the grid held a NaN or an infinity (1)
    or not (0), for the backward of the same grid (`_WindowInterp`)."""
    import ctypes
    d = len(disps)
    _check_inputs(grid, disps)
    lib = _lib()
    lead, nb, grid, g_stride, disps, d_stride = _batch(grid, disps, d)
    spatial = tuple(disps[0].shape[-d:])
    planes = [torch.empty(lead + spatial, dtype=torch.float32, device=grid.device)
              for _ in range(3 if compute_extrema else 1)]
    a = _ctypes_args()()
    for ax in range(d):
        a.disp[ax] = disps[ax].data_ptr()
        a.scale[ax] = scale[ax]
        a.o[ax] = spatial[ax]
    a.nb, a.grid_stride, a.disp_stride = nb, g_stride, d_stride
    _fill_src(a.grid, grid, K, mode, const, d)
    a.out = planes[0].data_ptr()
    if compute_extrema:
        a.out_lo, a.out_up = planes[1].data_ptr(), planes[2].data_ptr()
        a.extrema = 1
    a.K = K
    a.flag = _build.nonfinite_flag(grid)
    a.verdict = None if verdict is None else verdict.data_ptr()
    err = lib.window_interp(ctypes.byref(a), d, int(vector_route(spatial, (*disps, *planes))),
                            _build.stream_of(grid))
    _build.check(lib, err, name)
    _build.LAUNCHES[name] += 1
    return tuple(planes) if compute_extrema else planes[0]


def _window_interp_grad_cuda(name, grid, disps, K, compute_extrema, scale, mode, const, grads, need_grid,
                             need_disp, verdict=None):
    """K6ᵀ / K7ᵀ: (d_grid or None, [d_disp or None] * d) of the upstream
    `grads` (out[, lo, up]; None entries are zero) in one call for the batch
    (d_disp's kernel and d_grid's, planned by `grad_plan`; one launch counted).
    The grid's gradient has its raw shape (of one entry where it is shared:
    the entries summed in order) and is gathered, each cell written once by
    the thread that owns it, in a fixed order: no atomics and no zero fill,
    the same gradients from launch to launch, for every K the forward takes.
    The displacements' are written per entry and summed over the batch where
    they are shared. Empty outputs launch nothing: the gradients are zeros.
    `verdict`: the word the forward of this grid wrote (`_window_interp_cuda`),
    which d_disp then takes in place of testing the grid's cells itself; None
    (a call without that forward) tests them."""
    import ctypes
    d = len(disps)
    _check_inputs(grid, disps)
    lib = _lib()
    grid_in, disps_in = grid, disps
    lead, nb, grid, g_stride, disps, d_stride = _batch(grid, disps, d)
    spatial = tuple(disps[0].shape[-d:])
    out_shape = lead + spatial
    ups = [None if g is None else g.to(torch.float32).contiguous() for g in grads]
    ups += [None] * (3 - len(ups))
    for g in ups:
        if g is not None and (tuple(g.shape) != out_shape or g.device != grid.device):
            raise ValueError(f"{name}: an upstream gradient of shape {tuple(g.shape)} on {g.device}, "
                             f"outputs {out_shape} on {grid.device}")
    if not np.prod(out_shape, dtype=np.int64):  # no output: no tap, nothing launched
        return ((torch.zeros_like(grid_in) if need_grid else None),
                [torch.zeros_like(dd) if need_disp else None for dd in disps_in])
    d_grid = torch.empty_like(grid) if need_grid else None  # every cell written once
    d_disps = [torch.empty(out_shape, dtype=torch.float32, device=grid.device) if need_disp else None
               for _ in disps]
    a = _ctypes_grad_args()()
    _fill_src(a.grid, grid, K, mode, const, d)
    a.nb, a.grid_stride, a.disp_stride = nb, g_stride, d_stride
    for ax in range(d):
        a.disp[ax] = disps[ax].data_ptr()
        a.scale[ax] = scale[ax]
        a.o[ax] = spatial[ax]
        a.d_disp[ax] = d_disps[ax].data_ptr() if need_disp else None
    a.g_out, a.g_lo, a.g_up = (None if g is None else g.data_ptr() for g in ups)
    a.d_grid = d_grid.data_ptr() if need_grid else None
    a.K = K
    a.flag = _build.nonfinite_flag(grid)
    a.verdict = None if verdict is None else verdict.data_ptr()
    if need_grid:
        a.chunk = grad_plan(d, K, tuple(grid.shape[-d:]), nb, g_stride == 0,
                            **dict(zip(('sms', 'smem_per_sm'), sm_budget(grid.device.index))))['chunk']
    err = lib.window_interp_grad(ctypes.byref(a), d, int(compute_extrema), _build.stream_of(grid))
    _build.check(lib, err, name + '_grad')
    _build.LAUNCHES[name + '_grad'] += 1
    if d_grid is not None:
        d_grid = d_grid.reshape(grid_in.shape) if g_stride == 0 else d_grid.sum_to_size(grid_in.shape)
    if need_disp:
        d_disps = [g.sum_to_size(dd.shape) for g, dd in zip(d_disps, disps_in)]
    return d_grid, d_disps

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

The grid comes either padded, K halo cells on every side (the TPU kernels'
input), or raw with its halo described: ``const_pad=c`` (a constant, as the
TPU 3D kernel takes it) or ``halo='edge'`` / ``'wrap'`` (zero gradient /
periodic), which the kernel resolves by index without a padding pass.

No gradient is defined, as for the TPU kernels.
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
    arrays. ``negate`` flips the displacement sign, ``disp_scale`` converts the
    displacement to cells per axis. Returns out, or (out, lo, up) with
    ``compute_extrema``; all (X, Y, Z) float32."""
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
    out_shape = tuple(disps[0].shape)
    if grid.ndim != d or len(out_shape) != d:
        raise NotImplementedError(
            f"{name} takes one {d}D grid, got shapes {tuple(grid.shape)} / {out_shape}; leading batch "
            f"axes come with the batched-smoke slice of the port")
    if any(tuple(dd.shape) != out_shape for dd in disps):
        raise ValueError(f"displacement shapes differ: {[tuple(dd.shape) for dd in disps]}")
    expected = out_shape if mode is not None else tuple(n + 2 * K for n in out_shape)
    if tuple(grid.shape) != expected:
        raise ValueError(f"grid shape {tuple(grid.shape)} != {expected} for displacements {out_shape}, K={K}"
                         f"{'' if mode is not None else ' (padded)'}")
    if mode == 'wrap' and min(out_shape) < K:
        raise ValueError(f"a wrapped grid needs at least K={K} cells per axis, got {out_shape}")
    sgn = -1.0 if negate else 1.0
    scale = tuple(_f32(sgn * float(s)) for s in (disp_scale or (1.0,) * d))
    if len(scale) != d:
        raise ValueError(f"disp_scale needs {d} entries, got {disp_scale}")
    const = 0.0 if const_pad is None else _f32(const_pad)
    if grid.is_cuda:
        return _window_interp_cuda(name, grid, disps, K, compute_extrema, scale, mode, const)
    return _window_interp_plain(grid, disps, K, compute_extrema, scale, mode, const)


# ---------------------------------------------------------------------------
# plain PyTorch twin (CPU path; the kernels' oracle on the card)
# ---------------------------------------------------------------------------

def _pad(grid: torch.Tensor, K: int, mode: str, const: float) -> torch.Tensor:
    widths = (K, K) * grid.ndim
    if mode == 'const':
        return F.pad(grid, widths, value=const)
    return F.pad(grid[None, None], widths, mode=_PAD_MODE[mode])[0, 0]


def _window_interp_plain(grid, disps, K, compute_extrema, scale, mode, const):
    """The window sum over all (2K+1)^d taps, on any device. `scale` holds the
    sign; `mode` None takes `grid` as padded."""
    d = len(disps)
    out_shape = tuple(disps[0].shape)
    dtype = torch.float64 if grid.dtype == torch.float64 else torch.float32  # float64 only on the CPU
    padded = (grid if mode is None else _pad(grid, K, mode, const)).to(dtype)
    W = 2 * K + 1
    delta = [torch.clamp(scale[i] * disps[i].to(dtype), -float(K), float(K)) for i in range(d)]
    dist = [[torch.abs(delta[i] - float(s)) for s in range(-K, K + 1)] for i in range(d)]
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
            index.append(slice(j, j + out_shape[i]))
            wi = torch.clamp(1.0 - dist[i][j], min=0.0)  # hat function = linear-interpolation weight
            w = wi if w is None else w * wi
            if compute_extrema:
                ci = dist[i][j] < 1.0
                cm = ci if cm is None else cm & ci
        window = padded[tuple(index)]
        total = total + window * w
        if compute_extrema:
            lo_acc = torch.minimum(lo_acc, torch.where(cm, window, big))
            up_acc = torch.maximum(up_acc, torch.where(cm, window, -big))
    return (total, lo_acc, up_acc) if compute_extrema else total


# ---------------------------------------------------------------------------
# K6 / K7 on CUDA
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _ctypes_args():
    import ctypes
    I, F_, P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p

    class InterpArgs(ctypes.Structure):
        _fields_ = [('grid', _build.src_struct()), ('disp', P * 3), ('scale', F_ * 3),
                    ('out', P), ('out_lo', P), ('out_up', P), ('o', I * 3), ('K', I), ('extrema', I)]
    return InterpArgs


def _lib():
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    return _build.library('interp', {'window_interp': [P, I, I, P]})


def vector_route(out_shape: Sequence[int], arrays) -> bool:
    """Whether the kernel reads the displacements and writes its results as
    float4: every row (the last axis) holds a multiple of 4 outputs and every
    displacement and output array starts on a 16-byte boundary. Otherwise
    it loads and stores one value at a time and masks a row's ragged tail."""
    return out_shape[-1] % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in arrays)


def _check_f32(name, t):
    if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous float32 CUDA tensor, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}"
                         f"{'' if t.is_contiguous() else ', not contiguous'}")


def _window_interp_cuda(name, grid, disps, K, compute_extrema, scale, mode, const):
    import ctypes
    d = len(disps)
    _check_f32('grid', grid)
    for i, dd in enumerate(disps):
        _check_f32(f'disp[{i}]', dd)
        if dd.device != grid.device:
            raise ValueError(f"disp[{i}] is on {dd.device}, the grid on {grid.device}")
    lib = _lib()
    out_shape = tuple(disps[0].shape)
    planes = [torch.empty(out_shape, dtype=torch.float32, device=grid.device)
              for _ in range(3 if compute_extrema else 1)]
    a = _ctypes_args()()
    a.grid.p = grid.data_ptr()
    for ax in range(d):
        a.grid.n[ax] = grid.shape[ax]
        # a padded array holds logical index l at raw index l + K; its edge
        # mode only resolves the zero-weight upper tap of δ = +K
        a.grid.shift[ax] = -K if mode is None else 0
        a.disp[ax] = disps[ax].data_ptr()
        a.scale[ax] = scale[ax]
        a.o[ax] = out_shape[ax]
    a.grid.mode = _build.SRC_MODE['edge' if mode is None else mode]
    a.grid.c = const
    a.out = planes[0].data_ptr()
    if compute_extrema:
        a.out_lo, a.out_up = planes[1].data_ptr(), planes[2].data_ptr()
        a.extrema = 1
    a.K = K
    err = lib.window_interp(ctypes.byref(a), d, int(vector_route(out_shape, (*disps, *planes))),
                            _build.stream_of(grid))
    _build.check(lib, err, name)
    _build.LAUNCHES[name] += 1
    return tuple(planes) if compute_extrema else planes[0]

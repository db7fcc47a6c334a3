"""Particle→grid (P2G) mean scatter — port of `phiflow_tpu/ops/p2g.py`, the
FLIP step's transfer of particle values to the grid.

    cell(p)   = floor((pos[p] − lower) · inv_dx)      per axis, in float32
    mean[c]   = Σ_{p in c} values[p] / #{p in c},     `base` where no particle lies

A particle outside the grid is dropped (``clamp=False``) or kept at the border
cell (``clamp=True``). Sums and counts come from one pass: on the card the CUDA
kernel K8 (`csrc/p2g.cu`, one thread per particle, two atomic adds), on the CPU
the plain twin `_p2g_plain` (`index_add_` on the flat grid, `_p2g_xla` of the
JAX package). The mean and `base` are formed from them with PyTorch operations,
as the JAX package forms them outside its kernel.

The TPU kernel's limits (the one-hot plane must fit VMEM; at least 4096
particles) are TPU layout and have no counterpart: on CUDA every call launches
the kernel, whatever the grid or the particle count. The kernel is 3D, as the
TPU kernel is; with two spatial axes the wrapper computes with the twin on
whatever device the tensors lie (the JAX package scatters 2D through XLA).

Sums on the card are atomic adds, so their order changes from run to run: two
runs agree to float32 roundoff of a cell's addends, not bit for bit. Counts
are exact. Positions are taken to be finite; a NaN position goes to cell 0 and
counts as outside. A dropped particle contributes nothing, whatever its value.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = ['p2g_mean', 'p2g_mean_3d', 'p2g_sums_counts']


def _cell_ids(pos: torch.Tensor, res, lower, inv_dx, clamp: bool):
    """(flat row-major cell id, validity) per particle. The expression and its
    float32 roundings are those of the JAX package's `_cell_ids`."""
    ids = None
    valid = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    for a, r in enumerate(res):
        c = torch.floor((pos[:, a] - float(np.float32(lower[a]))) * float(np.float32(inv_dx[a])))
        if not clamp:
            valid = valid & (c >= 0) & (c < r)
        c = torch.clamp(torch.nan_to_num(c, nan=0.0), 0, r - 1).to(torch.int64)
        ids = c if ids is None else ids * int(r) + c
    return ids, valid


def _p2g_plain(pos, values, res, lower, inv_dx, clamp):
    """The plain twin: scatter-add on the flat grid. Returns (sums, counts)."""
    ids, valid = _cell_ids(pos, res, lower, inv_dx, clamp)
    n = int(np.prod(res))
    sums = torch.zeros(n, dtype=torch.float32, device=pos.device)
    counts = torch.zeros(n, dtype=torch.float32, device=pos.device)
    sums.index_add_(0, ids, torch.where(valid, values, torch.zeros_like(values)))
    counts.index_add_(0, ids, valid.to(torch.float32))
    return sums.reshape(tuple(res)), counts.reshape(tuple(res))


@functools.lru_cache(maxsize=1)
def _ctypes_grid():
    import ctypes

    class P2GGrid(ctypes.Structure):
        _fields_ = [('n', ctypes.c_int * 3), ('lower', ctypes.c_float * 3), ('inv_dx', ctypes.c_float * 3)]
    return P2GGrid


def _lib():
    import ctypes
    P = ctypes.c_void_p
    return _build.library('p2g', {'p2g_scatter': [P, P, P, P, ctypes.c_longlong, P, ctypes.c_int, P]})


def _p2g_cuda(pos, values, res, lower, inv_dx, clamp):
    import ctypes
    lib = _lib()
    g = _ctypes_grid()()
    for a in range(3):
        g.n[a] = int(res[a])
        g.lower[a] = float(np.float32(lower[a]))
        g.inv_dx[a] = float(np.float32(inv_dx[a]))
    out = torch.zeros((2,) + tuple(int(r) for r in res), dtype=torch.float32, device=pos.device)
    sums, counts = out[0], out[1]
    err = lib.p2g_scatter(pos.data_ptr(), values.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                          pos.shape[0], ctypes.byref(g), int(bool(clamp)), _build.stream_of(pos))
    _build.check(lib, err, 'p2g_scatter')
    _build.LAUNCHES['p2g'] += 1
    return sums, counts


def p2g_sums_counts(pos: torch.Tensor, values: torch.Tensor, res: Sequence[int], lower: Sequence[float],
                    inv_dx: Sequence[float], clamp: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per cell the sum of `values` and the number of particles, both float32
    of shape `res`. pos: (N, d) float32, values: (N,) float32, d = len(res)."""
    d = len(res)
    if pos.ndim != 2 or pos.shape[1] != d or values.shape != pos.shape[:1]:
        raise ValueError(f"expected pos (N, {d}) and values (N,), got {tuple(pos.shape)} and {tuple(values.shape)}")
    if len(lower) != d or len(inv_dx) != d:
        raise ValueError(f"lower and inv_dx need {d} entries each")
    if pos.dtype != torch.float32 or values.dtype != torch.float32:
        raise TypeError(f"pos and values must be float32, got {pos.dtype} and {values.dtype}")
    if values.device != pos.device:
        raise ValueError(f"pos on {pos.device}, values on {values.device}")
    if pos.is_cuda and d == 3:
        if int(np.prod(res)) >= 2 ** 31:
            raise ValueError(f"grid {tuple(res)} has too many cells for the kernel")
        return _p2g_cuda(pos.detach().contiguous(), values.detach().contiguous(), res, lower, inv_dx, clamp)
    return _p2g_plain(pos.detach(), values.detach(), res, lower, inv_dx, clamp)


class _P2GMean(torch.autograd.Function):
    """The mean scatter with the gradient of the JAX package's `_p2g_bwd`:
    d mean_c / d values_p = 1 / count_c for p in c; positions select cells and
    get no gradient."""

    @staticmethod
    def forward(ctx, pos, values, res, lower, inv_dx, clamp, base):
        sums, counts = p2g_sums_counts(pos, values, res, lower, inv_dx, clamp)
        ctx.save_for_backward(pos, counts)
        ctx.geometry = (res, lower, inv_dx, clamp)
        return _mean_or_base(sums, counts, base)

    @staticmethod
    def backward(ctx, g):
        pos, counts = ctx.saved_tensors
        res, lower, inv_dx, clamp = ctx.geometry
        ids, valid = _cell_ids(pos, res, lower, inv_dx, clamp)
        g_over_n = torch.where(counts > 0, g / torch.clamp(counts, min=1.0), torch.zeros_like(g)).reshape(-1)
        grad_values = g_over_n[ids] * valid.to(g.dtype)
        return None, grad_values, None, None, None, None, None


def _mean_or_base(sums, counts, base):
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                       torch.full_like(sums, float(base)))


def p2g_mean(pos: torch.Tensor, values: torch.Tensor, res: Sequence[int], lower: Sequence[float],
             inv_dx: Sequence[float], clamp: bool, base: float) -> torch.Tensor:
    """Mean of `values` per nearest grid cell; cells without a particle get
    `base` (NaN for a FLIP velocity). pos: (N, d) float32 positions, values:
    (N,) float32; res / lower / inv_dx: the grid (cell = floor((p − lower) ·
    inv_dx)); clamp: keep particles outside the grid at the border cell
    instead of dropping them. Differentiable in `values`."""
    res = tuple(int(r) for r in res)
    lower = tuple(float(x) for x in lower)
    inv_dx = tuple(float(x) for x in inv_dx)
    return _P2GMean.apply(pos, values, res, lower, inv_dx, bool(clamp), float(base))


def p2g_mean_3d(pos, values, res: Tuple[int, int, int], lower: Tuple[float, float, float],
                inv_dx: Tuple[float, float, float], clamp: bool, base: float) -> torch.Tensor:
    """`p2g_mean` for a 3D grid — the entry of the JAX package."""
    if len(res) != 3:
        raise ValueError(f"p2g_mean_3d takes a 3D grid, got res={tuple(res)}")
    return p2g_mean(pos, values, res, lower, inv_dx, clamp, base)

"""Multigrid transfer operators — port of `phiflow_tpu/ops/transfer.py`.

* `restrict_mean` — 2× mean pooling (`avg_pool`; `lax.reduce_window` in JAX,
  not a Pallas kernel there either). Exactly R = (1/2^d)·Pᵀ of the
  piecewise-constant prolongation P, which keeps the V-cycle symmetric.
* `prolong_add` / `prolong_pc` — u + nearest-2×-upsample(c), or the upsample
  alone: K4, `csrc/transfer.cu`, on CUDA; `_prolong_plain` (JAX's
  `_prolong_xla`) on the CPU. Arithmetic is float32, stored in u's dtype.
  The kernel is 3D, as the TPU kernel is; with ``ndim=2`` the wrappers
  compute with `_prolong_plain` on any device, as the JAX package computes
  through XLA there. That choice is made on `ndim` alone. Leading batch
  axes are independent fields: on CUDA one launch covers them all. K4 has no
  backward: on CUDA the wrapper raises when grad mode is on and an input
  requires grad (`_build.refuse_grad`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

__all__ = ['restrict_mean', 'prolong_pc', 'prolong_add']

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def restrict_mean(r: torch.Tensor, ndim: int) -> torch.Tensor:
    """Mean-pool the trailing `ndim` spatial axes by 2×. r: (*lead, *spatial)."""
    spatial = r.shape[r.ndim - ndim:]
    pooled = _POOL[ndim](r.reshape((-1, 1) + tuple(spatial)), 2)
    return pooled.reshape(r.shape[:r.ndim - ndim] + pooled.shape[2:])


def _prolong_plain(c: torch.Tensor, ndim: int) -> torch.Tensor:
    for ax in range(c.ndim - ndim, c.ndim):
        c = torch.repeat_interleave(c, 2, dim=ax)
    return c


def _lib():
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    return _build.library('transfer', {'prolong_add': [P, P, P, I, I, I, I, I, P]})


def _prolong_cuda(c: torch.Tensor, u: Optional[torch.Tensor]) -> torch.Tensor:
    _build.refuse_grad('prolong_add', c, u)
    if not c.is_cuda or c.dtype not in _DTYPE_CODE or c.ndim < 3 or not c.is_contiguous():
        raise ValueError(f"prolong kernel takes a contiguous 3D float32/bfloat16 CUDA field (leading batch axes "
                         f"allowed), got {c.dtype} {tuple(c.shape)} on {c.device}")
    lead = tuple(c.shape[:-3])
    fine = lead + tuple(2 * n for n in c.shape[-3:])
    if u is not None:
        if not u.is_cuda or u.dtype != c.dtype or tuple(u.shape) != fine or not u.is_contiguous():
            raise ValueError(f"u must be a contiguous CUDA {c.dtype} tensor of shape {fine}, got "
                             f"{u.dtype} {tuple(u.shape)} on {u.device}")
    lib = _lib()
    out = torch.empty(fine, dtype=c.dtype, device=c.device)
    nb = 1
    for n in lead:
        nb *= n
    err = lib.prolong_add(c.data_ptr(), None if u is None else u.data_ptr(), out.data_ptr(),
                          _DTYPE_CODE[c.dtype], nb, *fine[-3:], _build.stream_of(c))
    _build.check(lib, err, 'prolong_add')
    _build.LAUNCHES['prolong_add'] += 1
    return out


def prolong_pc(c: torch.Tensor, ndim: int = 3) -> torch.Tensor:
    """Piecewise-constant 2× upsample of the trailing `ndim` spatial axes."""
    if ndim == 2:
        return _prolong_plain(c, ndim)
    if c.is_cuda:
        if ndim != 3:
            raise NotImplementedError("the CUDA prolongation is 3D")
        return _prolong_cuda(c, None)
    return _prolong_plain(c, ndim)


def prolong_add(c: torch.Tensor, u: torch.Tensor, ndim: int = 3) -> torch.Tensor:
    """u + piecewise-constant-upsample(c), in u's dtype (float32 arithmetic)."""
    if ndim == 2:
        return _prolong_add_plain(c, u, ndim)
    if u.is_cuda:
        if ndim != 3:
            raise NotImplementedError("the CUDA prolongation is 3D")
        return _prolong_cuda(c, u)
    return _prolong_add_plain(c, u, ndim)


def _prolong_add_plain(c: torch.Tensor, u: Optional[torch.Tensor], ndim: int = 3) -> torch.Tensor:
    """`prolong_add` (or `prolong_pc` when u is None) through the twin, on any device."""
    if u is None:
        return _prolong_plain(c, ndim)
    return (u.float() + _prolong_plain(c, ndim).float()).to(u.dtype)

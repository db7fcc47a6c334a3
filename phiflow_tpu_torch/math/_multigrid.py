"""Geometric multigrid V-cycle for uniform-grid Poisson systems — port of
`phiflow_tpu/math/_multigrid.py::make_poisson_vcycle`, the CG preconditioner
of the pressure solve.

Damped-Jacobi pre/post smoothing with equal sweep counts (K2), the fused
residual + mean-pool restriction (K3), the piecewise-constant prolongation
+ add (K4) and an exact coarse solve through a host-built pseudo-inverse make
the V-cycle operator symmetric, as CG needs. Boundary modes are the
{periodic, neumann, ghost0} of the CG matvec. A batch of right-hand sides
(leading axes) runs through one V-cycle: each kernel launches once for the
batch. The coarse solve (the JAX package's one `einsum('ij,bj->bi')`) is one
product an entry (`per_entry`), so that an entry gets its own V-cycle's
result bit for bit (a product of the batch at once rounds differently).
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

from ..ops.poisson import _unmasked_coeffs_1d, per_entry, poisson_smooth, residual_restrict
from ..ops.transfer import prolong_add

__all__ = ['make_poisson_vcycle']


@functools.lru_cache(maxsize=32)
def _coarse_pinv(res: Tuple[int, ...], inv_dx2, bcs) -> np.ndarray:
    """Exact coarse solve: the coarse Laplacian assembled on the host from the
    per-axis profiles of the stencil (Kronecker sum) and pseudo-inverted (pinv
    handles the singular Neumann/periodic nullspace)."""
    mats = []
    for n_d, (lo, hi), inv in zip(res, bcs, inv_dx2):
        am, ap, c0 = _unmasked_coeffs_1d(n_d, lo, hi, np.float64)
        T = np.zeros((n_d, n_d), np.float64)
        idx = np.arange(n_d)
        T[idx, idx] = c0
        # += matches roll semantics when (i±1) wraps onto the same column
        np.add.at(T, (idx, (idx - 1) % n_d), am)
        np.add.at(T, (idx, (idx + 1) % n_d), ap)
        mats.append(T * float(inv))
    A = None
    for d, T in enumerate(mats):
        term = np.array([[1.0]])
        for k in range(len(mats)):
            term = np.kron(term, T if k == d else np.eye(res[k]))
        A = term if A is None else A + term
    return np.linalg.pinv(A, rcond=1e-5).astype(np.float32)


def make_poisson_vcycle(resolution: Tuple[int, ...], dx: Tuple[float, ...], bcs,
                        device: torch.device, nu: int = 3, omega: float = 0.9,
                        min_size: int = 4, max_direct: int = 512,
                        dtype='auto') -> Callable:
    """Build ``vcycle(b, emit_dot=False) -> (u, dot)`` with u ≈ A⁻¹ b for the
    Poisson operator on a uniform cell-centred 2D or 3D grid; b, u: (X, Y[, Z])
    or (*batch, X, Y[, Z]), each entry its own system (``dot`` one per entry).
    A 3D grid on CUDA goes through K2–K4, a 2D grid through the same wrappers'
    PyTorch route.

    ``dot`` is ⟨u, b⟩ from the last fine post-smooth (K2's ``emit_dot``) when
    ``emit_dot`` is set, else None — the finest level's dot only.

    dtype: storage of the level arrays. 'auto' → bfloat16 on CUDA for 3D grids
    with max(resolution) ≥ 64 (the JAX rule, where it applies when Pallas
    runs), float32 otherwise. The kernels compute in float32 either way, and
    the result has b's dtype.

    The coarsest level (≤ max_direct unknowns) is solved with the host-built
    pseudo-inverse as one matmul, else by 24 zero-start sweeps."""
    device = torch.device(device)
    if device.type == 'cuda':
        # the coarse solve is a float32 matmul; TF32 would keep ~3 digits of it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if dtype == 'auto':
        dtype = torch.bfloat16 if (device.type == 'cuda' and len(resolution) == 3
                                   and max(resolution) >= 64) else torch.float32
    levels = []  # (resolution, inv_dx2)
    res = tuple(int(n) for n in resolution)
    d = tuple(float(x) for x in dx)
    while True:
        levels.append((res, tuple(1.0 / (x * x) for x in d)))
        if any(n % 2 for n in res) or min(res) <= min_size:
            break
        res = tuple(n // 2 for n in res)
        d = tuple(2 * x for x in d)
    coarse_res, coarse_inv_dx2 = levels[-1]
    bcs = tuple(tuple(b) for b in bcs)
    coarse_inv = None
    if int(np.prod(coarse_res)) <= max_direct:
        coarse_inv = torch.from_numpy(_coarse_pinv(coarse_res, coarse_inv_dx2, bcs)).to(device)

    def smooth(u, b, inv_dx2, sweeps, zero_init=False, out_dtype=None, emit_dot=False):
        w = np.float32(omega / (-2.0 * sum(inv_dx2)))  # negative: A is negative semi-definite
        return poisson_smooth(u, b, inv_dx2, bcs, w, sweeps, zero_init=zero_init,
                              out_dtype=out_dtype, emit_dot=emit_dot)

    def vcycle_level(b, level: int, out_dtype, emit_dot):
        # b keeps the dtype it arrived with (the float32 CG residual at the
        # finest level, level-dtype restricted residuals below)
        res_l, inv_dx2 = levels[level]
        if level + 1 == len(levels):
            if coarse_inv is not None:
                e = per_entry(lambda r: torch.matmul(coarse_inv, r.reshape(-1)), b.ndim - len(res_l), b.float())
                e = e.reshape(b.shape)
                return e.to(out_dtype), None
            return smooth(None, b, inv_dx2, 24, zero_init=True, out_dtype=out_dtype), None
        u = smooth(None, b, inv_dx2, nu, zero_init=True, out_dtype=dtype)
        rc = residual_restrict(u, b, inv_dx2, bcs)
        e, _ = vcycle_level(rc, level + 1, dtype, False)
        u = prolong_add(e.to(u.dtype), u, len(res_l))
        if emit_dot:
            return smooth(u, b, inv_dx2, nu, out_dtype=out_dtype, emit_dot=True)
        return smooth(u, b, inv_dx2, nu, out_dtype=out_dtype), None

    def vcycle(b: torch.Tensor, emit_dot: bool = False):
        return vcycle_level(b, 0, b.dtype, emit_dot)

    return vcycle

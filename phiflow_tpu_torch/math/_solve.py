"""Conjugate gradients — port of `phiflow_tpu/math/_solve.py::_cg` and the parts
of `solve_linear` the pressure solve uses (the rank-deficiency mean
projections and the fused-dot matvec of a homogeneous operator).

The loop runs eagerly: the stop test reads ⟨r, r⟩ on the host once per
iteration (one device sync), where JAX keeps the loop on the device in a
`lax.while_loop`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ['SolveResult', 'cg', 'sub_mean']


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    converged: bool


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.dot(u.reshape(-1), v.reshape(-1))


def sub_mean(x: torch.Tensor) -> torch.Tensor:
    """x − mean(x): the projection onto the range of a rank-1-deficient
    (Neumann / periodic) Poisson operator."""
    return x - torch.mean(x)


def cg(A: Callable, b: torch.Tensor, x0: torch.Tensor, rtol: float, atol: float, max_iter: int,
       M: Optional[Callable] = None) -> SolveResult:
    """Conjugate gradients for a symmetric (positive- or negative-definite) A.

    A(p) -> (A·p, ⟨p, A·p⟩ or None): the matvec, with its fused dot when the
    operator is homogeneous. M(r) -> (z, ⟨r, z⟩ or None): the preconditioner,
    with the dot of its last kernel where it has one. Stops when
    ⟨r, r⟩ ≤ tol² with tol = max(atol, rtol·‖b‖), or after max_iter iterations."""
    dtype = b.dtype
    eps = torch.tensor(1e-30, dtype=dtype, device=b.device)

    def safe_denom(x):
        return torch.where(torch.abs(x) < eps, torch.where(x < 0, -eps, eps), x)

    b_norm_sq = _dot(b, b)
    tol_sq = torch.clamp(rtol * torch.sqrt(b_norm_sq), min=atol) ** 2
    x = x0
    Ax, _ = A(x)
    r = b - Ax
    if M is not None:
        z, rz0 = M(r)
    else:
        z, rz0 = r, None
    p = z
    rz = rz0 if rz0 is not None else _dot(r, z)
    rr = _dot(r, r)
    it = 0
    while it < max_iter and bool(rr > tol_sq):
        Ap, pap = A(p)
        alpha = rz / safe_denom(pap if pap is not None else _dot(p, Ap))
        # freeze a converged system: alpha → 0 (kept from the batched original)
        alpha = alpha * (rr > tol_sq).to(dtype)
        x = x + alpha * p
        r = r - alpha * Ap
        rr = _dot(r, r)
        if M is not None:
            z, rz_f = M(r)
        else:
            z, rz_f = r, None
        rz_new = rz_f if rz_f is not None else _dot(r, z)
        beta = rz_new / safe_denom(rz)
        p = z + beta * p
        rz = rz_new
        it += 1
    return SolveResult(x, it, bool(rr <= tol_sq))

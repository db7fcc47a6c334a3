"""BC-aware 1-D derivative operators as precomputed matrices — the port's own
copy of `phiflow_tpu/field/_stencil1d.py`, the higher-order finite-difference
engine.

A 1-D derivative (or interpolation) operator of order p along an axis of
static length N — one-sided boundary rows derived from the boundary
condition, and the tridiagonal left-hand side of the compact (implicit)
scheme folded in — is a fixed N_out×N_in matrix plus an affine vector, built
once on the host in float64 numpy (`derivative_matrix`, `interp_matrix`,
cached) exactly as the JAX package builds it. `apply_axis_matrix` applies it
along one axis of a torch tensor as one contraction (`tensordot` +
`movedim`): float32 input with full float32 products (TF32 off), float64
input in float64 — the JAX package's `Precision.HIGHEST`. The matrix
product is a plain GEMM; the JAX package runs it outside any Pallas kernel.

Supported boundary types per side:
  * 'periodic'            — circulant wrap.
  * ('dirichlet', value)  — wall value known at the domain edge (half a cell
                            outside the first/last centre): one-sided rows
                            with the Dirichlet constraint; nonzero values
                            enter the affine vector.
  * 'zero-gradient'       — first derivative vanishes at the wall: one-sided
                            rows with the Neumann constraint.
"""
from __future__ import annotations

import functools
from math import factorial
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ['fd_coefficients', 'derivative_matrix', 'interp_matrix', 'apply_axis_matrix',
           'classify_side']


def fd_coefficients(offsets: Sequence[float], deriv: int,
                    lhs_offsets: Sequence[float] = (),
                    bc: Optional[Tuple[float, int, float]] = None):
    """Taylor-table finite-difference weights (on the host, float64).

    Finds weights c_i (on u at `offsets`, in units of the grid spacing h) and
    compact weights a_j (on the deriv-th derivative at nonzero `lhs_offsets`)
    such that

        Σ_i c_i·u(x+o_i h) + s·u^{(q)}(x+o_b h)
            ≈ h^deriv · [u^{(deriv)}(x) + Σ_j a_j·u^{(deriv)}(x+l_j h)]

    with an optional extra constraint row bc = (o_b, q, value) encoding a known
    boundary derivative u^{(q)}(x+o_b·h) = value, solved as one square
    Vandermonde-like system.

    Returns (rhs_weights, lhs_weights, affine) where affine = s·value·h^q
    accounts for the known boundary data (zero if bc is None or value == 0).
    """
    offsets = [float(o) for o in offsets]
    lhs_offsets = [float(o) for o in lhs_offsets if o != 0]
    n = len(offsets) + len(lhs_offsets) + (1 if bc is not None else 0)

    def moment_row(k: int):
        """Row of Taylor moments of total order k."""
        row = []
        for o in offsets:  # u-samples: moment o^k / k!
            row.append(o ** k / factorial(k))
        for o in lhs_offsets:  # derivative samples: shifted moments
            row.append(o ** (k - deriv) / factorial(k - deriv) if k >= deriv else 0.0)
        if bc is not None:
            o_b, q, _ = bc
            row.append(float(o_b) ** (k - q) / factorial(k - q) if k >= q else 0.0)
        return row

    A = np.array([moment_row(k) for k in range(n)], np.float64)
    rhs = np.zeros(n, np.float64)
    rhs[deriv] = 1.0
    sol = np.linalg.solve(A, rhs)
    c = sol[:len(offsets)]
    a = -sol[len(offsets):len(offsets) + len(lhs_offsets)]  # move to the LHS
    affine = 0.0
    if bc is not None:
        _, q, value = bc
        affine = float(sol[-1]) * float(value)
    return c, a, affine


def classify_side(ext, dim: str, upper: bool):
    """Map an Extrapolation to a 1-D boundary spec for `derivative_matrix`,
    or None if unsupported (caller falls back to the generic pad path)."""
    from ..math._extrapolation import (ConstantExtrapolation, _MixedExtrapolation, _PeriodicExtrapolation,
                                       _BoundaryExtrapolation)
    while isinstance(ext, _MixedExtrapolation):
        ext = ext._get(dim, upper)
    if isinstance(ext, _PeriodicExtrapolation):
        return 'periodic'
    if isinstance(ext, _BoundaryExtrapolation):
        return 'zero-gradient'
    if isinstance(ext, ConstantExtrapolation):
        try:
            return ('dirichlet', float(ext.value))
        except (TypeError, ValueError):
            return None  # a boundary value that is not one number
    return None


def _interior_offsets(deriv: int, order: int, staggered: bool) -> list:
    """Symmetric interior node offsets (integer for center→center, half-integer
    for center→face) wide enough for accuracy `order`."""
    if staggered:
        k = (order + deriv) // 2  # nodes at ±(j−1/2), j=1..k
        return [j + 0.5 for j in range(-k, k)]
    k = (order + deriv - 1) // 2
    return [float(j) for j in range(-k, k + 1)]


@functools.lru_cache(maxsize=256)
def derivative_matrix(n_in: int, deriv: int, order: int, dx: float,
                      bc_lo, bc_hi, staggered_out: bool = False,
                      out_lo_valid: bool = True, out_hi_valid: bool = True,
                      implicit_order: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Build the dense (N_out, n_in) float64 operator matrix M and affine vector
    for d^deriv/dx^deriv along one axis, with per-side boundary handling.

    bc_lo / bc_hi: 'periodic' | ('dirichlet', value) | 'zero-gradient'.
    staggered_out: output at faces (offsets ±1/2 from input centers); N_out is
        n_in+1 full faces trimmed by out_lo_valid/out_hi_valid (periodic: n_in).
    implicit_order: >0 enables the compact (implicit) scheme of that accuracy
        on interior rows; the tridiagonal LHS is folded in by a dense solve so
        application stays a single matmul.

    Boundary rows use one-sided Taylor-table stencils constrained by the
    boundary condition (Dirichlet wall value or zero normal gradient at the
    wall, half a cell outside the outermost center).
    """
    periodic = bc_lo == 'periodic'
    assert periodic == (bc_hi == 'periodic'), "periodic must apply to both sides"
    inv_h = 1.0 / float(dx) ** deriv

    # --- interior stencil (explicit or compact) ---
    int_offsets = _interior_offsets(deriv, order - implicit_order if implicit_order else order,
                                    staggered_out)
    lhs_offsets = []
    if implicit_order:
        k = implicit_order // 2
        lhs_offsets = [float(j) for j in range(-k, k + 1) if j != 0]
    c_int, a_int, _ = fd_coefficients(int_offsets, deriv, lhs_offsets)

    if periodic:
        n_out = n_in
        R = np.zeros((n_out, n_in), np.float64)
        L = np.eye(n_out, dtype=np.float64)
        base = -0.5 if staggered_out else 0.0  # face i sits at center i − 1/2
        for i in range(n_out):
            for o, c in zip(int_offsets, c_int):
                R[i, int(round(i + base + o)) % n_in] += c
            for o, a in zip(lhs_offsets, a_int):
                L[i, (i + int(o)) % n_out] += a
        M = np.linalg.solve(L, R) if implicit_order else R
        return (M * inv_h), np.zeros(n_out, np.float64)

    # --- non-periodic: one-sided boundary rows ---
    if staggered_out:
        first_face = 0 if out_lo_valid else 1
        last_face = n_in if out_hi_valid else n_in - 1
        faces = list(range(first_face, last_face + 1))
        n_out = len(faces)
    else:
        faces = list(range(n_in))
        n_out = n_in
    R = np.zeros((n_out, n_in), np.float64)
    L = np.eye(n_out, dtype=np.float64)
    affine = np.zeros(n_out, np.float64)
    n_nodes_boundary = order + deriv  # one-sided window size (+1 constraint = bc)
    for row, pos in enumerate(faces):
        # output location in units of h, measured in center coordinates
        x_out = (pos - 0.5) if staggered_out else float(pos)
        lo_reach = x_out + min(int_offsets)
        hi_reach = x_out + max(int_offsets)
        lhs_ok = all(0 <= row + int(o) < n_out for o in lhs_offsets)
        if lo_reach >= 0 and hi_reach <= n_in - 1 and (not implicit_order or lhs_ok):
            # interior: symmetric (possibly compact) stencil
            for o, c in zip(int_offsets, c_int):
                R[row, int(round(x_out + o))] += c
            for o, a in zip(lhs_offsets, a_int):
                L[row, row + int(o)] += a
            continue
        # boundary row: one-sided window + BC constraint, explicit
        near_lo = x_out < n_in / 2
        if near_lo:
            nodes = [float(j) for j in range(0, min(n_nodes_boundary, n_in))]
            wall = -0.5
            side = bc_lo
        else:
            nodes = [float(j) for j in range(max(0, n_in - n_nodes_boundary), n_in)]
            wall = n_in - 0.5
            side = bc_hi
        rel = [nd - x_out for nd in nodes]
        if side == 'zero-gradient':
            bc = (wall - x_out, 1, 0.0)
        else:  # ('dirichlet', value)
            bc = (wall - x_out, 0, float(side[1]))
        c_row, _, aff = fd_coefficients(rel, deriv, (), bc)
        for nd, c in zip(nodes, c_row):
            R[row, int(round(nd))] += c
        affine[row] = aff
    M = np.linalg.solve(L, R) if implicit_order else R
    return (M * inv_h), (np.linalg.solve(L, affine) if implicit_order else affine) * inv_h


@functools.lru_cache(maxsize=256)
def interp_matrix(n_in: int, order: int, start: float, n_out: int,
                  bc_lo, bc_hi, implicit_order: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """High-order interpolation between half-cell-shifted dual grids as one
    dense (n_out, n_in) matrix + affine vector, the compact scheme's
    tridiagonal solve folded in on the host; application is one matrix
    product.

    Inputs at integer coords 0..n_in−1; output i at coord ``start + i`` with
    start ∈ {−0.5, +0.5}. Covers center→face (n_out = n_in±1, walls at the
    outermost outputs) and face→center (n_out = n_in−1, outputs strictly
    inside the data range). Rows:
      * interior — symmetric window; with ``implicit_order`` the compact
        scheme of that accuracy (order 6 ⇒ 4-node rhs + tridiagonal lhs).
      * one-sided — output inside the data range but window clipped: pure
        polynomial interpolation through the `order` nearest nodes.
      * wall — output AT the boundary (center→face outer faces): Taylor row
        constrained by the BC (Dirichlet value / zero normal gradient at the
        output location itself).
    """
    periodic = bc_lo == 'periodic'
    assert periodic == (bc_hi == 'periodic'), "periodic must apply to both sides"
    k_int = ((order - implicit_order) if implicit_order else order) // 2
    int_offsets = [j + 0.5 for j in range(-k_int, k_int)]
    lhs_offsets = []
    if implicit_order:
        k = implicit_order // 2
        lhs_offsets = [float(j) for j in range(-k, k + 1) if j != 0]
    c_int, a_int, _ = fd_coefficients(int_offsets, 0, lhs_offsets)

    if periodic:
        assert n_out == n_in
        R = np.zeros((n_out, n_in), np.float64)
        L = np.eye(n_out, dtype=np.float64)
        for i in range(n_out):
            for o, c in zip(int_offsets, c_int):
                R[i, int(round(start + i + o)) % n_in] += c
            for o, a in zip(lhs_offsets, a_int):
                L[i, (i + int(o)) % n_out] += a
        M = np.linalg.solve(L, R) if implicit_order else R
        return M, np.zeros(n_out, np.float64)

    R = np.zeros((n_out, n_in), np.float64)
    L = np.eye(n_out, dtype=np.float64)
    affine = np.zeros(n_out, np.float64)
    for row in range(n_out):
        x_out = start + row
        lo_reach = x_out + int_offsets[0]
        hi_reach = x_out + int_offsets[-1]
        lhs_ok = all(0 <= row + int(o) < n_out for o in lhs_offsets)
        if lo_reach >= 0 and hi_reach <= n_in - 1 and (not implicit_order or lhs_ok):
            for o, c in zip(int_offsets, c_int):
                R[row, int(round(x_out + o))] += c
            for o, a in zip(lhs_offsets, a_int):
                L[row, row + int(o)] += a
            continue
        near_lo = x_out < (n_in - 1) / 2
        nodes = ([float(j) for j in range(0, min(order, n_in))] if near_lo
                 else [float(j) for j in range(max(0, n_in - order), n_in)])
        rel = [nd - x_out for nd in nodes]
        if -0.5 < x_out < n_in - 0.5:
            c_row, _, aff = fd_coefficients(rel, 0, ())  # one-sided, inside data
        else:  # output exactly at a wall: constrain by the boundary condition
            side = bc_lo if near_lo else bc_hi
            bc = (0.0, 1, 0.0) if side == 'zero-gradient' else (0.0, 0, float(side[1]))
            c_row, _, aff = fd_coefficients(rel, 0, (), bc)
        for nd, c in zip(nodes, c_row):
            R[row, int(round(nd))] += c
        affine[row] = aff
    M = np.linalg.solve(L, R) if implicit_order else R
    aff_out = np.linalg.solve(L, affine) if implicit_order else affine
    return M, aff_out


_ON_DEVICE = {}  # (id of a cached host matrix, dtype, device) → (the host matrix, its torch copy)


def _on_device(M: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The torch copy of a host matrix on `device`, made once: the matrices
    come from the caches above and are applied at every derivative."""
    key = (id(M), dtype, str(device))
    entry = _ON_DEVICE.get(key)
    if entry is None or entry[0] is not M:
        if len(_ON_DEVICE) >= 512:
            _ON_DEVICE.clear()
        entry = _ON_DEVICE[key] = (M, torch.as_tensor(M, dtype=dtype, device=device))
    return entry[1]


def apply_axis_matrix(arr: torch.Tensor, axis: int, M: np.ndarray, affine: np.ndarray) -> torch.Tensor:
    """out[..., i, ...] = Σ_j M[i, j]·arr[..., j, ...] + affine[i] along `axis`:
    one contraction, the result's axis back in its place. float64 input
    computes in float64, any other in float32 with full float32 products."""
    dtype = arr.dtype
    work = torch.float64 if dtype == torch.float64 else torch.float32
    if arr.is_cuda:
        # a TF32 product keeps ~3 digits: the compact scheme's dense inverse needs full float32
        torch.backends.cuda.matmul.allow_tf32 = False
    out = torch.tensordot(arr.to(work), _on_device(M, work, arr.device), dims=([axis], [1]))
    out = torch.movedim(out, -1, axis)
    if np.any(affine):
        aff = _on_device(affine, work, arr.device).reshape((-1,) + (1,) * (out.ndim - axis - 1))
        out = out + aff
    return out.to(dtype)

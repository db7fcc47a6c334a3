"""The strong-Wolfe line search of `jax.scipy.optimize` — a port of the
zoom algorithm in JAX's `jax/_src/scipy/optimize/line_search.py`
(Wright and Nocedal, 'Numerical Optimization', 1999, algorithms 3.5 and
3.6), which the JAX package's L-BFGS and BFGS call.

The same constants and rules: c1 = 1e-4, c2 = 0.9, at most `maxiter`
trial steps doubling from 1 (or from the BFGS start value), zoom by the
cubic, then the quadratic interpolant, then bisection, with the safeguards
0.2 and 0.1 of the bracket, a bracket shorter than 1e-5 (1e-10 in float64)
or 30 zoom iterations failing the search, and a float32 step below 1e-8
raised to 1e-8. Where JAX evaluates both zooms of an iteration under
masks, this loop runs the one that applies; the counts of evaluations are
JAX's.

The vectors stay on their device. The scalars of the search (step sizes,
φ and φ′) live on the host in the vectors' precision (float32 or
float64), as JAX's do in its loop state: each evaluation copies φ and φ′
to the host once, the search's one device sync per evaluation.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ['LineSearchResult', 'line_search', 'host_scalars']


class LineSearchResult(NamedTuple):
    failed: bool      # the strong Wolfe conditions were not met
    nit: int          # trial steps taken
    nfev: int         # function (and gradient) evaluations
    ngev: int
    k: int
    a_k: np.generic   # the step, a host scalar in the vectors' precision
    f_k: np.generic   # φ(a_k)
    g_k: torch.Tensor  # ∇f at x + a_k·p
    status: int       # 0 passed, 1 zoom failed, 3 maxiter reached


def host_scalars(*values, dtype) -> list:
    """Device scalars (0-dim tensors) as host numpy scalars of `dtype`, in one copy."""
    tensors = [v.detach().reshape(()).to(torch.float64) for v in values]
    return [dtype.type(v) for v in torch.stack(tensors).cpu().numpy()]


def _cubicmin(a, fa, fpa, b, fb, c, fc, T):
    C = fpa
    db, dc = T(b - a), T(c - a)
    denom = T(T(db * dc) ** 2 * T(db - dc))
    d2 = (T(fb - fa - C * db), T(fc - fa - C * dc))
    A = T(T(T(dc ** 2) * d2[0]) + T(T(-db ** 2) * d2[1])) / denom
    B = T(T(T(-dc ** 3) * d2[0]) + T(T(db ** 3) * d2[1])) / denom
    radical = T(B * B - T(3.) * A * C)
    return T(a + (-B + np.sqrt(radical)) / (T(3.) * A))


def _quadmin(a, fa, fpa, b, fb, T):
    db = T(b - a)
    B = T((fb - fa - fpa * db) / T(db ** 2))
    return T(a - fpa / (T(2.) * B))


class _Zoom(NamedTuple):
    failed: bool
    a_star: np.generic
    phi_star: np.generic
    dphi_star: np.generic
    g_star: torch.Tensor
    nfev: int


def _zoom(evaluate, wolfe_one, wolfe_two, a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi, g_0, T, threshold) -> _Zoom:
    """Algorithm 3.6: shrink [a_lo, a_hi] until a step meets both conditions."""
    done, failed, j, nfev = False, False, 0, 0
    a_rec, phi_rec = T((a_lo + a_hi) / T(2.)), T((phi_lo + phi_hi) / T(2.))
    a_star, phi_star, dphi_star, g_star = T(1.), phi_lo, dphi_lo, g_0
    delta1, delta2 = T(0.2), T(0.1)
    while not done and not failed:
        dalpha = T(a_hi - a_lo)
        a, b = min(a_hi, a_lo), max(a_hi, a_lo)
        cchk, qchk = T(delta1 * dalpha), T(delta2 * dalpha)
        failed = failed or bool(dalpha <= threshold)
        a_j_cubic = _cubicmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, a_rec, phi_rec, T)
        use_cubic = j > 0 and a_j_cubic > a + cchk and a_j_cubic < b - cchk
        a_j_quad = _quadmin(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, T)
        use_quad = not use_cubic and a_j_quad > a + qchk and a_j_quad < b - qchk
        a_j = a_j_cubic if use_cubic else a_j_quad if use_quad else T((a_lo + a_hi) / T(2.))
        phi_j, dphi_j, g_j = evaluate(a_j)
        nfev += 1
        hi_to_j = bool(wolfe_one(a_j, phi_j) or phi_j >= phi_lo)
        star_to_j = bool(wolfe_two(dphi_j)) and not hi_to_j
        hi_to_lo = bool(dphi_j * (a_hi - a_lo) >= 0.) and not hi_to_j and not star_to_j
        lo_to_j = not hi_to_j and not star_to_j
        if hi_to_j:
            a_hi, phi_hi, dphi_hi, a_rec, phi_rec = a_j, phi_j, dphi_j, a_hi, phi_hi
        if star_to_j:
            done = True
            a_star, phi_star, dphi_star, g_star = a_j, phi_j, dphi_j, g_j
        if hi_to_lo:
            a_hi, phi_hi, dphi_hi, a_rec, phi_rec = a_lo, phi_lo, dphi_lo, a_hi, phi_hi
        if lo_to_j and not hi_to_lo:
            a_rec, phi_rec = a_lo, phi_lo
        if lo_to_j:
            a_lo, phi_lo, dphi_lo = a_j, phi_j, dphi_j
        j += 1
        failed = failed or j >= 30
    return _Zoom(failed, a_star, phi_star, dphi_star, g_star, nfev)


def line_search(value_and_grad: Callable, xk: torch.Tensor, pk: torch.Tensor, old_fval=None, old_old_fval=None,
                gfk: torch.Tensor = None, c1=1e-4, c2=0.9, maxiter=20) -> LineSearchResult:
    """A step a along the descent direction `pk` from `xk` that meets the
    strong Wolfe conditions φ(a) ≤ φ(0) + c1·a·φ′(0) and |φ′(a)| ≤ −c2·φ′(0),
    φ(a) = f(xk + a·pk). `value_and_grad(x)` returns (f(x), ∇f(x)) as
    tensors. `old_fval` and `gfk` (f and ∇f at xk) save the first
    evaluation; `old_old_fval` (the value before) sets the first trial step
    as BFGS does."""
    dt = np.dtype(np.float64) if pk.dtype == torch.float64 else np.dtype(np.float32)
    T = dt.type
    threshold = T(1e-10) if dt.itemsize == 8 else T(1e-5)

    def evaluate(t):
        phi, g = value_and_grad(xk + float(t) * pk)
        phi_h, dphi_h = host_scalars(phi, torch.dot(g.reshape(-1), pk.reshape(-1)), dtype=dt)
        return phi_h, dphi_h, g

    if old_fval is None or gfk is None:
        phi_0, dphi_0, gfk = evaluate(T(0.))
        nfev = 1
    else:
        phi_0 = old_fval if isinstance(old_fval, np.generic) else host_scalars(old_fval, dtype=dt)[0]
        dphi_0, = host_scalars(torch.dot(gfk.reshape(-1), pk.reshape(-1)), dtype=dt)
        phi_0, nfev = T(phi_0), 0
    if old_old_fval is not None:
        with np.errstate(all='ignore'):
            candidate = T(T(1.01) * T(2) * T(phi_0 - T(old_old_fval)) / dphi_0)
        start_value = T(1.0) if candidate > 1 else candidate
    else:
        start_value = T(1)
    c1, c2 = T(c1), T(c2)

    def wolfe_one(a_i, phi_i):  # the negation of the sufficient-decrease condition
        return phi_i > phi_0 + c1 * a_i * dphi_0

    def wolfe_two(dphi_i):
        return abs(dphi_i) <= -c2 * dphi_0

    done, failed, i = False, False, 1
    a_i1, phi_i1, dphi_i1 = T(0.), phi_0, dphi_0
    a_star, phi_star, g_star = T(0.), phi_0, gfk
    with np.errstate(all='ignore'):
        while not done and i <= maxiter and not failed:
            a_i = start_value if i == 1 else T(a_i1 * T(2.))
            phi_i, dphi_i, g_i = evaluate(a_i)
            nfev += 1
            star_to_zoom1 = bool(wolfe_one(a_i, phi_i) or (phi_i >= phi_i1 and i > 1))
            star_to_i = bool(wolfe_two(dphi_i)) and not star_to_zoom1
            star_to_zoom2 = bool(dphi_i >= 0.) and not star_to_zoom1 and not star_to_i
            if star_to_zoom1:
                zoom = _zoom(evaluate, wolfe_one, wolfe_two, a_i1, phi_i1, dphi_i1, a_i, phi_i, dphi_i, gfk, T,
                             threshold)
            elif star_to_zoom2:
                zoom = _zoom(evaluate, wolfe_one, wolfe_two, a_i, phi_i, dphi_i, a_i1, phi_i1, dphi_i1, gfk, T,
                             threshold)
            if star_to_zoom1 or star_to_zoom2:
                nfev += zoom.nfev
                done, failed = True, failed or zoom.failed
                a_star, phi_star, g_star = zoom.a_star, zoom.phi_star, zoom.g_star
            if star_to_i:
                done = True
                a_star, phi_star, g_star = a_i, phi_i, g_i
            i += 1
            a_i1, phi_i1, dphi_i1 = a_i, phi_i, dphi_i
    status = 1 if failed else 3 if i > maxiter else 0
    if dt.itemsize != 8 and abs(a_star) < T(1e-8):
        a_star = T(np.sign(a_star) * T(1e-8))
    return LineSearchResult(failed or not done, i - 1, nfev, nfev, i, a_star, phi_star, g_star, status)

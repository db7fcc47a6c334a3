"""Optimisation through the port's differentiable functions — port of
`minimize`, `_lbfgs` and `solve_nonlinear` of `phiflow_tpu/math/_solve.py`
(`:858-1056`) and of the BFGS of `jax.scipy.optimize.minimize` that the JAX
package's `minimize` calls for every other method.

`minimize(f, solve)` flattens `solve.x0` (a Tensor, Field, staggered grid
or tuple) with `_VecFormat`, takes the loss as the sum of `f(x)`'s native
and its gradient from `torch.autograd`, and runs:
- L-BFGS for 'auto', 'L-BFGS-B', 'L-BFGS' and 'lbfgs' (no box constraints):
  the JAX package's `_lbfgs`, a history of m = 10 pairs in a cyclic buffer
  of (m, N) arrays, the two-loop recursion with γ = sᵀy / yᵀy of the newest
  pair, steepest descent where the direction does not descend, JAX's
  strong-Wolfe search (`_line_search.py`; a step of 1e-8 where it returns
  no positive finite one), a pair kept only where sᵀy > 1e-10, and the stop
  test max|g| ≤ abs_tol;
- BFGS for every other method, 'GD' included: JAX's `minimize_bfgs`, a
  dense inverse Hessian, gtol 1e-5 in the inf-norm, at most 10 trial steps
  a search, a warning when it does not converge.
Each records a `SolveInfo` with JAX's success rule on every active
`SolveTape`.

`solve_nonlinear(f, y, solve)`: Newton–Krylov for 'auto' and 'Newton'
(at most 50 steps; each solves J·dx = −r with the port's `bicgstab` at
rel_tol 1e-3, abs_tol 1e-12 and 200 iterations, J·v by the double
backward of the step's one recorded forward; then at most 8 halvings of the
step until ‖r‖² falls); any other method minimises
‖f(x) − y‖². It raises `NotConverged` as JAX does.

The loops run eagerly on the host, the vectors on their device: a line
search copies φ and φ′ to the host once an evaluation, an L-BFGS iteration
once more for sᵀy and max|g|. `optimizer_trace()` collects one record an
iteration (loss, max|g|, evaluations, step).
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Callable

import numpy as np
import torch

from ._line_search import host_scalars, line_search
from ._magic import ConvergenceException, NotConverged
from ._solve import Solve, SolveInfo, _VecFormat, _tensor_leaves, bicgstab, record
from ._tensor import Tensor, TensorStack, to_torch, wrap

__all__ = ['minimize', 'solve_nonlinear', 'lbfgs', 'bfgs', 'optimizer_trace', 'LBFGS_METHODS']

LBFGS_METHODS = ('auto', 'L-BFGS-B', 'L-BFGS', 'lbfgs')
_TRACES: list = []


@contextlib.contextmanager
def optimizer_trace(on_iteration: Callable = None):
    """Collect a dict for each L-BFGS or BFGS iteration run within the
    context: `iteration`, `loss` and `max_grad` after it, `evaluations` of
    the loss it took, `step` (the line search's a). `on_iteration(entry)`,
    if given, runs as each is recorded (a caller's counters and clocks)."""
    records = []
    _TRACES.append((records, on_iteration))
    try:
        yield records
    finally:
        _TRACES.remove((records, on_iteration))


def _trace(**entry):
    for records, on_iteration in _TRACES:
        records.append(entry)
        if on_iteration is not None:
            on_iteration(entry)


def _dtype_of(x: torch.Tensor):
    return np.dtype(np.float64) if x.dtype == torch.float64 else np.dtype(np.float32)


def _two_loop(g, S, Y, rho, count: int, m: int):
    """H·g from the stored pairs, the newest in slot (count − 1) mod m."""
    q, k, alphas = g, min(count, m), {}
    for i in range(k):
        j = (count - 1 - i) % m
        alphas[j] = rho[j] * torch.dot(S[j], q)
        q = q - alphas[j] * Y[j]
    if count > 0:
        last = (count - 1) % m
        sy, yy = torch.dot(S[last], Y[last]), torch.dot(Y[last], Y[last])
        gamma = torch.where(yy > 1e-30, sy / torch.clamp(yy, min=1e-30), torch.ones_like(yy))
        r = gamma * q
    else:
        r = q
    for i in range(k):
        j = (count - k + i) % m
        r = r + (alphas[j] - rho[j] * torch.dot(Y[j], r)) * S[j]
    return r


def lbfgs(value_and_grad: Callable, x0: torch.Tensor, max_iter: int, tol: float, history: int = 10):
    """L-BFGS from `x0` (a flat tensor): (x, f(x), max|∇f(x)|, iterations)."""
    dt = _dtype_of(x0)
    T, m, n = dt.type, history, x0.shape[0]
    x = x0
    fx, g = value_and_grad(x)
    S = torch.zeros((m, n), dtype=x0.dtype, device=x0.device)
    Y = torch.zeros_like(S)
    rho = torch.zeros(m, dtype=x0.dtype, device=x0.device)
    count, it = 0, 0
    g_max, = host_scalars(torch.max(torch.abs(g)), dtype=dt)
    while g_max > T(tol) and it < max_iter:
        d = -_two_loop(g, S, Y, rho, count, m)
        d = torch.where(torch.dot(d, g) < 0, d, -g)  # steepest descent where d does not descend
        ls = line_search(value_and_grad, x, d, old_fval=fx, gfk=g)
        step = ls.a_k if np.isfinite(ls.a_k) and ls.a_k > 0 else T(1e-8)
        x_new = x + float(step) * d
        f_new, g_new = value_and_grad(x_new)
        s, y = x_new - x, g_new - g
        sy = torch.dot(s, y)
        sy_h, g_max, f_h = host_scalars(sy, torch.max(torch.abs(g_new)), f_new, dtype=dt)
        if sy_h > T(1e-10):
            slot = count % m
            S[slot], Y[slot] = s, y
            rho[slot] = 1.0 / torch.clamp(sy, min=1e-30)
            count += 1
        x, fx, g = x_new, f_new, g_new
        it += 1
        _trace(iteration=it, loss=float(f_h), max_grad=float(g_max), evaluations=ls.nfev + 1, step=float(step))
    return x, fx, g_max, it


def bfgs(value_and_grad: Callable, x0: torch.Tensor, maxiter: int = None, gtol: float = 1e-5,
         line_search_maxiter: int = 10):
    """JAX's `minimize_bfgs` (Wright and Nocedal, algorithm 6.1): a dict of
    x, fun, jac, hess_inv, nit, nfev, converged, failed, status, success."""
    dt = _dtype_of(x0)
    d = x0.shape[0]
    maxiter = d * 200 if maxiter is None else maxiter
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    H = eye
    f, g = value_and_grad(x0)
    g_inf, g_2, f = host_scalars(torch.max(torch.abs(g)), torch.linalg.norm(g), f, dtype=dt)
    converged, failed, k, nfev, ls_status = bool(g_inf < gtol), False, 0, 1, 0
    x, old_old = x0, dt.type(f + g_2 / 2)
    while not converged and not failed and k < maxiter:
        p = -(H @ g)
        ls = line_search(value_and_grad, x, p, old_fval=f, old_old_fval=old_old, gfk=g, maxiter=line_search_maxiter)
        nfev += ls.nfev
        failed, ls_status = ls.failed, ls.status
        s = float(ls.a_k) * p
        x_new, f_new, g_new = x + s, ls.f_k, ls.g_k
        y = g_new - g
        rho = torch.reciprocal(torch.dot(y, s))
        w = eye - rho * s[:, None] * y[None, :]
        H_new = w @ H @ w.T + rho * s[:, None] * s[None, :]
        H = torch.where(torch.isfinite(rho), H_new, H)
        g_inf, = host_scalars(torch.max(torch.abs(g_new)), dtype=dt)
        converged = bool(g_inf < gtol)
        k += 1
        _trace(iteration=k, loss=float(f_new), max_grad=float(g_inf), evaluations=ls.nfev, step=float(ls.a_k))
        x, old_old, f, g = x_new, f, f_new, g_new
    status = 0 if converged else 1 if k == maxiter else 2 + ls_status if failed else -1
    return dict(x=x, fun=f, jac=g, hess_inv=H, nit=k, nfev=nfev, converged=converged, failed=failed, status=status,
                success=converged and not failed)


def _loss_sum(loss) -> torch.Tensor:
    """The sum of a loss's native: a Field's values, a Tensor, or a TensorStack's components."""
    loss = loss.values if hasattr(loss, 'values') and hasattr(loss, 'geometry') else loss
    loss = wrap(loss)
    parts = loss.components if isinstance(loss, TensorStack) else (loss,)
    return sum(torch.sum(to_torch(p.native())) for p in parts)


def _value_and_grad(loss_flat: Callable) -> Callable:
    def value_and_grad(x: torch.Tensor):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            value = loss_flat(x)
            grad = torch.autograd.grad(value, x, allow_unused=True)[0] if value.requires_grad else None
        return value.detach(), (torch.zeros_like(x) if grad is None else grad)
    return value_and_grad


def minimize(f: Callable, solve: Solve):
    """Minimise the scalar `f(x)` over x from `solve.x0`: L-BFGS for the
    methods 'auto', 'L-BFGS-B', 'L-BFGS' and 'lbfgs', BFGS for any other.
    Returns x in `solve.x0`'s structure."""
    solve = solve.with_defaults('optimization')
    x0 = solve.x0
    fmt = _VecFormat(x0)
    x0_vec = fmt.flatten(x0)
    shape_bn = x0_vec.shape

    def loss_flat(xf):
        return _loss_sum(f(fmt.unflatten(xf.reshape(shape_bn))))

    value_and_grad = _value_and_grad(loss_flat)
    method = solve.method if solve.method is not None else 'auto'
    if method in LBFGS_METHODS:
        tol = solve.abs_tol if solve.abs_tol else 1e-6
        x_flat, fx, g_max, it = lbfgs(value_and_grad, x0_vec.reshape(-1), max_iter=solve.max_iterations, tol=tol)
        x = fmt.unflatten(x_flat.reshape(shape_bn))
        success = bool(g_max <= type(g_max)(max(solve.abs_tol or 1e-6, 1e-6) * 10)) or it < solve.max_iterations
        record(SolveInfo(solve, x, fx, it, -1, success, False, 'L-BFGS-B'))
        return x
    result = bfgs(value_and_grad, x0_vec.reshape(-1), maxiter=solve.max_iterations)
    x = fmt.unflatten(result['x'].reshape(shape_bn))
    record(SolveInfo(solve, x, result['fun'], result['nit'], result['nfev'], result['success'], False, 'BFGS'))
    if not result['success'] and NotConverged not in solve.suppress and ConvergenceException not in solve.suppress:
        warnings.warn(f"minimize did not converge: {result['status']}")
    return x


def _jvp_operator(r: torch.Tensor, x: torch.Tensor) -> Callable:
    """v ↦ J·v of the recorded r(x) by double backward: the VJP u ↦ Jᵀu
    with a graph, then, for each v, the gradient of ⟨Jᵀu, v⟩ in u."""
    with torch.enable_grad():
        u = torch.zeros_like(r, requires_grad=True)
        vjp, = torch.autograd.grad(r, x, u, create_graph=True)

    def jvp(v):
        return torch.autograd.grad(vjp, u, v, retain_graph=True)[0]
    return jvp


def solve_nonlinear(f: Callable, y, solve: Solve):
    """Solve f(x) = y from `solve.x0`: Newton–Krylov for the methods 'auto'
    and 'Newton', else the minimum of ‖f(x) − y‖² by `minimize`."""
    if solve.method not in ('auto', 'Newton', 'newton'):
        def loss(x):
            return sum(torch.sum(to_torch(t.native()) ** 2) for t in _tensor_leaves(f(x) - y))
        return minimize(loss, solve)
    solve = solve.with_defaults('solve')
    x0 = solve.x0
    assert x0 is not None, "solve_nonlinear requires solve.x0"
    fmt, y_fmt = _VecFormat(x0), _VecFormat(y)
    shape_bn = fmt.flatten(x0).shape
    x_vec = fmt.flatten(x0).reshape(-1)
    y_vec = y_fmt.flatten(y).reshape(-1)
    dt = _dtype_of(x_vec)

    def residual_flat(xf):
        return y_fmt.flatten(f(fmt.unflatten(xf.reshape(shape_bn)))).reshape(-1) - y_vec

    tol = max(solve.abs_tol or 1e-5, 1e-12)
    it = -1
    for it in range(min(solve.max_iterations, 50)):
        with torch.enable_grad():
            xg = x_vec.detach().requires_grad_(True)
            r_recorded = residual_flat(xg)
        r = r_recorded.detach()
        r_norm, base = host_scalars(torch.linalg.norm(r), torch.sum(r ** 2), dtype=dt)
        if r_norm < tol:
            break
        jvp = _jvp_operator(r_recorded, xg)
        dx = bicgstab(lambda v: (jvp(v), None), -r, torch.zeros_like(r), 1e-3, 1e-12, 200).x
        step = 1.0
        for _ in range(8):  # damping: halve the step until ‖r‖² falls
            r_new = residual_flat(x_vec + step * dx).detach()
            if host_scalars(torch.sum(r_new ** 2), dtype=dt)[0] < base:
                break
            step *= 0.5
        x_vec = (x_vec + step * dx).detach()
    x = fmt.unflatten(x_vec.reshape(shape_bn))
    res, = host_scalars(torch.linalg.norm(residual_flat(x_vec).detach()), dtype=dt)
    info = SolveInfo(solve, x, float(res), it + 1, -1, bool(res < tol * 10), not np.isfinite(res), 'Newton-Krylov')
    record(info)
    if not info.converged and NotConverged not in solve.suppress and ConvergenceException not in solve.suppress:
        raise NotConverged(info)
    return x

"""Linear solves — port of `phiflow_tpu/math/_solve.py`: the Krylov
solvers on raw tensors (`cg`, the array layer's solver; `cg_adaptive`,
JAX's `_cg_adaptive` `:435-486`; `bicgstab`, `_bicgstab` `:488-537`;
`bicgstab2`, the Sleijpen–Fokkema BiCGStab(2) of `_bicgstab2` `:540-647`) and
the dense `Direct` solve (`_direct` `:649-664`), and on top of them the solve
specification of the Field layer (`Solve`, `copy_solve`), its diagnostics
(`SolveInfo`, `SolveTape`) and `solve_linear`, which dispatches by the
solve's method in JAX's order (`:730-757`): 'auto' / 'CG' / 'CG-native' CG,
'CG-adaptive', 'biCG' / 'biCG-stab' / 'biCG-stab(1)' BiCGStab,
'biCG-stab(2)', 'direct' / 'scipy-direct' (BiCGStab at tolerances of at
most 1e-6, with a warning, above `DIRECT_MAX_UNKNOWNS`), and CG with a
warning for any other name. A preconditioner that is not callable is
ignored, as JAX ignores it. `solve_linear` flattens its unknown and
right-hand side with `_VecFormat` (JAX's `:198-312`: a Field, Tensor,
staggered TensorStack or tuple as one vector, leaves concatenated), so a
staggered unknown solves like a centred one. Systems along batch dims
(`nb` leading axes, as JAX splits them off, `:313-347`) run through one loop,
as JAX's `_cg` runs them: each has its own tolerance, rank-deficiency mean
and stop, a converged system is frozen (its step α × 0) while the others go
on, the loop ends when all have converged, and `SolveInfo.residual` holds
one ‖r‖ per system. Each system's inner products and means are reduced as
an unbatched system's, so an entry of a batch gets its own solve's numbers.
`minimize` and `solve_nonlinear` are in `_optimize.py`.

The loops run eagerly: the stop test reads ⟨r, r⟩ on the host once per
iteration (one device sync), where JAX keeps the loop on the device in a
`lax.while_loop`. A `SolveInfo` therefore holds the concrete iteration count.

Gradients: `implicit_solve` differentiates a solve implicitly, as JAX's
`jax.lax.custom_linear_solve` does (`phiflow_tpu/math/_solve.py:802-816`).
Its `torch.autograd.Function` runs the Krylov loop under `no_grad`, keeps x
alone, and its backward solves the adjoint system Aᵀλ = ḡ once (CG,
CG-adaptive: Aᵀ = A; BiCGStab and BiCGStab(2): Aᵀ applied as the VJP of the
linear map; direct: the matrix's transpose), ḡ projected onto A's
range and λ without its mean for a rank-deficient system; the right-hand
side gets λ, tensors the operator
depends on get −VJP_θ(A(x; θ))[λ], and x0 nothing. The graph holds O(1)
tensors whatever the iteration count. `Solve(implicit_diff=False)` is
forward-only: differentiating through it raises. `solve_linear` and the
array-level projections (`physics/fluid.py`) solve through it.
"""
from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional

import torch

from ._functional import LinearFunction
from ._magic import ConvergenceException, Diverged, NotConverged
from ._tensor import Tensor, TensorStack
from ..ops.poisson import per_entry

__all__ = ['SolveResult', 'cg', 'cg_adaptive', 'bicgstab', 'bicgstab2', 'Direct', 'sub_mean', 'implicit_solve',
           'Solve', 'copy_solve', 'SolveInfo', 'SolveTape', 'solve_linear', 'record', 'krylov_of',
           'DIRECT_MAX_UNKNOWNS']

# 'direct' / 'scipy-direct' build the dense matrix up to this many unknowns (the JAX package's limit, `:40-43`);
# larger systems run BiCGStab at tolerances of at most 1e-6
DIRECT_MAX_UNKNOWNS = 16384


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    converged: bool
    residual: Optional[torch.Tensor] = None  # ‖r‖ of the last iterate, one per system


def _dot(u: torch.Tensor, v: torch.Tensor, nb: int = 0) -> torch.Tensor:
    """⟨u, v⟩, one per system of the `nb` leading axes (`per_entry`)."""
    return per_entry(lambda a, b: torch.dot(a.reshape(-1), b.reshape(-1)), nb, u, v)


def _dot64(u: torch.Tensor, v: torch.Tensor, nb: int = 0) -> torch.Tensor:
    """⟨u, v⟩ accumulated in float64, in u's dtype."""
    return _dot(u.double(), v.double(), nb).to(u.dtype)


def _bc(s: torch.Tensor, like: torch.Tensor, nb: int) -> torch.Tensor:
    """A per-system scalar broadcast against a (*batch, *rest) vector."""
    return s if nb == 0 else s.reshape(s.shape + (1,) * (like.ndim - nb))


def sub_mean(x: torch.Tensor, nb: int = 0) -> torch.Tensor:
    """x − mean(x), per system of the `nb` leading axes (each mean taken as
    an unbatched one is): the projection onto the range of a
    rank-1-deficient (Neumann / periodic) Poisson operator."""
    return x - _bc(per_entry(torch.mean, nb, x), x, nb)


def _safe_denom_fn(dtype, device):
    eps = torch.full((), 1e-30, dtype=dtype, device=device)  # a fill, no host→device copy

    def safe_denom(x):
        return torch.where(torch.abs(x) < eps, torch.where(x < 0, -eps, eps), x)
    return safe_denom


def _tol_sq(b_norm_sq, rtol, atol):
    return torch.clamp(rtol * torch.sqrt(b_norm_sq), min=atol) ** 2


def _result(x, it, rr, tol_sq) -> SolveResult:
    return SolveResult(x, it, bool(torch.all(rr <= tol_sq)), torch.sqrt(rr))


def cg(A: Callable, b: torch.Tensor, x0: torch.Tensor, rtol: float, atol: float, max_iter: int,
       M: Optional[Callable] = None, nb: int = 0) -> SolveResult:
    """Conjugate gradients for a symmetric (positive- or negative-definite) A.

    A(p) -> (A·p, ⟨p, A·p⟩ or None): the matvec, with its fused dot when the
    operator is homogeneous. M(r) -> (z, ⟨r, z⟩ or None): the preconditioner,
    with the dot of its last kernel where it has one. Stops when
    ⟨r, r⟩ ≤ tol² with tol = max(atol, rtol·‖b‖), or after max_iter
    iterations; with `nb` leading batch axes, per system (a converged system
    is frozen while the others go on)."""
    dtype = b.dtype
    safe_denom = _safe_denom_fn(dtype, b.device)
    b_norm_sq = _dot(b, b, nb)
    tol_sq = _tol_sq(b_norm_sq, rtol, atol)
    x = x0
    Ax, _ = A(x)
    r = b - Ax
    if M is not None:
        z, rz0 = M(r)
    else:
        z, rz0 = r, None
    p = z
    rz = rz0 if rz0 is not None else _dot(r, z, nb)
    rr = _dot(r, r, nb)
    it = 0
    while it < max_iter and bool(torch.any(rr > tol_sq)):
        Ap, pap = A(p)
        alpha = rz / safe_denom(pap if pap is not None else _dot(p, Ap, nb))
        # freeze a converged system: alpha → 0
        alpha = alpha * (rr > tol_sq).to(dtype)
        x = x + _bc(alpha, p, nb) * p
        r = r - _bc(alpha, Ap, nb) * Ap
        rr = _dot(r, r, nb)
        if M is not None:
            z, rz_f = M(r)
        else:
            z, rz_f = r, None
        rz_new = rz_f if rz_f is not None else _dot(r, z, nb)
        beta = rz_new / safe_denom(rz)
        p = z + _bc(beta, p, nb) * p
        rz = rz_new
        it += 1
    return _result(x, it, rr, tol_sq)


def cg_adaptive(A: Callable, b: torch.Tensor, x0: torch.Tensor, rtol: float, atol: float, max_iter: int,
                M: Optional[Callable] = None, nb: int = 0) -> SolveResult:
    """CG with the step taken from the current residual (JAX's
    `_cg_adaptive`, phiml's 'CG-adaptive'): α = ⟨d, r⟩ / ⟨d, A·d⟩ and each new
    direction re-conjugated against A·d, d ← M·r − β·d with
    β = ⟨M·r, A·d⟩ / ⟨d, A·d⟩. One matvec an iteration, as CG, and no
    recurrence of ⟨r, z⟩ to drift in float32. The callables are `cg`'s: the
    matvec's fused ⟨d, A·d⟩ is taken where it has one (K1's epilogue), the
    preconditioner's dot is not used. Stops as `cg` does."""
    dtype = b.dtype
    safe_denom = _safe_denom_fn(dtype, b.device)
    b_norm_sq = _dot(b, b, nb)
    tol_sq = _tol_sq(b_norm_sq, rtol, atol)
    x = x0
    r = b - A(x)[0]
    d = M(r)[0] if M is not None else r
    Ad, dAd = A(d)
    if dAd is None:
        dAd = _dot(d, Ad, nb)
    rr = _dot(r, r, nb)
    it = 0
    while it < max_iter and bool(torch.any(rr > tol_sq)):
        alpha = _dot(d, r, nb) / safe_denom(dAd)
        alpha = alpha * (rr > tol_sq).to(dtype)
        x = x + _bc(alpha, d, nb) * d
        r = r - _bc(alpha, Ad, nb) * Ad
        rr = _dot(r, r, nb)
        z = M(r)[0] if M is not None else r
        beta = _dot(z, Ad, nb) / safe_denom(dAd)
        d = z - _bc(beta, d, nb) * d
        Ad, dAd = A(d)
        if dAd is None:
            dAd = _dot(d, Ad, nb)
        it += 1
    return _result(x, it, rr, tol_sq)


def bicgstab(A: Callable, b: torch.Tensor, x0: torch.Tensor, rtol: float, atol: float, max_iter: int,
             M: Optional[Callable] = None, nb: int = 0) -> SolveResult:
    """BiCGStab for a general (nonsymmetric) A, right-preconditioned by M.

    A(p) -> (A·p, ignored) and M(r) -> (z, ignored): the callables `cg`
    takes. Stops when ⟨r, r⟩ ≤ tol² with tol = max(atol, rtol·‖b‖), or after
    max_iter iterations, per system; an iteration applies M and A twice each.

    The inner products accumulate in float64 (the JAX package's in the
    working precision): ρ = ⟨r̂, r⟩ shrinks by orders of magnitude over a
    solve, and float32 sums broke the recurrence down on the wake's pressure
    systems (`models/cylinder_wake.py`), where float64 sums converge."""
    dtype = b.dtype
    safe_denom = _safe_denom_fn(dtype, b.device)
    b_norm_sq = _dot64(b, b, nb)
    tol_sq = _tol_sq(b_norm_sq, rtol, atol)
    x = x0
    r = b - A(x)[0]
    r_hat = r
    rho = alpha = omega = torch.ones_like(b_norm_sq)
    v = torch.zeros_like(r)
    p = torch.zeros_like(r)
    rr = _dot64(r, r, nb)
    it = 0
    while it < max_iter and bool(torch.any(rr > tol_sq)):
        rho_new = _dot64(r_hat, r, nb)
        beta = (rho_new / safe_denom(rho)) * (alpha / safe_denom(omega))
        p = r + _bc(beta, r, nb) * (p - _bc(omega, r, nb) * v)
        ph = M(p)[0] if M is not None else p
        v = A(ph)[0]
        alpha = rho_new / safe_denom(_dot64(r_hat, v, nb))
        s = r - _bc(alpha, v, nb) * v
        sh = M(s)[0] if M is not None else s
        t = A(sh)[0]
        omega = _dot64(t, s, nb) / safe_denom(_dot64(t, t, nb))
        # freeze a converged system
        active = (rr > tol_sq).to(dtype)
        x = x + _bc(active, x, nb) * (_bc(alpha, ph, nb) * ph + _bc(omega, sh, nb) * sh)
        r = s - _bc(omega, t, nb) * t
        rr = _dot64(r, r, nb)
        rho = rho_new
        it += 1
    return _result(x, it, rr, tol_sq)


def bicgstab2(A: Callable, b: torch.Tensor, x0: torch.Tensor, rtol: float, atol: float, max_iter: int,
              M: Optional[Callable] = None, nb: int = 0) -> SolveResult:
    """BiCGStab(2), the Sleijpen–Fokkema ℓ = 2 method of JAX's `_bicgstab2`:
    each outer iteration takes two BiCG steps, then minimises
    ‖r₀ − γ₁r₁ − γ₂r₂‖ over a 2-D polynomial (the 2×2 normal equations), so
    stiff or indefinite systems where BiCGStab's linear ω-polynomial stalls
    converge. 4 matvecs and 4 applications of M an outer iteration: M is
    applied on the right, and the companions M·u and M·r are carried through
    the same (linear) recurrences. `iterations` counts matvecs / 2, as JAX's
    does, so it compares with a one-matvec-a-step count.

    Its inner products accumulate in float64, as `bicgstab`'s do: in float64
    arithmetic that changes nothing, and in float32 ρ and the MR system's
    entries lose their digits over a solve as BiCGStab's ρ does."""
    dtype = b.dtype
    safe_denom = _safe_denom_fn(dtype, b.device)

    def Mfn(v):
        return M(v)[0] if M is not None else v

    def comb(x, a, y):
        return x + _bc(a, y, nb) * y
    b_norm_sq = _dot64(b, b, nb)
    tol_sq = _tol_sq(b_norm_sq, rtol, atol)
    x = x0
    r0 = b - A(x)[0]
    r_hat = r0
    ones = torch.ones_like(b_norm_sq)
    rho, alpha, omega = -ones, torch.zeros_like(ones), ones  # ρ₀ pre-negated: the loop starts with ρ ← −ω·ρ
    u0 = torch.zeros_like(r0)
    mr0 = Mfn(r0)
    mu0 = torch.zeros_like(r0)
    rr = _dot64(r0, r0, nb)
    it = 0
    while it < max_iter and bool(torch.any(rr > tol_sq)):
        active = (rr > tol_sq).to(dtype)
        rho = -omega * rho
        # the even BiCG step
        rho1 = _dot64(r0, r_hat, nb)
        beta = alpha * rho1 / safe_denom(rho)
        rho = rho1
        u0 = comb(r0, -beta, u0)
        mu0 = comb(mr0, -beta, mu0)
        u1 = A(mu0)[0]
        mu1 = Mfn(u1)
        alpha = rho / safe_denom(_dot64(u1, r_hat, nb)) * active
        r0 = comb(r0, -alpha, u1)
        mr0 = comb(mr0, -alpha, mu1)
        r1 = A(mr0)[0]
        mr1 = Mfn(r1)
        x = comb(x, alpha, mu0)
        # the odd BiCG step
        rho1 = _dot64(r1, r_hat, nb)
        beta = alpha * rho1 / safe_denom(rho)
        rho = rho1
        u0 = comb(r0, -beta, u0)
        mu0 = comb(mr0, -beta, mu0)
        u1 = comb(r1, -beta, u1)
        mu1 = comb(mr1, -beta, mu1)
        u2 = A(mu1)[0]
        mu2 = Mfn(u2)
        alpha = rho / safe_denom(_dot64(u2, r_hat, nb)) * active
        r0 = comb(r0, -alpha, u1)
        mr0 = comb(mr0, -alpha, mu1)
        r1 = comb(r1, -alpha, u2)
        mr1 = comb(mr1, -alpha, mu2)
        r2 = A(mr1)[0]
        mr2 = Mfn(r2)
        x = comb(x, alpha, mu0)
        # the minimal-residual part
        s11, s12, s22 = _dot64(r1, r1, nb), _dot64(r1, r2, nb), _dot64(r2, r2, nb)
        t1, t2 = _dot64(r1, r0, nb), _dot64(r2, r0, nb)
        det = safe_denom(s11 * s22 - s12 * s12)
        g1 = (s22 * t1 - s12 * t2) / det * active
        g2 = (s11 * t2 - s12 * t1) / det * active
        x = comb(comb(x, g1, mr0), g2, mr1)
        r0 = comb(comb(r0, -g1, r1), -g2, r2)
        mr0 = comb(comb(mr0, -g1, mr1), -g2, mr2)
        u0 = comb(comb(u0, -g1, u1), -g2, u2)
        mu0 = comb(comb(mu0, -g1, mu1), -g2, mu2)
        omega = g2
        rr = _dot64(r0, r0, nb)
        it += 2
    return _result(x, it, rr, tol_sq)


class Direct:
    """The dense direct solve of JAX's `_direct`: the matrix of A built by
    `matrix(A, b, nb)` — (N, N), or (B, N, N) with one batch axis — with the
    outer product ones/n added for a rank-deficient system (the constants'
    null space regularised), then `torch.linalg.solve`. JAX solves with
    `jnp.linalg.solve`, outside any Pallas kernel. Takes the Krylov
    solvers' arguments and ignores tolerances and preconditioner;
    `iterations` is N, as in JAX. `transposed` solves with Aᵀ: the adjoint."""

    def __init__(self, matrix: Callable, rank_deficient: bool = False, transposed: bool = False):
        self.matrix = matrix
        self.rank_deficient = rank_deficient
        self.transposed = transposed

    @property
    def adjoint(self) -> 'Direct':
        return Direct(self.matrix, self.rank_deficient, not self.transposed)

    def __call__(self, A, b, x0, rtol, atol, max_iter, M=None, nb=0) -> SolveResult:
        mat = self.matrix(A, b, nb)
        if self.transposed:
            mat = mat.transpose(-1, -2)
        n = mat.shape[-1]
        if self.rank_deficient:
            mat = mat + torch.full((n, n), 1. / (n * n), dtype=mat.dtype, device=mat.device)
        rhs = b.reshape(b.shape[:nb] + (-1, 1))
        x = torch.linalg.solve(mat, rhs).reshape(b.shape)
        return SolveResult(x, n, True, torch.zeros(b.shape[:nb], dtype=b.dtype, device=b.device))


# ---------------------------------------------------------------------------
# implicit differentiation
# ---------------------------------------------------------------------------

class _Spec(NamedTuple):
    krylov: Callable
    A: Callable
    M: Optional[Callable]
    x0: torch.Tensor
    tolerances: tuple          # (rel_tol, abs_tol, max_iter) of the forward solve
    adjoint_tolerances: tuple  # the same of the adjoint solve
    rank_deficient: bool
    null_space: Optional[torch.Tensor]  # of a rank-deficient A; None: the constants
    active: Optional[torch.Tensor]      # 0 on identity rows that no result depends on
    params: tuple              # the tensors A depends on that require grad
    param_matvec: Callable
    implicit_diff: bool
    on_adjoint: Optional[Callable]
    box: dict                  # receives the forward's SolveResult
    nb: int                    # leading batch axes: systems solved in one loop, each with its own stop


SELF_ADJOINT = (cg, cg_adaptive)  # solvers of symmetric systems: the adjoint solve takes A itself


def _transpose(A: Callable) -> Callable:
    """Aᵀ of a linear A(x) -> (A·x, ·) as its VJP, one graph a product."""
    def AT(v):
        with torch.enable_grad():
            x = torch.zeros_like(v, requires_grad=True)
            return torch.autograd.grad(A(x)[0], x, v)[0], None
    return AT


class _ImplicitSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec: _Spec, b, *params):
        result = spec.krylov(spec.A, b, spec.x0, *spec.tolerances, spec.M, nb=spec.nb)
        x = sub_mean(result.x, spec.nb) if spec.rank_deficient else result.x
        spec.box['result'] = result._replace(x=x)
        ctx.spec = spec
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        spec: _Spec = ctx.spec
        if not spec.implicit_diff:
            raise RuntimeError("this solve ran with Solve(implicit_diff=False): it is forward-only and has no "
                               "gradient, as in the JAX package")
        x, = ctx.saved_tensors
        g = g.contiguous()
        if spec.active is not None:  # Aᵀ's identity rows differ from A's; only the active block reaches b
            g = g * spec.active
        if spec.rank_deficient:  # ḡ onto A's range: its null-space component meets no x
            n = spec.null_space
            g = sub_mean(g, spec.nb) if n is None else g - n * (_dot64(n, g) / _dot64(n, n))
        krylov, A_adj = spec.krylov, spec.A
        if isinstance(krylov, Direct):
            krylov = krylov.adjoint
        elif krylov not in SELF_ADJOINT:
            A_adj = _transpose(spec.A)
        adjoint = krylov(A_adj, g, torch.zeros_like(g), *spec.adjoint_tolerances, spec.M, nb=spec.nb)
        lam = sub_mean(adjoint.x, spec.nb) if spec.rank_deficient else adjoint.x
        if spec.on_adjoint is not None:
            spec.on_adjoint(adjoint._replace(x=lam))
        needs = ctx.needs_input_grad[2:]
        grads = [None] * len(needs)
        if any(needs):
            theta = [t for t, need in zip(spec.params, needs) if need]
            with torch.enable_grad():  # θ̄ = −VJP_θ(A(x; θ))[λ]
                g_theta = iter(torch.autograd.grad(spec.param_matvec(x.detach()), theta, -lam, allow_unused=True))
            grads = [next(g_theta) if need else None for need in needs]
        return (None, lam, *grads)


def implicit_solve(krylov: Callable, A: Callable, b: torch.Tensor, x0: torch.Tensor, rel_tol: float, abs_tol: float,
                   max_iter: int, M: Optional[Callable] = None, rank_deficient: bool = False,
                   null_space: Optional[torch.Tensor] = None, active: Optional[torch.Tensor] = None, params=(),
                   param_matvec: Optional[Callable] = None, adjoint_tolerances: Optional[tuple] = None,
                   implicit_diff: bool = True, on_adjoint: Optional[Callable] = None, nb: int = 0) -> SolveResult:
    """`krylov` (a solver of this module or a `Direct`) on A·x = b,
    differentiable implicitly in b and in `params`, the tensors A depends
    on; `nb` leading batch axes hold independent systems.

    With `rank_deficient` the result (and the adjoint λ) lose their mean,
    and the adjoint's right-hand side is projected onto A's range: the
    constants removed, or the component along `null_space` (a masked
    system's active cells). A masked system's `active` (0 on its identity
    rows, whose right-hand side is 0 and whose solution feeds nothing): Aᵀ
    couples those rows to the active block where A does not, and the active
    block of λ, the only part a gradient needs, solves A's own active block
    once ḡ is zeroed there. `param_matvec(x)` is the part of A·x that
    depends on `params`, evaluated under grad in the backward (default:
    A(x)[0]). `adjoint_tolerances`
    (rel_tol, abs_tol, max_iter) of the adjoint solve default to the
    forward's; `on_adjoint(result)` receives its SolveResult. Returns the
    forward's SolveResult with x on the autograd graph where b or a param
    requires grad."""
    params = [t for t in params if isinstance(t, torch.Tensor) and t.requires_grad]
    x0 = x0.detach()
    tolerances = (rel_tol, abs_tol, max_iter)
    if not (torch.is_grad_enabled() and (b.requires_grad or params)):
        result = krylov(A, b, x0, *tolerances, M, nb=nb)
        return result._replace(x=sub_mean(result.x, nb)) if rank_deficient else result
    spec = _Spec(krylov, A, M, x0, tolerances, adjoint_tolerances or tolerances, rank_deficient, null_space, active,
                 tuple(params), param_matvec or (lambda x: A(x)[0]), implicit_diff, on_adjoint, {}, nb)
    x = _ImplicitSolve.apply(spec, b, *params)
    return spec.box['result']._replace(x=x)


def grad_tensors(*objects) -> list:
    """The torch tensors that require grad inside `objects`: tensors, this
    package's Tensors, Fields, geometries and extrapolations, sequences and
    dicts of them, and the closure of a function or a `LinearFunction`."""
    found, seen = [], set()

    def walk(obj, depth):
        if depth > 8 or id(obj) in seen:
            return
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            if obj.requires_grad:
                found.append(obj)
        elif isinstance(obj, (list, tuple, set)):
            for o in obj:
                walk(o, depth + 1)
        elif isinstance(obj, dict):
            for o in obj.values():
                walk(o, depth + 1)
        elif isinstance(obj, TensorStack):
            walk(obj.components, depth + 1)
        elif isinstance(obj, Tensor):
            walk(obj.native(), depth + 1)
        elif callable(obj) and hasattr(obj, '__code__'):
            for cell in obj.__closure__ or ():
                try:
                    walk(cell.cell_contents, depth + 1)
                except ValueError:  # an empty cell
                    pass
        elif hasattr(obj, '__self__') and hasattr(obj, '__func__'):
            walk(obj.__self__, depth + 1)
        elif type(obj).__module__.startswith(__name__.split('.')[0]) and hasattr(obj, '__dict__'):
            for o in vars(obj).values():
                walk(o, depth + 1)

    for o in objects:
        walk(o, 0)
    return found


# ---------------------------------------------------------------------------
# the solve specification of the Field layer
# ---------------------------------------------------------------------------

class Solve:
    """A linear solve: method, tolerances, initial guess `x0` (a Field or
    Tensor), iteration limit, exceptions to suppress, preprocessing of the
    right-hand side, rank deficiency and preconditioner — the JAX package's
    arguments."""

    def __init__(self, method: str = 'auto', rel_tol: float = None, abs_tol: float = None,
                 x0=None, max_iterations: int = 1000, suppress: tuple = (),
                 preprocessing=None, preprocessing_args: tuple = (), rank_deficiency: int = None,
                 preconditioner=None, gradient_solve: 'Solve' = None, implicit_diff: bool = True):
        self.method = method
        self.rel_tol = rel_tol
        self.abs_tol = abs_tol
        self.x0 = x0
        self.max_iterations = max_iterations
        self.suppress = tuple(suppress)
        self.preprocessing = preprocessing
        self.preprocessing_args = preprocessing_args
        self.rank_deficiency = rank_deficiency
        self.preconditioner = preconditioner
        self._gradient_solve = gradient_solve
        self.implicit_diff = implicit_diff

    @property
    def gradient_solve(self) -> 'Solve':
        return self._gradient_solve if self._gradient_solve is not None else self

    def with_preprocessing(self, preprocessing: Callable, *args) -> 'Solve':
        return copy_solve(self, preprocessing=preprocessing, preprocessing_args=args)

    def with_defaults(self, mode: str) -> 'Solve':
        rel = self.rel_tol if self.rel_tol is not None else (1e-5 if mode == 'solve' else 1e-3)
        abs_ = self.abs_tol if self.abs_tol is not None else 1e-5
        return copy_solve(self, rel_tol=rel, abs_tol=abs_)

    def __repr__(self):
        return (f"Solve('{self.method}', rel_tol={self.rel_tol}, abs_tol={self.abs_tol}, "
                f"max_iterations={self.max_iterations})")

    def __attrs__(self):
        return dict(method=self.method, rel_tol=self.rel_tol, abs_tol=self.abs_tol, x0=self.x0,
                    max_iterations=self.max_iterations, suppress=self.suppress,
                    preprocessing=self.preprocessing, preprocessing_args=self.preprocessing_args,
                    rank_deficiency=self.rank_deficiency, preconditioner=self.preconditioner,
                    gradient_solve=self._gradient_solve, implicit_diff=self.implicit_diff)


def copy_solve(solve: Solve, **updates) -> Solve:
    kw = solve.__attrs__()
    kw.update(updates)
    return Solve(**kw)


class SolveInfo:
    """Diagnostics of a solve. `iterations` is the solver's iteration count;
    `residual` is ‖r‖ of the recurrence's last residual, one per system (not
    recomputed after the loop: that would cost one more matvec)."""

    def __init__(self, solve: Solve, x, residual, iterations, function_evaluations, converged, diverged, method,
                 msg="", runtime_stats: Optional[dict] = None):
        self.solve = solve
        self.x = x
        self.residual = residual
        self.iterations = iterations
        self.function_evaluations = function_evaluations
        self.converged = converged
        self.diverged = diverged
        self.method = method
        self.msg = msg
        self.runtime_stats = runtime_stats if runtime_stats is not None else {}

    def __repr__(self):
        return (f"SolveInfo({self.method}: iterations={self.iterations}, converged={self.converged}, "
                f"diverged={self.diverged})")


_SOLVE_TAPES: list = []


class SolveTape:
    """Records the `SolveInfo` of every solve within its context."""

    def __init__(self, *solves: Solve, record_trajectories=False, record_runtime=False):
        self.solves = solves
        self.record_trajectories = record_trajectories
        self.record_runtime = record_runtime
        self.solve_infos: list = []

    def __enter__(self):
        _SOLVE_TAPES.append(self)
        return self

    def __exit__(self, *args):
        _SOLVE_TAPES.remove(self)

    def __getitem__(self, item) -> SolveInfo:
        if isinstance(item, Solve):
            for info in self.solve_infos:
                if info.solve is item:
                    return info
            raise KeyError(item)
        return self.solve_infos[item]

    def __iter__(self):
        return iter(self.solve_infos)

    def __len__(self):
        return len(self.solve_infos)


def record(info: SolveInfo):
    """Append `info` to every active `SolveTape`."""
    for tape in _SOLVE_TAPES:
        tape.solve_infos.append(info)


CG_METHODS = ('auto', 'CG', 'CG-native')
BICGSTAB_METHODS = ('biCG-stab', 'biCG', 'biCG-stab(1)')
DIRECT_METHODS = ('direct', 'scipy-direct')
PRECONDITIONED_METHODS = CG_METHODS + ('CG-adaptive',)  # the methods a projection preconditions by default


def krylov_of(method: str) -> Optional[Callable]:
    """The solver of `method`, in the JAX package's dispatch (`:730-757`):
    None for a direct solve; CG, with JAX's warning, for a name it does not
    know."""
    if method in CG_METHODS:
        return cg
    if method == 'CG-adaptive':
        return cg_adaptive
    if method in BICGSTAB_METHODS:
        return bicgstab
    if method == 'biCG-stab(2)':
        return bicgstab2
    if method in DIRECT_METHODS:
        return None
    warnings.warn(f"unknown solve method {method!r}; falling back to CG")
    return cg


def reroute_direct(solve: Solve, n_unknowns: int) -> Optional[Solve]:
    """A direct solve above `DIRECT_MAX_UNKNOWNS` unknowns as JAX reroutes
    it: BiCGStab at tolerances of at most 1e-6, with a warning; None when
    the dense matrix is built."""
    if n_unknowns <= DIRECT_MAX_UNKNOWNS:
        return None
    warnings.warn(f"'{solve.method}' with {n_unknowns} unknowns would materialize a dense "
                  f"{n_unknowns}x{n_unknowns} matrix; using BiCGStab instead")
    return copy_solve(solve, method='biCG-stab', rel_tol=min(solve.rel_tol or 1e-5, 1e-6),
                      abs_tol=min(solve.abs_tol or 1e-5, 1e-6))


def _taped_solve(solve: Solve) -> Solve:
    """`solve` as a `SolveInfo` keeps it: a copy with x0 detached where x0
    carries an autograd graph (a differentiated step's previous pressure),
    which a tape would otherwise keep alive with all its tensors; else
    `solve` itself, which `SolveTape[solve]` finds."""
    from ._functional import _detached, _flatten
    natives, _ = _flatten(solve.x0)
    if any(isinstance(n, torch.Tensor) and n.requires_grad for n in natives):
        return copy_solve(solve, x0=_detached(solve.x0))
    return solve


def _kind(method: str) -> tuple:
    """(name, matvecs an iteration) of the solver that runs `method`."""
    if method in BICGSTAB_METHODS:
        return 'BiCGStab', 2
    if method == 'biCG-stab(2)':
        return 'BiCGStab(2)', 2
    if method == 'CG-adaptive':
        return 'CG-adaptive', 1
    if method in DIRECT_METHODS:
        return 'direct', 1
    return 'CG', 1


def finish_solve(solve: Solve, x, result: SolveResult, residual=None) -> SolveInfo:
    """Record the `SolveInfo` of a finished solve on every active
    `SolveTape` and raise `Diverged` / `NotConverged` unless `solve`
    suppresses them. A non-finite ⟨r, r⟩ stops the loop early, unconverged:
    that is a divergence. The info holds x and the solve's x0 detached: a
    differentiated solve's would keep its autograd graph alive as long as
    the tape. `residual`: ‖r‖ as the info shows it (default: the result's)."""
    from ._functional import _detached
    diverged = not result.converged and result.iterations < solve.max_iterations
    kind, matvecs = _kind(solve.method)
    residual = residual if residual is not None else result.residual
    info = SolveInfo(_taped_solve(solve), _detached(x), residual, result.iterations, matvecs * result.iterations + 1,
                     result.converged, diverged, solve.method,
                     msg=f"{result.iterations} {kind} iterations, converged={result.converged}")
    record(info)
    suppressed = ConvergenceException in solve.suppress
    if diverged and Diverged not in solve.suppress and not suppressed:
        raise Diverged(info)
    if not result.converged and not diverged and NotConverged not in solve.suppress and not suppressed:
        raise NotConverged(info)
    return info


def record_adjoint(solve: Solve, result: SolveResult) -> SolveInfo:
    """Record the adjoint solve of a backward on every active `SolveTape`
    (a SolveInfo whose `msg` starts with 'adjoint'); never raises: a
    backward that did not converge returns its last iterate, as JAX's does."""
    kind, matvecs = _kind(solve.method)
    info = SolveInfo(_taped_solve(solve), result.x, result.residual, result.iterations,
                     matvecs * result.iterations + 1, result.converged, False, solve.method,
                     msg=f"adjoint: {result.iterations} {kind} iterations, converged={result.converged}")
    record(info)
    return info


# ---------------------------------------------------------------------------
# flattening: Field / Tensor / tuple ⇄ one (batch, N) torch array
# ---------------------------------------------------------------------------

def _is_field(x) -> bool:
    return hasattr(x, 'values') and hasattr(x, 'geometry')


def _tensor_leaves(state) -> list:
    """The Tensors of `state` in the JAX package's order: a TensorStack's
    components, a Field's values, the entries of tuples, lists and dicts;
    None is skipped, anything else wrapped."""
    from ._tensor import wrap
    result = []

    def visit(x):
        if isinstance(x, TensorStack):
            result.extend(x.components)
        elif isinstance(x, Tensor):
            result.append(x)
        elif _is_field(x):
            visit(x.values)
        elif isinstance(x, (tuple, list)):
            for i in x:
                visit(i)
        elif isinstance(x, dict):
            for i in x.values():
                visit(i)
        elif x is not None:
            result.append(wrap(x))
    visit(state)
    return result


def _rebuild_from_tensors(template, tensors: list):
    """`template` with its leaves (`_tensor_leaves`) replaced by `tensors`, in order."""
    tensors = list(tensors)

    def rebuild(x):
        if isinstance(x, TensorStack):
            return TensorStack([tensors.pop(0) for _ in x.components], x.stack_dim)
        if isinstance(x, Tensor):
            return tensors.pop(0)
        if _is_field(x):
            return x.with_values(rebuild(x.values))
        if isinstance(x, tuple):
            return tuple(rebuild(i) for i in x)
        if isinstance(x, list):
            return [rebuild(i) for i in x]
        if isinstance(x, dict):
            return {k: rebuild(v) for k, v in x.items()}
        return None if x is None else tensors.pop(0)
    return rebuild(template)


def _batch_shape_of(state):
    from ._shape import EMPTY_SHAPE, merge_shapes
    shapes = [t.shape.batch for t in _tensor_leaves(state)]
    return merge_shapes(*shapes) if shapes else EMPTY_SHAPE


class _VecFormat:
    """The layout of the JAX package's `_VecFormat` (`:198-312`): a state
    (Field, Tensor, TensorStack, tuple) as one (batch volume, N) array, its
    leaves in `_tensor_leaves` order, each leaf's non-batch entries in the
    template leaf's dim order, concatenated. A staggered grid's components
    follow one another; the L-BFGS history and the Krylov vectors live in
    this layout. Host leaves move to the default device."""

    def __init__(self, template, batch_shape=None):
        self.template = template
        self.leaves = _tensor_leaves(template)
        self.batch_shape = batch_shape if batch_shape is not None else _batch_shape_of(template)

    def flatten(self, state) -> torch.Tensor:
        """The state as a (batch volume, N) torch array."""
        from ._tensor import to_torch
        b = self.batch_shape
        leaves = _tensor_leaves(state)
        templates = self.leaves if len(self.leaves) == len(leaves) else leaves
        parts = []
        for t, like in zip(leaves, templates):
            order = b.names + like.shape.without(b.names).names
            n = to_torch(t.native(order))
            n = n.expand(tuple(b.sizes) + tuple(n.shape[len(b.names):]))
            parts.append(n.reshape((max(b.volume, 1) if b else 1, -1)))
        if not parts:
            raise ValueError(f"no tensors in {type(state).__name__}")
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)

    def unflatten(self, vec: torch.Tensor):
        """A (batch volume, N) array as a state of the template's structure."""
        from ._shape import concat_shapes
        b = self.batch_shape
        out, offset = [], 0
        for t in self.leaves:
            rest = t.shape.without(b.names)
            size = rest.volume if rest else 1
            native = vec[:, offset:offset + size].reshape(tuple(b.sizes) + tuple(rest.sizes))
            offset += size
            out.append(Tensor(native, concat_shapes(b, rest)))
        return _rebuild_from_tensors(self.template, out)


def solve_linear(f, y, solve: Solve, *f_args, grad_for_f=False, f_kwargs: dict = None,
                 assume_homogeneous: bool = False, **f_kwargs_additional):
    """Solve ``f(x, *f_args) = y`` for x by the solve's method (`krylov_of`),
    on a Field or Tensor unknown.

    `f` is a `LinearFunction` or a plain linear (or affine) callable; unless
    ``assume_homogeneous``, its offset f(0) is subtracted. The preprocessing,
    the rank deficiency (the mean removed from the right-hand side, every
    preconditioner output and the result) and a callable preconditioner of
    `solve` apply as in the JAX package; any other preconditioner is
    ignored. The systems along the batch dims of x0 and y are solved one by
    one. The solve is differentiable implicitly (`implicit_solve`) in `y`
    and in the tensors that `f`'s arguments and closure hold; its adjoint
    takes `solve.gradient_solve`'s tolerances."""
    from ._shape import batch, merge_shapes
    f_kwargs = dict(f_kwargs or {})
    f_kwargs.update(f_kwargs_additional)
    solve = solve.with_defaults('solve')
    x0 = solve.x0 if solve.x0 is not None else (y * 0)
    fn = f.f if isinstance(f, LinearFunction) else f
    if not callable(fn):
        raise NotImplementedError(f"solve_linear with a matrix ({type(f)}); pass a callable")

    def op(x):
        return fn(x, *f_args, **f_kwargs)

    if solve.preprocessing is not None:
        y = solve.preprocessing(y, *solve.preprocessing_args)
    shared_batch = merge_shapes(_batch_shape_of(x0), _batch_shape_of(y))
    x_format = _VecFormat(x0, shared_batch)
    # y in x's dims order where their leaves pair up (a square system's vectors share one layout)
    y_format = x_format if len(_tensor_leaves(y)) == len(x_format.leaves) else _VecFormat(y, shared_batch)
    x0_flat = x_format.flatten(x0)
    n_systems = x0_flat.shape[0]
    nb = 1 if n_systems > 1 else 0  # one system: a flat vector, as before batching existed

    def formats(columns: int):
        """x's and y's formats with `columns` more systems along a batch dim of their own (the direct solve)."""
        if not columns:
            return x_format, y_format
        cols = batch(_direct_column=columns)
        fx = _VecFormat(x0, cols & shared_batch)
        return fx, (fx if y_format is x_format else _VecFormat(y, cols & shared_batch))

    def matvec(columns: int = 0):
        fx, fy = formats(columns)
        shape = ((columns,) if columns else ()) + tuple(x0_flat.shape)

        def apply(x):
            return fy.flatten(op(fx.unflatten(x.reshape((-1, x0_flat.shape[-1]))))).reshape(shape[:-1] + (-1,))
        return apply

    def to_solver(v):  # (systems, N) → the solver's layout
        return v if nb else v.reshape(-1)

    plain = matvec()
    rhs = to_solver(y_format.flatten(y))
    x0_n = to_solver(x0_flat)
    b0 = None if assume_homogeneous else to_solver(plain(torch.zeros_like(x0_flat)))
    if b0 is not None:
        rhs = rhs - b0

    def A(x):
        fx = to_solver(plain(x.reshape(x0_flat.shape)))
        return (fx if b0 is None else fx - b0), None

    rank_def = solve.rank_deficiency or 0
    if rank_def:
        rhs = sub_mean(rhs, nb)
    M = None
    if callable(solve.preconditioner):
        def M(r):
            z = to_solver(x_format.flatten(solve.preconditioner(x_format.unflatten(r.reshape(x0_flat.shape)))))
            return (sub_mean(z, nb) if rank_def else z), None

    def param_matvec(x):  # the θ-dependent A·x of the backward: f(x) − f(0)
        fx = to_solver(plain(x.reshape(x0_flat.shape)))
        return fx if assume_homogeneous else fx - to_solver(plain(torch.zeros_like(x0_flat)))

    krylov = krylov_of(solve.method)
    if krylov is None:
        rerouted = reroute_direct(solve, x0_flat.shape[-1])
        if rerouted is not None:
            solve, krylov = rerouted, bicgstab
        else:
            def matrix(A_, b, nb_):  # A applied to the identity's columns as one batch of systems
                n = x0_flat.shape[-1]
                eye = torch.eye(n, dtype=b.dtype, device=b.device)
                cols = matvec(n)(eye.unsqueeze(1).expand(n, n_systems, n).contiguous())  # (column, system, N)
                if b0 is not None:
                    cols = cols - b0.reshape(1, n_systems, -1)
                cols = cols.permute(1, 2, 0)  # (system, row, column)
                return cols if nb_ else cols[0]
            krylov = Direct(matrix, bool(rank_def))
    grad_solve = solve.gradient_solve.with_defaults('solve')
    result = implicit_solve(krylov, A, rhs, x0_n, solve.rel_tol, solve.abs_tol, solve.max_iterations, M,
                            rank_deficient=bool(rank_def), params=grad_tensors(fn, f_args, f_kwargs),
                            param_matvec=param_matvec,
                            adjoint_tolerances=(grad_solve.rel_tol, grad_solve.abs_tol, grad_solve.max_iterations),
                            implicit_diff=solve.implicit_diff, on_adjoint=lambda r: record_adjoint(grad_solve, r),
                            nb=nb)
    x_state = x_format.unflatten(result.x.reshape(x0_flat.shape))
    residual = Tensor(result.residual.reshape(tuple(shared_batch.sizes)), shared_batch)
    finish_solve(solve, x_state, result, residual)
    return x_state

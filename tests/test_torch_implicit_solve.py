"""Implicit differentiation of the port's solves (`math/_solve.py::
implicit_solve`, `solve_linear`, the projections of `physics/fluid.py`)
against the JAX package's `jax.lax.custom_linear_solve` on the same numpy
inputs, on the CPU: the gradient with respect to the right-hand side and to
an argument of the operator, a rank-deficient (periodic) system, BiCGStab's
transpose, and `make_incompressible` in 2D and 3D, closed and periodic, with
obstacles (both masked preconditioners) and with active cells.

Tolerances: 1e-4 of the gradient's largest entry (both sides converge their
forward and adjoint solves to 1e-6; the rest is the Krylov iterates' float32
rounding), finite differences within 5%.

A projection's loss weights the pressure with a weight of mean 0 over the
accessible cells (and 0 in an obstacle): for any other cotangent the JAX
package's adjoint CG on the singular system starts from a right-hand side
outside the operator's range and stalls there (its gradient is wrong),
while the port projects the right-hand side onto the range first; the
gradient of the pressure's null-space component is 0 either way."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.field import CenteredGrid as JCenteredGrid
from phiflow_tpu.math import Tensor as JTensor
from phiflow_tpu.physics import fluid as jax_fluid
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.math import Solve, SolveTape
from phiflow_tpu_torch.field import cell_grid, face_layout, geometry_mask
from phiflow_tpu_torch.geom import union
from phiflow_tpu_torch.physics import fluid

from test_torch_obstacles import _jax_staggered, _obstacles, _random_velocity, ORDER

TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), (np.abs(got - ref).max(), np.abs(ref).max())


def _lap(m, x, ext):
    lo, up = m.shift(x, (-1, 1), 'x', ext, stack_dim=None)
    return 2 * x - lo - up


def _kappa_op(m):
    """−div(κ∇x) in 1D: κ on the faces i+½, x = 0 past the upper end, no flux
    through the lower one; symmetric positive definite for κ > 0."""
    def op(x, kappa):
        _, up = m.shift(x, (-1, 1), 'x', m.extrapolation.ZERO, stack_dim=None)
        flux = kappa * (up - x)
        lo_flux, _ = m.shift(flux, (-1, 1), 'x', m.extrapolation.ZERO, stack_dim=None)
        return lo_flux - flux
    return op


def _advection_diffusion(m):
    """A nonsymmetric 1D operator: diffusion plus a centred advection term."""
    def op(x, c):
        lo, up = m.shift(x, (-1, 1), 'x', m.extrapolation.ZERO, stack_dim=None)
        return 2 * x - lo - up + c * (up - lo)
    return op


def test_gradient_through_solve():
    """The JAX suite's `test_gradient_through_solve`: Σx² of a Dirichlet
    solve, its gradient in the right-hand side."""
    rhs = np.random.default_rng(0).standard_normal(16).astype(np.float32)

    def loss(m):
        def f(r):
            x = m.solve_linear(lambda v: _lap(m, v, m.extrapolation.ZERO), r, m.Solve('CG', 1e-6, 1e-6))
            return m.sum(x ** 2)
        return f

    jval, jgrad = jm.gradient(loss(jm), wrt=0, get_output=True)(jm.tensor(rhs, jm.spatial('x')))
    val, grad = tm.gradient(loss(tm), wrt=0, get_output=True)(tm.tensor(rhs, tm.spatial('x')))
    _close(grad.numpy(), np.asarray(jgrad.native()))
    assert abs(float(val) - float(jval)) <= 1e-4 * abs(float(jval))
    eps, e3 = 1e-2, np.eye(16, dtype=np.float32)[3]
    f = loss(tm)
    fd = (float(f(tm.tensor(rhs + eps * e3, tm.spatial('x')))) - float(f(tm.tensor(rhs - eps * e3, tm.spatial('x'))))) / (2 * eps)
    assert abs(fd - float(grad.numpy()[3])) <= 0.05 * abs(fd)


def test_gradient_with_respect_to_an_operator_argument():
    """θ̄ = −VJP_θ(A(x; θ))[λ]: the conductivity κ of −div(κ∇x), and the
    right-hand side, in one gradient."""
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal(12).astype(np.float32)
    kappa = rng.uniform(0.5, 2.0, 12).astype(np.float32)
    w = rng.standard_normal(12).astype(np.float32)

    def loss(m):
        def f(r, k):
            x = m.solve_linear(_kappa_op(m), r, m.Solve('CG', 1e-6, 1e-6), k)
            return m.sum(x * m.tensor(w, m.spatial('x')) + x ** 2)
        return f

    jg = jm.gradient(loss(jm), wrt=[0, 1], get_output=False)(jm.tensor(rhs, jm.spatial('x')),
                                                            jm.tensor(kappa, jm.spatial('x')))
    g = tm.gradient(loss(tm), wrt=[0, 1], get_output=False)(tm.tensor(rhs, tm.spatial('x')),
                                                           tm.tensor(kappa, tm.spatial('x')))
    for got, ref in zip(g, jg):
        _close(got.numpy(), np.asarray(ref.native()))


def test_rank_deficient_periodic_system():
    """A periodic Laplacian with rank deficiency 1: the result and λ lose
    their mean."""
    rng = np.random.default_rng(2)
    rhs = rng.standard_normal(16).astype(np.float32)
    rhs -= rhs.mean()
    w = rng.standard_normal(16).astype(np.float32)
    w -= w.mean()

    def loss(m):
        def f(r):
            x = m.solve_linear(lambda v: _lap(m, v, m.extrapolation.PERIODIC), r,
                               m.Solve('CG', 1e-6, 1e-6, rank_deficiency=1))
            return m.sum(x * m.tensor(w, m.spatial('x')) + 0.1 * x ** 2)
        return f

    jg = jm.gradient(loss(jm), get_output=False)(jm.tensor(rhs, jm.spatial('x')))
    g = tm.gradient(loss(tm), get_output=False)(tm.tensor(rhs, tm.spatial('x')))
    _close(g.numpy(), np.asarray(jg.native()))
    assert abs(float(g.numpy().mean())) < 1e-5


def test_bicgstab_transpose_of_a_nonsymmetric_operator():
    """BiCGStab's adjoint solves Aᵀλ = ḡ with Aᵀ the VJP of the linear map;
    the gradient reaches the right-hand side and the advection speed."""
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal(14).astype(np.float32)
    w = rng.standard_normal(14).astype(np.float32)

    def loss(m):
        def f(r, c):
            x = m.solve_linear(_advection_diffusion(m), r, m.Solve('biCG-stab', 1e-6, 1e-6), c)
            return m.sum(x * m.tensor(w, m.spatial('x')))
        return f

    speed = np.float32(0.4)
    jg = jm.gradient(loss(jm), wrt=[0, 1], get_output=False)(jm.tensor(rhs, jm.spatial('x')), jm.wrap(speed))
    g = tm.gradient(loss(tm), wrt=[0, 1], get_output=False)(tm.tensor(rhs, tm.spatial('x')), tm.wrap(speed))
    _close(g[0].numpy(), np.asarray(jg[0].native()))
    _close(g[1].numpy(), np.asarray(jg[1].native()))


def test_forward_only_solve_raises_when_differentiated():
    r = torch.randn(10, requires_grad=True)
    x = tm.solve_linear(lambda v: _lap(tm, v, tm.extrapolation.ZERO), tm.wrap(r, tm.spatial('x')),
                        Solve('CG', 1e-6, 1e-6, implicit_diff=False))
    with pytest.raises(RuntimeError, match='implicit_diff=False'):
        (x.torch() ** 2).sum().backward()


def _graph_nodes(t: torch.Tensor) -> int:
    seen, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return len(seen)


def test_backward_runs_one_adjoint_solve_and_keeps_no_iterations():
    """One adjoint SolveInfo a backward; the graph's size does not depend on
    the number of CG iterations."""
    rng = np.random.default_rng(4)
    sizes = []
    for tol in (1e-2, 1e-6):
        r = torch.tensor(rng.standard_normal(32).astype(np.float32), requires_grad=True)
        with SolveTape() as forward:
            x = tm.solve_linear(lambda v: _lap(tm, v, tm.extrapolation.ZERO), tm.wrap(r, tm.spatial('x')),
                                Solve('CG', tol, tol))
        sizes.append((_graph_nodes(x.torch()), forward[0].iterations))
        with SolveTape() as backward:
            (x.torch() ** 2).sum().backward()
        adjoint = [i for i in backward if i.msg.startswith('adjoint')]
        assert len(backward.solve_infos) == 1 and len(adjoint) == 1 and adjoint[0].converged
    (n_few, it_few), (n_many, it_many) = sizes
    assert it_many > it_few and n_few == n_many


# ---------------------------------------------------------------------------
# the projection
# ---------------------------------------------------------------------------

def _weights(comps, cells, seed, accessible=None):
    """Weights of the velocity components, and of the pressure one whose
    mean over the accessible cells is 0 and which is 0 elsewhere."""
    rng = np.random.default_rng(seed)
    wp = rng.standard_normal(cells).astype(np.float32)
    if accessible is None:
        return [rng.standard_normal(c.shape).astype(np.float32) for c in comps], wp - wp.mean()
    wp = (wp - (wp * accessible).sum() / accessible.sum()) * accessible
    return [rng.standard_normal(c.shape).astype(np.float32) for c in comps], wp.astype(np.float32)


def _projection_grads(comps, periodic, obs=(), jobs=(), preconditioner='chebyshev', active=None, tol=1e-6,
                      masks=None):
    """The gradient of L = Σ w_d·v'_d + ½Σ w_0·v'_0² + Σ w_p·p with respect
    to the velocity components, JAX's and the port's; `masks` (face masks,
    cell mask) restrict the weights."""
    dims, N = len(comps), comps[0].shape[1]
    names = ORDER[:dims]
    accessible = None
    if obs:
        accessible = geometry_mask(~union([o.geometry for o in fluid._get_obstacles_for(obs)]),
                                   cell_grid((N,) * dims, 1.0, 'cpu')).numpy()
    ws, wp = _weights(comps, (N,) * dims, 9, accessible if masks is None else masks[1])
    sq = np.ones_like(ws[0])
    if masks is not None:
        ws, sq = [w * m for w, m in zip(ws, masks[0])], masks[0][0]
    jactive = None
    if active is not None:
        jactive = JCenteredGrid(JTensor(jnp.asarray(active), jm.spatial(**{n: N for n in names})), 0.,
                                bounds=_jax_staggered(comps, periodic).bounds, **{n: N for n in names})
    old = jax_fluid.MASKED_PRECONDITIONER, fluid.MASKED_PRECONDITIONER
    jax_fluid.MASKED_PRECONDITIONER = fluid.MASKED_PRECONDITIONER = preconditioner
    try:
        def jloss(cs):
            v2, p = jax_fluid.make_incompressible(_jax_staggered(cs, periodic), jobs,
                                                  jm.Solve('CG', tol, 0., max_iterations=2000), active=jactive)
            out = [v2.vector[n].values.native(names) for n in names]
            return (sum(jnp.sum(o * w) for o, w in zip(out, ws)) + 0.5 * jnp.sum(out[0] ** 2 * sq)
                    + jnp.sum(p.values.native(names) * wp))
        ref = jax.jit(jax.grad(jloss))([jnp.asarray(c) for c in comps])
        cs = [torch.tensor(c, requires_grad=True) for c in comps]
        v2, p, result = fluid.make_incompressible_native(
            cs, None, 1.0, rel_tol=tol, abs_tol=0., max_iterations=2000, faces=face_layout(periodic, len(cs)), obstacles=obs,
            active=None if active is None else torch.from_numpy(active))
        loss = (sum((o * torch.from_numpy(w)).sum() for o, w in zip(v2, ws)) + 0.5 * (v2[0] ** 2 * torch.from_numpy(sq)).sum()
                + (p * torch.from_numpy(wp)).sum())
        with SolveTape() as tape:
            loss.backward()
    finally:
        jax_fluid.MASKED_PRECONDITIONER, fluid.MASKED_PRECONDITIONER = old
    assert result.converged and len(tape.solve_infos) == 1 and tape[0].converged
    return [c.grad.numpy() for c in cs], [np.asarray(r) for r in ref]


@pytest.mark.parametrize('dims,N,periodic', [(2, 16, False), (2, 16, True), (3, 12, False), (3, 12, True)],
                         ids=['2d-closed', '2d-periodic', '3d-closed', '3d-periodic'])
def test_make_incompressible_gradient_matches_jax(dims, N, periodic):
    got, ref = _projection_grads(_random_velocity(N, dims, periodic, seed=dims), periodic)
    for g, r in zip(got, ref):
        _close(g, r)


@pytest.mark.parametrize('dims,N,periodic,preconditioner', [(2, 16, False, 'chebyshev'), (3, 8, True, 'chebyshev'),
                                                            (2, 16, True, 'vcycle')],
                         ids=['2d-closed-chebyshev', '3d-periodic-chebyshev', '2d-periodic-vcycle'])
def test_make_incompressible_gradient_with_obstacles_matches_jax(dims, N, periodic, preconditioner):
    obs, jobs = _obstacles(N, dims, 'rotating')
    got, ref = _projection_grads(_random_velocity(N, dims, periodic, seed=5), periodic, obs, jobs, preconditioner)
    for g, r in zip(got, ref):
        _close(g, r)


def test_make_incompressible_gradient_with_active_cells_matches_jax():
    """A free surface (the lower two thirds active) and a stationary obstacle.
    The loss weighs only faces between two active cells and active cells'
    pressure: a cotangent in the identity rows (air) takes the JAX package's
    adjoint CG, which solves with A where Aᵀ differs there, out of the
    symmetric block it converges on; the port zeroes those rows' right-hand
    side, whose solution no gradient needs (and converges either way)."""
    N = 16
    active = np.zeros((N, N), np.float32)
    active[:, :2 * N // 3] = 1.0
    obs, jobs = _obstacles(N, 2, 'stationary')
    accessible = geometry_mask(~union([o.geometry for o in fluid._get_obstacles_for(obs)]),
                               cell_grid((N, N), 1.0, 'cpu')).numpy()
    cells = active * accessible
    face_masks = [cells[:-1] * cells[1:], cells[:, :-1] * cells[:, 1:]]
    got, ref = _projection_grads(_random_velocity(N, 2, False, seed=6), False, obs, jobs, active=active,
                                 masks=(face_masks, cells))
    for g, r in zip(got, ref):
        _close(g, r)

"""The rest of the solver layer against the JAX package's, on the CPU:
'CG-adaptive', 'biCG-stab(2)', 'direct' / 'scipy-direct' (and its reroute
to BiCGStab above 16384 unknowns), batched systems solved in one loop (each
with its own tolerance and stop, a converged one frozen), and
two faults: a preconditioner string ('ilu') and an unknown method raised in
the port where JAX ignores the one and warns and runs CG for the other.

The analogues of `tests/math/test_solve.py` keep its tolerances (|f(x) − y|
within 1e-4 in float32, 1e-7 at 1e-9 in float64); each also holds the
port's x to JAX's on the same numpy right-hand side (within 1e-4 of its
scale in float32, 1e-7 in float64). The inputs come from numpy generators,
never from either package's global key."""
import warnings

import jax
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.math import _solve as jax_solve

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.math import Solve, SolveTape, _solve


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _lap(m, periodic):
    def op(x):
        lo, up = m.shift(x, (-1, 1), 'x', m.extrapolation.PERIODIC if periodic else m.extrapolation.ZERO,
                         stack_dim=None)
        return 2 * x - lo - up
    return op


def _rhs(n, seed, zero_mean=False, batch=None):
    a = np.random.default_rng(seed).standard_normal(((batch,) if batch else ()) + (n,)).astype(np.float32)
    if zero_mean:
        a = a - a.mean(-1, keepdims=True)
    dims = ('b', 'x') if batch else ('x',)

    def make(m):
        shape = (m.batch('b'), m.spatial('x')) if batch else (m.spatial('x'),)
        return m.tensor(a if m is jm else torch.from_numpy(a), *shape)
    return make(jm), make(tm), dims


def _scaled(got, ref):
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize('method,periodic', [('CG-adaptive', False), ('CG-adaptive', True), ('biCG-stab(2)', False),
                                             ('scipy-direct', False), ('direct', True)])
def test_methods_match_jax(method, periodic):
    """`test_cg_adaptive`, `test_bicgstab`, `test_direct`: Dirichlet and singular periodic 1D Laplacians."""
    n = 32 if method == 'CG-adaptive' else 16
    jy, y, dims = _rhs(n, 1 + periodic, zero_mean=periodic)
    kw = dict(rank_deficiency=1) if periodic else {}
    jx = jm.solve_linear(_lap(jm, periodic), jy, jm.Solve(method, 1e-6, 1e-6, **kw))
    with SolveTape() as tape:
        x = tm.solve_linear(_lap(tm, periodic), y, Solve(method, 1e-6, 1e-6, **kw))
    assert tape[0].converged
    assert np.abs((_lap(tm, periodic)(x) - y).numpy(dims)).max() < 1e-4
    assert _scaled(x.numpy(dims), np.asarray(jx.numpy(dims))) < 1e-4


def test_solvers_are_distinct():
    assert _solve.krylov_of('CG-adaptive') is _solve.cg_adaptive is not _solve.cg
    assert _solve.krylov_of('biCG-stab(2)') is _solve.bicgstab2 is not _solve.bicgstab
    assert _solve.krylov_of('direct') is None and _solve.krylov_of('scipy-direct') is None


def test_batched_solve():
    jy, y, dims = _rhs(16, 3, batch=3)
    jx = jm.solve_linear(_lap(jm, False), jy, jm.Solve('CG', 1e-6, 1e-6))
    x = tm.solve_linear(_lap(tm, False), y, Solve('CG', 1e-6, 1e-6))
    assert 'b' in x.shape
    assert np.abs((_lap(tm, False)(x) - y).numpy(dims)).max() < 1e-4
    assert _scaled(x.numpy(dims), np.asarray(jx.numpy(dims))) < 1e-4


def _stiff_matrix():
    """`test_bicgstab2_is_genuine_l2`'s stiff nonsymmetric band matrix and right-hand side."""
    rng = np.random.RandomState(7)
    n = 96
    D = (np.diag(np.full(n, 6.)) + np.diag(np.full(n - 1, -4.), 1) + np.diag(np.full(n - 1, -4.), -1)
         + np.diag(np.full(n - 2, 1.), 2) + np.diag(np.full(n - 2, 1.), -2) + 0.5 * np.eye(n))
    D[0, :4] += [1.5, -2.0, 0.5, 0.1]
    D[-1, -4:] += [0.1, 0.5, -2.0, 1.5]
    return D, rng.randn(n)


def test_bicgstab2_is_genuine_l2():
    """The ℓ = 2 method on a stiff nonsymmetric system at 1e-10 in float64: within 1e-7 of the dense solution, and
    iteration for iteration JAX's `_bicgstab2` (both sum in float64 here)."""
    D, rhs = _stiff_matrix()
    Dt = torch.from_numpy(D)
    result = _solve.bicgstab2(lambda v: (Dt @ v, None), torch.from_numpy(rhs), torch.zeros(len(rhs), dtype=torch.float64),
                              1e-10, 1e-10, 4000)
    assert result.converged
    assert np.max(np.abs(result.x.numpy() - np.linalg.solve(D, rhs))) < 1e-7
    with jm.precision(64):
        jx, _, jit_, jconv = jax_solve._bicgstab2(lambda xs: [jax.numpy.asarray(D) @ xs[0]], [jax.numpy.asarray(rhs)],
                                                   [jax.numpy.zeros(len(rhs), jax.numpy.float64)], 1e-10, 1e-10, 4000)
        assert int(jit_) == result.iterations and bool(jconv)
        np.testing.assert_allclose(result.x.numpy(), np.asarray(jx[0]), atol=1e-9)


def test_bicgstab2_through_solve_linear_batched():
    """4x − laplace(x), periodic, two systems, float64 at 1e-9."""
    with jm.precision(64), tm.precision(64):
        a = np.random.default_rng(5).standard_normal((2, 32))
        jy = jm.tensor(a, jm.batch('b'), jm.spatial('x'))
        y = tm.tensor(torch.from_numpy(a), tm.batch('b'), tm.spatial('x'))
        jx = jm.solve_linear(lambda x: 4 * x - jm.laplace(x, padding=jm.extrapolation.PERIODIC), jy,
                             jm.Solve('biCG-stab(2)', 1e-9, 1e-9))
        f = lambda x: 4 * x - tm.laplace(x, padding=tm.extrapolation.PERIODIC)  # noqa: E731
        x = tm.solve_linear(f, y, Solve('biCG-stab(2)', 1e-9, 1e-9))
        assert np.abs((f(x) - y).numpy(('b', 'x'))).max() < 1e-7
        np.testing.assert_allclose(x.numpy(('b', 'x')), np.asarray(jx.numpy(('b', 'x'))), atol=1e-7)


def test_batched_systems_stop_one_by_one():
    """c_b·x − laplace(x) with c = (4, 0.01), periodic, float64: each system has its own tolerance and stop; each
    result and each residual held to JAX's (JAX's residual is the true ‖b − A·x‖, the port's its recurrence's)."""
    with jm.precision(64), tm.precision(64):
        a = np.random.default_rng(9).standard_normal((2, 32))
        jc, c = jm.tensor(np.array([4., 0.01]), jm.batch('b')), tm.tensor(torch.tensor([4., 0.01]), tm.batch('b'))
        jy = jm.tensor(a, jm.batch('b'), jm.spatial('x'))
        y = tm.tensor(torch.from_numpy(a), tm.batch('b'), tm.spatial('x'))
        with jm.SolveTape() as jtape:
            jx = jm.solve_linear(lambda x: jc * x - jm.laplace(x, padding=jm.extrapolation.PERIODIC), jy,
                                 jm.Solve('CG', 1e-8, 1e-8))
        with SolveTape() as tape:
            x = tm.solve_linear(lambda x: c * x - tm.laplace(x, padding=tm.extrapolation.PERIODIC), y,
                                Solve('CG', 1e-8, 1e-8))
        np.testing.assert_allclose(x.numpy(('b', 'x')), np.asarray(jx.numpy(('b', 'x'))), atol=1e-7)
        res, jres = tape[0].residual.numpy('b'), np.asarray(jtape[0].residual).reshape(-1)
        assert res.shape == (2,) and np.all(res <= 1e-8 * np.linalg.norm(a, axis=1) + 1e-12)
        np.testing.assert_allclose(res, jres, atol=1e-9)


def test_direct_large_mesh_parity():
    """72 × 64 = 4608 unknowns solve densely, with no reroute warning, as a CG at 1e-10 does; the cut-off is
    JAX's."""
    assert _solve.DIRECT_MAX_UNKNOWNS == jax_solve.DIRECT_MAX_UNKNOWNS == 16384

    def op(x):
        lo_x, up_x = tm.shift(x, (-1, 1), 'x', tm.extrapolation.ZERO, stack_dim=None)
        lo_y, up_y = tm.shift(x, (-1, 1), 'y', tm.extrapolation.ZERO, stack_dim=None)
        return 4 * x - lo_x - up_x - lo_y - up_y

    with tm.precision(64):
        rhs = tm.tensor(torch.from_numpy(np.random.default_rng(11).standard_normal((72, 64))), tm.spatial('x,y'))
        with warnings.catch_warnings():
            warnings.simplefilter('error')
            x_direct = tm.solve_linear(op, rhs, Solve('scipy-direct', 1e-6, 1e-6))
        x_iter = tm.solve_linear(op, rhs, Solve('CG', 1e-10, 1e-10, max_iterations=20000))
        assert np.abs((x_direct - x_iter).numpy(('x', 'y'))).max() < 1e-4


def test_direct_reroutes_above_cutoff():
    """Above the cut-off: JAX's warning, BiCGStab at tolerances of at most 1e-6."""
    def op(m):
        def f(x):
            lo, up = m.shift(x, (-1, 1), 'x', m.extrapolation.ZERO, stack_dim=None)
            return 3 * x - lo - up
        return f

    a = np.random.default_rng(13).standard_normal(20000).astype(np.float32)
    rhs = tm.tensor(torch.from_numpy(a), tm.spatial('x'))
    with SolveTape() as tape, pytest.warns(UserWarning, match='BiCGStab'):
        x = tm.solve_linear(op(tm), rhs, Solve('scipy-direct', 1e-5, 1e-5))
    assert np.abs((op(tm)(x) - rhs).numpy('x')).max() < 1e-3
    assert tape[0].solve.method == 'biCG-stab' and tape[0].solve.rel_tol == 1e-6
    with pytest.warns(UserWarning, match='BiCGStab'):
        jx = jm.solve_linear(op(jm), jm.tensor(a, jm.spatial('x')), jm.Solve('scipy-direct', 1e-5, 1e-5))
    assert _scaled(x.numpy('x'), np.asarray(jx.numpy('x'))) < 1e-4


def test_preconditioner_string_is_ignored():
    """Fault 3.6: `Solve(preconditioner='ilu')` raised NotImplementedError; JAX ignores a preconditioner it
    cannot call."""
    jy, y, dims = _rhs(32, 17)
    jx = jm.solve_linear(_lap(jm, False), jy, jm.Solve('CG', 1e-5, 1e-5, preconditioner='ilu'))
    x = tm.solve_linear(_lap(tm, False), y, Solve('CG', 1e-5, 1e-5, preconditioner='ilu'))
    plain = tm.solve_linear(_lap(tm, False), y, Solve('CG', 1e-5, 1e-5))
    assert np.array_equal(x.numpy(dims), plain.numpy(dims))
    assert _scaled(x.numpy(dims), np.asarray(jx.numpy(dims))) < 1e-4


def test_unknown_method_warns_and_runs_cg():
    """Fault 3.7: an unknown method raised NotImplementedError; JAX warns and runs CG."""
    jy, y, dims = _rhs(32, 19)
    with pytest.warns(UserWarning) as jrecord:
        jx = jm.solve_linear(_lap(jm, False), jy, jm.Solve('GMRES', 1e-5, 1e-5))
    with pytest.warns(UserWarning) as record:
        x = tm.solve_linear(_lap(tm, False), y, Solve('GMRES', 1e-5, 1e-5))
    assert [str(w.message) for w in record] == [str(w.message) for w in jrecord]
    cg = tm.solve_linear(_lap(tm, False), y, Solve('CG', 1e-5, 1e-5))
    assert np.array_equal(x.numpy(dims), cg.numpy(dims))
    assert _scaled(x.numpy(dims), np.asarray(jx.numpy(dims))) < 1e-4


@pytest.mark.parametrize('method', ['CG-adaptive', 'biCG-stab(2)', 'direct'])
def test_gradient_through_solve(method):
    """d Σx² / dy through each new solver's implicit adjoint, against JAX's `custom_linear_solve`."""
    jy, y, dims = _rhs(16, 23)

    def loss(m, solve):
        def f(r):
            return m.sum(m.solve_linear(_lap(m, False), r, solve) ** 2)
        return f
    _, jg = jm.gradient(loss(jm, jm.Solve(method, 1e-6, 1e-6)), wrt=0, get_output=True)(jy)
    _, g = tm.gradient(loss(tm, Solve(method, 1e-6, 1e-6)), wrt=0, get_output=True)(y)
    assert _scaled(g.numpy(dims), np.asarray(jg.numpy(dims))) < 1e-4

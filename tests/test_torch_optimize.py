"""Optimisation in `phiflow_tpu_torch.math` against `phiflow_tpu.math` and
`jax.scipy.optimize` on the same numpy inputs, on the CPU: the strong-Wolfe
line search alone (float64, a quadratic and Rosenbrock: the step, the
evaluations and the failure flag exactly equal, the step to 1e-12),
`minimize` with L-BFGS on 64-bit Rosenbrock (the analogue of
`tests/math/test_solve.py::test_minimize_lbfgs`: equal iteration counts,
the minimum to 1e-5), with BFGS and 'GD' (equal iteration counts and
success, x within 1e-6), `solve_nonlinear` by Newton–Krylov (the analogue of
`test_solve_nonlinear_newton`, within 1e-4) and by minimisation, a
StaggeredGrid `x0`, and the `SolveInfo`s a `SolveTape` records."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
import phiflow_tpu.field as jf
import phiflow_tpu.geom as jg
import phiflow_tpu_torch.math as tm
import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.geom as tg
from phiflow_tpu_torch.math._line_search import line_search


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _quadratic(lib):
    a = np.diag([1., 10., 100.])
    return lambda x: 0.5 * lib.sum(x * (lib.asarray(a) @ x) if lib is jnp else x * (torch.from_numpy(a) @ x))


def _rosenbrock(lib):
    return lambda x: lib.sum(100. * (x[1:] - x[:-1] ** 2) ** 2 + (1. - x[:-1]) ** 2)


def _value_and_grad(f):
    def value_and_grad(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            v = f(x)
            return v.detach(), torch.autograd.grad(v, x)[0]
    return value_and_grad


@pytest.mark.parametrize('function', ['quadratic', 'rosenbrock'])
def test_line_search_against_jax(function):
    """Float64: the same step, evaluations, failure flag and status as
    `jax._src.scipy.optimize.line_search`, with and without the BFGS start value."""
    from jax._src.scipy.optimize.line_search import line_search as jax_line_search
    make = _quadratic if function == 'quadratic' else _rosenbrock
    jf_, tf_ = make(jnp), make(torch)
    rng = np.random.default_rng(1)
    with jm.precision(64):  # jax_enable_x64 within
        for k in range(3):
            x = rng.normal(size=3)
            g = np.asarray(jax.grad(jf_)(jnp.asarray(x)))
            p = -g * rng.uniform(1e-3, 1.)
            old_old = float(jf_(jnp.asarray(x))) + rng.uniform(0.1, 2.) if k else None
            ref = jax_line_search(jf_, jnp.asarray(x), jnp.asarray(p), old_old_fval=old_old)
            got = line_search(_value_and_grad(tf_), torch.from_numpy(x), torch.from_numpy(p), old_old_fval=old_old)
            assert (got.nfev, got.failed, got.status) == (int(ref.nfev), bool(ref.failed), int(ref.status))
            np.testing.assert_allclose(float(got.a_k), float(ref.a_k), rtol=1e-12)
            np.testing.assert_allclose(got.g_k.numpy(), np.asarray(ref.g_k), rtol=1e-10, atol=1e-12)


def _rosen(t):
    return (1 - t.x[0]) ** 2 + 100 * (t.x[1] - t.x[0] ** 2) ** 2


def test_minimize_lbfgs_rosenbrock_64bit():
    """The analogue of `test_minimize_lbfgs` in float64 throughout (x0 made
    under `precision(64)`): equal L-BFGS iteration counts and success."""
    infos = {}
    for name, m in (('jax', jm), ('port', tm)):
        with m.precision(64):
            x0 = m.wrap(np.array([-1.2, 1.0], np.float64), m.spatial('x'))
            with m.SolveTape() as tape:
                x = m.minimize(_rosen, m.Solve('L-BFGS-B', abs_tol=1e-10, x0=x0, max_iterations=200))
        infos[name] = (tape[-1].iterations, tape[-1].converged, np.asarray(x.numpy()))
    assert infos['port'][:2] == infos['jax'][:2]
    np.testing.assert_allclose(infos['port'][2], [1., 1.], atol=1e-5)
    np.testing.assert_allclose(infos['port'][2], infos['jax'][2], atol=1e-9)


@pytest.mark.parametrize('method', ['BFGS', 'GD'])
def test_minimize_bfgs_against_jax(method):
    """JAX's BFGS (every method but L-BFGS, 'GD' included) on 64-bit
    Rosenbrock with 8 iterations and on the JAX suite's quadratic: equal
    iterations, success and x; the failed Rosenbrock search warns in both."""
    for name, m in (('jax', jm), ('port', tm)):
        with m.precision(64), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            x0 = m.wrap(np.array([-1.2, 1.0], np.float64), m.spatial('x'))
            with m.SolveTape() as tape:
                x = m.minimize(_rosen, m.Solve(method, 1e-6, 1e-6, x0=x0, max_iterations=200))
        info = tape[-1]
        if name == 'jax':
            ref = (info.iterations, info.converged, np.asarray(x.numpy()), len(caught))
        else:
            assert (info.iterations, info.converged, len(caught)) == (ref[0], ref[1], ref[3])
            np.testing.assert_allclose(np.asarray(x.numpy()), ref[2], rtol=1e-6)
    target = np.array([1., 2., 3.], np.float32)
    results = []
    for m in (jm, tm):
        t = m.wrap(target, m.spatial('x'))
        results.append(np.asarray(m.minimize(lambda x: m.sum((x - t) ** 2),
                                             m.Solve(method, 1e-6, 1e-6, x0=m.zeros(m.spatial(x=3)))).numpy()))
    np.testing.assert_allclose(results[1], results[0], atol=1e-6)
    np.testing.assert_allclose(results[1], target, atol=1e-3)


def test_solve_nonlinear_against_jax():
    """Newton–Krylov on f(x) = x³ + x (the analogue of
    `test_solve_nonlinear_newton`) and the minimisation route ('L-BFGS-B'):
    the same x within 1e-4, equal Newton steps; an impossible solve raises
    NotConverged in both."""
    out = {}
    for name, m in (('jax', jm), ('port', tm)):
        target = m.wrap(np.array([2., 10., -2.], np.float32), m.spatial('x'))
        with m.SolveTape() as tape:
            x = m.solve_nonlinear(lambda x: x ** 3 + x, target, m.Solve('Newton', 1e-6, 1e-6, x0=m.zeros(m.spatial(x=3))))
            xm = m.solve_nonlinear(lambda x: x ** 3 + x, target, m.Solve('L-BFGS-B', 1e-6, 1e-8, x0=m.zeros(m.spatial(x=3))))
        out[name] = (np.asarray(x.numpy()), np.asarray(xm.numpy()), tape[0].iterations, tape[0].converged)
        m.assert_close(x ** 3 + x, target, abs_tolerance=1e-4)
        with pytest.raises(m.NotConverged):
            m.solve_nonlinear(lambda x: x ** 2 + 1, m.zeros(m.spatial(x=2)),
                              m.Solve('Newton', 1e-6, 1e-6, x0=m.ones(m.spatial(x=2)), max_iterations=3))
    np.testing.assert_allclose(out['port'][0], out['jax'][0], atol=1e-4)
    np.testing.assert_allclose(out['port'][1], out['jax'][1], atol=1e-4)
    assert out['port'][2:] == out['jax'][2:]


def test_staggered_x0_and_solve_tape():
    """L-BFGS over a StaggeredGrid: the result keeps its structure
    (components, geometry, boundary) and equals JAX's within 1e-5 of scale;
    the tape holds one SolveInfo with JAX's method, iterations and success."""
    n = 6
    rng = np.random.default_rng(2)
    comps = [rng.standard_normal((n - 1, n)).astype(np.float32), rng.standard_normal((n, n - 1)).astype(np.float32)]
    results = {}
    for name, m, f, g in (('jax', jm, jf, jg), ('port', tm, tf, tg)):
        target = f.StaggeredGrid(m.stack([m.wrap(c, m.spatial('x,y')) for c in comps], m.dual(vector='x,y')), 0,
                                 g.Box(x=1, y=1), x=n, y=n)
        x0 = f.StaggeredGrid(0, 0, g.Box(x=1, y=1), x=n, y=n)
        solve = m.Solve('L-BFGS-B', abs_tol=1e-6, x0=x0, max_iterations=5)
        with m.SolveTape() as tape:
            x = m.minimize(lambda v: f.l2_loss(v - target) + 0.1 * f.l2_loss(v) ** 2, solve)
        assert len(tape) == 1 and tape[0].solve.x0 is x0 and tape[0].method == 'L-BFGS-B'
        results[name] = ([np.asarray(x.values[{'~vector': d}].numpy(('x', 'y'))) for d in 'xy'],
                         tape[0].iterations, tape[0].converged, float(tape[0].residual))
        assert x.is_staggered and x.geometry == x0.geometry and x.boundary == x0.boundary
    for got, ref in zip(results['port'][0], results['jax'][0]):
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    assert results['port'][1:3] == results['jax'][1:3]
    np.testing.assert_allclose(results['port'][3], results['jax'][3], rtol=1e-5)


def test_taped_minimize_frees_its_evaluations_graphs():
    """L-BFGS under an open SolveTape over a loss whose linear solve starts
    from an x0 computed from x (as a differentiated smoke step's previous
    pressure): the tape records every forward and adjoint solve, and holds
    no evaluation's tensors once minimize has returned."""
    import gc
    import weakref
    rng = np.random.default_rng(4)
    target = tm.wrap(torch.from_numpy(rng.standard_normal(8)), tm.spatial('x'))
    alive = []

    def loss(x):
        guess = x * 0.5
        alive.append(weakref.ref(guess.native()))
        p = tm.solve_linear(lambda p: 3 * p, x, tm.Solve('CG', 1e-8, 1e-8, x0=guess))
        return tm.l2_loss(p - target)

    with tm.SolveTape() as tape:
        x = tm.minimize(loss, tm.Solve('L-BFGS-B', abs_tol=1e-6, x0=tm.zeros(tm.spatial(x=8)), max_iterations=4))
        gc.collect()
        assert len(alive) >= 4 and not any(ref() is not None for ref in alive)
    methods = [info.method for info in tape]
    assert methods[-1] == 'L-BFGS-B' and methods.count('CG') == 2 * len(alive)
    assert sum(info.msg.startswith('adjoint') for info in tape) == len(alive)
    np.testing.assert_allclose(x.numpy('x'), 3 * target.numpy('x'), rtol=1e-5)


def test_solve_nonlinear_grid_against_jax():
    """Newton–Krylov on a CenteredGrid residual through the field layer,
    u + u³ − 0.05·∇²u = y with a zero boundary (J·v by double backward
    through `field.laplace`): the same u within 1e-4 of scale as JAX's, and
    equal Newton steps."""
    rng = np.random.default_rng(6)
    y_np = rng.standard_normal((8, 6)).astype(np.float32)
    out = {}
    for name, m, f, g in (('jax', jm, jf, jg), ('port', tm, tf, tg)):
        y = f.CenteredGrid(m.wrap(y_np, m.spatial('x,y')), 0, g.Box(x=1, y=1), x=8, y=6)
        with m.SolveTape() as tape:
            u = m.solve_nonlinear(lambda u: u + u ** 3 - 0.05 * f.laplace(u), y,
                                  m.Solve('Newton', 1e-6, 1e-5, x0=0 * y))
        out[name] = (np.asarray(u.values.numpy(('x', 'y'))), tape[0].iterations, tape[0].converged)
    np.testing.assert_allclose(out['port'][0], out['jax'][0], atol=1e-4 * np.abs(out['jax'][0]).max())
    assert out['port'][1:] == out['jax'][1:]

"""`phiflow_tpu_torch.math.solve_linear` with `Solve`, `SolveTape` and
`jit_compile_linear` against `phiflow_tpu.math`'s on the same numpy inputs:
a Dirichlet Laplace system on a CenteredGrid, an affine one (a boundary value
of 1, whose offset the solve subtracts), and a periodic one that needs the
rank deficiency and a preprocessing of the right-hand side."""
import numpy as np
import pytest
import torch

import phiflow_tpu.field as jf
import phiflow_tpu.math as jm
import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.math as tm


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _grids(boundary, seed=0, n=(12, 10)):
    rhs = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    port = tf.CenteredGrid(tm.wrap(torch.from_numpy(rhs), tm.spatial('x,y')), boundary(tm.extrapolation),
                           x=n[0], y=n[1])
    ref = jf.CenteredGrid(jm.wrap(rhs, jm.spatial('x,y')), boundary(jm.extrapolation), x=n[0], y=n[1])
    return port, ref


def _subtract_mean(y):
    return y - tf.mean(y)


def _j_subtract_mean(y):
    return y - jf.mean(y)


@pytest.mark.parametrize('boundary,rank_deficiency', [(lambda e: e.ZERO, None), (lambda e: e.ONE, None),
                                                      (lambda e: e.PERIODIC, 1)], ids=['zero', 'one', 'periodic'])
def test_solve_linear_matches_jax(boundary, rank_deficiency):
    y, jy = _grids(boundary)
    port_laplace = tm.jit_compile_linear(lambda x: tf.laplace(x))
    jax_laplace = jm.jit_compile_linear(lambda x: jf.laplace(x))
    kwargs = dict(rel_tol=1e-6, abs_tol=1e-6, max_iterations=500, rank_deficiency=rank_deficiency)
    solve, jsolve = tm.Solve('CG', x0=y * 0, **kwargs), jm.Solve('CG', x0=jy * 0, **kwargs)
    if rank_deficiency:
        solve, jsolve = solve.with_preprocessing(_subtract_mean), jsolve.with_preprocessing(_j_subtract_mean)
    with tm.SolveTape() as tape:
        x = tm.solve_linear(port_laplace, y, solve)
    jx = jm.solve_linear(jax_laplace, jy, jsolve)
    assert isinstance(x, tf.Field) and x.boundary == y.boundary
    assert len(tape) == 1 and tape[0].converged and tape[0].iterations > 0
    ref = np.asarray(jx.values.numpy(('x', 'y')))
    np.testing.assert_allclose(x.values.numpy(('x', 'y')), ref, atol=1e-4 * np.abs(ref).max())


def test_solve_linear_raises_unless_suppressed():
    y, _ = _grids(lambda e: e.ZERO, seed=1)
    laplace = tm.jit_compile_linear(lambda x: tf.laplace(x))
    with pytest.raises(tm.NotConverged):
        tm.solve_linear(laplace, y, tm.Solve('CG', 1e-9, 1e-9, x0=y * 0, max_iterations=2))
    x = tm.solve_linear(laplace, y, tm.Solve('CG', 1e-9, 1e-9, x0=y * 0, max_iterations=2,
                                              suppress=(tm.ConvergenceException,)))
    assert x.values.shape == y.values.shape
    with pytest.raises(NotImplementedError, match='matrix'):  # as in the JAX package
        tm.solve_linear(y.values, y, tm.Solve('biCG-stab(2)', x0=y * 0))

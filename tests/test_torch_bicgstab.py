"""BiCGStab and the mesh projection of the port against the JAX package's,
on the CPU.

One fixed mesh pressure system — the 120×30 channel with a cylinder of
`tests/physics/test_cylinder_wake.py::test_mesh_chebyshev_preconditioner_reduces_iterations`,
the divergence of a uniform stream — solved by the port's `bicgstab` and
JAX's `_bicgstab` for the same number of iterations, with and without the
mesh Chebyshev preconditioner, within 1e-4 of the solution's scale. Then the
analogue of that test, and `make_incompressible` on the mesh against JAX's:
pressure and velocity within 1e-3 of their scale.

BiCGStab's iteration count at a tolerance of 1e-5 is noise: relative
perturbations of 1e-7 of the velocity (six seeds) move it over 57–61 in JAX
and 57–67 in the port with the preconditioner, over 213–328 in JAX without.
The preconditioned projection's count is held within 25% of JAX's; the
plain one's only to converge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.field import Field as JField, divergence as jax_divergence, laplace as jax_laplace
from phiflow_tpu.geom import Box as JBox, Sphere as JSphere
from phiflow_tpu.geom._mesh import build_mesh as jax_build_mesh
from phiflow_tpu.math import _solve as jax_solve
from phiflow_tpu.math.extrapolation import ZERO_GRADIENT as JZG
from phiflow_tpu.physics import fluid as jax_fluid

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.field import Field, divergence, laplace
from phiflow_tpu_torch.geom import Box, Sphere, build_mesh
from phiflow_tpu_torch.math import ConvergenceException, Solve, SolveTape, Tensor, bicgstab, vec
from phiflow_tpu_torch.math.extrapolation import ZERO_GRADIENT
from phiflow_tpu_torch.physics import fluid


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


@pytest.fixture(scope='module')
def channel():
    """(JAX's velocity Field, the port's) on the 120×30 channel mesh."""
    jax_mesh = jax_build_mesh(JBox(x=4., y=1.), x=120, y=30, obstacles=JSphere(x=1., y=0.5, radius=0.2))
    mesh = build_mesh(Box(x=4., y=1.), x=120, y=30, obstacles=Sphere(x=1., y=0.5, radius=0.2))
    jv = JField(jax_mesh, jm.vec(x=1., y=0.), {'x-': jm.vec(x=1., y=0.), 'x+': JZG, 'y-': 0., 'y+': 0., 'boundary': 0.})
    v = Field(mesh, vec(x=1., y=0.), {'x-': vec(x=1., y=0.), 'x+': ZERO_GRADIENT, 'y-': 0., 'y+': 0., 'boundary': 0.})
    return jv, v


def test_bicgstab_matches_jax_iteration_for_iteration(channel):
    jv, v = channel
    jdiv, div = jax_divergence(jv), divergence(v)
    jx0 = JField(jdiv.geometry, jm.wrap(0.), jax_fluid._pressure_extrapolation(jv.boundary))
    x0 = Field(div.geometry, tm.wrap(0.), fluid._pressure_extrapolation(v.boundary))
    jM, M = jax_fluid._mesh_chebyshev_preconditioner(jx0), fluid._mesh_chebyshev_preconditioner(x0)
    shape = jx0.values.shape

    def jax_A(xs):
        return [jax_laplace(jx0.with_values(jm.Tensor(xs[0], shape))).values.native(('cells',))]

    def jax_M(xs):
        return [jM(jx0.with_values(jm.Tensor(xs[0], shape))).values.native(('cells',))]

    def A(x):
        return laplace(x0.with_values(Tensor(x, x0.values.shape))).values.torch('cells'), None

    def port_M(x):
        return M(x0.with_values(Tensor(x, x0.values.shape))).values.torch('cells'), None

    b = np.asarray(jdiv.values.native(('cells',)))
    np.testing.assert_array_equal(div.values.numpy('cells'), b)
    tb = torch.from_numpy(b.copy())
    for preconditioned in (False, True):
        for k in (1, 4, 12):
            run = jax.jit(lambda b: jax_solve._bicgstab(jax_A, [b], [jnp.zeros_like(b)], 1e-9, 1e-9, k,
                                                        M=jax_M if preconditioned else None))
            ref, _, it, _ = run(jnp.asarray(b))
            got = bicgstab(A, tb, torch.zeros_like(tb), 1e-9, 1e-9, k, port_M if preconditioned else None)
            assert int(it) == got.iterations == k and not got.converged
            ref = np.asarray(ref[0])
            np.testing.assert_allclose(got.x.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                       err_msg=f'{k} iterations, preconditioned={preconditioned}')


def test_mesh_chebyshev_preconditioner_reduces_iterations(channel):
    """The Chebyshev(Jacobi) mesh preconditioner at least halves BiCGStab's
    iterations, and the two solutions agree within 1e-3."""
    _, v = channel
    with SolveTape() as tape:
        _, p1 = fluid.make_incompressible(v, (), Solve('biCG-stab', 1e-5, 1e-5, preconditioner=False,
                                                       suppress=(ConvergenceException,), implicit_diff=False))
    plain = tape[-1]
    with SolveTape() as tape:
        _, p2 = fluid.make_incompressible(v, (), Solve('auto', 1e-5, 1e-5, suppress=(ConvergenceException,),
                                                       implicit_diff=False))
    pre = tape[-1]
    assert pre.converged and plain.converged and pre.method == 'biCG-stab'
    assert pre.iterations < plain.iterations / 2, (plain.iterations, pre.iterations)
    a, b = p1.values.numpy('cells'), p2.values.numpy('cells')
    assert np.abs(a - b).max() / np.abs(a).max() < 1e-3


@pytest.mark.parametrize('method,preconditioner', [('auto', None), ('biCG-stab', False)],
                         ids=['auto-chebyshev', 'bicgstab-plain'])
def test_make_incompressible_matches_jax(channel, method, preconditioner):
    jv, v = channel
    with jm.SolveTape(record_runtime=True) as jax_tape:
        jv1, jp1 = jax_fluid.make_incompressible(jv, (), jm.Solve(method, 1e-5, 1e-5, preconditioner=preconditioner,
                                                                   suppress=(jm.ConvergenceException,),
                                                                   max_iterations=2000))
    with SolveTape() as tape:
        v1, p1 = fluid.make_incompressible(v, (), Solve(method, 1e-5, 1e-5, preconditioner=preconditioner,
                                                        suppress=(ConvergenceException,), max_iterations=2000))
    ref_stats, info = jax_tape.solve_infos[-1].runtime_stats, tape[-1]
    assert ref_stats['converged'] and info.converged
    if preconditioner is None:
        assert abs(info.iterations - ref_stats['iterations']) <= 0.25 * ref_stats['iterations'], \
            (info.iterations, ref_stats['iterations'])
    for ref, got, names in ((jp1, p1, ('cells',)), (jv1, v1, ('cells', 'vector'))):
        a, b = np.asarray(ref.values.native(names)), got.values.numpy(names)
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-3 * np.abs(a).max())
    assert v1.boundary == v.boundary and p1.is_mesh


def test_solve_linear_bicgstab_affine(channel):
    """`solve_linear` by BiCGStab subtracts an affine operator's offset f(0)
    once, and reports BiCGStab's iterations on the tape."""
    _, v = channel
    rhs = v.values * 0 + 0.5
    offset = 0.25

    def f(x):
        return x * 2. + offset

    with SolveTape() as tape:
        x = tm.solve_linear(f, rhs, Solve('biCG', 1e-6, 1e-6, x0=rhs * 0))
    np.testing.assert_allclose(x.numpy('cells,vector'), (0.5 - offset) / 2., rtol=1e-6)
    assert tape[-1].converged and tape[-1].iterations == 1 and 'BiCGStab' in tape[-1].msg
    with pytest.raises(NotImplementedError, match='matrix'):  # as in the JAX package
        tm.solve_linear(rhs, rhs, Solve('biCG-stab(2)', 1e-6, 1e-6, x0=rhs * 0))

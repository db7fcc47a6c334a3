"""`KolmogorovFlow`, the centred wide-stencil projection and
`incompressible_rk4` of the port against the JAX package's, on the CPU.

`KolmogorovFlow(32)` at orders 6 and 4: one float32 step from JAX's state as
numpy, every solve converged (cg_tol 1e-6, at most 1000 iterations), within
2e-4 of each field's scale with CG counts at most 1 apart; the forcing within
1e-6; `step_native` against the Field step (order 4 bit-equal, order 6
within 1e-5 of the scale). `make_incompressible` of a centred velocity at
orders 2, 4 and 6 within 1e-4; `incompressible_rk4` on a hand-built PDE;
`integrate.rk4` / `euler`; the cases the centred projection refuses."""
import jax
import numpy as np
import pytest
import torch

import phiflow_tpu.field as jf
import phiflow_tpu.math as jm
from phiflow_tpu.geom import Box as JBox
from phiflow_tpu.math import SolveTape as JSolveTape
from phiflow_tpu.models import KolmogorovFlow as JaxKolmogorov
from phiflow_tpu.physics import diffuse as jdiffuse, fluid as jfluid, integrate as jintegrate

import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.geom import Box, Sphere
from phiflow_tpu_torch.models import KolmogorovFlow
from phiflow_tpu_torch.models.kolmogorov import state_from_numpy, state_to_numpy
from phiflow_tpu_torch.physics import diffuse, fluid, integrate

NAMES = ('x', 'y')


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _components(field):
    return [np.asarray(field.values[{'vector': d}].native(NAMES)) for d in NAMES]


def _scaled(got, ref):
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _vector_grids(seed, n=32, size=2 * np.pi):
    arr = np.random.default_rng(seed).standard_normal((n, n, 2)).astype(np.float32)
    shape, jshape = tm.spatial('x,y') & tm.channel(vector='x,y'), jm.spatial('x,y') & jm.channel(vector='x,y')
    v = tf.CenteredGrid(tm.wrap(torch.from_numpy(arr.copy()), shape), tm.extrapolation.PERIODIC, x=n, y=n,
                        bounds=Box(x=size, y=size))
    jv = jf.CenteredGrid(jm.wrap(arr, jshape), jm.extrapolation.PERIODIC, x=n, y=n, bounds=JBox(x=size, y=size))
    return v, jv


def test_forcing_matches_jax():
    """The forcing sampled from the model's callable at the cell centres."""
    jmodel, model = JaxKolmogorov(32), KolmogorovFlow(32, device='cpu')
    assert model.forcing.values.shape.get_labels('vector') == ('x', 'y')
    for got, ref in zip([model.forcing.values[{'vector': d}].numpy(NAMES) for d in NAMES],
                        _components(jmodel.forcing)):
        assert float(np.abs(got - ref).max()) <= 1e-6
    assert model.forcing.boundary == tm.extrapolation.PERIODIC


@pytest.mark.parametrize('order', [6, 4])
def test_kolmogorov_step_matches_jax(order):
    """One float32 step from JAX's state, the solves converged on both
    sides: each field within 2e-4 of its scale, CG counts at most 1 apart."""
    jmodel = JaxKolmogorov(32, order=order, cg_tol=1e-6, max_iterations=1000)
    jv, jp = jmodel.initial_state()
    model = KolmogorovFlow(32, order=order, cg_tol=1e-6, max_iterations=1000, device='cpu')
    v, p = model.state_fields(*state_from_numpy(_components(jv), np.asarray(jp.values.native(NAMES)), device='cpu'))
    with JSolveTape(record_runtime=True) as jtape:
        jv, jp = jax.jit(jmodel.step)(jv, jp)
    with tm.SolveTape() as tape:
        v, p = model.step(v, p)
    assert len(tape) == 4 and all(info.converged for info in tape)
    jax_iterations = [info.runtime_stats['iterations'] for info in jtape.solve_infos]
    assert all(abs(a.iterations - b) <= 1 for a, b in zip(tape, jax_iterations)), jax_iterations
    (vx, vy), pressure = state_to_numpy(model.state_natives(v, p))
    for got, ref in zip((vx, vy, pressure), _components(jv) + [np.asarray(jp.values.native(NAMES))]):
        assert _scaled(got, ref) <= 2e-4
    assert v.boundary == p.boundary == tm.extrapolation.PERIODIC


@pytest.mark.parametrize('order', [4, 6])
def test_native_step_equals_field_step(order):
    """`step_native` on the arrays against the Field step: the same
    operators in the same order (order 4 bit-equal; order 6 contracts the
    stacked components in one product on the Field side, 1e-5)."""
    model = KolmogorovFlow(24, order=order, dt=0.01, device='cpu', seed=1)
    v, p = model.initial_state()
    native = model.initial_state_native()
    with tm.SolveTape() as tape:
        v, p = model.step(v, p)
    native = model.step_native(*native)
    assert [info.iterations for info in tape] == [r.iterations for r in model.last_solves]
    for got, ref in zip((*native[0], native[1]), (*model.state_natives(v, p)[0], model.state_natives(v, p)[1])):
        if order == 4:
            assert torch.equal(got, ref)
        else:
            assert _scaled(got.numpy(), ref.numpy()) <= 1e-5


@pytest.mark.parametrize('order', [2, 4, 6])
def test_centred_projection_matches_jax(order):
    """`make_incompressible` of a centred periodic velocity: the wide
    stencil of `order`, unpreconditioned CG from 0 with rank deficiency 1;
    velocity and pressure within 1e-4 of their scales, CG counts at most 1
    apart, and the divergence of `order` gone."""
    v, jv = _vector_grids(21)
    solve, jsolve = tm.Solve('CG', 1e-6, 0., max_iterations=1000), jm.Solve('CG', 1e-6, 0., max_iterations=1000)
    with JSolveTape(record_runtime=True) as jtape:
        jv2, jp2 = jax.jit(lambda u: jfluid.make_incompressible(u, (), jsolve, order=order))(jv)
    with tm.SolveTape() as tape:
        v2, p2 = fluid.make_incompressible(v, (), solve, order=order)
    assert abs(tape[0].iterations - jtape.solve_infos[0].runtime_stats['iterations']) <= 1 and tape[0].converged
    for got, ref in zip([c.numpy() for c in (v2.values[{'vector': d}].native(NAMES) for d in NAMES)],
                        _components(jv2)):
        assert _scaled(got, ref) <= 1e-4
    assert _scaled(p2.values.numpy(NAMES), np.asarray(jp2.values.native(NAMES))) <= 1e-4
    assert p2.boundary == tm.extrapolation.PERIODIC and v2.boundary == v.boundary
    div = tf.divergence(v2, order=order).values.numpy(NAMES)
    assert float(np.abs(div).max()) <= 1e-3 * float(np.abs(tf.divergence(v, order=order).values.numpy(NAMES)).max())


def test_incompressible_rk4_on_a_hand_built_pde():
    """A linear PDE (decay + order-4 diffusion + a constant push):
    `incompressible_rk4` from one state, 1e-4 of each field's scale."""
    v, jv = _vector_grids(22)
    p = tf.CenteredGrid(0., tm.extrapolation.PERIODIC, x=32, y=32, bounds=Box(x=2 * np.pi, y=2 * np.pi))
    jp = jf.CenteredGrid(0., jm.extrapolation.PERIODIC, x=32, y=32, bounds=JBox(x=2 * np.pi, y=2 * np.pi))

    def pde(u, strength):
        return u * -strength + diffuse.differential(u, 0.05, order=4) + (0.2, -0.1)

    def jpde(u, strength):
        return u * -strength + jdiffuse.differential(u, 0.05, order=4) + (0.2, -0.1)
    solve, jsolve = tm.Solve('CG', 1e-6, 0., max_iterations=1000), jm.Solve('CG', 1e-6, 0., max_iterations=1000)
    v2, p2 = fluid.incompressible_rk4(pde, v, p, 0.05, pressure_order=4, pressure_solve=solve, strength=0.3)
    jv2, jp2 = jax.jit(lambda a, b: jfluid.incompressible_rk4(jpde, a, b, 0.05, pressure_order=4,
                                                              pressure_solve=jsolve, strength=0.3))(jv, jp)
    for got, ref in zip([v2.values[{'vector': d}].numpy(NAMES) for d in NAMES], _components(jv2)):
        assert _scaled(got, ref) <= 1e-4
    assert _scaled(p2.values.numpy(NAMES), np.asarray(jp2.values.native(NAMES))) <= 1e-4


def test_integrators_match_jax():
    """`rk4` and `euler` on one state and on a tuple of states."""
    def pde(x, rate=1.0):
        return x * -rate

    def pde2(x, y):
        return y, x * -1.0
    for fn, jfn in ((integrate.rk4, jintegrate.rk4), (integrate.euler, jintegrate.euler)):
        assert fn(pde, 2.0, 0.1, rate=0.5) == jfn(pde, 2.0, 0.1, rate=0.5)
        assert fn(pde2, (1.0, 0.0), 0.2) == jfn(pde2, (1.0, 0.0), 0.2)
    t = tm.wrap(torch.arange(4, dtype=torch.float32), tm.spatial('x'))
    np.testing.assert_allclose(integrate.rk4(pde, t, 0.1).numpy(), np.arange(4) * np.exp(-0.1), rtol=1e-6)


def test_centred_projection_refuses_what_it_lacks():
    v, _ = _vector_grids(23, n=16)
    solve = tm.Solve('CG', 1e-5, 0., max_iterations=100)
    with pytest.raises(NotImplementedError, match='obstacles'):
        fluid.make_incompressible(v, [Sphere(x=3., y=3., radius=1.)], solve)
    with pytest.raises(NotImplementedError, match='active'):
        fluid.make_incompressible(v, (), solve, active=v)
    with pytest.raises(NotImplementedError, match='obstacles'):
        fluid.make_incompressible(v, [Sphere(x=3., y=3., radius=1.)], tm.Solve('biCG-stab(2)', 1e-5, 0.),
                                  wide_stencil=False)

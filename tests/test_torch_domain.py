"""The legacy `Domain` API, diffusion with a diffusivity Field, the geometry
masks, `solve_pressure_field` and the Poiseuille march of the port against
the JAX package's, on the CPU: `tests/physics/test_domain.py`'s factories
and projection round trip; `diffuse.explicit` / `implicit` / `differential`
with a spatially varying diffusivity (1e-5 of the field's scale in float32,
the implicit solve at 1e-6); `HardGeometryMask` / `SoftGeometryMask`
exactly; the unmasked pressure solve from a divergence Field (1e-4); and
`tests/physics/test_higher_order.py::test_poiseuille_steady_state_f64`,
order-6 implicit diffusion by 'biCG-stab(2)' in float64, within 2e-4 of
the analytic profile's scale as JAX's test holds it, and 1e-8 of JAX's."""
import warnings

import jax
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.field import CenteredGrid as JCenteredGrid, StaggeredGrid as JStaggeredGrid
from phiflow_tpu.geom import Box as JBox, Sphere as JSphere
from phiflow_tpu.physics import diffuse as jdiffuse, fluid as jfluid

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.field import CenteredGrid, StaggeredGrid, divergence, HardGeometryMask, SoftGeometryMask
from phiflow_tpu_torch.geom import Box, Sphere
from phiflow_tpu_torch.math import Solve
from phiflow_tpu_torch.physics import diffuse, fluid


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _scaled(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.max(np.abs(ref)))


def _pair(arr, boundary, bounds=None):
    """JAX's and the port's centred grids on one numpy array (2D, x and y)."""
    nx, ny = arr.shape
    jb = JBox(x=bounds[0], y=bounds[1]) if bounds else None
    tb = Box(x=bounds[0], y=bounds[1]) if bounds else None
    jg = JCenteredGrid(jm.wrap(arr, jm.spatial('x,y')), boundary[0], bounds=jb, x=nx, y=ny)
    g = CenteredGrid(tm.wrap(torch.from_numpy(arr), tm.spatial('x,y')), boundary[1], bounds=tb, x=nx, y=ny)
    return jg, g


def test_domain_factories():
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        from phiflow_tpu_torch.physics import CLOSED, PERIODIC_DOMAIN, Domain
        d = Domain(x=16, y=16, boundaries=CLOSED)
        assert d.rank == 2
        assert float(tm.sum(d.grid(1.).values)) == 256.0
        assert d.staggered_grid(0.).is_staggered
        assert 'vector' in d.vector_grid(0.).values.shape
        assert Domain(x=8, boundaries=PERIODIC_DOMAIN).grid(0.).boundary == tm.extrapolation.PERIODIC
    with pytest.warns(DeprecationWarning):
        Domain(x=4, y=4)


@pytest.mark.parametrize('preset', ['CLOSED', 'OPEN'])
def test_domain_simulation_roundtrip(preset):
    """Domain grids plug straight into make_incompressible; the projection equals JAX's from one numpy velocity
    (OPEN: the open box, both outer faces stored)."""
    import phiflow_tpu.physics._boundaries as jb
    import phiflow_tpu_torch.physics._boundaries as tb
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        jd, d = jb.Domain(x=16, y=16, boundaries=getattr(jb, preset)), tb.Domain(x=16, y=16,
                                                                               boundaries=getattr(tb, preset))
        jv, v = jd.staggered_grid(0.), d.staggered_grid(0.)
    rng = np.random.default_rng(2)
    arrays = [rng.standard_normal(tuple(jv.vector[n].values.shape.sizes)).astype(np.float32) for n in 'xy']
    jv = jv.with_values(jm.stack([jm.wrap(a, jm.spatial('x,y')) for a in arrays], jm.dual(vector='x,y')))
    v = v.with_values(tm.stack([tm.wrap(torch.from_numpy(a), tm.spatial('x,y')) for a in arrays], tm.dual(vector='x,y')))
    jv2, jp = jax.jit(lambda u: jfluid.make_incompressible(u, (), jm.Solve('CG', 1e-5, 1e-5)))(jv)
    v2, p = fluid.make_incompressible(v, (), Solve('CG', 1e-5, 1e-5))
    assert float(tm.max(abs(divergence(v2).values))) < 1e-2
    for n in 'xy':
        assert _scaled(v2.vector[n].values.numpy(('x', 'y')), jv2.vector[n].values.numpy(('x', 'y'))) < 1e-4
    assert _scaled(p.values.numpy(('x', 'y')), jp.values.numpy(('x', 'y'))) < 1e-4


def _diffusivity():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((24, 16)).astype(np.float32)
    nu = (0.05 + 0.1 * rng.uniform(size=(24, 16))).astype(np.float32)
    return _pair(u, (0., 0.)), _pair(nu, (jm.extrapolation.BOUNDARY, tm.extrapolation.BOUNDARY))


def test_diffusivity_field_explicit_and_differential():
    (ju, u), (jnu, nu) = _diffusivity()
    got, ref = diffuse.explicit(u, nu, 0.5, substeps=2), jdiffuse.explicit(ju, jnu, 0.5, substeps=2)
    assert _scaled(got.values.numpy(('x', 'y')), ref.values.numpy(('x', 'y'))) < 1e-5
    got, ref = diffuse.differential(u, nu), jdiffuse.differential(ju, jnu)
    assert _scaled(got.values.numpy(('x', 'y')), ref.values.numpy(('x', 'y'))) < 1e-5


def test_diffusivity_field_implicit():
    (ju, u), (jnu, nu) = _diffusivity()
    got = diffuse.implicit(u, nu, 1.0, solve=Solve('CG', 1e-6, 1e-6))
    ref = jdiffuse.implicit(ju, jnu, 1.0, solve=jm.Solve('CG', 1e-6, 1e-6))
    assert _scaled(got.values.numpy(('x', 'y')), ref.values.numpy(('x', 'y'))) < 1e-5


def test_geometry_masks():
    """Hard (by cell centre) and soft (fraction inside) masks of a sphere, centred and at the faces."""
    from phiflow_tpu.field import HardGeometryMask as JHard, SoftGeometryMask as JSoft
    for jmask, mask in ((JHard(JSphere(x=5., y=6., radius=3.)), HardGeometryMask(Sphere(x=5., y=6., radius=3.))),
                        (JSoft(JSphere(x=5., y=6., radius=3.)), SoftGeometryMask(Sphere(x=5., y=6., radius=3.)))):
        jg, g = JCenteredGrid(jmask, 0, x=12, y=10), CenteredGrid(mask, 0, x=12, y=10)
        np.testing.assert_allclose(g.values.numpy(('x', 'y')), jg.values.numpy(('x', 'y')), atol=1e-6)
        jg, g = JStaggeredGrid(jmask, 0, x=12, y=10), StaggeredGrid(mask, 0, x=12, y=10)
        for n in 'xy':
            np.testing.assert_allclose(g.vector[n].values.numpy(('x', 'y')),
                                       jg.vector[n].values.numpy(('x', 'y')), atol=1e-6)


def test_solve_pressure_field():
    """The unmasked pressure solve of a ready divergence Field, closed box, the V-cycle preconditioned CG."""
    rng = np.random.default_rng(7)
    div = rng.standard_normal((32, 16)).astype(np.float32)
    div -= div.mean()
    jd, d = _pair(div, (jm.extrapolation.BOUNDARY, tm.extrapolation.BOUNDARY))
    jp = jfluid.solve_pressure_field(jd, jm.extrapolation.ZERO, jm.Solve('CG', 1e-6, 1e-6))
    p = fluid.solve_pressure_field(d, tm.extrapolation.ZERO, Solve('CG', 1e-6, 1e-6))
    assert _scaled(p.values.numpy(('x', 'y')), jp.values.numpy(('x', 'y'))) < 1e-4


def test_poiseuille_steady_state_f64():
    """ν·u'' + G·sin(πy) = 0 with no-slip walls, marched to steady state by order-6 implicit diffusion with
    'biCG-stab(2)' at 1e-10 in float64 (JAX's test, 25 steps of dt 2)."""
    def march(m, Box_, CenteredGrid_, diffuse_, compile_=lambda f: f):
        n, nu, G = 48, 0.1, 1.0
        u = CenteredGrid_(0., m.extrapolation.ZERO, y=n, bounds=Box_(y=1.))
        force = CenteredGrid_(lambda pos: G * m.sin(np.pi * pos.vector['y']), m.extrapolation.ZERO, y=n,
                              bounds=Box_(y=1.))
        step = compile_(lambda u: diffuse_.implicit(u + 2.0 * force, nu, 2.0, order=6,
                                                    solve=m.Solve('biCG-stab(2)', 1e-10, 1e-10, max_iterations=500)))
        for _ in range(25):
            u = step(u)
        return u.values.numpy('y')

    with jm.precision(64), tm.precision(64):
        ref = march(jm, JBox, JCenteredGrid, jdiffuse, jax.jit)  # JAX's step jitted: its tracing dominates
        got = march(tm, Box, CenteredGrid, diffuse)
    scale = 1.0 / (0.1 * np.pi ** 2)
    analytic = scale * np.sin(np.pi * (np.arange(48) + 0.5) / 48)
    assert got.dtype == np.float64
    assert np.max(np.abs(got - analytic)) < 2e-4 * scale
    np.testing.assert_allclose(got, ref, atol=1e-8 * scale)

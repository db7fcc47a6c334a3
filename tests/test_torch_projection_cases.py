"""`make_incompressible` in every case the JAX package computes, the port
against JAX on the CPU from the same numpy-seeded velocity (float32): any
solve method ('CG-adaptive' with a union of boxes, 'biCG-stab',
'biCG-stab(2)', 'direct', 'scipy-direct'), a caller's preconditioner, a
preconditioner string JAX ignores ('ilu'), walls with a normal velocity,
cells of unequal size, the open box (both outer faces stored), the compact
stencil of a centred velocity and a nested domain (x0's boundary a coarse
Field). Velocity and pressure agree within 1e-4 of each field's scale where
both solves converged (the JAX suite's projection tolerance); the methods'
own test solves to 1e-6, where two unpreconditioned Krylov runs that stop
at 1e-5 of the residual still differ by ~1e-4 of the velocity. JAX's side
is jitted, as `examples/fluid_logo.py` runs it: that cuts its tracing time
to a third. Then the cases the JAX package fails on, which the port
refuses, and two steps of `examples/fluid_logo.py` at its 64²."""
import jax
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.field import CenteredGrid as JCenteredGrid, StaggeredGrid as JStaggeredGrid
from phiflow_tpu.geom import Box as JBox, Sphere as JSphere, union as junion
from phiflow_tpu.physics import fluid as jfluid

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.field import CenteredGrid, StaggeredGrid, divergence, resample
from phiflow_tpu_torch.geom import Box, Sphere, union
from phiflow_tpu_torch.math import Solve
from phiflow_tpu_torch.physics import fluid

TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _smooth(shape, rng):
    grids = np.meshgrid(*[np.arange(s) / max(shape) for s in shape], indexing='ij')
    out = np.zeros(shape)
    for _ in range(3):
        k = rng.integers(1, 3, len(shape))
        ph = rng.uniform(0, 2 * np.pi, len(shape))
        out += np.prod([np.sin(2 * np.pi * k[i] * grids[i] + ph[i]) for i in range(len(shape))], axis=0)
    return (out / np.abs(out).max()).astype(np.float32)


def _velocities(jv, v, seed):
    """JAX's and the port's velocity Fields with the same smooth random values."""
    rng = np.random.default_rng(seed)
    names = v.resolution.names
    if v.is_staggered:
        arrays = [_smooth(tuple(c.shape.only(names, reorder=True).sizes), rng) for c in
                  (jv.vector[d].values for d in names)]
        jvals = jm.stack([jm.wrap(a, jm.spatial(*names)) for a in arrays], jm.dual(vector=names))
        vals = tm.stack([tm.wrap(torch.from_numpy(a), tm.spatial(*names)) for a in arrays], tm.dual(vector=names))
    else:
        arr = np.stack([_smooth(tuple(v.resolution.sizes), rng) for _ in names], -1)
        jvals = jm.wrap(arr, jm.spatial(*names), jm.channel(vector=names))
        vals = tm.wrap(torch.from_numpy(arr), tm.spatial(*names), tm.channel(vector=names))
    return jv.with_values(jvals), v.with_values(vals)


def _scaled_error(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-12))


def _arrays(field):
    names = field.resolution.names
    if field.is_staggered:
        return [field.vector[d].values.numpy(names) for d in names]
    return [field.values.numpy(field.values.shape.names)]


def _compare(j_out, t_out):
    for jf, tf in zip(j_out, t_out):
        for ja, ta in zip(_arrays(jf), _arrays(tf)):
            assert ja.shape == ta.shape
            assert _scaled_error(ta, ja) < TOL


def _both(boundary_j, boundary_t, res, seed=0, bounds=None, centred=False, jsolve=None, tsolve=None, **kwargs):
    """Project one velocity in both packages with the given Solves; return (JAX's, the port's) outputs."""
    names = tuple(res)
    jb = JBox(**{n: float(s) for n, s in (bounds or res).items()})
    tb = Box(**{n: float(s) for n, s in (bounds or res).items()})
    grid_j, grid_t = (JCenteredGrid, CenteredGrid) if centred else (JStaggeredGrid, StaggeredGrid)
    jv, v = _velocities(grid_j((0.,) * len(names), boundary_j, bounds=jb, **res),
                        grid_t((0.,) * len(names), boundary_t, bounds=tb, **res), seed)
    jobs, tobs = kwargs.pop('obstacles', ((), ()))
    j_out = jax.jit(lambda u: jfluid.make_incompressible(u, jobs, jsolve, **kwargs))(jv)
    t_out = fluid.make_incompressible(v, tobs, tsolve, **kwargs)
    return j_out, t_out


@pytest.mark.parametrize('method', ['CG-adaptive', 'biCG-stab', 'biCG-stab(2)', 'direct', 'scipy-direct'])
def test_solve_methods_closed_box(method):
    j_out, t_out = _both(0., 0., dict(x=24, y=16), jsolve=jm.Solve(method, 1e-6, 1e-6),
                         tsolve=Solve(method, 1e-6, 1e-6))
    _compare(j_out, t_out)


@pytest.mark.parametrize('boundary', ['periodic', 'x-periodic'])
def test_direct_on_a_3d_box_with_periodic_axes(boundary):
    """The direct solve's matrix from `fluid._stencil_matrix`'s coloured probes in 3D, along periodic axes of 8, 6
    and 7 cells (4, 3 and 7 colours: the smallest divisor ≥ 3 of each size) and beside closed ones."""
    jb = jm.extrapolation.PERIODIC if boundary == 'periodic' else \
        jm.extrapolation.combine_sides(x=jm.extrapolation.PERIODIC, y=jm.extrapolation.ZERO, z=jm.extrapolation.ZERO)
    tb = tm.extrapolation.PERIODIC if boundary == 'periodic' else \
        tm.extrapolation.combine_sides(x=tm.extrapolation.PERIODIC, y=tm.extrapolation.ZERO, z=tm.extrapolation.ZERO)
    j_out, t_out = _both(jb, tb, dict(x=8, y=6, z=7), jsolve=jm.Solve('direct', 1e-6, 1e-6),
                         tsolve=Solve('direct', 1e-6, 1e-6))
    _compare(j_out, t_out)


def test_cg_adaptive_with_a_union_of_boxes():
    """The `examples/fluid_logo.py` solve: CG-adaptive, masked Chebyshev."""
    boxes = [((4, 9), (10, 26)), ((14, 19), (10, 26)), ((9, 14), (22, 26))]
    jgeo = junion([JBox(x=x, y=y) for x, y in boxes])
    tgeo = union([Box(x=x, y=y) for x, y in boxes])
    j_out, t_out = _both(0., 0., dict(x=32, y=32), obstacles=(jgeo, tgeo),
                         jsolve=jm.Solve('CG-adaptive', 1e-5, 1e-5), tsolve=Solve('CG-adaptive', 1e-5, 1e-5))
    _compare(j_out, t_out)


@pytest.mark.parametrize('kind', ['callable', 'ilu'])
def test_preconditioners(kind):
    """A caller's preconditioner (a scaled identity) is used as given; a string JAX ignores."""
    pre_j = (lambda r: r * -0.25) if kind == 'callable' else 'ilu'
    pre_t = (lambda r: r * -0.25) if kind == 'callable' else 'ilu'
    j_out, t_out = _both(0., 0., dict(x=16, y=16), jsolve=jm.Solve('CG', 1e-5, 1e-5, preconditioner=pre_j),
                         tsolve=Solve('CG', 1e-5, 1e-5, preconditioner=pre_t))
    _compare(j_out, t_out)


def test_walls_with_a_normal_velocity_and_unequal_cells():
    """Flow through the x walls at unit speed, cells twice as long along x, around a sphere."""
    j_out, t_out = _both({'x': 1, 'y': 0}, {'x': 1, 'y': 0}, dict(x=32, y=16), bounds=dict(x=2, y=1),
                         obstacles=([JSphere(x=0.5, y=0.5, radius=0.2)], [Sphere(x=0.5, y=0.5, radius=0.2)]),
                         jsolve=jm.Solve('CG', 1e-5, 1e-5), tsolve=Solve('CG', 1e-5, 1e-5))
    _compare(j_out, t_out)
    j_out, t_out = _both(0., 0., dict(x=16, y=32), bounds=dict(x=2, y=1), jsolve=jm.Solve('auto', 1e-5, 1e-5),
                         tsolve=Solve('auto', 1e-5, 1e-5))
    _compare(j_out, t_out)


def test_open_box():
    """ZERO_GRADIENT: both outer faces stored, the pressure 0 beyond them (ghost0), no rank deficiency."""
    j_out, t_out = _both(jm.extrapolation.ZERO_GRADIENT, tm.extrapolation.ZERO_GRADIENT, dict(x=32, y=16),
                         jsolve=jm.Solve('CG', 1e-5, 1e-5), tsolve=Solve('CG', 1e-5, 1e-5))
    assert t_out[0].vector['x'].values.shape.get_size('x') == 33
    _compare(j_out, t_out)


def test_centred_compact_stencil():
    j_out, t_out = _both(0., 0., dict(x=16, y=16), centred=True, wide_stencil=False,
                         jsolve=jm.Solve('CG', 1e-5, 1e-5), tsolve=Solve('CG', 1e-5, 1e-5))
    _compare(j_out, t_out)


def _nested_inputs():
    rng = np.random.default_rng(3)
    p_large = rng.standard_normal((32, 32)).astype(np.float32) * 0.1
    jpl = JCenteredGrid(jm.wrap(p_large, jm.spatial('x,y')), jm.extrapolation.BOUNDARY, JBox(x=100, y=100), x=32, y=32)
    tpl = CenteredGrid(tm.wrap(torch.from_numpy(p_large), tm.spatial('x,y')), tm.extrapolation.BOUNDARY,
                       Box(x=100, y=100), x=32, y=32)
    small_j, small_t = JBox(x=(30, 70), y=(40, 80)), Box(x=(30, 70), y=(40, 80))
    jv, v = _velocities(JStaggeredGrid(0, jm.extrapolation.ZERO_GRADIENT, bounds=small_j, x=24, y=24),
                        StaggeredGrid(0, tm.extrapolation.ZERO_GRADIENT, bounds=small_t, x=24, y=24), 4)
    jx0 = JCenteredGrid(0, jpl, bounds=small_j, resolution=jv.resolution)
    x0 = CenteredGrid(0, tpl, bounds=small_t, resolution=v.resolution)
    return jv * 0.1, v * 0.1, jx0, x0


def test_embedding_ghost_cells():
    """The port's ghost cells are JAX's `pad` of one cell on both sides of each axis, within 2e-6. JAX pads the
    lower side first and samples the upper ghosts on the widened values, a grid of one cell more in the same bounds:
    3e-3 off the upper ghosts that `pad_values` of the unpadded values gives (ROADMAP §3, 3.10), which the port
    keeps."""
    from phiflow_tpu.math import _ops as jops
    _, _, jx0, x0 = _nested_inputs()
    for dim in 'xy':
        padded = jops.pad(jx0.values, {dim: (1, 1)}, jx0.boundary, bounds=jx0.bounds).numpy(('x', 'y'))
        for upper in (False, True):
            ref = padded[-1 if upper else 0] if dim == 'x' else padded[:, -1 if upper else 0]
            got = x0.boundary.ghost_cells(x0.geometry, dim, upper).numpy()
            np.testing.assert_allclose(got.reshape(-1), ref.reshape(-1), atol=2e-6)
        unpadded = jx0.boundary.pad_values(jx0.values, 1, dim, True, bounds=jx0.bounds).numpy(('x', 'y'))
        got = x0.boundary.ghost_cells(x0.geometry, dim, True).numpy()
        assert np.abs(unpadded.reshape(-1) - got.reshape(-1)).max() > 1e-3


def test_nested_domain():
    """`tests/physics/test_fluid.py::test_embedded_pressure_boundary_solve` on numpy inputs, with and without
    the sphere: x0's boundary samples a coarse pressure, with JAX's ghost cells (`test_embedding_ghost_cells`)."""
    jv, v, jx0, x0 = _nested_inputs()
    for jobs, tobs in (([JSphere(x=50, y=60, radius=5)], [Sphere(x=50, y=60, radius=5)]), ([], [])):
        j_out = jax.jit(lambda u, x: jfluid.make_incompressible(u, jobs, jm.Solve('CG', 1e-5, 1e-5, x0=x,
                                                                                  max_iterations=4000)))(jv, jx0)
        t_out = fluid.make_incompressible(v, tobs, Solve('CG', 1e-5, 1e-5, x0=x0, max_iterations=4000))
        _compare(j_out, t_out)
        div = divergence(t_out[0])
        dd = np.abs(div.values.numpy(('x', 'y')))
        if tobs:
            dd = dd * (1 - resample(tobs[0], div, soft=False).values.numpy(('x', 'y')))
        assert dd.max() < 1e-3  # the JAX test's bound


@pytest.mark.parametrize('case', ['staggered-order-4', 'centred-obstacle', 'staggered-wide', 'centred-active'])
def test_cases_jax_fails_on_raise(case):
    v = (CenteredGrid if case.startswith('centred') else StaggeredGrid)((0., 0.), 0., x=16, y=16)
    kwargs = {'staggered-order-4': dict(order=4), 'centred-obstacle': dict(obstacles=[Sphere(x=8, y=8, radius=3)]),
              'staggered-wide': dict(wide_stencil=True),
              'centred-active': dict(active=CenteredGrid(1., 0., x=16, y=16))}[case]
    with pytest.raises(NotImplementedError):
        fluid.make_incompressible(v, solve=Solve('CG', 1e-5, 1e-5), **kwargs)


def test_fluid_logo_two_steps():
    """`examples/fluid_logo.py` at its 64² for 2 steps, through each package's public functions."""
    from phiflow_tpu.field import resample as jresample
    from phiflow_tpu.physics import advect as jadvect
    from phiflow_tpu_torch.field import resample
    from phiflow_tpu_torch.physics import advect

    def setup(m, Box_, union_, CenteredGrid_, StaggeredGrid_, fluid_):
        domain = dict(x=64, y=64, bounds=Box_(x=100, y=100))
        geometries = [Box_(x=(15 + x * 7, 15 + (x + 1) * 7), y=(41, 83)) for x in range(1, 10, 2)] + \
            [Box_(x=(43, 50), y=(41, 48)), Box_(x=(15, 43), y=(83, 90)), Box_(x=(50, 85), y=(83, 90))]
        zg = m.extrapolation.ZERO_GRADIENT
        inflow = CenteredGrid_(Box_(x=(14, 21), y=(6, 10)), zg, **domain) + \
            CenteredGrid_(Box_(x=(81, 88), y=(6, 10)), zg, **domain) * 0.9 + \
            CenteredGrid_(Box_(x=(44, 47), y=(49, 51)), zg, **domain) * 0.4
        v0 = StaggeredGrid_(0, boundary=0, **domain)
        return union_(geometries), inflow, CenteredGrid_(0, boundary=zg, **domain), v0, \
            CenteredGrid_(0., fluid_._pressure_extrapolation(v0.boundary), **domain)

    def step(m, advect_, resample_, fluid_, geometry, inflow, smoke, v, p):
        smoke = advect_.semi_lagrangian(smoke, v, 1) + inflow
        v = advect_.semi_lagrangian(v, v, 1) + resample_(smoke * (0, 0.1), to=v)
        v, p = fluid_.make_incompressible(v, geometry, m.Solve('CG-adaptive', 1e-5, 1e-5, x0=p))
        return smoke, v, p

    jgeometry, jinflow, *j_out = setup(jm, JBox, junion, JCenteredGrid, JStaggeredGrid, jfluid)
    jstep = jax.jit(lambda s, v, p: step(jm, jadvect, jresample, jfluid, jgeometry, jinflow, s, v, p))  # as the example
    geometry, inflow, *t_out = setup(tm, Box, union, CenteredGrid, StaggeredGrid, fluid)
    for _ in range(2):
        j_out = jstep(*j_out)
        t_out = step(tm, advect, resample, fluid, geometry, inflow, *t_out)
    _compare(j_out, t_out)
    assert float(tm.sum(t_out[0].values)) > 10


def test_window_lookup_takes_contiguous_arrays(monkeypatch):
    """Fault 3.9: a Field's constant values are broadcast views; the semi-Lagrangian lookup hands the window kernel
    (which takes contiguous arrays only) contiguous ones — the CPU twin would accept any layout, so the test
    records what reaches the kernel's wrapper."""
    from phiflow_tpu_torch.math import _nd
    from phiflow_tpu_torch.physics import advect
    seen = []
    kernel = _nd.window_interp_2d

    def recording(grid, disps, *args, **kwargs):
        seen.append(grid.is_contiguous() and all(d.is_contiguous() for d in disps))
        return kernel(grid, disps, *args, **kwargs)
    monkeypatch.setattr(_nd, 'window_interp_2d', recording)
    smoke = CenteredGrid(0, tm.extrapolation.ZERO_GRADIENT, x=16, y=16)
    v = StaggeredGrid(0, 0, x=16, y=16)
    assert not smoke.values.torch(('x', 'y')).is_contiguous()
    advect.semi_lagrangian(smoke, v, 1.)
    advect.semi_lagrangian(v, v, 1.)
    assert seen and all(seen)

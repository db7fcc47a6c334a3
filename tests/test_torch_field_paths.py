"""The port's Field API on the smoke path against the JAX package's and against
the port's own array layer, on the CPU: `SmokePlume`'s per-phase step written
as a user writes it (`advect.mac_cormack`, `advect.semi_lagrangian`, the
buoyancy through `resample`, `fluid.make_incompressible` with a `Solve`) for 2
steps in 3D and 2D, closed and periodic, within 2e-4 of JAX with equal CG
counts and bit-equal to the array layer; `mac_cormack` / `semi_lagrangian` on
Fields within 1e-5; `make_incompressible` around a `Sphere` at 24³ within 1e-4
of the field's scale; a moving lid through advection and projection against
JAX; the refusals of `wide_stencil` and of staggered velocities in a layout
the array layer lacks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jmath
from phiflow_tpu.geom import Sphere as JSphere
from phiflow_tpu.models import SmokePlume as JaxSmoke
from phiflow_tpu.physics import advect as jadvect, fluid as jfluid

import phiflow_tpu_torch.math as math
from phiflow_tpu_torch.field import CenteredGrid, StaggeredGrid, divergence, resample
from phiflow_tpu_torch.field._field import face_components
from phiflow_tpu_torch.geom import Box, Sphere
from phiflow_tpu_torch.math import ConvergenceException, Solve, SolveTape, dual, extrapolation, spatial, stack
from phiflow_tpu_torch.models import SmokePlume
from phiflow_tpu_torch.physics import advect, fluid

CONFIGS = [dict(dims=3, resolution=16), dict(dims=2, resolution=32),
           dict(dims=3, resolution=16, periodic=True), dict(dims=2, resolution=32, periodic=True)]
IDS = ['3d', '2d', '3d-periodic', '2d-periodic']


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with math.default_device('cpu'):
        yield


def _names(dims):
    return tuple('xyz'[:dims])


def _smooth(shape, rng, amp):
    n = max(shape)
    grids = np.meshgrid(*[np.arange(s) / n for s in shape], indexing='ij')
    out = np.zeros(shape)
    for _ in range(3):
        k = rng.integers(1, 3, len(shape))
        ph = rng.uniform(0, 2 * np.pi, len(shape))
        out += np.prod([np.sin(2 * np.pi * k[i] * grids[i] + ph[i]) for i in range(len(shape))], axis=0)
    return (amp * out / np.abs(out).max()).astype(np.float32)


def _state_arrays(model: SmokePlume, seed, amp=1.2):
    """A smooth random (velocity components, smoke) in the model's layout: |v|·dt/dx ≤ 0.6."""
    rng = np.random.default_rng(seed)
    comps, cells = model._shapes()
    return [_smooth(s, rng, amp) for s in comps], 0.5 + _smooth(cells, rng, 0.5)


def _fields(vel, smoke, pressure, periodic, size):
    """The port's (velocity, smoke, pressure) Fields on the given arrays."""
    names = _names(len(vel))
    bounds = Box(**{n: float(size) for n in names})
    res = {n: smoke.shape[i] for i, n in enumerate(names)}
    v = StaggeredGrid(stack([math.wrap(torch.from_numpy(a), spatial(*names)) for a in vel], dual(vector=names)),
                      extrapolation.PERIODIC if periodic else 0., bounds=bounds, **res)
    s_ext = extrapolation.PERIODIC if periodic else extrapolation.BOUNDARY
    s = CenteredGrid(math.wrap(torch.from_numpy(smoke), spatial(*names)), s_ext, bounds=bounds, **res)
    p = CenteredGrid(math.wrap(torch.from_numpy(pressure), spatial(*names)), s_ext, bounds=bounds, **res)
    return v, s, p


def _jax_fields(jax_model, vel, smoke, pressure):
    from phiflow_tpu.math import Tensor
    names = _names(len(vel))
    v0, s0, p0 = jax_model.initial_state()
    comps = [Tensor(jnp.asarray(a), v0.vector[d].values.shape.only(names, reorder=True)) for d, a in zip(names, vel)]
    v = v0.with_values(jmath.stack(comps, jmath.dual(vector=list(names))))
    s = s0.with_values(Tensor(jnp.asarray(smoke), s0.values.shape.only(names, reorder=True)))
    p = p0.with_values(Tensor(jnp.asarray(pressure), p0.values.shape.only(names, reorder=True)))
    return v, s, p


def field_step(model: SmokePlume, v, s, p, inflow):
    """One per-phase smoke step in the Field API, as JAX's `SmokePlume` writes it."""
    names = v.resolution.names
    s = advect.mac_cormack(s, v, model.dt, max_cells=model.max_cells) + model.inflow_rate * inflow
    adv = advect.semi_lagrangian(v, v, model.dt, max_cells=model.max_cells)
    up = names[-1]
    lift = resample(s * (model.buoyancy * model.dt), to=adv.vector[up])
    v = adv.with_values(stack([adv.vector[d].values + lift.values if d == up else adv.vector[d].values
                               for d in names], dual(vector=names)))
    v, p = fluid.make_incompressible(v, (), Solve('CG', model.cg_tol, 0., x0=p, max_iterations=model.max_iterations,
                                                  suppress=(ConvergenceException,)))
    return v, s, p


def _inflow(model, s):
    return s.with_values(math.wrap(model._inflow_mask_values_native(s.values.native(s.resolution.names)), s.resolution))


def _arrays(v, s, p):
    names = v.resolution.names
    return [c.numpy(names) for c in face_components(v.values)], s.values.numpy(names), p.values.numpy(names)


@pytest.mark.parametrize('kwargs', CONFIGS, ids=IDS)
def test_field_step_matches_jax_and_array_layer(kwargs):
    """2 steps from a smooth random state: within 2e-4 of JAX's `SmokePlume`
    per-phase step with equal CG counts, and bit-equal to the port's
    array-level step on the same inputs."""
    from phiflow_tpu.math import SolveTape as JSolveTape
    kw = dict(kwargs, cg_tol=1e-5, max_iterations=200)
    jax_model = JaxSmoke(**kw)
    model = SmokePlume(device='cpu', **kw)
    vel, smoke = _state_arrays(model, seed=7)
    pressure = np.zeros_like(smoke)
    v, s, p = _fields(vel, smoke, pressure, model.periodic, model._resolution)
    jv, js, jp = _jax_fields(jax_model, vel, smoke, pressure)
    tv, ts, tp = tuple(torch.from_numpy(a) for a in vel), torch.from_numpy(smoke), torch.from_numpy(pressure)
    inflow = _inflow(model, s)

    def jax_step(jv, js, jp):
        js = jax_model.advect_smoke(jv, js)
        jv = jax_model.advect_velocity(jv, js)
        jv, jp = jax_model.project(jv, jp)
        return jv, js, jp
    with JSolveTape(record_runtime=True) as jtape:
        jax_step = jax.jit(jax_step)
        for _ in range(2):
            with SolveTape() as tape:
                v, s, p = field_step(model, v, s, p, inflow)
            jv, js, jp = jax_step(jv, js, jp)
            jax.block_until_ready(jp.values.native())
            assert tape[0].iterations == jtape.solve_infos[-1].runtime_stats['iterations']
            ts = model.advect_smoke_native(tv, ts)
            tv = model.advect_velocity_native(tv, ts)
            tv, tp = model.project_native(tv, tp)
            assert tape[0].iterations == model.last_solve.iterations
            got_v, got_s, got_p = _arrays(v, s, p)
            assert all(np.array_equal(g, r.numpy()) for g, r in zip(got_v, tv)), "velocity differs from the array layer"
            assert np.array_equal(got_s, ts.numpy()) and np.array_equal(got_p, tp.numpy())
    names = _names(model.dims)
    for g, d in zip(got_v, names):
        assert np.abs(g - np.asarray(jv.vector[d].values.native(names))).max() < 2e-4, d
    assert np.abs(got_s - np.asarray(js.values.native(names))).max() < 2e-4
    assert np.abs(got_p - np.asarray(jp.values.native(names))).max() < 2e-4
    assert float(divergence(v).values.torch().abs().max()) < 1e-2


@pytest.mark.parametrize('kwargs', CONFIGS, ids=IDS)
def test_advection_of_fields_matches_jax(kwargs):
    """The smoke and the velocity advected by the velocity with
    `semi_lagrangian` and `mac_cormack`, max_cells 1 and 2, against JAX's
    functions of the same name within 1e-5."""
    model = SmokePlume(device='cpu', **kwargs)
    jax_model = JaxSmoke(**kwargs)
    vel, smoke = _state_arrays(model, seed=11, amp=1.6)
    v, s, _ = _fields(vel, smoke, smoke, model.periodic, model._resolution)
    jv, js, _ = _jax_fields(jax_model, vel, smoke, smoke)
    names = _names(model.dims)
    cases = [(scheme, max_cells, kind) for scheme in ('semi_lagrangian', 'mac_cormack') for max_cells in (1, 2)
             for kind in ('smoke', 'velocity')]

    def jax_all(jv, js):
        return [getattr(jadvect, scheme)(js if kind == 'smoke' else jv, jv, model.dt, max_cells=max_cells)
                for scheme, max_cells, kind in cases]
    refs = jax.jit(jax_all)(jv, js)
    for (scheme, max_cells, kind), ref in zip(cases, refs):
        got = getattr(advect, scheme)(s if kind == 'smoke' else v, v, model.dt, max_cells=max_cells)
        if got.is_staggered:
            pairs = [(got.vector[d].values.numpy(names), ref.vector[d].values.native(names)) for d in names]
        else:
            pairs = [(got.values.numpy(names), ref.values.native(names))]
        for g, r in pairs:
            assert g.shape == np.asarray(r).shape
            assert np.abs(g - np.asarray(r)).max() < 1e-5, (scheme, max_cells, kind)


@pytest.mark.parametrize('periodic', [False, True], ids=['closed', 'periodic'])
def test_make_incompressible_with_sphere_matches_jax(periodic):
    """A projection around a `Sphere` at 24³ (K1m's coefficient form on the
    card): velocity and pressure within 1e-4 of the field's scale."""
    n = 24
    model = SmokePlume(resolution=n, dims=3, periodic=periodic, device='cpu')
    vel, _ = _state_arrays(model, seed=13, amp=1.0)
    zeros = np.zeros((n,) * 3, np.float32)
    v, _, _ = _fields(vel, zeros, zeros, periodic, n)
    jv, _, _ = _jax_fields(JaxSmoke(resolution=n, dims=3, periodic=periodic), vel, zeros, zeros)
    solve = dict(max_iterations=300, suppress=(ConvergenceException,))
    with SolveTape() as tape:
        v2, p2 = fluid.make_incompressible(v, [Sphere(x=12., y=11., z=13., radius=5.)], Solve('CG', 1e-5, 1e-5, **solve))
    jv2, jp2 = jax.jit(lambda jv: jfluid.make_incompressible(jv, [JSphere(x=12., y=11., z=13., radius=5.)],
                                                             jmath.Solve('CG', 1e-5, 1e-5, **solve)))(jv)
    assert tape[0].converged
    names = _names(3)
    for d in names:
        ref = np.asarray(jv2.vector[d].values.native(names))
        got = v2.vector[d].values.numpy(names)
        assert np.abs(got - ref).max() < 1e-4 * max(1.0, np.abs(ref).max()), d
    ref_p = np.asarray(jp2.values.native(names))
    assert np.abs(p2.values.numpy(names) - ref_p).max() < 1e-4 * max(1.0, np.abs(ref_p).max())
    assert p2.boundary == extrapolation.PERIODIC if periodic else p2.boundary == extrapolation.BOUNDARY


def test_field_api_raises_for_later_slices():
    """`substeps='auto'` and the gather (`max_cells=None`) run since the open-boundary slice and equal JAX's
    within 1e-5 of the smoke's scale; a staggered projection at order 4 still raises, as JAX fails there."""
    model = SmokePlume(resolution=8, dims=2, device='cpu')
    jmodel = JaxSmoke(resolution=8, dims=2)
    vel, smoke = _state_arrays(model, seed=1)
    v, s, _ = _fields(vel, smoke, smoke, False, 8)
    jv, js, _ = _jax_fields(jmodel, vel, smoke, smoke)
    for got, ref in ((advect.semi_lagrangian(s, v, 0.5, substeps='auto'), jadvect.semi_lagrangian(js, jv, 0.5,
                                                                                                  substeps='auto')),
                     (advect.mac_cormack(s, v, 0.5, max_cells=None), jadvect.mac_cormack(js, jv, 0.5, max_cells=None))):
        ref = np.asarray(ref.values.native(('x', 'y')))
        assert np.abs(got.values.numpy(('x', 'y')) - ref).max() < 1e-5 * np.abs(ref).max()
    with pytest.raises(NotImplementedError, match='order'):
        fluid.make_incompressible(v, (), Solve('biCG-stab'), order=4)


def test_apply_boundary_conditions_matches_jax():
    """A moving, spinning sphere's velocity blended into a 2D staggered Field,
    against JAX's `apply_boundary_conditions` (closed box, float32)."""
    from phiflow_tpu.physics.fluid import Obstacle as JObstacle
    from phiflow_tpu_torch.physics.fluid import Obstacle
    model = SmokePlume(resolution=32, dims=2, device='cpu')
    vel, _ = _state_arrays(model, seed=17)
    zeros = np.zeros((32, 32), np.float32)
    v, _, _ = _fields(vel, zeros, zeros, False, 32)
    jv, _, _ = _jax_fields(JaxSmoke(resolution=32, dims=2), vel, zeros, zeros)
    obstacle = Obstacle(Sphere(x=15., y=17., radius=6.), velocity=math.vec(x=0.5, y=-0.25), angular_velocity=0.1)
    jobstacle = JObstacle(JSphere(x=15., y=17., radius=6.), velocity=jmath.vec(x=0.5, y=-0.25), angular_velocity=0.1)
    got = fluid.apply_boundary_conditions(v, [obstacle])
    ref = jfluid.apply_boundary_conditions(jv, [jobstacle])
    for d in 'xy':
        np.testing.assert_allclose(got.vector[d].values.numpy(('x', 'y')),
                                   np.asarray(ref.vector[d].values.native(('x', 'y'))), atol=1e-6)


def test_make_incompressible_refuses_wide_stencil():
    """JAX solves another Laplacian with ``wide_stencil=True``; the port
    raises. ``correct_skew``, unused by JAX's projection, changes nothing."""
    model = SmokePlume(resolution=16, dims=2, device='cpu')
    vel, _ = _state_arrays(model, seed=19)
    zeros = np.zeros((16, 16), np.float32)
    v, _, _ = _fields(vel, zeros, zeros, False, 16)
    solve = Solve('CG', 1e-5, 1e-5, max_iterations=200)
    with pytest.raises(NotImplementedError, match='wide-stencil'):
        fluid.make_incompressible(v, (), solve, wide_stencil=True)
    v1, p1 = fluid.make_incompressible(v, (), solve)
    for kwargs in (dict(wide_stencil=False), dict(correct_skew=True)):
        v2, p2 = fluid.make_incompressible(v, (), solve, **kwargs)
        assert np.array_equal(p2.values.numpy('x,y'), p1.values.numpy('x,y'))
        for d in 'xy':
            assert np.array_equal(v2.vector[d].values.numpy('x,y'), v1.vector[d].values.numpy('x,y'))


def test_moving_lid_advection_and_projection_match_jax():
    """A closed 2D box whose upper y wall moves along x (JAX's
    `LidDrivenCavity` boundary): `semi_lagrangian` and `mac_cormack` of the
    velocity by itself within 1e-5 of JAX, `make_incompressible` within 1e-4
    of the field's scale."""
    n, dt = 32, 0.5
    lid = dict(x=0., y=(0., math.vec(x=1., y=0.)))
    jlid = dict(x=0., y=(0., jmath.vec(x=1., y=0.)))
    model = SmokePlume(resolution=n, dims=2, device='cpu')
    vel, _ = _state_arrays(model, seed=23)
    zeros = np.zeros((n, n), np.float32)
    v, _, _ = _fields(vel, zeros, zeros, False, n)
    jv, _, _ = _jax_fields(JaxSmoke(resolution=n, dims=2), vel, zeros, zeros)
    v = v.with_boundary(extrapolation.combine_sides(**lid))
    jv = jv.with_boundary(jmath.extrapolation.combine_sides(**jlid))
    names = _names(2)
    schemes = ('semi_lagrangian', 'mac_cormack')
    refs = jax.jit(lambda jv: [getattr(jadvect, scheme)(jv, jv, dt, max_cells=2) for scheme in schemes])(jv)
    for scheme, ref in zip(schemes, refs):
        got = getattr(advect, scheme)(v, v, dt, max_cells=2)
        for d in names:
            assert np.abs(got.vector[d].values.numpy(names) - np.asarray(ref.vector[d].values.native(names))).max() \
                < 1e-5, (scheme, d)
    solve = dict(max_iterations=300, suppress=(ConvergenceException,))
    v2, p2 = fluid.make_incompressible(v, (), Solve('CG', 1e-5, 1e-5, **solve))
    jv2, jp2 = jax.jit(lambda jv: jfluid.make_incompressible(jv, (), jmath.Solve('CG', 1e-5, 1e-5, **solve)))(jv)
    for got, ref in [(v2.vector[d].values.numpy(names), jv2.vector[d].values.native(names)) for d in names] + \
            [(p2.values.numpy(names), jp2.values.native(names))]:
        ref = np.asarray(ref)
        assert np.abs(got - ref).max() < 1e-4 * max(1.0, np.abs(ref).max())


def test_advection_by_staggered_velocity_refuses_other_layouts():
    """A staggered velocity in the zero-gradient box (both outer faces
    stored), which the array layer takes since the open-boundary slice,
    advects the smoke as JAX's does, within 1e-5 of its scale."""
    from phiflow_tpu.field import CenteredGrid as JCenteredGrid, StaggeredGrid as JStaggeredGrid
    from phiflow_tpu.geom import Box as JBox
    model = SmokePlume(resolution=8, dims=2, device='cpu')
    _, smoke = _state_arrays(model, seed=29)
    _, s, _ = _fields([np.zeros((7, 8), np.float32), np.zeros((8, 7), np.float32)], smoke, smoke, False, 8)
    js = JCenteredGrid(jmath.wrap(smoke, jmath.spatial('x,y')), jmath.extrapolation.BOUNDARY, bounds=JBox(x=8., y=8.),
                       x=8, y=8)
    v = StaggeredGrid(0.5, extrapolation.BOUNDARY, bounds=Box(x=8., y=8.), x=8, y=8)
    jv = JStaggeredGrid(0.5, jmath.extrapolation.BOUNDARY, bounds=JBox(x=8., y=8.), x=8, y=8)
    for scheme, jscheme in ((advect.semi_lagrangian, jadvect.semi_lagrangian),
                            (advect.mac_cormack, jadvect.mac_cormack)):
        ref = np.asarray(jscheme(js, jv, 0.5, max_cells=1).values.native(('x', 'y')))
        got = scheme(s, v, 0.5, max_cells=1).values.numpy(('x', 'y'))
        assert np.abs(got - ref).max() < 1e-5 * np.abs(ref).max()

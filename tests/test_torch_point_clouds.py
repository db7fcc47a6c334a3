"""Point clouds as Fields in the port — `PointCloud`, `distribute_points`,
`mask`, `resample` between particles and grids, `advect.points` with
`finite_rk4` and `euler`, `fluid.boundary_push` — and `FlipLiquid` through
its Field face, against the JAX package on the CPU (the port takes its plain
twins there: K8's `index_add_` scatter, K1m's roll stencil), and the FLIP
Field step bit-equal to `step_native`. The same particles, made with numpy
from a seed, go through both packages."""
import jax
import numpy as np
import pytest
import torch

from phiflow_tpu.field import CenteredGrid as JCenteredGrid, PointCloud as JPointCloud, StaggeredGrid as JStaggeredGrid
from phiflow_tpu.field import distribute_points as jax_distribute_points, finite_fill as jax_finite_fill
from phiflow_tpu.field import mask as jax_mask, resample as jax_resample
from phiflow_tpu.field._resample import sample as jax_sample
from phiflow_tpu.geom import Box as JBox, Cuboid as JCuboid, Point as JPoint, Sphere as JSphere
from phiflow_tpu.math import Tensor as JTensor, channel as jchannel, dual as jdual, instance as jinstance
from phiflow_tpu.math import spatial as jspatial, stack as jstack, wrap as jwrap
from phiflow_tpu.models import FlipLiquid as JaxFlip
from phiflow_tpu.physics import advect as jax_advect, fluid as jax_fluid

import phiflow_tpu_torch.math as math
from phiflow_tpu_torch.field import (CenteredGrid, PointCloud, StaggeredGrid, distribute_points, finite_fill, mask,
                                     resample, sample)
from phiflow_tpu_torch.field._field import face_components
from phiflow_tpu_torch.geom import Box, Cuboid, Point, Sphere
from phiflow_tpu_torch.math import SolveTape, channel, instance, wrap
from phiflow_tpu_torch.models import FlipLiquid
from phiflow_tpu_torch.models.flip import state_from_numpy
from phiflow_tpu_torch.physics import advect, fluid

ORDER = ('x', 'y', 'z')


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with math.default_device('cpu'):
        yield


def _points(a, names, jax=False):
    return (jwrap if jax else wrap)(a, (jinstance if jax else instance)('points'),
                                    (jchannel if jax else channel)(vector=','.join(names)))


def _smooth(positions, R, amp):
    d = positions.shape[1]
    return (amp * np.stack([np.sin(2 * np.pi * positions[:, (a + 1) % d] / R) * np.cos(2 * np.pi * positions[:, a] / R)
                            for a in range(d)], axis=1)).astype(np.float32)


def _cloud(pos, vel, names, jax=False):
    """Particles as both packages build them: spheres of a quarter cell, NaN boundary."""
    sphere = (JSphere if jax else Sphere)(_points(pos, names, jax), radius=0.25)
    return (JPointCloud if jax else PointCloud)(sphere, _points(vel, names, jax), float('nan'))


def _jax_np(t, order):
    return np.asarray(t.native(order))


def _staggered(R, names, jax=False):
    kw = {n: R for n in names}
    return (JStaggeredGrid if jax else StaggeredGrid)(0, 0, (JBox if jax else Box)(**{n: float(R) for n in names}), **kw)


@pytest.fixture(scope='module')
def cloud3d():
    """1,500 particles at 12³ with a smooth velocity, some outside the face grids."""
    R, names = 12, ORDER
    rng = np.random.default_rng(4)
    pos = rng.uniform(-1.5, R + 1.5, (1500, 3)).astype(np.float32)
    return R, names, pos, _smooth(pos, R, 1.5)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', [dict(extents=dict(x=(3.6, 13.2), y=(3.6, 13.2), z=(10.8, 20.4)), res=24, ppc=8),
                                  dict(extents=dict(x=(6, 10), y=(24, 28)), res=32, ppc=8),
                                  dict(extents=dict(x=(2, 6), y=(2, 8), z=(2, 6)), res=12, ppc=2, center=True)],
                         ids=['3d-block', '2d', '3d-centres'])
def test_distribute_points_matches_jax_bit_for_bit(case):
    """The points bit for bit, a Sphere of radius ¼ cell each, values 0, a NaN boundary."""
    names = tuple(case['extents'])
    kw = dict(points_per_cell=case['ppc'], center=case.get('center', False), **{n: case['res'] for n in names})
    ref = jax_distribute_points(JBox(**case['extents']), **kw)
    got = distribute_points(Box(**case['extents']), **kw)
    assert got.is_point_cloud and isinstance(got.geometry, Sphere)
    pts = got.points.numpy(('points', 'vector'))
    assert pts.dtype == np.float32 and pts.shape[0] > 0
    assert np.array_equal(pts, _jax_np(ref.geometry.center, ('points', 'vector')))
    assert float(got.geometry.radius) == float(ref.geometry.radius) == 0.25
    assert float(got.values) == 0. and np.isnan(float(got.boundary.value))


def test_point_cloud_mask_and_arithmetic_match_jax():
    """`PointCloud` from a Tensor of points, `mask` of a point cloud, a grid
    and a geometry, and `Field * tuple` on a point cloud's values."""
    pos = np.random.default_rng(1).uniform(0, 8, (20, 2)).astype(np.float32)
    got, ref = PointCloud(_points(pos, 'xy')), JPointCloud(_points(pos, 'xy', jax=True))
    assert isinstance(got.geometry, Point) and got.is_point_cloud and ref.is_point_cloud
    assert np.array_equal(got.points.numpy(('points', 'vector')), _jax_np(ref.points, ('points', 'vector')))
    scaled, jscaled = got * (2., 3.), ref * (2., 3.)  # one vector for all points; JAX expands it onto the points
    assert scaled.values.numpy('vector').tolist() == [2., 3.]
    assert np.array_equal(np.broadcast_to(scaled.values.numpy('vector'), pos.shape),
                          _jax_np(jscaled.values, ('points', 'vector')))
    m, jm = mask(got), jax_mask(ref)
    assert float(m.values) == 1. and (np.asarray(jm.values.native()) == 1.).all() and float(m.boundary.value) == 0.
    grid = CenteredGrid(wrap(np.array([[0., 1.], [2., 0.]], np.float32), math.spatial('x,y')), 1., x=2, y=2)
    assert mask(grid).values.numpy('x,y').tolist() == [[0., 1.], [1., 0.]] and float(mask(grid).boundary.value) == 0.
    assert float(mask(Box(x=1., y=1.)).values) == 1.


@pytest.mark.parametrize('outside_handling', ['clamp', 'discard'])
def test_resample_points_onto_grids_matches_jax(cloud3d, outside_handling):
    """`resample(particles, grid, scatter=True)` onto the closed box's
    staggered grid (component a of the velocity onto the faces of axis a) and
    of `mask(particles)` onto the cells: the same faces NaN, values within
    1e-6; the occupancy exactly."""
    R, names, pos, vel = cloud3d
    got = resample(_cloud(pos, vel, names), _staggered(R, names), scatter=True, outside_handling=outside_handling)
    ref = jax_resample(_cloud(pos, vel, names, jax=True), _staggered(R, names, jax=True), scatter=True,
                       outside_handling=outside_handling)
    for d, c in zip(names, face_components(got.values)):
        g, r = c.numpy(names), _jax_np(ref.vector[d].values, names)
        assert g.shape == r.shape and np.array_equal(np.isnan(g), np.isnan(r)) and np.isnan(g).any()
        assert float(np.nanmax(np.abs(g - r))) <= 1e-6
    bounds = Box(**{n: float(R) for n in names})
    occupied = resample(mask(_cloud(pos, vel, names)), CenteredGrid(0, got.boundary.spatial_gradient(), bounds,
                                                                     **{n: R for n in names}),
                        scatter=True, outside_handling=outside_handling)
    jocc = jax_resample(jax_mask(_cloud(pos, vel, names, jax=True)),
                        JCenteredGrid(0, ref.boundary.spatial_gradient(), JBox(**{n: float(R) for n in names}),
                                      **{n: R for n in names}), scatter=True, outside_handling=outside_handling)
    assert np.array_equal(occupied.values.numpy(names), _jax_np(jocc.values, names))


def test_resample_grid_at_points_matches_jax(cloud3d):
    """A staggered and a centred grid at the particles (`resample(grid,
    particles)`, `sample` at a `Point`): within 1e-6 of the grid's scale."""
    R, names, pos, vel = cloud3d
    rng = np.random.default_rng(2)
    inside = np.clip(pos, 0.1, R - 0.1)
    comps = [rng.standard_normal(tuple(R - (a == d) for a in range(3))).astype(np.float32) for d in range(3)]
    cells = rng.standard_normal((R,) * 3).astype(np.float32)
    grid = _staggered(R, names).with_values(math.stack(
        [wrap(c, math.spatial('x,y,z')) for c in comps], math.dual(vector='x,y,z')))
    jgrid = _staggered(R, names, jax=True)
    jgrid = jgrid.with_values(jstack([JTensor(c, jgrid.vector[d].values.shape.only(names, reorder=True))
                                      for d, c in zip(names, comps)], jdual(vector=list(names))))
    got = resample(grid, _cloud(inside, vel, names))
    ref = jax_resample(jgrid, _cloud(inside, vel, names, jax=True))
    scale = max(float(np.abs(c).max()) for c in comps)
    assert float(np.abs(got.values.numpy(('points', 'vector')) - _jax_np(ref.values, ('points', 'vector'))).max()) \
        <= 1e-6 * scale
    assert np.isnan(float(got.boundary.value))
    centred = CenteredGrid(wrap(cells, math.spatial('x,y,z')), 0., Box(x=R, y=R, z=R), x=R, y=R, z=R)
    jcentred = JCenteredGrid(jwrap(cells, jspatial('x,y,z')), 0., JBox(x=R, y=R, z=R), x=R, y=R, z=R)
    got_c = sample(centred, Point(_points(pos, names)))
    ref_c = jax_sample(jcentred, JPoint(_points(pos, names, jax=True)))
    assert float(np.abs(got_c.numpy('points') - _jax_np(ref_c, 'points')).max()) <= 1e-6 * float(np.abs(cells).max())


def test_advect_points_and_boundary_push_match_jax(cloud3d):
    """`advect.points` with `finite_rk4` (NaN faces count as zero) and with
    `euler`, then `boundary_push(particles, [~bounds])` and a push out of a
    cuboid: within 1e-5."""
    R, names, pos, vel = cloud3d
    grid = resample(_cloud(pos, vel, names), _staggered(R, names), scatter=True, outside_handling='clamp')
    jgrid = jax_resample(_cloud(pos, vel, names, jax=True), _staggered(R, names, jax=True), scatter=True,
                         outside_handling='clamp')
    inside = np.clip(pos, 0.2, R - 0.2)
    for integrator, jintegrator in ((advect.finite_rk4, jax_advect.finite_rk4), (advect.euler, jax_advect.euler)):
        if integrator is advect.euler:  # euler takes no NaN: fill the grid first
            grid, jgrid = finite_fill(grid, distance=3), jax_finite_fill(jgrid, distance=3)
        moved = advect.points(_cloud(inside, vel, names), grid, 0.5, integrator)
        jmoved = jax_advect.points(_cloud(inside, vel, names, jax=True), jgrid, 0.5, jintegrator)
        got, ref = moved.points.numpy(('points', 'vector')), _jax_np(jmoved.points, ('points', 'vector'))
        assert np.isfinite(got).all() and float(np.abs(got - ref).max()) <= 1e-5
        assert float(np.abs(got - inside).max()) > 0.1
    bounds, jbounds = Box(x=R, y=R, z=R), JBox(x=R, y=R, z=R)
    pushed = fluid.boundary_push(_cloud(pos, vel, names), [~bounds])
    jpushed = jax_fluid.boundary_push(_cloud(pos, vel, names, jax=True), [~jbounds])
    got = pushed.points.numpy(('points', 'vector'))
    assert np.array_equal(got, _jax_np(jpushed.points, ('points', 'vector')))
    assert (got >= 0).all() and (got <= R).all()  # those outside pulled in to 0.5 from the walls
    cub = fluid.boundary_push(_cloud(pos, vel, names), [Cuboid(wrap([6., 6., 6.], channel(vector='x,y,z')), x=2., y=2., z=2.)])
    jcub = jax_fluid.boundary_push(_cloud(pos, vel, names, jax=True),
                                   [JCuboid(jwrap([6., 6., 6.], jchannel(vector='x,y,z')), x=2., y=2., z=2.)])
    assert float(np.abs(cub.points.numpy(('points', 'vector')) - _jax_np(jcub.points, ('points', 'vector'))).max()) <= 1e-5
    # a sphere: no exact push; both packages push along the finite-difference normal of its signed distance
    sph = fluid.boundary_push(_cloud(pos, vel, names), [Sphere(x=6., y=6., z=6., radius=2.)])
    jsph = jax_fluid.boundary_push(_cloud(pos, vel, names, jax=True), [JSphere(x=6., y=6., z=6., radius=2.)])
    assert float(np.abs(sph.points.numpy(('points', 'vector')) - _jax_np(jsph.points, ('points', 'vector'))).max()) <= 1e-3


# ---------------------------------------------------------------------------
# FlipLiquid
# ---------------------------------------------------------------------------

def _jax_state_from(jm, pos, vel, R, dims):
    names = ORDER[:dims]
    p = jm.particles0
    p = p.with_geometry(p.geometry.at(_points(pos, names, jax=True))).with_values(_points(vel, names, jax=True))
    return p, jm.initial_state()[1]


@pytest.mark.parametrize('R,dims,velocities', [(24, 3, True), (32, 2, False)], ids=['3d-24', '2d-32'])
def test_flip_field_steps_match_jax_and_native(R, dims, velocities):
    """FlipLiquid through its Field face, 2 steps: particles, velocities and
    pressure within 5e-4 of JAX's, the particle count kept and NaN in the
    same places; bit-equal to `step_native` with the same CG counts. 3D from
    a moving state carried across with `state_fields`, 2D from
    `initial_state()` at rest."""
    names = ORDER[:dims]
    jm = JaxFlip(resolution=R, dims=dims, cg_tol=1e-5, max_iterations=500)
    model = FlipLiquid(R, dims=dims, cg_tol=1e-5, max_iterations=500, device='cpu')
    pos = model.positions0
    assert np.array_equal(model.particles0.points.numpy(('points', 'vector')), pos)
    assert np.array_equal(pos, _jax_np(jm.particles0.geometry.center, ('points', 'vector')))
    if velocities:
        vel = _smooth(pos, R, 0.5)
        native = state_from_numpy(pos, vel, np.zeros((R,) * dims, np.float32), device='cpu')
        state = model.state_fields(*state_from_numpy(pos, vel, np.zeros((R,) * dims, np.float32), device='cpu'))
        jstate = _jax_state_from(jm, pos, vel, R, dims)
    else:
        state, native, jstate = model.initial_state(), model.initial_state_native(), jm.initial_state()
    jstep = jax.jit(lambda s: jm.step(*s))
    for _ in range(2):
        with SolveTape() as tape:
            state = model.step(*state)
        native = model.step_native(*native)
        jstate = jstep(jstate)
        assert tape[0].iterations == model.last_solve.iterations
        (p_pos, p_vel), p_pressure = model.state_natives(*state)
        for a, b in zip((p_pos, p_vel, p_pressure), (*native[0], native[1])):
            assert a.shape == b.shape and torch.equal(a, b), "the Field step differs from step_native"
    assert state[0].is_point_cloud and np.isnan(float(state[0].boundary.value))
    got_pos = p_pos.numpy()
    ref_pos = _jax_np(jstate[0].geometry.center, ('points', 'vector'))
    ref_vel = _jax_np(jstate[0].values, ('points', 'vector'))
    assert got_pos.shape == ref_pos.shape == (pos.shape[0], dims)
    assert float(np.abs(got_pos - ref_pos).max()) <= 5e-4
    assert np.array_equal(np.isnan(p_vel.numpy()), np.isnan(ref_vel))
    assert float(np.nanmax(np.abs(p_vel.numpy() - ref_vel))) <= 5e-4
    assert float(np.abs(p_pressure.numpy() - _jax_np(jstate[1].values, names)).max()) <= 5e-4
    assert tape[0].iterations > 0


def test_field_plus_tuple_skips_zero_entries():
    """`grid + (0, 0, g)` on a staggered grid adds g to the last component
    only and keeps the other two tensors as they are; NaN stays NaN."""
    R, names = 6, ORDER
    grid = _staggered(R, names).with_values(math.stack(
        [wrap(torch.full(tuple(R - (a == d) for a in range(3)), float(d) - 1.), math.spatial('x,y,z'))
         for d in range(3)], math.dual(vector='x,y,z')))
    grid = grid.with_values(math.stack([face_components(grid.values)[0] * float('nan'), *face_components(grid.values)[1:]],
                                       math.dual(vector='x,y,z')))
    out = grid + (0, 0, -0.981)
    before, after = face_components(grid.values), face_components(out.values)
    assert after[0] is before[0] and after[1] is before[1]
    assert torch.equal(after[2].native(), before[2].native() + np.float32(-0.981).item())
    assert bool(torch.isnan(after[0].native()).all())
    assert torch.equal(face_components((grid - (0., 0., 2.)).values)[2].native(), before[2].native() - 2.)

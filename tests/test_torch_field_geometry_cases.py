"""The Field cases the geometry layer unlocks, against the JAX package on the
same numpy inputs: stacks of Fields of different geometries (`GeometryStack`,
or one geometry of their type), a point cloud sampled at the points of
another geometry (its values as they are, or the nearest point's), slicing a
point cloud along its dims, `upwind` / `gradient` on grids, which both
packages take and ignore, and grid values with an instance dim."""
import numpy as np
import pytest

import phiflow_tpu.field as jf
import phiflow_tpu.geom as jg
import phiflow_tpu.math as jm
import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.geom as tg
import phiflow_tpu_torch.math as tm

PKGS = ((jm, jg, jf), (tm, tg, tf))


@pytest.fixture(autouse=True)
def _cpu():
    with tm.default_device('cpu'):
        yield


def _np(t, order):
    return np.asarray(t.numpy(order))


def _cloud(m, g, f, pts, vals, dim='points'):
    pts = m.tensor(pts.astype(np.float32), m.instance(dim), m.channel(vector='x,y'))
    return f.PointCloud(pts, m.tensor(vals.astype(np.float32), m.instance(dim)))


RNG = np.random.default_rng(2)
P1, V1 = RNG.uniform(0, 4, (12, 2)), RNG.standard_normal(12)
P2, V2 = RNG.uniform(0, 4, (7, 2)), RNG.standard_normal(7)


def test_stack_of_fields_of_different_geometries():
    """A box Field and a sphere Field stacked along a batch dim: the stack's
    centres, its inside test at points and the stacked values equal JAX's."""
    out = []
    for m, g, f in PKGS:
        a = f.Field(g.Box(x=(0, 2), y=(0, 1)), m.wrap(1.5), 0.)
        b = f.Field(g.Sphere(x=3, y=3, radius=1), m.wrap(-2.), 0.)
        s = f.stack([a, b], m.batch('b'))
        pts = m.tensor(P_STACK, m.instance('p'),
                       m.channel(vector='x,y'))
        out.append((_np(s.geometry.center, ('b', 'vector')), _np(s.values, 'b'),
                    _np(s.geometry.lies_inside(pts), ('b', 'p')), _np(s.geometry.approximate_signed_distance(pts),
                                                                     ('b', 'p'))))
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, atol=1e-6)
    assert isinstance(tf.stack([tf.Field(tg.Box(x=1, y=1), tm.wrap(0.), 0.),
                                tf.Field(tg.Sphere(x=0, y=0, radius=1), tm.wrap(0.), 0.)], tm.batch('b')).geometry,
                      tg.GeometryStack)


P_STACK = np.random.default_rng(8).uniform(-1, 5, (30, 2)).astype(np.float32)


def test_stack_of_point_clouds_and_cylinders():
    """Point clouds stack their points, cylinders into one cylinder (`__field_stack__`)."""
    out = []
    for m, g, f in PKGS:
        s = f.stack([_cloud(m, g, f, P1, V1), _cloud(m, g, f, P1 + 1, V1 * 2)], m.batch('b'))
        c = f.stack([f.Field(g.cylinder(x=0, y=0, z=0, radius=1., depth=2.), m.wrap(1.), 0.),
                     f.Field(g.cylinder(x=1, y=2, z=0, radius=0.5, depth=1.), m.wrap(2.), 0.)], m.batch('b'))
        out.append((_np(s.points, ('b', 'points', 'vector')), _np(s.values, ('b', 'points')),
                    _np(c.geometry.center, ('b', 'vector')), _np(c.geometry.volume, 'b')))
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, rtol=1e-6)


def test_point_cloud_sampled_at_points():
    """At as many points: the values as they are, renamed to the target's
    instance dim; at other points: the value of the nearest source point."""
    out = []
    for m, g, f in PKGS:
        src = _cloud(m, g, f, P1, V1)
        same = f.resample(src, _cloud(m, g, f, P1[::-1].copy(), np.zeros(12), 'markers'))
        near = f.resample(src, _cloud(m, g, f, P2, np.zeros(7), 'markers'))
        at_geom = f.sample(src, g.Point(m.tensor(P2.astype(np.float32), m.instance('q'), m.channel(vector='x,y'))))
        out.append((_np(same.values, 'markers'), _np(near.values, 'markers'), _np(at_geom, 'q')))
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, rtol=1e-6)


def test_point_cloud_slicing():
    out = []
    for m, g, f in PKGS:
        c = _cloud(m, g, f, P1, V1)
        part = c[{'points': slice(3, 9)}]
        one = c[{'points': 4}]
        out.append((_np(part.points, ('points', 'vector')), _np(part.values, 'points'), _np(one.points, 'vector'),
                    _np(one.values, ())))
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a)


def test_upwind_and_gradient_on_grids_are_ignored():
    """As in the JAX package: laplace's `gradient` and `upwind`, spatial_gradient's and divergence's `upwind`
    give what the plain call gives on a grid."""
    vals = np.random.default_rng(3).standard_normal((8, 6)).astype(np.float32)
    out = []
    for m, g, f in PKGS:
        c = f.CenteredGrid(m.tensor(vals, m.spatial('x,y')), m.extrapolation.PERIODIC, x=8, y=6)
        v = f.StaggeredGrid(m.vec(x=0.5, y=-0.25), m.extrapolation.PERIODIC, x=8, y=6)
        up = f.CenteredGrid(m.vec(x=1., y=1.), m.extrapolation.PERIODIC, x=8, y=6)
        lap = f.laplace(c, gradient=f.spatial_gradient(c), upwind=up)
        grad = f.spatial_gradient(c, upwind=up)
        div = f.divergence(v, upwind=up)
        out.append((_np(lap.values, 'x,y'), _np(grad.values, 'x,y,vector'), _np(div.values, 'x,y'),
                    _np(f.laplace(c).values, 'x,y')))
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, atol=1e-5)
    np.testing.assert_array_equal(out[1][0], out[1][3])


def test_grid_values_with_an_instance_dim():
    """A centred grid whose values carry an instance dim: laplace and the gradient map over it, as in JAX."""
    vals = np.random.default_rng(5).standard_normal((8, 6, 3)).astype(np.float32)
    out = []
    for m, g, f in PKGS:
        c = f.CenteredGrid(m.tensor(vals, m.spatial('x,y'), m.instance('i')), 0, x=8, y=6)
        out.append((_np(f.laplace(c).values, 'i,x,y'), _np(f.spatial_gradient(c).values, 'i,x,y,vector')))
    for a, b in zip(*out):
        np.testing.assert_allclose(b, a, atol=1e-5)

"""The port's geometry layer (`phiflow_tpu_torch.geom`) against the JAX
package's (`phiflow_tpu.geom`): every name both export, each query on the
same points (numpy, `default_rng`), the analogues of `tests/geom/test_geom.py`
and `tests/geom/test_geom_extra.py` — `test_push`,
`test_heightmap_sloped_distance` and `test_heightmap_push_particles` among
them. Values within 1e-5 (float32 in both); the same booleans."""
import numpy as np
import pytest
import torch

import phiflow_tpu.geom as jg
import phiflow_tpu.math as jm
import phiflow_tpu_torch.geom as tg
import phiflow_tpu_torch.math as tm

EXCLUDED = {  # the splines: a slice of their own
    'b_spline_knots', 'eval_nurbs_bases', 'spline_eval', 'BSplineSheet', 'SplineVolume', 'to_spline_volume',
    'double_cover', 'SplineSolid', 'to_spline', 'apply_spline_bounds', 'transform_with_spline', 'closest_param',
    'spline_eval_surface'}


@pytest.fixture(autouse=True)
def _cpu():
    with tm.default_device('cpu'):
        yield


def _np(x, order=None):
    if isinstance(x, (bool, float, int, np.ndarray, np.generic)):
        return np.asarray(x)
    return np.asarray(x.numpy(order) if order else x.numpy())


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == bool or b.dtype == bool:
        assert (a == b).all(), (a, b)
    else:
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), rtol=tol, atol=tol)


def _points(m, pts: np.ndarray, labels=('x', 'y')):
    """A Tensor of points (instance dim p, vector) of package `m`."""
    return m.tensor(pts.astype(np.float32), m.instance('p'), m.channel(vector=','.join(labels)))


def _both(fn, order=None, tol=1e-5):
    """fn(math module, geom module) in both packages, compared."""
    j, t = fn(jm, jg), fn(tm, tg)
    j, t = (j, t) if isinstance(j, tuple) else ((j,), (t,))
    for a, b in zip(j, t):
        _close(_np(b, order), _np(a, order), tol)
    return t


def test_every_name_is_ported():
    missing = sorted(n for n in dir(jg) if not n.startswith('_') and n not in EXCLUDED and not hasattr(tg, n))
    assert not missing, missing


RNG = np.random.default_rng(0)
PTS2 = RNG.uniform(-3, 3, (40, 2))
PTS3 = RNG.uniform(-3, 3, (40, 3))

SHAPES = {
    'box': (lambda m, g: g.Box(x=2, y=(-1, 1.5)), 2),
    'box-slices': (lambda m, g: g.Box['x,y', 0:1, -2:2], 2),
    'cuboid': (lambda m, g: g.Cuboid(m.vec(x=0.3, y=-0.2), half_size=m.vec(x=2., y=0.5), rotation=0.7), 2),
    'sphere': (lambda m, g: g.Sphere(x=0.5, y=-0.5, radius=1.3), 2),
    'sphere-3d': (lambda m, g: g.Sphere(x=0.5, y=-0.5, z=0.2, radius=1.3), 3),
    'inverted': (lambda m, g: ~g.Sphere(x=0, y=0, radius=1), 2),
    'union': (lambda m, g: g.union(g.Box(x=(0, 1), y=(0, 2)), g.Sphere(x=-1, y=-1, radius=1)), 2),
    'intersection': (lambda m, g: g.intersection(g.Box(x=(-1, 1), y=(-2, 2)), g.Sphere(x=0, y=0, radius=1.5)), 2),
    'cylinder': (lambda m, g: g.cylinder(x=0.2, y=0, z=-0.3, radius=1., depth=2., axis='z'), 3),
    'cylinder-rotated': (lambda m, g: g.cylinder(x=0, y=0, z=0, radius=1., depth=2.5, axis='z').rotated(
        m.vec(x=0.4, y=0.3, z=0.)), 3),
    'sdf': (lambda m, g: g.SDF(lambda loc: m.vec_length(loc) - 1., g.Box(x=(-2, 2), y=(-2, 2))), 2),
    'numpy-sdf': (lambda m, g: g.numpy_sdf(lambda p: np.linalg.norm(p, axis=-1) - 1.2, g.Box(x=(-2, 2), y=(-2, 2))), 2),
    'sdf-grid': (lambda m, g: g.sample_sdf(g.Sphere(x=0, y=0, radius=1), g.Box(x=(-2, 2), y=(-2, 2)), x=32, y=32), 2),
    'heightmap': (lambda m, g: g.Heightmap(m.wrap((1.0 + 0.4 * np.sin(np.arange(16) / 3)).astype(np.float32),
                                                  m.spatial('x')), g.Box(x=(-3, 3), y=(-3, 3)), max_dist=1.), 2),
    'embed': (lambda m, g: g.infinite_cylinder(x=0, y=0, radius=1., inf_dim='z'), 3),
    'voxels': (lambda m, g: g.Voxels(g.UniformGrid(m.spatial(x=4, y=4), g.Box(x=(-2, 2), y=(-2, 2))),
                                     m.wrap(np.array([[1, 1], [2, 1], [2, 2]], np.int32), m.instance('v'),
                                            m.channel(vector='x,y'))), 2),
}


@pytest.mark.parametrize('name', list(SHAPES))
def test_queries_match_jax(name):
    """lies_inside, the signed distance, the closest surface where the shape
    has one, the bounds, and push (outward and inward) at 40 points. A push
    along the finite-difference normal (`sdf_normal`) divides float32
    distance differences by 2e-3, so pushed points agree within 1e-3."""
    make, d = SHAPES[name]
    pts = PTS3 if d == 3 else PTS2
    labels = ('x', 'y', 'z')[:d]

    def queries(m, g):
        shape, loc = make(m, g), _points(m, pts, labels)
        out = [shape.lies_inside(loc), shape.approximate_signed_distance(loc)]
        return tuple(_np(x, 'p') for x in out)
    _both(queries, tol=2e-5)

    def pushed(m, g):
        shape, loc = make(m, g), _points(m, pts, labels)
        return (shape.push(loc, shift_amount=0.05).numpy(('p', 'vector')),
                shape.push(loc, outward=False, shift_amount=0.05).numpy(('p', 'vector')))
    _both(pushed, tol=1e-3)

    def closest(m, g):
        shape = make(m, g)
        try:
            sgn, delta, normal, _, _ = shape.approximate_closest_surface(_points(m, pts, labels))
        except NotImplementedError:
            return (np.zeros(1),)
        return _np(sgn, 'p'), delta.numpy(('p', 'vector')), normal.numpy(('p', 'vector'))
    _both(closest, tol=2e-5)

    def bounds(m, g):
        shape = make(m, g)
        try:
            box = shape.bounding_box()
            return _np(box.lower, 'vector'), _np(box.upper, 'vector'), _np(shape.bounding_radius())
        except NotImplementedError:
            return (np.zeros(1),)
    _both(bounds)


def test_per_axis_locations_equal_tensor_queries():
    """The array layer's per-axis locations (a grid's coordinate arrays) give the Tensor query's values."""
    xs, ys = torch.linspace(-3, 3, 9).reshape(9, 1), torch.linspace(-3, 3, 7).reshape(1, 7)
    grid = np.stack(np.meshgrid(xs.numpy()[:, 0], ys.numpy()[0], indexing='ij'), -1).reshape(-1, 2)
    for name, (make, d) in SHAPES.items():
        if d != 2:
            continue
        shape = make(tm, tg)
        loc = _points(tm, grid)
        for q in ('lies_inside', 'approximate_signed_distance'):
            per_axis = getattr(shape, q)((xs, ys)).reshape(-1).numpy()
            _close(per_axis, _np(getattr(shape, q)(loc), 'p'))


def test_box_and_grid_methods_match_jax():
    def f(m, g):
        b = g.Box(x=(1, 3), y=(-1, 2))
        c = b.center_representation()
        grid = g.UniformGrid(m.spatial(x=4, y=3), g.Box(x=(0, 8), y=(0, 3)))
        p = g.UniformGrid(m.spatial(x=4, y=3), g.Box(x=(0, 8), y=(0, 3))).padded({'x': (1, 2)})
        loc = _points(m, PTS2)
        return (_np(b.volume), _np(b.global_to_local(loc), ('p', 'vector')),
                _np(b.local_to_global(b.global_to_local(loc)), ('p', 'vector')),
                _np(b.global_to_local(loc, scale=False, origin='center'), ('p', 'vector')),
                _np(c.half_size, 'vector'), _np(c.volume), _np(b.corner_representation().lower, 'vector'),
                _np(b.contains(g.Box(x=(1.5, 2), y=(0, 1)))), _np(b.scaled(2.).upper, 'vector'),
                _np(grid.lower, ('x', 'y', 'vector')), _np(grid.upper, ('x', 'y', 'vector')),
                _np(grid.size, 'vector'), _np(grid.volume), _np(grid.bounding_radius()),
                _np(p.bounds.lower, 'vector'), _np(p.bounds.upper, 'vector'), np.asarray(p.resolution.sizes),
                np.asarray(grid.with_scaled_resolution(2).resolution.sizes),
                _np(grid.voxel_at(m.vec(x=5., y=1.)), 'vector'), _np(grid.position_of(m.vec(x=1, y=2)), 'vector'),
                _np(g.bounding_box(loc).upper, 'vector'), _np(g.box_from_limits(m.vec(x=0, y=1), m.vec(x=2, y=3)).size,
                                                               'vector'),
                np.asarray(g.enclosing_grid(b, g.Sphere(x=0, y=0, radius=1), voxel_count=64).resolution.sizes),
                _np(g.enclosing_grid(b, voxel_count=16, rel_margin=0.1).bounds.upper, 'vector'),
                _np(g.Cuboid(m.vec(x=0., y=0.), half_size=m.vec(x=2., y=0.5), rotation=0.6).bounding_half_extent(),
                    'vector'))
    _both(f)
    assert isinstance(tg.Box(x=1, y=1), tg.BaseBox) and isinstance(tg.Cuboid(0, x=1, y=1), tg.BaseBox)


def test_geometry_functions_match_jax():
    def f(m, g):
        from phiflow_tpu.geom import _functions as JF
        from phiflow_tpu_torch.geom import _functions as TF
        F = JF if m is jm else TF
        A, B, C = m.vec(x=0., y=0., z=0.), m.vec(x=1., y=0., z=0.), m.vec(x=0., y=1., z=0.)
        q = _points(m, PTS3, ('x', 'y', 'z'))
        out = [F.closest_on_triangle(A, B, C, q).numpy(('p', 'vector')),
               _np(F.plane_sgn_dist(m.vec(x=0., y=0.), m.vec(x=0., y=1.), _points(m, PTS2)), 'p'),
               F.clip_length(_points(m, PTS2), 0.5, 1.).numpy(('p', 'vector')),
               F.normal_from_slope(m.wrap([1.0], m.channel(vector='x')), 'x,y').numpy('vector'),
               _np(F.distance_line_point(m.vec(x=0., y=0., z=0.), m.vec(x=1., y=1., z=0.), q), 'p'),
               F.orthogonal_vector(m.vec(x=1., y=2.)).numpy('vector'),
               F.closest_on_plane(m.vec(x=0., y=0., z=1.), m.vec(x=0., y=0., z=1.), q).numpy(('p', 'vector')),
               F.closest_on_line(A, B, q).numpy(('p', 'vector')),
               g.cross(m.vec(x=1., y=0., z=0.), m.vec(x=0., y=1., z=0.)).numpy('vector'),
               g.length(m.vec(x=3., y=4.)).numpy(), g.squared_length(m.vec(x=3., y=4.)).numpy(),
               g.normalize(m.vec(x=3., y=4.)).numpy('vector'),
               g.farthest_points(_points(m, PTS2), 5).numpy()]
        p1, p2 = g.closest_points_on_lines(m.vec(x=0., y=0., z=0.), m.vec(x=1., y=0., z=0.),
                                           m.vec(x=0., y=1., z=1.), m.vec(x=0., y=0., z=1.))[:2]
        out += [_np(p1), _np(p2)]
        hit, t, pos, normal, _ = g.line_trace(g.Sphere(x=5, y=0, radius=1), m.vec(x=0., y=0.), m.vec(x=1., y=0.))
        out += [_np(hit), _np(t), pos.numpy('vector'), normal.numpy('vector')]
        return tuple(out)
    _both(f)
    # JAX's closest_normal_vector passes `eps=` to vec_normalize, which takes `epsilon=`: it raises, and so does
    # the port's copy
    from phiflow_tpu.geom import _functions as JF
    from phiflow_tpu_torch.geom import _functions as TF
    for F, m in ((JF, jm), (TF, tm)):
        with pytest.raises(TypeError):
            F.closest_normal_vector(m.vec(x=1., y=2., z=0.), m.vec(x=0., y=0., z=1.))


def test_transforms_match_jax():
    def f(m, g):
        v = _points(m, PTS3, ('x', 'y', 'z'))
        ax = g.rotation_matrix_from_axis_and_angle(m.vec(x=0.3, y=-1., z=0.5), 0.8)
        dirs = g.rotation_matrix_from_directions(m.vec(x=1., y=0.2, z=0.), m.vec(x=0., y=1., z=1.))
        r2 = g.rotation_matrix(0.6)
        return (ax.numpy(('~vector', 'vector')), dirs.numpy(('~vector', 'vector')),
                _np(g.rotation_angles(r2)), g.rotate_vector(v, m.vec(x=0.1, y=0.2, z=0.3)).numpy(('p', 'vector')),
                g.rotate_vector(g.rotate_vector(v, ax), ax, invert=True).numpy(('p', 'vector')),
                g.rotate(m.vec(x=1., y=0.), 0.5).numpy('vector'), g.scale(m.vec(x=1., y=2.), 3.).numpy('vector'),
                _np(g.rotate(g.Box(x=(0, 2), y=(0, 1)), 0.4, pivot=m.vec(x=0., y=0.)).center, 'vector'),
                _np(g.scale(g.Sphere(x=1, y=1, radius=1), 2., pivot=m.vec(x=0., y=0.)).center, 'vector'))
    _both(f)


def test_module_functions_and_stacks():
    def f(m, g):
        loc = _points(m, PTS2)
        s1, b1 = g.Sphere(x=0, y=0, radius=1), g.Box(x=(1, 2), y=(0, 1))
        stack = g.GeometryStack((s1, b1), m.batch('b'))
        nog = g.NoGeometry(('x', 'y'))
        inv = g.invert(s1)
        return (stack.lies_inside(loc).numpy(('b', 'p')), stack.approximate_signed_distance(loc).numpy(('b', 'p')),
                _np(nog.lies_inside(loc), 'p'), _np(nog.approximate_signed_distance(loc), 'p'),
                _np(inv.approximate_signed_distance(loc), 'p'),
                g.expel(s1, loc, 0.1).numpy(('p', 'vector')), g.expel(b1, loc, 0.1, invert=True).numpy(('p', 'vector')),
                _np(g.sample_function(lambda x, y: x * y, g.UniformGrid(m.spatial(x=3, y=2)), 'center', None),
                    ('x', 'y')),
                _np(g.Point(m.vec(x=1., y=2.)).approximate_signed_distance(loc), 'p'))
    _both(f)
    tg.assert_same_rank(tg.Sphere(x=0, y=0, radius=1), 2, 'rank')
    assert issubclass(tg.GeometryException, Exception)
    assert isinstance(tg.union(tg.Sphere(x=0, y=0, radius=1), tg.Box(x=1, y=1)), tg.GeometryStack)
    assert isinstance(tg.intersection(tg.Sphere(x=0, y=0, radius=1), tg.Box(x=1, y=1)), tg.Intersection)
    assert isinstance(tg.union(), tg.NoGeometry)


def test_volumes_and_shape_methods_match_jax():
    def f(m, g):
        c = g.cylinder(x=0, y=0, z=0, radius=1., depth=2., axis='z')
        grid = g.sample_sdf(g.Sphere(x=0, y=0, radius=1), g.Box(x=(-2, 2), y=(-2, 2)), x=64, y=64)
        vox = g.Voxels(g.UniformGrid(m.spatial(x=4, y=4), g.Box(x=4, y=4)),
                       m.wrap(np.array([[1, 1], [2, 1]], np.int32), m.instance('v'), m.channel(vector='x,y')))
        h = g.Heightmap(m.wrap(np.ones(8, np.float32) * 2.0, m.spatial('x')), g.Box(x=8, y=8))
        return (_np(c.volume), _np(c.scaled(2.).volume), _np(c.at(m.vec(x=1., y=1., z=1.)).center, 'vector'),
                _np(grid.volume), _np(vox.volume), np.asarray(vox.voxel_count), _np(h.volume),
                _np(h.at(m.vec(x=4., y=5.)).height, 'x'), _np(g.Sphere(x=0, y=0, radius=2).scaled(0.5).volume))
    _both(f, tol=1e-4)
    assert tg.cylinder(x=0, y=0, z=0, radius=1., depth=2.) == tg.cylinder(x=0, y=0, z=0, radius=1., depth=2.)


def test_push():
    """`(~box).push` pulls points back inside, as in `tests/geom/test_geom.py::test_push`."""
    def f(m, g):
        b = g.Box(x=2, y=2)
        pts = m.vec(x=m.wrap([1., 5.], m.instance(p=2)), y=m.wrap([1., 1.], m.instance(p=2)))
        pushed = (~b).push(pts, shift_amount=0.1)
        return pushed.numpy(('p', 'vector')), _np(b.lies_inside(pushed), 'p')
    _, inside = _both(f)
    assert inside.all()


def test_heightmap_sloped_distance():
    """A 45° plane h(x) = x: the distance of a point 0.3 above it is 0.3 / √2, its normal (−1, 1) / √2."""
    def f(m, g):
        n = 64
        hm = g.Heightmap(m.wrap(((np.arange(n) + 0.5) / n).astype(np.float32), m.spatial('x')), g.Box(x=1., y=1.))
        loc = m.vec(x=m.wrap([0.5], m.instance(points=1)), y=m.wrap([0.8], m.instance(points=1)))
        sgn, delta, normal, *_ = hm.approximate_closest_surface(loc)
        return _np(hm.approximate_signed_distance(loc), 'points'), normal.numpy(('points', 'vector'))
    d, normal = _both(f)
    assert abs(d[0] - 0.3 / np.sqrt(2)) < 0.02
    assert abs(normal[0, 0] + 1 / np.sqrt(2)) < 0.05 and abs(normal[0, 1] - 1 / np.sqrt(2)) < 0.05


def test_heightmap_push_particles():
    """Particles below the terrain are pushed above it."""
    def f(m, g):
        n = 32
        heights = (0.4 + 0.1 * np.sin(2 * np.pi * (np.arange(n) + 0.5) / n)).astype(np.float32)
        hm = g.Heightmap(m.wrap(heights, m.spatial('x')), g.Box(x=1., y=1.))
        pts = m.vec(x=m.wrap([0.2, 0.5, 0.8], m.instance(points=3)), y=m.wrap([0.1, 0.45, 0.9], m.instance(points=3)))
        pushed = hm.push(pts, outward=True, shift_amount=0.02)
        return pushed.numpy(('points', 'vector')), _np(hm.approximate_signed_distance(pushed), 'points')
    _, d_after = _both(f)
    assert (d_after > 0).all()


def test_voxels_from_mask():
    def f(m, g):
        import phiflow_tpu.field as jf
        import phiflow_tpu_torch.field as tf
        F = jf if m is jm else tf
        mask = F.CenteredGrid(g.Sphere(x=2, y=2, radius=1.2), 0., x=4, y=4, bounds=g.Box(x=4, y=4))
        vox = g.Voxels.from_mask(mask)
        return np.asarray(vox.voxel_count), _np(vox.lies_inside(_points(m, PTS2 + 2)), 'p')
    _both(f)

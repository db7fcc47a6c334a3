"""The splines of the port (`phiflow_tpu_torch.geom._spline*`) against the
JAX package's: the same numpy control nets and query points
(`default_rng`) through both. Knots, bases, curves, `BSplineSheet` /
`SplineVolume`, `to_spline_volume`, `double_cover`, `SplineSolid`'s
properties and queries (`closest_param`, `lies_inside`, the signed distance,
all five outputs of `approximate_closest_surface`), `face_areas`,
`surface_mesh`, `to_spline` of a box, a cylinder and a sphere,
`apply_spline_bounds`, `transform_with_spline`, the transforms and the
arithmetic; the seed of the closest-parameter search (`_argmin_2d`) on ties
and NaN. Float32 values within 1e-5 of their scale, host numpy (knots,
meshes) bit for bit. A query's signed distance jumps where the seed or an
edge's fillet branch changes, so the points where the two packages took
another seed or branch are counted (at most 0.1%) and left out.

Every SplineSolid here shares one query shape (`Q` points), because each
new shape costs JAX about 3 s of tracing op by op."""
import numpy as np
import pytest

import phiflow_tpu.geom as jg
import phiflow_tpu.math as jm
from phiflow_tpu.geom import _spline_solid as jss
import phiflow_tpu_torch.geom as tg
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.geom import _spline_solid as tss

PKGS = {'jax': (jm, jg), 'torch': (tm, tg)}
Q = 300
RNG = np.random.default_rng(24)


@pytest.fixture(autouse=True)
def _cpu():
    with tm.default_device('cpu'):
        yield


def _np(x, order=None):
    if isinstance(x, (bool, float, int, np.ndarray, np.generic)):
        return np.asarray(x)
    return np.asarray(x.numpy(order) if order else x.numpy())


def _close(got, ref, tol=1e-5, what=''):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.nanmax(np.abs(ref))) if ref.size else 0., 1e-6)
    assert np.array_equal(np.isnan(got), np.isnan(ref)), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale, err_msg=what)


# ---------------------------------------------------------------------------
# bases, curves, sheets, volumes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('degree', [1, 2, 3])
@pytest.mark.parametrize('count', [4, 6])
def test_knots_and_bases(degree, count):
    """Knots bit for bit; the bases at u = 0, 1, the knots and random u
    within 1e-6, summing to 1 (the partition of unity, u = 1 included)."""
    knots = tg.b_spline_knots(count, degree)
    np.testing.assert_array_equal(knots, jg.b_spline_knots(count, degree))
    np.testing.assert_array_equal(tg.b_spline_knots(count, degree, clamped=False),
                                  jg.b_spline_knots(count, degree, clamped=False))
    u = np.concatenate([[0., 1.], knots, RNG.uniform(0, 1, 20)]).astype(np.float32)
    got = tg.eval_nurbs_bases(tm.wrap(u, tm.instance('u')), knots, degree, count)
    ref = jg.eval_nurbs_bases(jm.wrap(u, jm.instance('u')), knots, degree, count)
    assert got.shape.get_size('basis') == count
    _close(_np(got, ('u', 'basis')), _np(ref, ('u', 'basis')), 1e-6)
    np.testing.assert_allclose(_np(got, ('u', 'basis')).sum(-1), 1., atol=1e-6)
    # a number, and more bases than control points (the default count)
    _close(_np(tg.eval_nurbs_bases(0.3, knots, degree), 'basis'), _np(jg.eval_nurbs_bases(0.3, knots, degree), 'basis'))


@pytest.mark.parametrize('degree', [1, 2, 3])
def test_spline_eval(degree):
    ctrl = RNG.uniform(-2, 2, (6, 3)).astype(np.float32)
    u = RNG.uniform(0, 1, 15).astype(np.float32)
    got = tg.spline_eval(tm.tensor(ctrl, tm.instance('points'), tm.channel(vector='x,y,z')),
                         tm.wrap(u, tm.instance('u')), degree)
    ref = jg.spline_eval(jm.tensor(ctrl, jm.instance('points'), jm.channel(vector='x,y,z')),
                         jm.wrap(u, jm.instance('u')), degree)
    _close(_np(got, ('u', 'vector')), _np(ref, ('u', 'vector')))


SHEET = RNG.uniform(0, 4, (4, 5, 3)).astype(np.float32)
SHEET[..., 0] += np.arange(4)[:, None] * 2
SHEET[..., 1] += np.arange(5)[None, :] * 2


@pytest.mark.parametrize('degrees', [(1, 1), (2, 2), (3, 2)])
def test_bspline_sheet(degrees):
    """eval at random (u, v), the normal, the area and the quad mesh. The
    normal divides float32 differences by its step of 1e-4, which leaves
    1e-3 of rounding noise: it is compared in float64 (`precision(64)`)."""
    u, v = RNG.uniform(0, 1, (2, 12)).astype(np.float32)
    out = {}
    for pkg, (m, g) in PKGS.items():
        s = g.BSplineSheet(SHEET, degrees)
        pts, faces = s.to_mesh(6, 5)
        with m.precision(64):
            normal = _np(s.normal(0.4, 0.7), 'vector')
        out[pkg] = (_np(s.eval(m.wrap(u, m.instance('p')), m.wrap(v, m.instance('p'))), ('p', 'vector')),
                    normal, s.area(12), pts, faces, _np(s.sample_grid(3, 4), ('u', 'v', 'vector')),
                    s.spatial_rank, repr(s))
    for i, (a, b) in enumerate(zip(out['torch'], out['jax'])):
        if i == 4 or i >= 6:
            assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b, i
        else:
            _close(a, b, what=str(i))


def test_spline_volume_and_double_cover():
    ctrl = np.stack(np.meshgrid(np.linspace(0, 2, 3), np.linspace(0, 3, 4), np.linspace(0, 1, 3), indexing='ij'), -1)
    ctrl = (ctrl + RNG.uniform(-.1, .1, ctrl.shape)).astype(np.float32)
    u, v, w = RNG.uniform(0, 1, (3, 10)).astype(np.float32)
    out = {}
    for pkg, (m, g) in PKGS.items():
        vol = g.SplineVolume(ctrl, (2, 2, 1))
        sheets = vol.to_sheets()
        dc = g.double_cover(g.BSplineSheet(SHEET, (2, 2)))
        out[pkg] = [_np(vol.eval(*(m.wrap(a, m.instance('p')) for a in (u, v, w))), ('p', 'vector')), vol.volume(8),
                    _np(vol.sample_grid(2, 3, 2), ('u', 'v', 'w', 'vector'))] \
            + [s.control for s in sheets] + [dc.control, _np(dc.eval(0.3, 0.6), 'vector'), repr(vol)]
    for i, (a, b) in enumerate(zip(out['torch'], out['jax'])):
        if isinstance(a, str) or 3 <= i < 10:  # the repr and the nets: bit for bit
            assert np.array_equal(a, b), i
        else:
            _close(a, b, what=str(i))


@pytest.mark.parametrize('shape', ['box', 'sphere', 'cylinder'])
def test_to_spline_volume(shape):
    make = {'box': lambda m, g: g.Box(x=(0, 1), y=(1, 3), z=(-1, 0.5)),
            'sphere': lambda m, g: g.Sphere(x=1, y=2, z=3, radius=1.5),
            'cylinder': lambda m, g: g.Cylinder(m.vec(x=1., y=2., z=3.), radius=1., depth=2., axis='z')}[shape]
    got = tg.to_spline_volume(make(tm, tg), (3, 4, 5))
    ref = jg.to_spline_volume(make(jm, jg), (3, 4, 5))
    np.testing.assert_array_equal(got.control, ref.control)
    assert got.degrees == ref.degrees
    _close(got.volume(6), ref.volume(6))
    with pytest.raises(NotImplementedError):
        tg.to_spline_volume(object())


# ---------------------------------------------------------------------------
# SplineSolid
# ---------------------------------------------------------------------------

def _chute_net():
    xs, ys, zs = np.array([16, 40, 64, 88, 112.]) / 8, np.array([24, 64, 104.]) / 8, np.array([64, 44, 28, 24, 34.]) / 8
    return np.stack(np.broadcast_arrays(xs[:, None], ys[None, :], zs[:, None]), -1).astype(np.float32)


def _warped_net():
    g = np.stack(np.meshgrid(np.linspace(0, 6, 4), np.linspace(0, 4, 3), indexing='ij'), -1)
    z = 1.5 + 0.6 * np.sin(g[..., 0]) * np.cos(g[..., 1] / 2)
    return np.concatenate([g, z[..., None]], -1).astype(np.float32) + RNG.uniform(-.05, .05, (4, 3, 3)).astype(np.float32)


# 12 Gauss-Newton steps do not converge on the warped order-2 net: its parameters still move by up to 0.7 in the
# last step, and float32 rounding (XLA's against PyTorch's order of a sum) moves them apart by 1e-3. It is compared
# in float64 (`precision(64)` in both packages).
BITS = {'warped-order2': 64}
SOLIDS = {  # name: (net, thickness, fillet, order); thickness a number or per control point
    'chute': (_chute_net(), 1., {'u-': 1, 'u+': 1, 'v-': .5, 'v+': .5}, {'u': 2, 'v': 1}),
    'warped': (_warped_net(), RNG.uniform(0.5, 1.2, (4, 3)).astype(np.float32), {'u-': .3, 'v+': 1.}, None),
    'warped-order2': (_warped_net(), 0.8, {'u-': 1., 'u+': .2, 'v-': .7, 'v+': 0.}, {'u': 2, 'v': 2}),
}


def _solid(pkg, name):
    m, g = PKGS[pkg]
    net, thickness, fillet, order = SOLIDS[name]
    dtype = np.float64 if BITS.get(name) == 64 else np.float32
    points = m.tensor(net.astype(dtype), m.spatial('u,v'), m.channel(vector='x,y,z'))
    if isinstance(thickness, np.ndarray):
        thickness = m.tensor(thickness.astype(dtype), m.spatial('u,v'))
    return g.SplineSolid(points, thickness, fillet, order)


def _queries(pkg, name, n=Q, seed=0):
    m = PKGS[pkg][0]
    net = SOLIDS[name][0]
    lo, hi = net.reshape(-1, 3).min(0) - 2, net.reshape(-1, 3).max(0) + 2
    pts = np.random.default_rng(seed).uniform(lo, hi, (n, 3))
    return m.tensor(pts.astype(np.float64 if BITS.get(name) == 64 else np.float32), m.instance('p'),
                    m.channel(vector='x,y,z'))


@pytest.fixture(autouse=True)
def _bits(request):
    """`precision(64)` in both packages for the solids of BITS."""
    name = request.node.callspec.params.get('name') if hasattr(request.node, 'callspec') else None
    with tm.precision(BITS.get(name, 32)), jm.precision(BITS.get(name, 32)):
        yield


def _branches(pkg, solid, loc):
    """The seed (flat control-point index) and the edge-overrun flags of each query point: the branches of the
    signed distance."""
    m = PKGS[pkg][0]
    ss = jss if pkg == 'jax' else tss
    d2 = m.sum((loc - solid.points) ** 2, 'vector')
    iu, iv = ss._argmin_2d(d2, 'u', 'v')
    seed = _np(iu, 'p') * solid.points.shape.get_size('v') + _np(iv, 'p')
    _, uv, unbounded, _ = ss.closest_param(solid.order, solid.points, loc)
    over = (_np(unbounded, ('p', 'vector')) < _np(uv, ('p', 'vector')) - 1e-6) * 1 \
        + (_np(unbounded, ('p', 'vector')) > _np(uv, ('p', 'vector')) + 1e-6) * 2
    return np.concatenate([seed[:, None], over], -1)


def _same_branch(name):
    out = {pkg: _branches(pkg, _solid(pkg, name), _queries(pkg, name)) for pkg in PKGS}
    same = (out['torch'] == out['jax']).all(-1)
    assert (~same).mean() <= 1e-3, (~same).sum()
    return same


@pytest.mark.parametrize('name', list(SOLIDS))
def test_spline_solid_queries(name):
    """closest_param (its four outputs), lies_inside, the signed distance
    and approximate_closest_surface's five outputs at Q points; where the
    two packages took the same seed and branch."""
    same = _same_branch(name)
    out = {}
    for pkg, (m, g) in PKGS.items():
        s, loc = _solid(pkg, name), _queries(pkg, name)
        ss = jss if pkg == 'jax' else tss
        on, uv, unb, tan = ss.closest_param(s.order, s.points, loc)
        dist, delta, normal, offset, face = s.approximate_closest_surface(loc)
        assert offset is None
        out[pkg] = [_np(on, ('p', 'vector')), _np(uv, ('p', 'vector')), _np(unb, ('p', 'vector')),
                    _np(tan, ('p', '~tangents', 'vector')), _np(s.lies_inside(loc), 'p'),
                    _np(s.approximate_signed_distance(loc), 'p'), _np(dist, 'p'), _np(delta, ('p', 'vector')),
                    _np(normal, ('p', 'vector')), _np(face, ('p', 'index'))]
    for i, (a, b) in enumerate(zip(out['torch'], out['jax'])):
        if a.dtype == bool or i == 9:
            assert np.array_equal(a[same], b[same]), i
        else:
            _close(a[same], b[same], what=f'{name} output {i}')
    assert 0 < out['torch'][4].sum() < Q or name != 'chute'


@pytest.mark.parametrize('name', list(SOLIDS))
def test_spline_solid_properties(name):
    out = {}
    for pkg, (m, g) in PKGS.items():
        s = _solid(pkg, name)
        out[pkg] = [_np(s.center, ('u', 'v', 'vector')), _np(s.radius, ('u', 'v')), _np(s.volume, ('u', 'v')),
                    _np(s.corners, ('~side', 'u', 'v', 'vector')), _np(s.corner_radii, ('~side', 'u', 'v')),
                    _np(s.vertex_tangents, ('~tangents', 'u', 'v', 'vector')), _np(s.vertex_normals, ('u', 'v', 'vector')),
                    _np(s.surface_points, ('~side', 'u', 'v', 'vector')), _np(s.bounding_radius()),
                    _np(s.bounding_half_extent(), 'vector'), _np(s.face_areas, ('~side', 'u', 'v')),
                    _np(s.thickness_at(m.vec(u=1.3, v=0.6)))]
        assert s.shape == s.points.shape and s.resolution.sizes == SOLIDS[name][0].shape[:2]
        assert s.boundary_faces == {'u-': {'u': slice(0, 1)}, 'u+': {'u': slice(-1, None)}, 'v-': {'v': slice(0, 1)},
                                    'v+': {'v': slice(-1, None)}}
        assert s.spatial_rank == 3 and repr(s).startswith('SplineSolid(')
        with pytest.raises(TypeError):  # JAX's face_shape adds two Shapes, which neither package defines
            s.face_shape
    for i, (a, b) in enumerate(zip(out['torch'], out['jax'])):
        _close(a, b, what=f'{name} property {i}')


@pytest.mark.parametrize('name', list(SOLIDS))
def test_surface_mesh(name):
    """The closed surface mesh (host numpy through `MeshBuilder`): JAX's
    vertices and polygons bit for bit."""
    got = _solid('torch', name).surface_mesh(min_cyl_segments=3, min_corner_segments=2)
    ref = _solid('jax', name).surface_mesh(min_cyl_segments=3, min_corner_segments=2)
    assert got.cell_count == ref.cell_count and got.boundaries == ref.boundaries
    verts = [v.center if hasattr(v, 'center') else v for v in (got.vertices, ref.vertices)]
    np.testing.assert_array_equal(_np(verts[0], ('vertices', 'vector')), _np(verts[1], ('vertices', 'vector')))
    np.testing.assert_array_equal(np.asarray(got._element_lists), np.asarray(ref._element_lists))


def test_spline_solid_transforms_and_arithmetic():
    out = {}
    for pkg, (m, g) in PKGS.items():
        s = _solid(pkg, 'warped')
        loc = _queries(pkg, 'warped')
        moved = [s.shifted(m.vec(x=1., y=-0.5, z=0.25)), s.rotated(m.vec(x=0.1, y=0.2, z=0.3)), s.scaled(1.5), s * 2.,
                 2. * s, s + s, s.at(s.points * 1.1)]
        out[pkg] = [(_np(t.points, ('u', 'v', 'vector')), _np(t.thickness, ('u', 'v')),
                     [_np(t.fillet[k], t.fillet[k].shape.names) for k in sorted(t.fillet)]) for t in moved]
        out[pkg].append(_np(moved[0].approximate_signed_distance(loc), 'p'))
        assert s == _solid(pkg, 'warped') and not (s == moved[0]) and hash(s) == hash(_solid(pkg, 'warped'))
        assert s.order == {'u': 1, 'v': 1}
    for k, (a, b) in enumerate(zip(out['torch'], out['jax'])):
        if k < 7:
            _close(a[0], b[0], what=f'points {k}')
            _close(a[1], b[1], what=f'thickness {k}')
            for fa, fb in zip(a[2], b[2]):
                _close(fa, fb, what=f'fillet {k}')
        else:
            _close(a, b, 1e-4, 'shifted signed distance')


@pytest.mark.parametrize('shape', ['box', 'cylinder', 'sphere', 'rotated-cylinder', 'rotated-cylinder-float64'])
def test_to_spline(shape):
    """to_spline of a box, a cylinder (axis-aligned and rotated) and a
    sphere: JAX's nets, thickness and fillets, and its signed distance at Q
    points. The rotated cylinder's degenerate net (its v edge 1e-5 of the
    depth) leaves the sheet's v tangent below float32's rounding, so its
    float32 signed distance is far from the float64 one; both packages
    compute the same values in each precision, point for point
    (`-float64`: the net cast to float64 under `precision(64)`)."""
    rotated = lambda m, g: g.Cylinder(m.vec(x=4., y=4., z=4.), radius=2., depth=3., axis='z').rotated(
        m.vec(x=0.4, y=0.2, z=0.))
    make = {'box': lambda m, g: g.Box(x=(0, 3), y=(1, 2), z=(-1, 0.5)),
            'cylinder': lambda m, g: g.Cylinder(m.vec(x=1., y=2., z=3.), radius=1., depth=2., axis='z'),
            'sphere': lambda m, g: g.Sphere(x=1, y=1, z=1, radius=0.5),
            'rotated-cylinder': rotated, 'rotated-cylinder-float64': rotated}[shape]
    bits = 64 if shape.endswith('float64') else 32
    dtype = np.float64 if bits == 64 else np.float32
    out = {}
    pts = RNG.uniform(-1, 4, (Q, 3)) if shape in ('box', 'cylinder', 'sphere') else RNG.uniform(0, 8, (Q, 3))
    for pkg, (m, g) in PKGS.items():
        with m.precision(bits):
            s = g.to_spline(make(m, g))
            if bits == 64:
                net = m.tensor(_np(s.points, ('u', 'v', 'vector')).astype(np.float64), m.spatial('u,v'),
                               m.channel(vector='x,y,z'))
                s = g.SplineSolid(net, s.thickness, s.fillet, s.order)
            loc = m.tensor(pts.astype(dtype), m.instance('p'), m.channel(vector='x,y,z'))
            out[pkg] = [_np(s.points, ('u', 'v', 'vector')), _np(s.thickness, ('u', 'v'))] \
                + [_np(s.fillet[k], s.fillet[k].shape.names) for k in sorted(s.fillet)] \
                + [_np(s.approximate_signed_distance(loc), 'p')]
        assert s.order == {'u': 1, 'v': 1} and out[pkg][-1].dtype == dtype
    for i, (a, b) in enumerate(zip(out['torch'], out['jax'])):
        _close(a, b, 1e-5 if i < 6 else 1e-4, f'{shape} {i}')
    with pytest.raises(NotImplementedError):
        tg.to_spline(tg.Heightmap(tm.wrap(np.ones((3, 3), np.float32), tm.spatial('x,y')), tg.Box(x=1, y=1, z=1)))


def test_apply_spline_bounds_and_transform_with_spline():
    """apply_spline_bounds of a skewed 2 × 2 solid; transform_with_spline of
    Q points from the chute to a copy with its lip raised and thickness 1.25."""
    skew = np.array([[[0, 0, 0], [0.3, 2, 0.1]], [[3, 0.5, 0.2], [3.2, 2.4, 0.4]]], np.float32)
    lifted = _chute_net().copy()
    lifted[-1, :, 2] += 2
    out = {}
    for pkg, (m, g) in PKGS.items():
        s = g.SplineSolid(m.tensor(skew, m.spatial('u,v'), m.channel(vector='x,y,z')), 1e-7,
                          {'u-': 1.5, 'v+': -0.2}, None)
        b = g.apply_spline_bounds(s)
        src = _solid(pkg, 'chute')
        tgt = g.SplineSolid(m.tensor(lifted, m.spatial('u,v'), m.channel(vector='x,y,z')), 1.25, src.fillet, src.order)
        moved = g.transform_with_spline(_queries(pkg, 'chute'), src, tgt)
        with m.precision(64):  # central differences of step 1e-3: float32 leaves 1e-4 of rounding noise
            net64 = m.tensor(_chute_net().astype(np.float64), m.spatial('u,v'), m.channel(vector='x,y,z'))
            pos, tan, nrm = g.spline_eval_surface(src.order, net64, m.vec(u=1.5, v=0.5),
                                                  ('position', 'tangents', 'normal'))
        out[pkg] = [_np(b.points, ('u', 'v', 'vector')), _np(b.thickness, ('u', 'v'))] \
            + [_np(b.fillet[k], b.fillet[k].shape.names) for k in sorted(b.fillet)] \
            + [_np(pos, 'vector'), _np(tan, ('~tangents', 'vector')), _np(nrm, 'vector'), _np(moved, ('p', 'vector'))]
    same = _same_branch('chute')
    for i, (a, b) in enumerate(zip(out['torch'], out['jax'])):
        if i == 9:
            _close(a[same], b[same], 1e-5, 'transform_with_spline')
        else:
            _close(a, b, what=str(i))


def test_argmin_2d_ties_and_nan():
    """The seed is the first (u, v) in row-major order on ties, and at the
    first NaN where the distances hold one, as jnp.argmin."""
    d2 = np.array([[[3., 1., 2.], [1., 5., 1.]],          # tie: (0, 1) before (1, 0) and (1, 2)
                   [[np.nan, 0., 1.], [2., np.nan, 0.]],   # NaNs: the first one, (0, 0)
                   [[4., 4., 4.], [4., 4., 4.]]], np.float32)  # all equal: (0, 0)
    out = {}
    for pkg, (m, g) in PKGS.items():
        ss = jss if pkg == 'jax' else tss
        iu, iv = ss._argmin_2d(m.tensor(d2, m.instance('p'), m.spatial('u,v')), 'u', 'v')
        out[pkg] = (_np(iu, 'p'), _np(iv, 'p'))
        # a location equidistant from two control points seeds at the first
        net = m.tensor(np.array([[[0, 0, 0], [0, 2, 0]], [[2, 0, 0], [2, 2, 0]]], np.float32), m.spatial('u,v'),
                       m.channel(vector='x,y,z'))
        loc = m.tensor(np.array([[1, 0, 1], [0, 1, 1], [1, 1, 0]], np.float32), m.instance('p'),
                       m.channel(vector='x,y,z'))
        iu2, iv2 = ss._argmin_2d(m.sum((loc - net) ** 2, 'vector'), 'u', 'v')
        out[pkg] += (_np(iu2, 'p'), _np(iv2, 'p'))
    for a, b in zip(out['torch'], out['jax']):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out['torch'][0], [0, 0, 0])
    np.testing.assert_array_equal(out['torch'][1], [1, 0, 0])

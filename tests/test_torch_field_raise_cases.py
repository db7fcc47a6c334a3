"""The Field cases the port refused until now, against the JAX package on
the same numpy inputs: `divergence` of a staggered grid whose walls' normal
velocity is no scalar constant (ANTISYMMETRIC walls, a vector constant,
mixed sides), a point cloud sampled at or resampled onto a grid without
scatter (JAX's overlap of the points' geometry with the cells: hard centre
containment and `soft` fractions, centred and staggered targets, scalar and
vector values, spheres and bare points), and a grid Field or a point cloud
sampled at a mesh's cells. Values within 1e-5 (float32 in both), masks
equal."""
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


def _values(t):
    """A Tensor (or a staggered TensorStack) as numpy arrays, by component label, dims in name order."""
    shape = t.shape
    if '~vector' in shape.names:
        labels = shape.get_labels('~vector')
        return {l: _values(t[{'~vector': l}])[''] for l in labels}
    names = tuple(sorted(shape.names))
    return {'': np.asarray(t.numpy(names))}


def _close(a, b, tol=1e-5):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, (k, a[k].shape, b[k].shape)
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol, err_msg=k)


BOUNDARIES = {
    'antisymmetric': lambda m: m.extrapolation.ANTISYMMETRIC,
    'vector-constant': lambda m: m.tensor([0.5, -1.], m.channel(vector='x,y')),
    'mixed': lambda m: m.extrapolation.combine_sides(x=m.extrapolation.ANTISYMMETRIC,
                                                     y=m.extrapolation.ZERO_GRADIENT),
    'antisymmetric-3d': lambda m: m.extrapolation.ANTISYMMETRIC,
}


def _wave(m, res, names, shift):
    return lambda x: m.stack([m.sin(x.vector[d] * float(shift[i])) for i, d in enumerate(res)],
                             m.channel(vector=names))


@pytest.mark.parametrize('case', list(BOUNDARIES))
def test_staggered_divergence_of_non_scalar_walls(case):
    """JAX pads each face component by its own extrapolation where the outer
    face is not stored; the port takes the same route where the face layout
    has no entry."""
    out = []
    rng = np.random.default_rng(11)
    res = dict(x=6, y=5, z=4) if case.endswith('3d') else dict(x=6, y=5)
    names = ','.join(res)
    shift = rng.uniform(0.3, 0.9, len(res)).astype(np.float32)
    for m, g, f in PKGS:
        fn = _wave(m, res, names, shift)
        v = f.StaggeredGrid(fn, BOUNDARIES[case](m), **res)
        out.append(_values(f.divergence(v).values))
    _close(out[1], out[0])


P = np.random.default_rng(12).uniform(0, 8, (14, 2)).astype(np.float32)
V = np.random.default_rng(13).standard_normal(14).astype(np.float32)
VV = np.random.default_rng(14).standard_normal((14, 2)).astype(np.float32)


def _cloud(m, g, f, geo, vector):
    pts = m.tensor(P, m.instance('points'), m.channel(vector='x,y'))
    geom = g.Sphere(pts, radius=0.7) if geo == 'sphere' else pts
    vals = m.tensor(VV, m.instance('points'), m.channel(vector='x,y')) if vector else m.tensor(V, m.instance('points'))
    return f.PointCloud(geom, vals)


@pytest.mark.parametrize('geo', ['sphere', 'points'])
@pytest.mark.parametrize('vector', [False, True], ids=['scalar', 'vector'])
@pytest.mark.parametrize('target', ['centred', 'staggered'])
@pytest.mark.parametrize('soft', [False, True], ids=['hard', 'soft'])
def test_points_resampled_onto_a_grid_without_scatter(geo, vector, target, soft):
    out = []
    for m, g, f in PKGS:
        grid = (f.CenteredGrid if target == 'centred' else f.StaggeredGrid)(0, 0, x=8, y=8)
        r = f.resample(_cloud(m, g, f, geo, vector), grid, soft=soft)
        assert r.is_staggered == (target == 'staggered')
        out.append(_values(r.values))
    _close(out[1], out[0])


@pytest.mark.parametrize('geo', ['sphere', 'points'])
@pytest.mark.parametrize('at', ['center', 'face'])
def test_points_sampled_at_a_grid(geo, at):
    out = []
    for m, g, f in PKGS:
        grid = f.CenteredGrid(0, 0, x=8, y=8).geometry
        out.append(_values(f.sample(_cloud(m, g, f, geo, True), grid, at=at)))
    _close(out[1], out[0])


def _cosine(m):
    return lambda x: m.cos(x * 0.6)


def _mesh(g):
    return g.build_mesh(g.Box(x=(0, 4), y=(0, 3)), x=8, y=6)


@pytest.mark.parametrize('value', ['centred', 'centred-vector', 'staggered', 'points'])
def test_fields_sampled_at_a_mesh(value):
    """A grid Field is looked up at the mesh's cell centres (a staggered one
    per component), a point cloud gives its nearest point's value; `resample`
    onto a mesh Field the same, on the mesh."""
    out = []
    rng = np.random.default_rng(15)
    data = rng.standard_normal((9, 7, 2)).astype(np.float32)
    for m, g, f in PKGS:
        mesh = _mesh(g)
        bounds = g.Box(x=(-0.5, 4.5), y=(-0.5, 3.5))
        if value == 'centred':
            field = f.CenteredGrid(m.tensor(data[..., 0], m.spatial('x,y')), m.extrapolation.ZERO_GRADIENT,
                                   bounds=bounds, x=9, y=7)
        elif value == 'centred-vector':
            field = f.CenteredGrid(m.tensor(data, m.spatial('x,y'), m.channel(vector='x,y')), 0., bounds=bounds,
                                   x=9, y=7)
        elif value == 'staggered':
            field = f.StaggeredGrid(_cosine(m), 0., bounds=bounds, x=9, y=7)
        else:
            field = _cloud(m, g, f, 'points', True)
        at_mesh = f.sample(field, mesh)
        on_mesh = f.resample(field, f.Field(mesh, 0., 0.))
        assert on_mesh.is_mesh
        out.append((_values(at_mesh), _values(on_mesh.values)))
    _close(out[1][0], out[0][0])
    _close(out[1][1], out[0][1])

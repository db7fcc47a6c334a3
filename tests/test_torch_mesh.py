"""The port's unstructured mesh and FVM operators against the JAX package's,
on the CPU.

The 120×36 and 400×128 meshes of `CylinderWake`'s domain with its cylinder:
`neighbors`, `boundaries` and every float table bit-equal to those JAX's C++
face matcher builds (the test asserts JAX took its C++ path, never its
float32 Python fallback). Every operator of `field/_mesh_math.py` on the
120×36 mesh, seeded random scalar and vector values under the wake's mixed
boundary, within 1e-5 of the output's scale. Then the port's analogues of
the 2D cases of `tests/field/test_mesh.py`."""
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.field import Field as JField
from phiflow_tpu.field import _mesh_math as jmm
from phiflow_tpu.geom import Box as JBox, Point as JPoint, Sphere as JSphere
from phiflow_tpu.geom._mesh import build_mesh as jax_build_mesh

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.field import Field, divergence, laplace, sample, spatial_gradient
from phiflow_tpu_torch.field import _mesh_math as mm
from phiflow_tpu_torch.geom import Box, Mesh, Point, Sphere, build_mesh, mesh, mesh_from_numpy
from phiflow_tpu_torch.math import extrapolation, channel, instance, wrap, Solve, ConvergenceException, vec
from phiflow_tpu_torch.native import _lib

SIZES = {'120x36': (120, 36), '400x128': (400, 128)}
TABLES = ('center', 'volume', 'neighbors', 'face_areas', 'face_centers', 'face_normals', 'neighbor_distances',
          'vertices')


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


@pytest.fixture(scope='module')
def meshes():
    """(JAX's mesh, the port's) of the wake's domain and cylinder at each size."""
    from phiflow_tpu.native._lib import get_lib
    assert get_lib() is not None, "the JAX package must build its meshes with its C++ face matcher"
    return {name: (jax_build_mesh(JBox(x=8., y=4.), x=nx, y=ny, obstacles=JSphere(x=2., y=2., radius=0.25)),
                   build_mesh(Box(x=8., y=4.), x=nx, y=ny, obstacles=Sphere(x=2., y=2., radius=0.25)))
            for name, (nx, ny) in SIZES.items()}


def _np(t, names):
    native = t.native(names)
    return native.numpy() if isinstance(native, torch.Tensor) else np.asarray(native)


@pytest.mark.parametrize('size', list(SIZES))
@pytest.mark.parametrize('table', TABLES)
def test_mesh_tables_bit_equal(meshes, size, table):
    jax_mesh, port = meshes[size]
    ref, got = getattr(jax_mesh, table), getattr(port, table)
    assert str(got.shape) == str(ref.shape)
    a, b = _np(ref, ref.shape.names), _np(got, ref.shape.names)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize('size', list(SIZES))
def test_mesh_boundaries_equal(meshes, size):
    jax_mesh, port = meshes[size]
    assert port.boundaries == jax_mesh.boundaries == {'x-': 0, 'x+': 1, 'y-': 2, 'y+': 3, 'boundary': 4}
    assert port.cell_count == jax_mesh.cell_count and port.max_faces == jax_mesh.max_faces == 4
    for name in port.boundaries:
        np.testing.assert_array_equal(_np(port.boundary_mask(name), ('cells', '~faces')),
                                      _np(jax_mesh.boundary_mask(name), ('cells', '~faces')))


def test_build_mesh_lists_the_jax_packages_polygons_and_side_edges(monkeypatch):
    """`build_mesh` finds the kept cells and the side groups' edges with
    numpy where the JAX package loops: the same polygons and the same edge
    lists in the same order reach `mesh_from_numpy`."""
    import phiflow_tpu.geom._mesh as jax_mesh_module
    import phiflow_tpu_torch.geom._mesh as mesh_module
    seen = {}

    def capture(key, original):
        def wrapper(points, polygons, boundaries=None, *args, **kwargs):
            seen[key] = (np.asarray(points), [tuple(int(v) for v in p if v >= 0) for p in polygons],
                         {k: [tuple(int(v) for v in e) for e in edges] for k, edges in boundaries.items()})
            return original(points, polygons, boundaries, *args, **kwargs)
        return wrapper
    monkeypatch.setattr(jax_mesh_module, 'mesh_from_numpy', capture('jax', jax_mesh_module.mesh_from_numpy))
    monkeypatch.setattr(mesh_module, 'mesh_from_numpy', capture('port', mesh_module.mesh_from_numpy))
    jax_mesh_module.build_mesh(JBox(x=8., y=4.), x=40, y=12, obstacles=JSphere(x=2., y=2., radius=0.5))
    mesh_module.build_mesh(Box(x=8., y=4.), x=40, y=12, obstacles=Sphere(x=2., y=2., radius=0.5))
    (jax_points, jax_polys, jax_edges), (points, polys, edges) = seen['jax'], seen['port']
    np.testing.assert_array_equal(points, jax_points)
    assert polys == jax_polys and len(polys) < 40 * 12
    assert list(edges) == list(jax_edges) == ['x-', 'x+', 'y-', 'y+']
    for name in edges:
        assert edges[name] == jax_edges[name] and edges[name], name


def test_face_matcher_is_the_jax_packages():
    """The port compiles its own copy of the C++ matcher, into its own build
    directory; the code (comments aside) is the JAX package's."""
    import os
    import re
    import phiflow_tpu.native as jax_native

    def code(path):
        with open(path) as f:
            return re.sub(r'//[^\n]*', '', f.read())
    assert code(_lib.SOURCE) == code(os.path.join(os.path.dirname(jax_native.__file__), 'meshbuild.cpp'))
    assert os.path.dirname(_lib.library_path()).endswith(os.path.join('phiflow_tpu_torch', '_build'))
    _lib.get_lib()
    assert os.path.isfile(_lib.library_path())


def test_jax_python_face_matcher_is_not_the_reference(meshes, monkeypatch):
    """JAX's Python fallback matcher (taken without g++) sums the shoelace in
    float32 over absolute coordinates: at 120×36 its cell centres are up to
    1.1e-3 off the C++ matcher's, whose tables the port reproduces."""
    import phiflow_tpu.native._lib as jax_lib
    jax_mesh, port = meshes['120x36']
    monkeypatch.setattr(jax_lib, 'build_face_tables_2d', lambda *args: None)
    fallback = jax_build_mesh(JBox(x=8., y=4.), x=120, y=36, obstacles=JSphere(x=2., y=2., radius=0.25))
    names = ('cells', 'vector')
    np.testing.assert_array_equal(_np(fallback.neighbors, ('cells', '~faces')), _np(port.neighbors, ('cells', '~faces')))
    off = np.abs(_np(fallback.center, names) - _np(port.center, names)).max()
    assert 1e-4 < off < 1e-2, off


def test_3d_input_raises():
    with pytest.raises(NotImplementedError):
        mesh_from_numpy(np.zeros((8, 3)), [tuple(range(8))])


# ---------------------------------------------------------------------------
# the FVM operators on seeded random values
# ---------------------------------------------------------------------------

def _bc(math, zero_gradient):
    return {'x-': math.vec(x=1., y=0.), 'x+': zero_gradient, 'y-': math.vec(x=1., y=0.),
            'y+': math.vec(x=1., y=0.), 'boundary': 0.}


def _scalar_bc(zero_gradient):
    return {'x-': 1., 'x+': zero_gradient, 'y-': 0.5, 'y+': 0., 'boundary': 0.}


@pytest.fixture(scope='module')
def fields(meshes):
    """Seeded random scalar and vector Fields on the 120×36 mesh, and a random
    face flux, in both packages."""
    from phiflow_tpu.math.extrapolation import ZERO_GRADIENT as JZG
    jax_mesh, port = meshes['120x36']
    rng = np.random.default_rng(7)
    n = port.cell_count
    s = rng.standard_normal(n).astype(np.float32)
    v = rng.standard_normal((n, 2)).astype(np.float32)
    flux = rng.standard_normal((n, 4)).astype(np.float32)
    pts = rng.uniform((0.2, 0.2), (7.8, 3.8), (64, 2)).astype(np.float32)
    zg = extrapolation.ZERO_GRADIENT
    jax_side = dict(
        s=JField(jax_mesh, jm.wrap(s, jm.instance('cells')), _scalar_bc(JZG)),
        v=JField(jax_mesh, jm.wrap(v, jm.instance('cells'), jm.channel(vector='x,y')), _bc(jm, JZG)),
        flux=jm.wrap(flux, jm.instance('cells'), jm.dual(faces=4)),
        points=JPoint(jm.wrap(pts, jm.instance('points'), jm.channel(vector='x,y'))))
    port_side = dict(
        s=Field(port, wrap(s, instance('cells')), _scalar_bc(zg)),
        v=Field(port, wrap(v, instance('cells'), channel(vector='x,y')), _bc(tm, zg)),
        flux=wrap(flux, instance('cells'), tm.dual(faces=4)),
        points=Point(wrap(pts, instance('points'), channel(vector='x,y'))))
    return jax_side, port_side


OPERATORS = {
    'centroid_to_faces linear': lambda m, f: m.centroid_to_faces(f['s']),
    'centroid_to_faces upwind': lambda m, f: m.centroid_to_faces(f['s'], 'upwind', f['flux']),
    'centroid_to_faces component': lambda m, f: m.centroid_to_faces(f['v'], component='y'),
    'green_gauss_gradient': lambda m, f: m.green_gauss_gradient(f['s']),
    'least_squares_gradient': lambda m, f: m.least_squares_gradient(f['s']),
    'mesh_divergence': lambda m, f: m.mesh_divergence(f['v']),
    'mesh_laplace scalar': lambda m, f: m.mesh_laplace(f['s']),
    'mesh_laplace scalar correct_skew': lambda m, f: m.mesh_laplace(f['s'], correct_skew=True),
    'mesh_laplace vector': lambda m, f: m.mesh_laplace(f['v']),
    'mesh_laplace vector correct_skew': lambda m, f: m.mesh_laplace(f['v'], correct_skew=True),
    'mesh_laplace_diagonal correct_skew': lambda m, f: m.mesh_laplace_diagonal(f['s']),
    'mesh_laplace_diagonal': lambda m, f: m.mesh_laplace_diagonal(f['s'], correct_skew=False),
    'mesh_advection_differential upwind': lambda m, f: m.mesh_advection_differential(f['v'], f['v']),
    'mesh_advection_differential linear': lambda m, f: m.mesh_advection_differential(f['v'], f['v'], upwind=False),
    'sample_mesh_field scalar': lambda m, f: m.sample_mesh_field(f['s'], f['points'], 'center', None, None),
    'sample_mesh_field vector': lambda m, f: m.sample_mesh_field(f['v'], f['points'], 'center', None, None),
}


@pytest.mark.parametrize('operator', list(OPERATORS))
def test_operator_matches_jax(fields, operator):
    jax_fields, port_fields = fields
    ref, got = OPERATORS[operator](jmm, jax_fields), OPERATORS[operator](mm, port_fields)
    ref, got = getattr(ref, 'values', ref), getattr(got, 'values', got)
    assert set(got.shape.names) == set(ref.shape.names)
    a, b = _np(ref, ref.shape.names), _np(got, ref.shape.names)
    scale = np.abs(a).max()
    assert scale > 0 and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * scale)


def _sides(ext):
    return {k: tuple(repr(e) for e in pair) for k, pair in ext.ext.items()} if hasattr(ext, 'ext') else repr(ext)


@pytest.mark.parametrize('derive', ['as given', 'spatial_gradient', 'component x', 'component y',
                                    'pressure', 'group x-', 'group x+', 'group boundary'])
def test_wake_boundary_matches_jax(fields, derive):
    """The wake's boundary dict — side keys with vector constants, zero
    gradient at the outflow, the group key 'boundary' with a scalar 0 — and
    what the FVM path derives from it equal JAX's, side by side."""
    from phiflow_tpu.physics import fluid as jax_fluid
    from phiflow_tpu_torch.physics import fluid
    jax_fields, port_fields = fields
    derivations = {
        'as given': lambda ext, mod, fl: ext,
        'spatial_gradient': lambda ext, mod, fl: ext.spatial_gradient(),
        'component x': lambda ext, mod, fl: ext[{'vector': 'x'}],
        'component y': lambda ext, mod, fl: ext[{'vector': 'y'}],
        'pressure': lambda ext, mod, fl: fl._pressure_extrapolation(ext),
        'group x-': lambda ext, mod, fl: mod._group_extrapolation(ext, 'x-'),
        'group x+': lambda ext, mod, fl: mod._group_extrapolation(ext, 'x+'),
        'group boundary': lambda ext, mod, fl: mod._group_extrapolation(ext, 'boundary'),
    }
    ref = derivations[derive](jax_fields['v'].boundary, jmm, jax_fluid)
    got = derivations[derive](port_fields['v'].boundary, mm, fluid)
    assert _sides(got) == _sides(ref)
    assert got.is_flexible == ref.is_flexible


def test_field_routes_reach_the_mesh_operators(fields):
    """`laplace`, `spatial_gradient` (both schemes, and per component of a
    vector) and `divergence` of a mesh Field are the mesh operators."""
    _, f = fields
    np.testing.assert_array_equal(laplace(f['s']).values.numpy('cells'),
                                  mm.mesh_laplace(f['s'], correct_skew=True).values.numpy('cells'))
    np.testing.assert_array_equal(spatial_gradient(f['s']).values.numpy('cells,vector'),
                                  mm.green_gauss_gradient(f['s']).values.numpy('cells,vector'))
    np.testing.assert_array_equal(spatial_gradient(f['s'], scheme='least-squares').values.numpy('cells,vector'),
                                  mm.least_squares_gradient(f['s']).values.numpy('cells,vector'))
    np.testing.assert_array_equal(divergence(f['v']).values.numpy('cells'),
                                  mm.mesh_divergence(f['v']).values.numpy('cells'))
    grad = spatial_gradient(f['v'])
    assert grad.values.shape.get_labels('gradient') == ('x', 'y')
    np.testing.assert_array_equal(grad.values[{'vector': 'y'}].numpy('cells,gradient'),
                                  mm.green_gauss_gradient(f['v'][{'vector': 'y'}]).values.numpy('cells,vector'))


def test_mesh_moves_between_devices(meshes):
    """`Mesh.to` keeps a mesh already on the device and `models.to_device`
    moves a mesh Field's geometry with its values."""
    from phiflow_tpu_torch.models import to_device
    _, port = meshes['120x36']
    assert port.device.type == 'cpu' and port.to('cpu') is port
    field = Field(port, 1., 0.)
    moved = to_device(field, 'cpu')
    assert moved.geometry is port and moved.values.native().device.type == 'cpu'


# ---------------------------------------------------------------------------
# the analogues of tests/field/test_mesh.py's 2D cases
# ---------------------------------------------------------------------------

def _quad_mesh(n=8):
    return build_mesh(Box(x=1, y=1), x=n, y=n)


def _interior(m):
    return (tm.sum(m.interior_mask, '~faces') >= 4).numpy('cells')


def test_build_mesh_basic():
    m = _quad_mesh(4)
    assert isinstance(m, Mesh) and m.cell_count == 16
    assert abs(float(tm.sum(m.volume)) - 1.0) < 1e-5
    assert float(tm.max(tm.sum(m.interior_mask, '~faces'))) == 4


def test_mesh_with_obstacle():
    m = build_mesh(Box(x=1, y=1), x=8, y=8, obstacles=Sphere(x=0.5, y=0.5, radius=0.2))
    assert m.cell_count < 64
    assert 'boundary' in m.boundaries


def test_green_gauss_gradient_linear():
    """Gradient of f(x, y) = 3x is (3, 0) on interior cells."""
    m = _quad_mesh(8)
    f = Field(m, 3 * m.center.vector['x'], extrapolation.ZERO_GRADIENT)
    gx = mm.green_gauss_gradient(f).values[{'vector': 'x'}].numpy('cells')
    assert np.allclose(gx[_interior(m)], 3.0, atol=1e-4)


def test_mesh_laplace_quadratic():
    """Δ(x²) = 2 on interior cells."""
    m = _quad_mesh(10)
    f = Field(m, m.center.vector['x'] ** 2, extrapolation.ZERO_GRADIENT)
    vals = laplace(f).values.numpy('cells')
    assert np.allclose(vals[_interior(m)], 2.0, atol=1e-3)


def test_mesh_divergence_constant():
    m = _quad_mesh(6)
    c = vec(x=1., y=2.)
    v = Field(m, c, {'x-': c, 'x+': c, 'y-': c, 'y+': c})
    assert float(tm.max(abs(divergence(v).values))) < 1e-5


def test_dirichlet_boundary_laplace():
    """∇²p = 0 with p = 0 / p = 1 Dirichlet walls → p is linear in x (BiCGStab:
    the port has no direct solve)."""
    m = _quad_mesh(8)
    p = Field(m, 0., {'x-': 0., 'x+': 1., 'y-': extrapolation.ZERO_GRADIENT, 'y+': extrapolation.ZERO_GRADIENT})
    rhs = Field(m, 0., extrapolation.ZERO_GRADIENT)
    sol = tm.solve_linear(lambda x: laplace(x), rhs, Solve('biCG-stab', 1e-6, 1e-6, x0=p, max_iterations=500))
    assert np.allclose(sol.values.numpy('cells'), m.center.vector['x'].numpy('cells'), atol=1e-3)


def test_mesh_laplace_skew_correction():
    """On a skewed quad mesh the non-orthogonal correction reduces the
    Laplacian's error against Δ(x² + y²) = 4."""
    n = 12
    xs, ys = np.meshgrid(np.linspace(0, 1, n + 1), np.linspace(0, 1, n + 1), indexing='ij')
    pert_x = 0.25 / n * np.sin(7.0 * ys) * np.cos(5.0 * xs)
    pert_y = 0.25 / n * np.cos(6.0 * xs) * np.sin(4.0 * ys)
    xs[1:-1, 1:-1] += pert_x[1:-1, 1:-1]
    ys[1:-1, 1:-1] += pert_y[1:-1, 1:-1]
    points = np.stack([xs.ravel(), ys.ravel()], -1)

    def vid(i, j):
        return i * (n + 1) + j
    quads = [(vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)) for i in range(n) for j in range(n)]
    m = mesh_from_numpy(points, quads)
    f = Field(m, m.center.vector['x'] ** 2 + m.center.vector['y'] ** 2, extrapolation.ZERO_GRADIENT)
    interior = _interior(m)
    err_plain = np.abs(laplace(f, correct_skew=False).values.numpy('cells')[interior] - 4).mean()
    err_skew = np.abs(laplace(f, correct_skew=True).values.numpy('cells')[interior] - 4).mean()
    assert err_skew < err_plain * 0.7, (err_plain, err_skew)
    same = mesh(wrap(points.astype(np.float32), instance('vertices'), channel(vector='x,y')), np.asarray(quads))
    np.testing.assert_array_equal(same.neighbors.numpy('cells,~faces'), m.neighbors.numpy('cells,~faces'))


def test_fvm_implicit_channel_end_to_end():
    """Implicit momentum and projection on a channel with an obstacle keep
    the mean streamwise velocity near the inflow value (the backward-Euler
    sign composition)."""
    from phiflow_tpu_torch.math import jit_compile_linear
    from phiflow_tpu_torch.physics import advect, fluid
    m = build_mesh(Box(x=2, y=1), x=24, y=12, obstacles=Sphere(x=0.6, y=0.5, radius=0.15))
    bc = {'x-': vec(x=1., y=0.), 'x+': extrapolation.ZERO_GRADIENT, 'y-': 0., 'y+': 0., 'boundary': 0.}
    v = Field(m, vec(x=1., y=0.), bc)

    @jit_compile_linear
    def momentum_eq(u, u_prev, dt, viscosity=0.01):
        diffusion = viscosity * laplace(u).values
        advection = advect.differential(u, u_prev, order=1).values
        return u.with_values(u.values - dt * (advection + diffusion))

    for _ in range(10):
        v = tm.solve_linear(momentum_eq, v, Solve('biCG-stab', 1e-5, 1e-5, x0=v, suppress=(ConvergenceException,)),
                            v, 0.05)
        v, p = fluid.make_incompressible(v, (), Solve('biCG-stab', 1e-5, 1e-5, suppress=(ConvergenceException,)))
    mean_ux = float(tm.mean(v.values[{'vector': 'x'}]))
    vmax = float(tm.max(abs(v.values)))
    assert 0.7 < mean_ux < 1.4, f"mean u_x {mean_ux} drifted from inflow 1.0"
    assert vmax < 10.0, f"velocity blew up: {vmax}"


def test_sample_mesh_field_at_points():
    """Nearest cell plus the linear Green-Gauss reconstruction reproduces a
    linear function away from the boundary."""
    m = _quad_mesh(8)
    f = Field(m, lambda pos: 2 * pos.vector['x'] + 3 * pos.vector['y'], 0.)
    pts = wrap([(0.43, 0.52), (0.55, 0.61), (0.31, 0.47)], instance(points=3), channel(vector='x,y'))
    sampled = sample(f, Point(pts))
    expect = 2 * pts.vector['x'] + 3 * pts.vector['y']
    np.testing.assert_allclose(sampled.numpy('points'), expect.numpy('points'), atol=2e-2)


def test_least_squares_gradient_linear_exact():
    """Least squares is exact for linear fields at all cells, boundary cells too."""
    m = _quad_mesh(6)
    f = Field(m, lambda pos: 2 * pos.vector['x'] - 1.5 * pos.vector['y'], extrapolation.ZERO_GRADIENT)
    g = mm.least_squares_gradient(f)
    np.testing.assert_allclose(g.values[{'vector': 'x'}].numpy('cells'), 2.0, atol=1e-4)
    np.testing.assert_allclose(g.values[{'vector': 'y'}].numpy('cells'), -1.5, atol=1e-4)


def test_least_squares_gradient_via_spatial_gradient_scheme():
    m = _quad_mesh(4)
    f = Field(m, lambda pos: pos.vector['x'] ** 2, extrapolation.ZERO_GRADIENT)
    via_dispatch = spatial_gradient(f, scheme='least-squares')
    direct = mm.least_squares_gradient(f)
    np.testing.assert_allclose(via_dispatch.values.numpy('cells,vector'), direct.values.numpy('cells,vector'),
                               atol=1e-6)

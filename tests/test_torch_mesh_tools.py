"""The rest of the mesh slice against the JAX package: `load_stl` (ASCII
and binary), `MeshBuilder` / `join_meshes` / `decimate_tri_mesh`, `as_sdf`
/ `surface_mesh` / `marching_tetrahedra`, and `make_incompressible` of a
mesh velocity with `active` (and its refusal of obstacles, where JAX fails
too). Vertices and SDF values within 1e-5, triangles, faces and neighbours
exactly, the projection within 1e-4 of scale."""
import numpy as np
import pytest

import phiflow_tpu.geom as jg
import phiflow_tpu.math as jm
import phiflow_tpu_torch.geom as tg
import phiflow_tpu_torch.math as tm
import phiflow_tpu_torch.physics.fluid as tfl
from test_torch_mesh3d import _same_mesh
from test_torch_mesh_channel import PKGS, _channel_state, _np


@pytest.fixture(autouse=True)
def _cpu():
    with tm.default_device('cpu'):
        yield


@pytest.mark.parametrize('form', ['ascii', 'binary'])
def test_load_stl(tmp_path, form):
    """A tetrahedron's four triangles (a vertex repeated per triangle): four
    unique vertices and the same faces as JAX's loader."""
    tris = np.array([[(0, 0, 0), (1, 0, 0), (0, 1, 0)], [(0, 0, 0), (0, 0, 1), (1, 0, 0)],
                     [(0, 0, 0), (0, 1, 0), (0, 0, 1)], [(1, 0, 0), (0, 0, 1), (0, 1, 0)]], np.float32)
    path = tmp_path / f'tet_{form}.stl'
    if form == 'ascii':
        lines = ['solid tet'] + [l for t in tris for l in
                                 ['facet normal 0 0 0', ' outer loop'] + [f'  vertex {x} {y} {z}' for x, y, z in t] +
                                 [' endloop', 'endfacet']] + ['endsolid tet']
        path.write_text('\n'.join(lines))
    else:
        rec = np.zeros(len(tris), dtype=[('n', '<f4', 3), ('v', '<f4', (3, 3)), ('attr', '<u2')])
        rec['v'] = tris
        path.write_bytes(b'\0' * 80 + np.uint32(len(tris)).tobytes() + rec.tobytes())
    verts, faces = tg.load_stl(str(path))
    jverts, jfaces = jg.load_stl(str(path))
    assert verts.shape == (4, 3) and faces.shape == (4, 3)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)


def test_mesh_builder_join_and_decimate():
    """`MeshBuilder` (deduplicated vertices, named edges), `join_meshes` of two
    quad meshes sharing an edge, and `decimate_tri_mesh`: JAX's results."""
    out = []
    rng = np.random.default_rng(6)
    verts = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    faces = rng.integers(0, 200, (300, 3))
    for m, g in ((tm, tg), (jm, jg)):
        b = g.MeshBuilder()
        q0 = b.add_polygon((0., 0.), (1., 0.), (1., 1.), (0., 1.))
        b.add_polygon((1., 0.), (2., 0.), (2., 1.), (1., 1. + 1e-8))
        b.add_boundary_edge('left', b.vertex(0., 0.), b.vertex(0., 1.))
        built = b.build()
        left = g.build_mesh(g.Box(x=(0, 1), y=(0, 1)), x=2, y=2)
        right = g.build_mesh(g.Box(x=(1, 2), y=(0, 1)), x=2, y=2)
        joined = g.join_meshes(left, right)
        out.append((q0, built, joined, g.decimate_tri_mesh(verts, faces, 0.3)))
    (q0, built, joined, dec), (jq0, jbuilt, jjoined, jdec) = out
    assert q0 == jq0 == 0 and built.cell_count == 2 and joined.cell_count == 8
    _same_mesh(built, jbuilt)
    _same_mesh(joined, jjoined)
    assert int(_np(joined.vertices, ('vertices', 'vector')).shape[0]) == 15
    np.testing.assert_allclose(dec[0], jdec[0], atol=1e-6)
    np.testing.assert_array_equal(dec[1], jdec[1])


def test_as_sdf_surface_mesh_and_marching_tetrahedra():
    """A sphere's SDF at points, its 3D surface by marching tetrahedra and a
    box's 2D contour: JAX's vertices and triangles."""
    pts = np.random.default_rng(7).uniform(-1.5, 1.5, (40, 3)).astype(np.float32)
    out = []
    for m, g in ((tm, tg), (jm, jg)):
        sphere = g.Sphere(x=0., y=0., z=0., radius=1.)
        sdf = g.as_sdf(sphere)
        at = _np(sdf.approximate_signed_distance(m.tensor(pts, m.instance('p'), m.channel(vector='x,y,z'))), 'p')
        verts, tris = g.surface_mesh(sphere, rel_dx=0.1)
        contour = g.surface_mesh(g.Box(x=(0, 1), y=(0, 2)), rel_dx=0.1)
        lattice = np.fromfunction(lambda i, j, k: (i - 3.) ** 2 + (j - 3.) ** 2 + (k - 3.) ** 2 - 6.5, (7, 7, 7))
        out.append((at, verts, tris, contour, g.marching_tetrahedra(lattice, (0, 0, 0), 0.5)
                    if hasattr(g, 'marching_tetrahedra') else None))
    (at, verts, tris, contour, mt), (jat, jverts, jtris, jcontour, _) = out
    np.testing.assert_allclose(at, jat, atol=1e-5)
    assert len(tris) > 100
    np.testing.assert_allclose(verts, jverts, atol=1e-5)
    np.testing.assert_array_equal(tris, jtris)
    assert len(contour) == len(jcontour)
    for a, b in zip(contour, jcontour):
        np.testing.assert_allclose(a, b, atol=1e-5)
    from phiflow_tpu.geom._convert import marching_tetrahedra as j_mt
    jmt = j_mt(np.fromfunction(lambda i, j, k: (i - 3.) ** 2 + (j - 3.) ** 2 + (k - 3.) ** 2 - 6.5, (7, 7, 7)),
               (0, 0, 0), 0.5)
    np.testing.assert_array_equal(mt[0], jmt[0])
    np.testing.assert_array_equal(mt[1], jmt[1])


def test_mesh_projection_with_active_and_obstacles():
    """`make_incompressible` of a mesh velocity with `active` as JAX computes
    it; with obstacles the port refuses, naming JAX's failure (an
    AssertionError in its `stagger`, which takes grids only)."""
    out = []
    for name in ('port', 'jax'):
        m, g, f, fluid, cw = PKGS[name]
        v, p = _channel_state(PKGS[name], 8, 4, 4, ((2, 3), (1, 3), (1, 3)))
        mask = m.where(v.geometry.center.vector['x'] < 6, 1., 0.)
        active = f.Field(v.geometry, mask, 0.)
        solve = m.Solve('auto', 1e-4, 1e-4, max_iterations=100, suppress=(m.ConvergenceException,))
        w, q = fluid.make_incompressible(v, solve=solve, active=active)
        out.append((_np(w.values, ('cells', 'vector')), _np(q.values, 'cells')))
    for a, b in zip(*out):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())
    with pytest.raises(NotImplementedError, match='_field_math.py:214'):
        tfl.make_incompressible(_channel_state(PKGS['port'], 8, 4, 4, ((2, 3), (1, 3), (1, 3)))[0],
                                obstacles=[tg.Box(x=(5, 6), y=(1, 3), z=(1, 3))])

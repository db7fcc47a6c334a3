"""The 3D mesh slice against the JAX package: `mesh_from_numpy` of volume
elements (tetrahedra, pyramids, wedges, hexahedra; JAX's face slots,
boundary ids and neighbours exactly, the geometry within float32 rounding),
the loaders `load_su2` and `load_gmsh` in 2D and 3D on files written here,
the FVM operators in 3D (Green-Gauss and least-squares gradients, Laplace,
divergence, the advection differential), and an SU2 file of the
mesh-channel-3d recipe's mesh. The analogues of `tests/field/test_mesh.py`'s
3D and loader cases keep their names; the STL loader, the mesh builder, the
conversions and the mesh projection with `active` are in
`test_torch_mesh_tools.py`, the recipe's steps in
`test_torch_mesh_channel.py`. Geometry within 2e-6 of each table's scale
(float32, computed in float64 here and partly in float32 there), operators
within 1e-5."""
import itertools

import numpy as np
import pytest

import phiflow_tpu.field as jf
import phiflow_tpu.geom as jg
import phiflow_tpu.math as jm
import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.geom as tg
import phiflow_tpu_torch.math as tm
from phiflow_tpu.field._mesh_math import green_gauss_gradient as j_gg, least_squares_gradient as j_lsq
from phiflow_tpu_torch.field._mesh_math import green_gauss_gradient as t_gg, least_squares_gradient as t_lsq
from test_torch_mesh_channel import PKGS, _channel_arrays, _np, _write_su2

TABLES = {'neighbors': ('cells', '~faces'), 'center': ('cells', 'vector'), 'volume': ('cells',),
          'face_areas': ('cells', '~faces'), 'face_centers': ('cells', '~faces', 'vector'),
          'face_normals': ('cells', '~faces', 'vector'), 'neighbor_distances': ('cells', '~faces')}


@pytest.fixture(autouse=True)
def _cpu():
    with tm.default_device('cpu'):
        yield


def _same_mesh(a, b, tol=2e-6):
    """Port mesh `a` against JAX mesh `b`: boundary ids and neighbours exact, the geometry within `tol` of scale."""
    assert a.boundaries == b.boundaries and a.cell_count == b.cell_count
    for name, order in TABLES.items():
        x, y = _np(getattr(a, name), order), _np(getattr(b, name), order)
        if name == 'neighbors':
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=tol * max(1.0, np.abs(y).max()), err_msg=name)


def _lattice(nx, ny, nz, jitter=0.0, seed=0):
    vid = np.arange((nx + 1) * (ny + 1) * (nz + 1)).reshape(nx + 1, ny + 1, nz + 1)
    pts = np.stack(np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1), indexing='ij'), -1)
    pts = pts.reshape(-1, 3).astype(np.float32)
    pts = pts + np.random.default_rng(seed).uniform(-jitter, jitter, pts.shape).astype(np.float32)
    i, j, k = (a.ravel() for a in np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing='ij'))
    hexes = np.stack([vid[i, j, k], vid[i + 1, j, k], vid[i + 1, j + 1, k], vid[i, j + 1, k],
                      vid[i, j, k + 1], vid[i + 1, j, k + 1], vid[i + 1, j + 1, k + 1], vid[i, j + 1, k + 1]], 1)
    return pts, hexes


def _mixed_elements(hexes):
    """Hexahedra, tetrahedra, pyramids and wedges cut from the lattice's cells, in that order of blocks."""
    n = len(hexes)
    q = n // 4
    return ([tuple(h) for h in hexes[:q]] + [tuple(h[[0, 1, 3, 4]]) for h in hexes[q:2 * q]] +
            [tuple(h[[0, 1, 2, 3, 4]]) for h in hexes[2 * q:3 * q]] + [tuple(h[[0, 1, 3, 4, 5, 7]]) for h in hexes[3 * q:]])


def test_mesh_3d_tables_match_jax():
    """Every element kind on a jittered lattice, named groups (a quad and a
    triangle face, listed in either orientation) and the unnamed rest: the
    tables equal JAX's cell-by-cell builder."""
    pts, hexes = _lattice(4, 3, 3, jitter=0.12, seed=1)
    elements = _mixed_elements(hexes)
    xlo = [tuple(h[[0, 3, 7, 4]]) for h in hexes if np.all(pts[h[[0, 3, 7, 4]], 0] < 0.2)]
    tet = elements[len(hexes) // 4]
    boundaries = {'xlo': xlo, 'tri': [tuple(tet[i] for i in (0, 1, 2))[::-1]]}
    j = jg.mesh_from_numpy(pts, elements, boundaries)
    t = tg.mesh_from_numpy(pts, elements, boundaries)
    assert 'boundary' in t.boundaries and t.max_faces == 6
    _same_mesh(t, j)


def _hex_grid_3d(g, nx=2, ny=2, nz=2):
    xs, ys, zs = np.linspace(0, 1, nx + 1), np.linspace(0, 1, ny + 1), np.linspace(0, 1, nz + 1)
    vid = lambda i, j, k: (i * (ny + 1) + j) * (nz + 1) + k
    points = [(x, y, z) for x in xs for y in ys for z in zs]
    elements = [(vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k), vid(i, j + 1, k), vid(i, j, k + 1),
                 vid(i + 1, j, k + 1), vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1))
                for i in range(nx) for j in range(ny) for k in range(nz)]
    return g.mesh_from_numpy(points, elements)


def test_mesh_3d_hex_geometry():
    m = _hex_grid_3d(tg, 2, 2, 2)
    _same_mesh(m, _hex_grid_3d(jg, 2, 2, 2))
    assert m.spatial_rank == 3 and m.cell_count == 8
    assert abs(float(tm.sum(m.volume)) - 1.0) < 1e-5
    assert np.allclose(_np(m.volume, 'cells'), 1 / 8, atol=1e-6)
    assert np.all(_np(tm.sum(m.interior_mask, '~faces'), 'cells') == 3)
    areas = _np(m.face_areas, ('cells', '~faces'))
    assert np.allclose(areas[areas > 0], 0.25, atol=1e-6)


def test_mesh_3d_tet_volume():
    points = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)]
    m = tg.mesh_from_numpy(points, [(0, 1, 2, 3)])
    _same_mesh(m, jg.mesh_from_numpy(points, [(0, 1, 2, 3)]))
    assert abs(float(tm.sum(m.volume)) - 1 / 6) < 1e-6
    n, a = _np(m.face_normals, ('cells', '~faces', 'vector')), _np(m.face_areas, ('cells', '~faces'))
    assert np.allclose((n * a[..., None]).sum(1), 0, atol=1e-6)


def test_mesh_3d_gradient_and_laplace():
    """JAX's test on the port (a linear field's Green-Gauss gradient at
    interior cells, Laplace of x² 2), then the 3D operators on a jittered
    mesh against JAX's."""
    m = _hex_grid_3d(tg, 4, 4, 4)
    f = tf.Field(m, 2 * m.center.vector['z'], tm.extrapolation.ZERO_GRADIENT)
    interior = _np(tm.sum(m.interior_mask, '~faces') >= 6, 'cells')
    assert interior.any()
    assert np.allclose(_np(t_gg(f).values[{'vector': 'z'}], 'cells')[interior], 2.0, atol=1e-4)
    lap = tf.laplace(tf.Field(m, m.center.vector['x'] ** 2, tm.extrapolation.ZERO_GRADIENT))
    assert np.allclose(_np(lap.values, 'cells')[interior], 2.0, atol=1e-3)
    from phiflow_tpu.physics import advect as jadvect
    from phiflow_tpu_torch.physics import advect as tadvect
    out = {}
    for name, pkg, gg, lsq, adv in (('jax', PKGS['jax'], j_gg, j_lsq, jadvect), ('port', PKGS['port'], t_gg, t_lsq,
                                                                               tadvect)):
        mm, g, ff = pkg[:3]
        pts, hexes = _lattice(4, 4, 4, jitter=0.1, seed=2)
        mesh = g.mesh_from_numpy(pts, [tuple(h) for h in hexes])
        c = mesh.center
        s = ff.Field(mesh, mm.sin(c.vector['x']) + 2 * c.vector['z'] * c.vector['y'], mm.extrapolation.ZERO_GRADIENT)
        v = ff.Field(mesh, mm.stack({'x': mm.cos(c.vector['y']), 'y': c.vector['x'] * 0.5, 'z': mm.sin(c.vector['z'])},
                                    mm.channel(vector='x,y,z')), {'boundary': mm.vec(x=1., y=0., z=0.)})
        out[name] = {'gg': _np(gg(s).values, ('cells', 'vector')), 'lsq': _np(lsq(s).values, ('cells', 'vector')),
                     'laplace': _np(ff.laplace(s).values, 'cells'), 'divergence': _np(ff.divergence(v).values, 'cells'),
                     'advection': _np(adv.differential(v, v, order=1).values, ('cells', 'vector'))}
    for key, ref in out['jax'].items():
        np.testing.assert_allclose(out['port'][key], ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()),
                                   err_msg=key)


def test_least_squares_gradient_3d():
    n = 3
    pts = np.array([(x, y, z) for x in range(n) for y in range(n) for z in range(n)], float)

    def vid(x, y, z):
        return (x * n + y) * n + z
    cells = [[vid(x, y, z), vid(x + 1, y, z), vid(x + 1, y + 1, z), vid(x, y + 1, z),
              vid(x, y, z + 1), vid(x + 1, y, z + 1), vid(x + 1, y + 1, z + 1), vid(x, y + 1, z + 1)]
             for x, y, z in itertools.product(range(n - 1), repeat=3)]
    vals = []
    for m, g, f, lsq in ((tm, tg, tf, t_lsq), (jm, jg, jf, j_lsq)):
        mesh = g.mesh_from_numpy(pts, cells, element_rank=3)
        field = f.Field(mesh, lambda pos: pos.vector['x'] + 2 * pos.vector['y'] - pos.vector['z'],
                        m.extrapolation.ZERO_GRADIENT)
        vals.append(_np(lsq(field).values, ('cells', 'vector')))
    np.testing.assert_allclose(vals[0], np.tile([1.0, 2.0, -1.0], (8, 1)), atol=1e-4)
    np.testing.assert_allclose(vals[0], vals[1], atol=1e-6)


SU2_2D = """NDIME= 2
NELEM= 2
5 0 1 2 0
5 0 2 3 1
NPOIN= 4
0.0 0.0 0
1.0 0.0 1
1.0 1.0 2
0.0 1.0 3
NMARK= 1
MARKER_TAG= walls
MARKER_ELEMS= 4
3 0 1
3 1 2
3 2 3
3 3 0
"""

SU2_3D = """NDIME= 3
NELEM= 1
12 0 1 2 3 4 5 6 7 0
NPOIN= 8
0 0 0
1 0 0
1 1 0
0 1 0
0 0 1
1 0 1
1 1 1
0 1 1
NMARK= 1
MARKER_TAG= bottom
MARKER_ELEMS= 1
9 0 1 2 3
"""

GMSH_3D = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
5
1 0 0 0
2 1 0 0
3 0 1 0
4 0 0 1
5 1 1 1
$EndNodes
$Elements
3
1 4 2 1 1 1 2 3 4
2 4 2 1 1 2 3 4 5
3 2 2 2 2 1 2 3
$EndElements
"""

GMSH_2D = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
4
1 2 2 5 1 1 2 3
2 2 2 5 1 1 3 4
3 1 2 7 2 1 2
4 1 2 8 3 3 4
$EndElements
"""


def test_su2_roundtrip(tmp_path):
    path = tmp_path / 'square.su2'
    path.write_text(SU2_2D)
    m = tg.load_su2(str(path))
    assert m.cell_count == 2 and abs(float(tm.sum(m.volume)) - 1.0) < 1e-5 and 'walls' in m.boundaries
    _same_mesh(m, jg.load_su2(str(path)))


def test_load_su2_3d(tmp_path):
    path = tmp_path / 'cube.su2'
    path.write_text(SU2_3D)
    m = tg.load_su2(str(path))
    assert m.spatial_rank == 3 and m.cell_count == 1 and abs(float(tm.sum(m.volume)) - 1.0) < 1e-5
    assert 'bottom' in m.boundaries and 'boundary' in m.boundaries
    _same_mesh(m, jg.load_su2(str(path)))


@pytest.mark.parametrize('dims', [2, 3])
def test_load_gmsh_3d(tmp_path, dims):
    """JAX's 3D case (two tetrahedra, a named floor) and a 2D one (two
    triangles, two line groups): the tables equal JAX's."""
    path = tmp_path / 'mesh.msh'
    path.write_text(GMSH_3D if dims == 3 else GMSH_2D)
    names = ['floor'] if dims == 3 else ['south', 'north']
    m = tg.load_gmsh(str(path), boundary_names=names)
    assert m.spatial_rank == dims and m.cell_count == 2 and names[0] in m.boundaries
    assert np.all(_np(m.volume, 'cells') > 0)
    _same_mesh(m, jg.load_gmsh(str(path), boundary_names=names))


def test_load_su2_of_a_written_channel(tmp_path):
    """A channel mesh written as SU2 (hexahedra and quad markers, as the card's
    path writes its own) loads as `mesh_from_numpy` of the same arrays builds it, and as JAX loads it."""
    pts, hexes, groups = _channel_arrays(6, 4, 4, ((2, 3), (1, 3), (1, 3)))
    path = str(tmp_path / 'channel.su2')
    _write_su2(path, pts, hexes, groups)
    m = tg.load_su2(path)
    _same_mesh(m, tg.mesh_from_numpy(pts, hexes, groups), tol=0)
    _same_mesh(m, jg.load_su2(path))
    assert m.boundaries == {'inlet': 0, 'outlet': 1, 'walls': 2, 'cube': 3}

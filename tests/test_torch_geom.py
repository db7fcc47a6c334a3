"""The port's geometries and their masks (`geom/`, `field/_resample.py::geometry_mask`,
`field/_field_math.py::stagger` / `safe_mul`, `field/_angular_velocity.py`)
against the JAX package on the CPU. The same plain numbers describe a geometry
in both packages; hard masks must be equal, cell for cell, also where a
surface passes exactly through cell and face centres."""
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jmath
from phiflow_tpu.field import AngularVelocity, CenteredGrid, Field, StaggeredGrid, resample as jax_resample
from phiflow_tpu.field import safe_mul as jax_safe_mul, stagger as jax_stagger
from phiflow_tpu.geom import Box as JBox, Cuboid as JCuboid, Sphere as JSphere, union as jax_union
from phiflow_tpu.geom._transform import rotation_matrix as jax_rotation_matrix
from phiflow_tpu.math import _ops as jops
from phiflow_tpu.math import extrapolation, vec
from phiflow_tpu.physics.fluid import _accessible_extrapolation as jax_accessible_extrapolation

from phiflow_tpu_torch.field import (angular_velocity_at_faces, cell_grid, face_layout, geometry_mask, safe_mul_native,
                                     stagger_native, staggered_cells)
from phiflow_tpu_torch.geom import Box, Cuboid, Sphere, UniformGrid_native, rotation_matrix, rotation_matrix_native, union
from phiflow_tpu_torch.math import PERIODIC
from phiflow_tpu_torch.physics.fluid import _accessible_extrapolation

ORDER = ('x', 'y', 'z')


def _vec(values):
    return vec(**dict(zip(ORDER, [float(v) for v in values])))


def _jax_grids(res, size, periodic):
    """(centred grid, staggered grid) of the JAX package on [0, size]."""
    names = ORDER[:len(res)]
    bounds = JBox(**dict(zip(names, [float(s) for s in size])))
    sizes = dict(zip(names, res))
    ext = extrapolation.PERIODIC if periodic else extrapolation.ZERO
    return CenteredGrid(0., ext, bounds=bounds, **sizes), StaggeredGrid(0., ext, bounds=bounds, **sizes)


def _components(field):
    names = tuple(field.resolution.names)
    return [np.asarray(field.vector[n].values.native(names)) for n in names]


# one description, both packages: (port geometry, JAX geometry)
def _sphere(center, radius):
    return Sphere(center, radius), JSphere(_vec(center), radius=radius)


def _box(lower, upper):
    return Box(lower, upper), JBox(_vec(lower), _vec(upper))


def _cuboid(center, half, rotation=None):
    jrot = None if rotation is None else (rotation if np.ndim(rotation) == 0 else _vec(rotation))
    return Cuboid(center, half, rotation), JCuboid(_vec(center), _vec(half), rotation=jrot)


def _union(*pairs):
    return union([p for p, _ in pairs]), jax_union([j for _, j in pairs])


GEOMETRIES_2D = {
    # centre 12 on a unit grid: radius 2.5 passes through cell centres, radius 5 through face centres
    'sphere-through-cell-centres': lambda: _sphere((12., 12.), 2.5),
    'sphere-through-face-centres': lambda: _sphere((12., 12.), 5.),
    'sphere-off-grid': lambda: _sphere((9.3, 14.6), 4.2),
    'box-through-cell-centres': lambda: _box((3.5, 6.5), (9.5, 15.5)),
    'box-through-face-centres': lambda: _box((4., 7.), (9., 15.)),
    'cuboid': lambda: _cuboid((12., 10.), (3., 5.5)),
    'cuboid-rotated': lambda: _cuboid((11.2, 12.7), (3.1, 5.3), 0.6),
    'union-sphere-cuboid': lambda: _union(_sphere((7., 8.), 3.), _cuboid((15.2, 14.1), (2.6, 4.2), -0.4)),
    'union-two-spheres': lambda: _union(_sphere((7., 8.), 3.), _sphere((15., 15.), 4.5)),
}
GEOMETRIES_3D = {
    'sphere-through-cell-centres': lambda: _sphere((8., 8., 8.), 2.5),
    'sphere-through-face-centres': lambda: _sphere((8., 8., 8.), 5.),
    'box-through-cell-centres': lambda: _box((3.5, 4.5, 2.5), (9.5, 11.5, 8.5)),
    'cuboid-rotated': lambda: _cuboid((8.3, 7.6, 8.9), (2.2, 3.4, 4.1), (0.3, -0.5, 0.8)),
    'cuboid-rotated-about-z': lambda: _cuboid((8.3, 7.6, 8.9), (2.2, 3.4, 4.1), 0.7),
    'union-sphere-cuboid': lambda: _union(_sphere((5., 6., 5.), 3.), _cuboid((11., 10.5, 11.), (2., 2.5, 3.), (0., 0., 0.5))),
}
CASES = [(2, (24, 24), k) for k in GEOMETRIES_2D] + [(3, (16, 16, 16), k) for k in GEOMETRIES_3D]


@pytest.mark.parametrize('periodic', [False, True], ids=['closed', 'periodic'])
@pytest.mark.parametrize('dims,res,key', CASES, ids=[f'{d}d-{k}' for d, _, k in CASES])
def test_geometry_masks_match_jax(dims, res, key, periodic):
    """Cell grid and every face grid, the geometry and its inverse: hard masks
    equal; soft masks (balance 0.5 and 1) within 1e-6."""
    geom, jgeom = (GEOMETRIES_2D if dims == 2 else GEOMETRIES_3D)[key]()
    centred, staggered = _jax_grids(res, res, periodic)
    cells = cell_grid(res, 1.0, 'cpu')
    faces = staggered_cells(cells, periodic)
    for g, jg in ((geom, jgeom), (~geom, ~jgeom)):
        ref = np.asarray(jax_resample(jg, to=centred, soft=False).values.native(ORDER[:dims]))
        got = geometry_mask(g, cells).numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert np.array_equal(got, ref)
        assert 0 < got.sum() < got.size
        for got_c, ref_c in zip(geometry_mask(g, faces), _components(jax_resample(jg, to=staggered, soft=False))):
            assert got_c.shape == ref_c.shape
            assert np.array_equal(got_c.numpy(), ref_c)
        for balance in (0.5, 1):
            ref = np.asarray(jax_resample(jg, to=centred, soft=True, balance=balance).values.native(ORDER[:dims]))
            assert float(np.abs(geometry_mask(g, cells, soft=True, balance=balance).numpy() - ref).max()) <= 1e-6
            soft = geometry_mask(g, faces, soft=True, balance=balance)
            for got_c, ref_c in zip(soft, _components(jax_resample(jg, to=staggered, soft=True, balance=balance))):
                assert float(np.abs(got_c.numpy() - ref_c).max()) <= 1e-6
                assert 0 < float(got_c.min()) + float(got_c.max()) < 2  # neither all 0 nor all 1


@pytest.mark.parametrize('periodic', [False, True], ids=['closed', 'periodic'])
def test_masks_on_a_domain_that_is_not_unit_cells(periodic):
    """100 × 100 over 64 cells (dx = 1.5625), the moving-obstacle model's
    domain: the cuboid's faces lie on cell borders and the sphere touches
    face centres. Hard equal, soft within 1e-6."""
    res, size = (64, 64), (100., 100.)
    centred, staggered = _jax_grids(res, size, periodic)
    cells = cell_grid(res, 100. / 64, 'cpu')
    faces = staggered_cells(cells, periodic)
    assert cells.upper.tolist() == [100., 100.]
    for geom, jgeom in (_cuboid((25., 80.), (10., 10.)), _sphere((20.5, 22.), 10.),
                        _union(_cuboid((25., 80.), (10., 10.)), _sphere((20.5, 22.), 10.))):
        ref = np.asarray(jax_resample(~jgeom, to=centred, soft=False).values.native(('x', 'y')))
        assert np.array_equal(geometry_mask(~geom, cells).numpy(), ref)
        for got_c, ref_c in zip(geometry_mask(geom, faces, soft=True, balance=1),
                                _components(jax_resample(jgeom, to=staggered, soft=True, balance=1))):
            assert float(np.abs(got_c.numpy() - ref_c).max()) <= 1e-6


def test_face_grids_have_jax_bounds_and_radius():
    """`UniformGrid.stagger`: bounds, resolution and the cells' bounding radius
    (which the soft mask divides by) are the JAX package's numbers exactly."""
    res, size = (24, 16, 20), (36., 16., 25.)
    centred, _ = _jax_grids(res, size, False)
    cells = UniformGrid_native(res, (0., 0., 0.), size, 'cpu')
    for axis, name in enumerate(ORDER):
        for lower, upper in ((False, False), (True, False), (True, True)):
            ref = centred.geometry.stagger(name, lower, upper)
            got = cells.stagger(axis, lower, upper)
            assert got.resolution == tuple(ref.resolution.sizes)
            assert np.array_equal(got.lower, np.asarray(ref.bounds.lower.native()))
            assert np.array_equal(got.upper, np.asarray(ref.bounds.upper.native()))
            assert got.bounding_radius() == float(ref.bounding_radius())
            ref_centre = np.asarray(ref.center.native(ORDER + ('vector',)))
            for a, coords in enumerate(got.center):
                assert np.array_equal(np.broadcast_to(coords.numpy(), got.resolution), ref_centre[..., a])


@pytest.mark.parametrize('angle', [0.6, (0.3, -0.5, 0.8), (0., 0., 1.1)], ids=['2d', '3d-euler', '3d-about-z'])
def test_rotation_matrix_matches_jax(angle):
    """Within 1e-7: cos and sin come from two libraries. JAX's signature
    returns a host Tensor (~vector, vector), `rotation_matrix_native` its numpy array."""
    d = 2 if np.ndim(angle) == 0 else 3
    ref = jax_rotation_matrix(angle if d == 2 else _vec(angle), ORDER[:d])
    ref = np.asarray(ref.native(('~vector', 'vector')))
    tensor = rotation_matrix(angle, ORDER[:d])
    got = tensor.native(('~vector', 'vector'))
    assert tensor.shape.get_labels('vector') == ORDER[:d] and tensor.shape.get_labels('~vector') == ORDER[:d]
    assert np.array_equal(got, rotation_matrix_native(angle, d))
    assert got.dtype == np.float32 and got.shape == (d, d)
    assert float(np.abs(got - ref).max()) <= 1e-7
    assert float(np.abs(got @ got.T - np.eye(d)).max()) <= 1e-6


def test_geometry_transforms_keep_jax_numbers():
    """`at`, `shifted`, `rotated` in float32: the centres a moving obstacle
    goes through are the JAX package's."""
    box, jbox = _box((3.5, 6.5), (9.5, 15.5))
    moved, jmoved = box.shifted((1.3, -0.7)), jbox.shifted(_vec((1.3, -0.7)))
    assert np.array_equal(moved.lower, np.asarray(jmoved.lower.native()))
    assert np.array_equal(moved.upper, np.asarray(jmoved.upper.native()))
    placed, jplaced = box.at((20.1, 30.3)), jbox.at(_vec((20.1, 30.3)))
    assert np.array_equal(placed.lower, np.asarray(jplaced.lower.native()))
    turned, jturned = box.rotated(0.3).rotated(0.2), jbox.rotated(0.3).rotated(0.2)
    assert isinstance(turned, Cuboid)
    assert np.array_equal(turned.center, np.asarray(jturned.center.native()))
    assert np.array_equal(turned.half_size, np.asarray(jturned.half_size.native()))
    assert float(turned.rotation) == float(jturned._rotation)
    sphere, jsphere = _sphere((12., 12.), 2.5)
    assert sphere.rotated(1.0) is sphere
    assert np.array_equal(sphere.shifted((0.1, 0.2)).center, np.asarray(jsphere.shifted(_vec((0.1, 0.2))).center.native()))
    assert union(sphere) is sphere and (~~sphere) is sphere
    with pytest.raises(ValueError, match='2D sphere'):
        sphere.lies_inside(cell_grid((4, 4, 4), 1.0, 'cpu').center)


@pytest.mark.parametrize('dims,periodic', [(2, False), (2, True), (3, False), (3, True)],
                         ids=['2d-closed', '2d-periodic', '3d-closed', '3d-periodic'])
def test_angular_velocity_at_faces_matches_jax(dims, periodic):
    """ω × (x − x₀), each component at its own face centres: within 1e-6."""
    res = (24, 20) if dims == 2 else (12, 10, 14)
    _, staggered = _jax_grids(res, res, periodic)
    centre = (9.3, 7.1, 5.2)[:dims]
    strength = 0.7 if dims == 2 else (0.2, -0.5, 0.9)
    ref = jax_resample(AngularVelocity(location=_vec(centre), strength=strength if dims == 2 else _vec(strength),
                                       falloff=None), to=staggered)
    faces = staggered_cells(cell_grid(res, 1.0, 'cpu'), periodic)
    got = angular_velocity_at_faces(faces, centre, strength)
    for a, (g, r) in enumerate(zip(got, _components(ref))):
        g = g.expand(faces[a].resolution).numpy()
        assert g.shape == r.shape
        assert float(np.abs(g - r).max()) <= 1e-6
        assert float(np.abs(r).max()) > 1.0


@pytest.mark.parametrize('dims,periodic', [(2, False), (2, True), (3, False), (3, True)],
                         ids=['2d-closed', '2d-periodic', '3d-closed', '3d-periodic'])
def test_stagger_minimum_matches_jax(dims, periodic):
    """`hard_bcs`: the accessible cells combined onto the faces the velocity
    stores, with the accessible extrapolation beyond the outer faces. Equal."""
    res = (24, 24) if dims == 2 else (16, 16, 16)
    names = ORDER[:dims]
    centred, staggered = _jax_grids(res, res, periodic)
    geom, jgeom = _union(_sphere((5., 6., 5.)[:dims], 3.), _cuboid((11., 10.5, 11.)[:dims], (2., 2.5, 3.)[:dims]),
                         _box((0., 0., 0.)[:dims], (2., 30., 30.)[:dims]))  # a slab along the x− wall
    acc_ext = jax_accessible_extrapolation(staggered.boundary)
    accessible = Field(staggered.geometry, ~jgeom, acc_ext)
    ref = jax_stagger(accessible, jops.minimum, staggered.boundary, at='face', dims=staggered.resolution.names)
    mask = geometry_mask(~geom, cell_grid(res, 1.0, 'cpu'))
    assert np.array_equal(mask.numpy(), np.asarray(accessible.values.native(names)))
    got = stagger_native(mask, torch.minimum, _accessible_extrapolation(PERIODIC if periodic else 0.0),
                         face_layout(periodic, len(res)))
    for g, r in zip(got, _components(ref)):
        assert np.array_equal(g.numpy(), r)
        assert 0 < g.sum() < g.numel()


def test_accessible_extrapolation_follows_the_velocity():
    from phiflow_tpu_torch.math import BOUNDARY, PerSide
    assert _accessible_extrapolation(PERIODIC) == PERIODIC
    assert _accessible_extrapolation(0.0) == 0.0 and _accessible_extrapolation(1.5) == 0.0
    assert _accessible_extrapolation(PerSide((0., 0.), (0., 1.))) == 0.0
    assert _accessible_extrapolation(BOUNDARY) == 1.0


def test_safe_mul_with_nan_matches_jax():
    """0 · NaN = 0 on both sides, NaN elsewhere it meets a non-zero: the NaN
    pattern and the values equal."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 7)).astype(np.float32)
    b = rng.standard_normal((6, 7)).astype(np.float32)
    a[0, :3], a[1, :3], a[2, :3] = 0.0, np.nan, 0.0
    b[0, :3], b[1, :3], b[2, 1] = np.nan, 0.0, 0.0
    b[3, 3] = np.nan
    shape = jmath.spatial(x=6, y=7)
    ref = np.asarray(jax_safe_mul(jmath.tensor(a, shape), jmath.tensor(b, shape)).native(('x', 'y')))
    got = safe_mul_native(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got).sum() == 1 and (got[:3, :3] == 0).all()
    assert np.array_equal(np.nan_to_num(got), np.nan_to_num(ref))

"""The Field cases that raised before the open-boundary slice, the port against
the JAX package on the CPU: SYMMETRIC, REFLECT, ANTISYMMETRIC, ANTIREFLECT and
SYMMETRIC_GRADIENT in `laplace`, `resample` (onto the closed box's faces), the
face `spatial_gradient` and `mac_cormack` of a centred grid, in 2D (16²) and
3D (10 × 8 × 6), one parametrised test of the 40 cases within 1e-5 of each
result's scale; the same rules by side, mixed with constants and PERIODIC;
`stagger` over a subset of the dims and at the centres; slicing centred and
staggered grids along their dims (values bit-equal, bounds and boundary
equal); the analogue of `tests/field/test_grids.py::test_resample_coarser`
and `resample(order=4)` / `order=6` (the `interp_matrix` route between
half-shifted grids); lookups at points under the mirror rules. Inputs from
numpy; JAX's side of the 40 cases jitted at once."""
import jax
import numpy as np
import pytest
import torch

import phiflow_tpu.field as jf
import phiflow_tpu.geom as jg
import phiflow_tpu.math as jm
from phiflow_tpu.physics import advect as jadvect

import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.geom as tg
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.physics import advect

TOL = 1e-5
RULES = ['SYMMETRIC', 'REFLECT', 'ANTISYMMETRIC', 'ANTIREFLECT', 'SYMMETRIC_GRADIENT']
OPERATIONS = ['laplace', 'resample', 'face gradient', 'mac_cormack']
SIZES = {2: (16, 16), 3: (10, 8, 6)}


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _names(dims):
    return ('x', 'y', 'z')[:dims]


def _centred(dims, boundary_of, seed, bounds=None):
    """(JAX, port) centred grids of one numpy-seeded array under `boundary_of(extrapolation module)`."""
    names = _names(dims)
    arr = np.random.default_rng(seed).standard_normal(SIZES[dims]).astype(np.float32)
    res = dict(zip(names, SIZES[dims]))
    out = []
    for m, f, g, wrap in ((jm, jf, jg, lambda a: a), (tm, tf, tg, torch.from_numpy)):
        box = g.Box(**(bounds or {n: float(s) for n, s in res.items()}))
        out.append(f.CenteredGrid(m.wrap(wrap(arr.copy()), m.spatial(**res)), boundary_of(m.extrapolation),
                                  bounds=box, **res))
    return out


def _staggered(dims, boundary_of, seed, scale=1.0):
    names = _names(dims)
    res = dict(zip(names, SIZES[dims]))
    rng = np.random.default_rng(seed)
    grids = [f.StaggeredGrid(0., boundary_of(m.extrapolation), **res) for m, f in ((jm, jf), (tm, tf))]
    arrays = [(scale * rng.standard_normal(tuple(grids[0].vector[d].values.shape.only(names, reorder=True).sizes)))
              .astype(np.float32) for d in names]
    return (grids[0].with_values(jm.stack([jm.wrap(a, jm.spatial(*names)) for a in arrays], jm.dual(vector=names))),
            grids[1].with_values(tm.stack([tm.wrap(torch.from_numpy(a), tm.spatial(*names)) for a in arrays],
                                          tm.dual(vector=names))))


def _arrays(value):
    """numpy arrays of a Field (its components, staggered) or a Tensor."""
    if hasattr(value, 'resolution'):
        names = value.resolution.names
        if value.is_staggered:
            return [np.asarray(value.values[{'~vector': d}].numpy(names))
                    for d in value.values.shape.get_labels('~vector')]
        value = value.values
    return [np.asarray(value.numpy(value.shape.names))]


def _close(port, ref, tol=TOL):
    got, want = _arrays(port), _arrays(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1.0)


def _operation(op, pkg, grid, velocity):
    f, a = pkg
    if op == 'laplace':
        return f.laplace(grid)
    if op == 'resample':
        return f.resample(grid, to=f.StaggeredGrid(0., 0., grid.bounds, grid.resolution))
    if op == 'face gradient':
        return f.spatial_gradient(grid, at='face')
    return a.mac_cormack(grid, velocity, 1.0)


CASES = [(dims, rule, op) for dims in (2, 3) for rule in RULES for op in OPERATIONS]


def _inputs(dims, rule):
    jg_, g = _centred(dims, lambda e: getattr(e, rule), 10 + dims)
    jv, v = _staggered(dims, lambda e: 0., 20 + dims, 0.6)
    return jg_, g, jv, v


@pytest.fixture(scope='module')
def jax_results():
    results = {}
    for dims in (2, 3):
        group = [c for c in CASES if c[0] == dims]
        inputs = [_inputs(dims, rule) for _, rule, _ in group]

        def run(pairs):
            return [_operation(op, (jf, jadvect), grid, v) for (_, _, op), (grid, v) in zip(group, pairs)]
        results.update(zip(group, jax.jit(run)([(i[0], i[2]) for i in inputs])))
    return results


@pytest.mark.parametrize('case', CASES, ids=['-'.join(map(str, c)).replace(' ', '_') for c in CASES])
def test_mirror_rules_match_jax(case, jax_results):
    """The 20 cases of a centred grid under a mirror rule, 2D and 3D: the port's result, and its boundary
    (the rule's gradient or the target's), equal JAX's."""
    dims, rule, op = case
    _, grid, _, v = _inputs(dims, rule)
    got = _operation(op, (tf, advect), grid, v)
    ref = jax_results[case]
    assert got.boundary.to_dict() == ref.boundary.to_dict()
    _close(got, ref)


MIXED = {'mirrors': lambda e: e.combine_sides(x=(e.SYMMETRIC, e.ANTIREFLECT), y=(e.REFLECT, 2.0)),
         'mirror-periodic': lambda e: e.combine_sides(x=e.PERIODIC, y=(e.ANTISYMMETRIC, e.SYMMETRIC_GRADIENT))}


@pytest.mark.parametrize('name', list(MIXED))
def test_mirror_rules_by_side_match_jax(name):
    """Mirrors by side beside a constant or PERIODIC (JAX's `combine_sides` padding order, ROADMAP §3 3.11) in
    `laplace`, the face gradient and `mac_cormack` (2D): within 1e-5."""
    jgrid, grid = _centred(2, MIXED[name], 30)
    jv, v = _staggered(2, lambda e: 0., 31, 0.6)
    refs = jax.jit(lambda g_, v_: [_operation(op, (jf, jadvect), g_, v_) for op in ('laplace', 'face gradient',
                                                                                     'mac_cormack')])(jgrid, jv)
    for op, ref in zip(('laplace', 'face gradient', 'mac_cormack'), refs):
        _close(_operation(op, (tf, advect), grid, v), ref)


@pytest.mark.parametrize('at', ['face', 'center'])
def test_stagger_subsets_and_centres_match_jax(at):
    """`stagger` of a 3D grid over (z, x) and over all dims, at the faces and at the centres."""
    jgrid, grid = _centred(3, lambda e: e.combine_sides(x=e.SYMMETRIC, y=e.BOUNDARY, z=(0., e.PERIODIC)), 40)
    for dims in (['z', 'x'], None):
        for fn, jfn in ((tm.minimum, jm.minimum), (tm.maximum, jm.maximum)):
            got = tf.stagger(grid, fn, tm.extrapolation.BOUNDARY, at=at, dims=dims)
            ref = jf.stagger(jgrid, jfn, jm.extrapolation.BOUNDARY, at=at, dims=dims)
            if at == 'center':
                assert got.values.shape.get_labels('vector') == ref.values.shape.get_labels('vector')
                np.testing.assert_allclose(got.values.numpy(('vector', 'x', 'y', 'z')),
                                           np.asarray(ref.values.numpy(('vector', 'x', 'y', 'z'))), atol=0, rtol=0)
            else:
                assert got.values.shape.get_labels('~vector') == ref.values.shape.get_labels('~vector')
                _close(got, ref, 0.)


def test_face_gradient_over_some_dims_matches_jax():
    jgrid, grid = _centred(3, lambda e: e.REFLECT, 41)
    for dims, boundary in ((['y'], 'ZERO'), (['z', 'x'], 'BOUNDARY'), (None, 'PERIODIC')):
        got = tf.spatial_gradient(grid, getattr(tm.extrapolation, boundary), at='face', dims=dims)
        ref = jf.spatial_gradient(jgrid, getattr(jm.extrapolation, boundary), at='face', dims=dims)
        _close(got, ref)


SLICES = [{'x': slice(2, 5)}, {'x': slice(1, None), 'y': slice(None, -2)}, {'y': slice(-5, -1), 'z': slice(0, 3)}]


@pytest.mark.parametrize('staggered', [False, True], ids=['centred', 'staggered'])
@pytest.mark.parametrize('k', range(len(SLICES)))
def test_slicing_along_grid_dims_matches_jax(staggered, k):
    """`field[slices]` of a 3D grid on Box(x=(-1, 4), y=(0, 2), z=(1, 7)) under a boundary mixed by side:
    values bit-equal, resolution, bounds and boundary equal to JAX's; a staggered grid's components keep the
    face counts JAX gives them."""
    boundary = lambda e: e.combine_sides(x=(0., e.BOUNDARY), y=e.PERIODIC, z=e.SYMMETRIC)  # noqa: E731
    if staggered:
        jgrid, grid = _staggered(3, boundary, 50)
    else:
        jgrid, grid = _centred(3, boundary, 50, dict(x=(-1., 4.), y=(0., 2.), z=(1., 7.)))
    got, ref = grid[SLICES[k]], jgrid[SLICES[k]]
    assert got.resolution.sizes == tuple(ref.resolution.sizes)
    np.testing.assert_array_equal(got.bounds.lower.numpy(), np.asarray(ref.bounds.lower.numpy()))
    np.testing.assert_array_equal(got.bounds.upper.numpy(), np.asarray(ref.bounds.upper.numpy()))
    assert got.boundary.to_dict() == ref.boundary.to_dict()
    _close(got, ref, 0.)
    if staggered:
        assert [a.shape for a in _arrays(got)] == [a.shape for a in _arrays(ref)]


def test_resample_coarser():
    """The analogue of the JAX suite's test: x sampled at 16² resampled onto 8² equals x sampled at 8² (1e-5),
    and JAX's resampled grid."""
    fields = []
    for m, f, g in ((jm, jf, jg), (tm, tf, tg)):
        fine = f.CenteredGrid(lambda pos: pos.vector['x'], m.extrapolation.BOUNDARY, x=16, y=16, bounds=g.Box(x=4, y=4))
        coarse = f.resample(fine, f.CenteredGrid(0., m.extrapolation.BOUNDARY, x=8, y=8, bounds=g.Box(x=4, y=4)))
        fields.append((coarse, f.CenteredGrid(lambda pos: pos.vector['x'], m.extrapolation.BOUNDARY, x=8, y=8,
                                              bounds=g.Box(x=4, y=4))))
    (jcoarse, _), (coarse, ref) = fields
    tf.assert_close(coarse, ref, abs_tolerance=1e-5)
    _close(coarse, jcoarse)


@pytest.mark.parametrize('order', [4, 6])
@pytest.mark.parametrize('route', ['centres-to-faces', 'faces-to-centres', 'coarser'])
def test_higher_order_resample_matches_jax(order, route):
    """`resample(..., order=4 / 6)`: between half-shifted grids through `interp_matrix` per axis (where both
    sides classify; the mirror side of x pads and averages at order 2, as in JAX), onto a coarser grid through
    `grid_sample` at order 2, as JAX does."""
    if route == 'faces-to-centres':
        jsrc, src = _staggered(2, lambda e: e.PERIODIC, 60)
        targets = [f.CenteredGrid(0., m.extrapolation.PERIODIC, x=16, y=16) for m, f in ((jm, jf), (tm, tf))]
    else:
        jsrc, src = _centred(2, lambda e: e.combine_sides(x=e.SYMMETRIC, y=(e.BOUNDARY, 1.0)), 61)
        targets = [f.StaggeredGrid(0., 0., x=16, y=16) if route == 'centres-to-faces' else
                   f.CenteredGrid(0., 0., x=8, y=8, bounds=g.Box(x=16, y=16)) for f, g in ((jf, jg), (tf, tg))]
    _close(tf.resample(src, to=targets[1], order=order), jf.resample(jsrc, to=targets[0], order=order))


@pytest.mark.parametrize('rule', RULES)
def test_lookups_at_points_under_mirror_rules(rule):
    """A 2D grid under each mirror rule, on Box(x=(1, 5), y=(-2, 2)), sampled at 50 points inside and up to
    two cells beyond it: within 1e-5 of JAX's."""
    jgrid, grid = _centred(2, lambda e: getattr(e, rule), 70, dict(x=(1., 5.), y=(-2., 2.)))
    pts = np.random.default_rng(71).uniform((0.5, -2.5), (5.5, 2.5), (50, 2)).astype(np.float32)
    got = grid.sample(tg.Point(tm.wrap(torch.from_numpy(pts), tm.instance('p'), tm.channel(vector='x,y'))))
    ref = jgrid.sample(jg.Point(jm.wrap(pts, jm.instance('p'), jm.channel(vector='x,y'))))
    _close(got, ref)

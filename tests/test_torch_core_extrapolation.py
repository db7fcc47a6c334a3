"""`phiflow_tpu_torch.math.extrapolation` against `phiflow_tpu.math.extrapolation`:
the cases of `tests/math/test_extrapolation.py`, padding on host (numpy) and
torch natives equal to JAX's in float32, plus `to_native`, the map onto the
array layer's descriptors."""
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
import phiflow_tpu_torch.math as tm
from phiflow_tpu.math import extrapolation as je
from phiflow_tpu_torch.math import extrapolation as te

NATIVE = ['host', 'torch']
NAMES = ['ZERO', 'ONE', 'PERIODIC', 'BOUNDARY', 'SYMMETRIC', 'REFLECT', 'ANTISYMMETRIC', 'ANTIREFLECT']


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _t(kind, values=(0., 1., 2., 3., 4.)):
    arr = np.asarray(values, np.float32)
    return tm.wrap(arr if kind == 'host' else torch.from_numpy(arr.copy()), tm.spatial('x')), \
        jm.wrap(arr, jm.spatial('x'))


@pytest.mark.parametrize('kind', NATIVE)
@pytest.mark.parametrize('name', NAMES)
@pytest.mark.parametrize('widths', [(2, 1), (1, 0), (0, 2), (1, 2)])
def test_pad_modes(kind, name, widths):
    t, j = _t(kind)
    got = getattr(te, name).pad(t, {'x': widths})
    ref = getattr(je, name).pad(j, {'x': widths})
    assert got.shape.names == ref.shape.names and got.shape.sizes == ref.shape.sizes
    np.testing.assert_array_equal(got.numpy('x'), np.asarray(ref.numpy('x')))


@pytest.mark.parametrize('kind', NATIVE)
def test_pad_2d_and_stack(kind):
    arr = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    t = tm.wrap(arr if kind == 'host' else torch.from_numpy(arr.copy()), tm.spatial('x,y'))
    j = jm.wrap(arr, jm.spatial('x,y'))
    for name in NAMES:
        got = getattr(te, name).pad(t, {'x': (1, 1), 'y': (2, 0)})
        ref = getattr(je, name).pad(j, {'x': (1, 1), 'y': (2, 0)})
        assert got.shape.names == ref.shape.names
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref.numpy()))


@pytest.mark.parametrize('kind', NATIVE)
def test_combine_sides(kind):
    t, j = _t(kind)
    mix, jmix = te.combine_sides(x=(te.ZERO, te.BOUNDARY)), je.combine_sides(x=(je.ZERO, je.BOUNDARY))
    np.testing.assert_array_equal(mix.pad(t, {'x': (1, 1)}).numpy('x'), np.asarray(jmix.pad(j, {'x': (1, 1)}).numpy('x')))
    assert mix.valid_outer_faces('x') == jmix.valid_outer_faces('x') == (False, True)


@pytest.mark.parametrize('name', NAMES + ['NONE', 'ZERO_GRADIENT'])
def test_queries(name):
    e, j = getattr(te, name), getattr(je, name)
    assert e.valid_outer_faces('x') == j.valid_outer_faces('x')
    assert e.is_flexible == j.is_flexible
    assert repr(e.spatial_gradient()) == repr(j.spatial_gradient())
    assert e.to_dict() == j.to_dict()


@pytest.mark.parametrize('kind', NATIVE)
def test_constant_vector_pad(kind):
    arr = np.zeros((3, 2), np.float32)
    t = tm.wrap(arr if kind == 'host' else torch.from_numpy(arr), tm.spatial('x'), tm.channel(vector='x,y'))
    p = te.ConstantExtrapolation(tm.vec(x=1., y=2.)).pad(t, {'x': (1, 0)})
    jp = je.ConstantExtrapolation(jm.vec(x=1., y=2.)).pad(jm.wrap(arr, jm.spatial('x'), jm.channel(vector='x,y')),
                                                          {'x': (1, 0)})
    np.testing.assert_array_equal(p.numpy(('x', 'vector')), np.asarray(jp.numpy(('x', 'vector'))))


def test_arithmetic():
    assert (te.ZERO + te.ONE) == te.ConstantExtrapolation(1.)
    assert (te.PERIODIC - te.PERIODIC) == te.PERIODIC
    assert (te.BOUNDARY * 2) == te.BOUNDARY
    assert -te.ONE == te.ConstantExtrapolation(-1.)
    assert repr(te.ONE * 3) == repr(je.ONE * 3)


def test_spatial_gradient_map():
    assert te.ZERO.spatial_gradient() == te.ZERO
    assert te.PERIODIC.spatial_gradient() == te.PERIODIC
    assert te.BOUNDARY.spatial_gradient() == te.ZERO
    assert te.remove_constant_offset(te.ConstantExtrapolation(5.)) == te.ZERO


@pytest.mark.parametrize('build', [lambda e: e.ZERO, lambda e: e.PERIODIC, lambda e: e.BOUNDARY,
                                   lambda e: e.combine_sides(x=(e.ZERO, e.PERIODIC)),
                                   lambda e: e.combine_by_direction(e.ZERO, e.BOUNDARY)],
                         ids=['zero', 'periodic', 'boundary', 'mixed', 'normal-tangential'])
def test_serialization(build):
    d = build(te).to_dict()
    assert d == build(je).to_dict()
    assert te.from_dict(d) == build(te)


def test_normal_tangential():
    nt = te.combine_by_direction(te.ZERO, te.BOUNDARY)
    assert te.get_normal(nt) == te.ZERO and te.get_tangential(nt) == te.BOUNDARY
    assert te.as_extrapolation('periodic') == te.PERIODIC and te.as_extrapolation(0.) == te.ZERO


def test_to_native():
    """Every value-independent extrapolation and scalar constant has an
    array-layer rule, by side too; the array layer's ghost cells of each
    equal JAX's pad (float32, host values)."""
    from phiflow_tpu_torch.math import BOUNDARY, PERIODIC, PerSide, _nd
    assert te.to_native(te.ZERO) == 0.0 and te.to_native(te.ConstantExtrapolation(2.)) == 2.0
    assert te.to_native(te.PERIODIC) == PERIODIC and te.to_native(te.BOUNDARY) == BOUNDARY
    lid = te.combine_sides(x=0., y=(0., 1.))
    assert te.to_native(lid, ('x', 'y')) == PerSide((0., 0.), (0., 1.))
    assert te.to_native(te.combine_sides(x=te.PERIODIC, y=(te.REFLECT, 2.)), ('x', 'y')) == \
        PerSide((PERIODIC, PERIODIC), (_nd.REFLECT, 2.))
    values = np.asarray([3., -1., 4., 1.5, -5.], np.float32)
    for name in ('SYMMETRIC', 'REFLECT', 'ANTISYMMETRIC', 'ANTIREFLECT', 'SYMMETRIC_GRADIENT'):
        rule = te.to_native(getattr(te, name))
        got = _nd.pad(torch.from_numpy(values), 0, 2, 3, rule).numpy()
        ref = getattr(je, name).pad(jm.wrap(values, jm.spatial('x')), {'x': (2, 3)}).numpy('x')
        np.testing.assert_array_equal(got, np.asarray(ref), err_msg=name)
    with pytest.raises(NotImplementedError):
        te.to_native(te.NONE)
    with pytest.raises(NotImplementedError):
        te.to_native(te.ConstantExtrapolation(tm.vec(x=1., y=0.)))

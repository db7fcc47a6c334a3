"""`CenteredGrid` / `StaggeredGrid` and the field operators of the port against
the JAX package's: the cases of `tests/field/test_grids.py` that this slice
covers, on numpy inputs from a seed where the JAX test draws `Noise` or
samples a function (neither is ported yet), with `stagger`, cells of
different sizes along the axes, `laplace` over some axes and the cases the
array layer refuses. Shapes exactly, values within float32 rounding."""
import numpy as np
import pytest
import torch

import phiflow_tpu.field as jf
import phiflow_tpu.math as jm
from phiflow_tpu.geom import Box as JBox, Sphere as JSphere

import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.geom import Box, Sphere


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _pair(arr, names='x,y'):
    arr = np.ascontiguousarray(arr, np.float32)
    return tm.wrap(torch.from_numpy(arr.copy()), tm.spatial(names)), jm.wrap(arr, jm.spatial(names))


def _close(port, ref, atol=0.):
    assert port.shape.names == ref.shape.names and port.shape.sizes == ref.shape.sizes
    np.testing.assert_allclose(port.numpy(), np.asarray(ref.numpy()), atol=atol, rtol=1e-6 if atol else 0)


def _random(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_centered_constructors():
    g, jg = tf.CenteredGrid(0., 0., x=8, y=8), jf.CenteredGrid(0., 0., x=8, y=8)
    assert g.shape.spatial.sizes == jg.shape.spatial.sizes == (8, 8)
    _close(g.values, jg.values)
    values, jvalues = _pair(_random((16, 16), 0))
    g2 = tf.CenteredGrid(values, tm.extrapolation.PERIODIC, x=16, y=16, bounds=Box(x=2, y=2))
    jg2 = jf.CenteredGrid(jvalues, jm.extrapolation.PERIODIC, x=16, y=16, bounds=JBox(x=2, y=2))
    _close(g2.values, jg2.values)
    _close(g2.dx, jg2.dx)
    for soft in (False, True):
        mask = tf.resample(Sphere(x=2, y=2, radius=1), to=tf.CenteredGrid(0., 0., x=4, y=4, bounds=Box(x=4, y=4)),
                           soft=soft)
        jmask = jf.resample(JSphere(x=2, y=2, radius=1), to=jf.CenteredGrid(0., 0., x=4, y=4, bounds=JBox(x=4, y=4)),
                            soft=soft)
        _close(mask.values, jmask.values)
    g4 = tf.CenteredGrid(Sphere(x=2, y=2, radius=1), 0., x=4, y=4, bounds=Box(x=4, y=4))
    assert float(tm.max(g4.values)) > 0
    _close(g4.values, jf.CenteredGrid(JSphere(x=2, y=2, radius=1), 0., x=4, y=4, bounds=JBox(x=4, y=4)).values)


@pytest.mark.parametrize('name,sizes_x', [('ZERO', (7, 8)), ('PERIODIC', (8, 8)), ('BOUNDARY', (9, 8))])
def test_staggered_sizes(name, sizes_x):
    v = tf.StaggeredGrid(0., getattr(tm.extrapolation, name), x=8, y=8)
    jv = jf.StaggeredGrid(0., getattr(jm.extrapolation, name), x=8, y=8)
    assert v.vector['x'].values.shape.sizes == jv.vector['x'].values.shape.sizes == sizes_x
    assert v.vector['x'].geometry.resolution == tm.spatial(x=sizes_x[0], y=8)
    np.testing.assert_array_equal(v.vector['x'].geometry.bounds.lower.numpy(),
                                  np.asarray(jv.vector['x'].geometry.bounds.lower.numpy()))


def test_staggered_tensor_roundtrip():
    comps = [_random((7, 8), 1), _random((8, 7), 2)]
    v = tf.StaggeredGrid(tm.stack([_pair(c)[0] for c in comps], tm.dual(vector='x,y')), tm.extrapolation.ZERO,
                         x=8, y=8)
    jv = jf.StaggeredGrid(jm.stack([_pair(c)[1] for c in comps], jm.dual(vector='x,y')), jm.extrapolation.ZERO,
                          x=8, y=8)
    uniform, juniform = v.staggered_tensor(), jv.staggered_tensor()
    assert uniform.shape.spatial.sizes == juniform.shape.spatial.sizes == (9, 9)
    np.testing.assert_array_equal(uniform.numpy(('vector', 'x', 'y')), np.asarray(juniform.numpy(('vector', 'x', 'y'))))
    v2 = tf.StaggeredGrid(uniform, tm.extrapolation.ZERO, x=8, y=8)
    np.testing.assert_array_equal(v2.vector['x'].values.numpy(('x', 'y')), comps[0])


def test_grid_sampling_identity():
    values, jvalues = _pair(_random((16, 16), 3))
    g = tf.CenteredGrid(values, tm.extrapolation.PERIODIC, x=16, y=16)
    g2 = tf.resample(g, tf.CenteredGrid(0., tm.extrapolation.PERIODIC, x=16, y=16))
    _close(g2.values, g.values)
    assert g2 == g


@pytest.mark.parametrize('name', ['ZERO', 'PERIODIC', 'BOUNDARY'])
def test_centres_and_faces(name):
    """resample between a centred grid and a staggered one, both ways."""
    values, jvalues = _pair(_random((8, 6), 4))
    ext, jext = getattr(tm.extrapolation, name), getattr(jm.extrapolation, name)
    g = tf.CenteredGrid(values, ext, x=8, y=6, bounds=Box(x=8, y=6))
    jg = jf.CenteredGrid(jvalues, jext, x=8, y=6, bounds=JBox(x=8, y=6))
    faces = tf.resample(g * (1., 2.), to=tf.StaggeredGrid(0., ext, x=8, y=6, bounds=Box(x=8, y=6)))
    jfaces = jf.resample(jg * (1., 2.), to=jf.StaggeredGrid(0., jext, x=8, y=6, bounds=JBox(x=8, y=6)))
    for d in 'xy':
        _close(faces.vector[d].values, jfaces.vector[d].values)
    back = tf.resample(faces, to=g)
    jback = jf.resample(jfaces, to=jg)
    _close(back.values, jback.values)


def test_divergence_free_constant():
    for name in ('PERIODIC', 'ZERO'):
        v = tf.StaggeredGrid((1., 2.), getattr(tm.extrapolation, name), x=8, y=8)
        jv = jf.StaggeredGrid((1., 2.), getattr(jm.extrapolation, name), x=8, y=8)
        _close(tf.divergence(v).values, jf.divergence(jv).values)
    assert float(tm.max(abs(tf.divergence(tf.StaggeredGrid((1., 2.), tm.extrapolation.PERIODIC, x=8, y=8)).values))) < 1e-6


def test_div_grad_equals_laplace_periodic():
    values, jvalues = _pair(_random((16, 16), 5))
    p = tf.CenteredGrid(values, tm.extrapolation.PERIODIC, x=16, y=16)
    jp = jf.CenteredGrid(jvalues, jm.extrapolation.PERIODIC, x=16, y=16)
    gp = tf.spatial_gradient(p, tm.extrapolation.PERIODIC, at='face')
    jgp = jf.spatial_gradient(jp, jm.extrapolation.PERIODIC, at='face')
    for d in 'xy':
        _close(gp.vector[d].values, jgp.vector[d].values)
    lap = tf.laplace(p)
    _close(lap.values, jf.laplace(jp).values)
    _close(tf.divergence(gp).values, lap.values, atol=1e-4)


def test_gradient_linear_exact():
    x = (np.arange(8) + 0.5)[:, None] * np.ones((1, 8))
    values, jvalues = _pair(3 * x)
    g = tf.CenteredGrid(values, tm.extrapolation.BOUNDARY, x=8, y=8, bounds=Box(x=8, y=8))
    jg = jf.CenteredGrid(jvalues, jm.extrapolation.BOUNDARY, x=8, y=8, bounds=JBox(x=8, y=8))
    grad, jgrad = tf.spatial_gradient(g, at='center'), jf.spatial_gradient(jg, at='center')
    _close(grad.values, jgrad.values)
    inner = grad.values[{'x': slice(1, -1), 'vector': 'x'}]
    assert np.allclose(inner.numpy(('x', 'y')), 3.0, atol=1e-5)
    assert grad.boundary == tm.extrapolation.ZERO


def test_laplace_quadratic():
    x = (np.arange(16) + 0.5)[:, None] * np.ones((1, 4))
    values, jvalues = _pair(x ** 2)
    g = tf.CenteredGrid(values, tm.extrapolation.BOUNDARY, x=16, y=4, bounds=Box(x=16, y=4))
    jg = jf.CenteredGrid(jvalues, jm.extrapolation.BOUNDARY, x=16, y=4, bounds=JBox(x=16, y=4))
    lap = tf.laplace(g)
    _close(lap.values, jf.laplace(jg).values)
    assert np.allclose(lap.values[{'x': slice(2, -2)}].numpy(('x', 'y')), 2.0, atol=1e-4)


def test_field_arithmetic():
    a, b = tf.CenteredGrid(1., 0., x=4, y=4), tf.CenteredGrid(2., 0., x=4, y=4)
    c = a + b * 2
    assert float(c.values.x[0].y[0]) == 5.0 and c.boundary == tm.extrapolation.ConstantExtrapolation(0.)
    v = tf.StaggeredGrid(1., tm.extrapolation.ZERO, x=4, y=4) * 3
    assert float(v.vector['x'].values.x[0].y[0]) == 3.0
    jv = jf.StaggeredGrid(1., jm.extrapolation.ZERO, x=4, y=4) * 3
    assert v.shape.names == jv.shape.names and v.shape.sizes == jv.shape.sizes


def test_vector_slicing_staggered():
    v = tf.StaggeredGrid((1., 2.), tm.extrapolation.PERIODIC, x=8, y=8)
    vx = v.vector['x']
    assert vx.is_centered
    assert float(vx.values.x[0].y[0]) == 1.0
    assert vx.geometry.resolution.get_size('x') == 8


def test_field_math_elementwise():
    """where, clip, maximum, minimum, safe_mul, is_finite, finite_fill, mean
    on Fields, against JAX's on the same values."""
    a = _random((6, 5), 6)
    a[2, 3] = np.nan
    values, jvalues = _pair(a)
    other, jother = _pair(_random((6, 5), 7))
    g, jg = tf.CenteredGrid(values, 0., x=6, y=5), jf.CenteredGrid(jvalues, 0., x=6, y=5)
    h, jh = tf.CenteredGrid(other, 0., x=6, y=5), jf.CenteredGrid(jother, 0., x=6, y=5)
    _close(tf.where(h.values > 0, g, h).values, jf.where(jh.values > 0, jg, jh).values)
    _close(tf.clip(h, -0.5, 0.5).values, jf.clip(jh, -0.5, 0.5).values)
    _close(tf.maximum(g, h).values, jf.maximum(jg, jh).values)
    _close(tf.minimum(h, 0.1).values, jf.minimum(jh, 0.1).values)
    _close(tf.safe_mul(tf.CenteredGrid(0., 0., x=6, y=5), g).values,
           jf.safe_mul(jf.CenteredGrid(0., 0., x=6, y=5), jg).values)
    _close(tf.is_finite(g).values, jf.is_finite(jg).values)
    _close(tf.finite_fill(g).values, jf.finite_fill(jg).values)
    np.testing.assert_allclose(float(tf.mean(h)), float(jf.mean(jh)), rtol=1e-6)


def _grid_pair(arr, ext_name, size):
    """A centred grid on `arr` (x, y) over a box of `size`, in the port and in JAX."""
    values, jvalues = _pair(arr)
    ext, jext = getattr(tm.extrapolation, ext_name), getattr(jm.extrapolation, ext_name)
    res = dict(x=arr.shape[0], y=arr.shape[1])
    return (tf.CenteredGrid(values, ext, bounds=Box(x=size[0], y=size[1]), **res),
            jf.CenteredGrid(jvalues, jext, bounds=JBox(x=size[0], y=size[1]), **res))


@pytest.mark.parametrize('function', ['minimum', 'maximum'])
@pytest.mark.parametrize('field_ext,faces', [('ZERO', 'ZERO'), ('ONE', 'ZERO'), ('BOUNDARY', 'ZERO'),
                                             ('PERIODIC', 'PERIODIC')])
def test_stagger_matches_jax(function, field_ext, faces):
    """`stagger` onto the closed box's interior faces and the periodic box's
    faces, the cells beyond the outer faces from the grid's boundary."""
    g, jg = _grid_pair(_random((8, 6), 8), field_ext, (8., 3.))
    got = tf.stagger(g, getattr(tm, function), getattr(tm.extrapolation, faces))
    ref = jf.stagger(jg, getattr(jm, function), getattr(jm.extrapolation, faces))
    assert got.boundary == getattr(tm.extrapolation, faces)
    for d in 'xy':
        _close(got.vector[d].values, ref.vector[d].values)


@pytest.mark.parametrize('ext', ['ZERO', 'PERIODIC', 'BOUNDARY'])
def test_operators_with_cells_of_different_sizes(ext):
    """`laplace`, the face `spatial_gradient` and `divergence` where dx is 1
    along x and 0.5 along y."""
    g, jg = _grid_pair(_random((8, 6), 9), ext, (8., 3.))
    _close(tf.laplace(g).values, jf.laplace(jg).values)
    faces = 'PERIODIC' if ext == 'PERIODIC' else 'ZERO'
    grad = tf.spatial_gradient(g, getattr(tm.extrapolation, faces), at='face')
    jgrad = jf.spatial_gradient(jg, getattr(jm.extrapolation, faces), at='face')
    for d in 'xy':
        _close(grad.vector[d].values, jgrad.vector[d].values)
    _close(tf.divergence(grad).values, jf.divergence(jgrad).values)


def test_laplace_over_some_axes():
    g, jg = _grid_pair(_random((8, 6), 10), 'BOUNDARY', (8., 3.))
    for axes in (['y'], ['x'], ['y', 'x']):
        _close(tf.laplace(g, axes=axes).values, jf.laplace(jg, axes=axes).values)


def test_staggered_operators_refuse_what_the_array_layer_lacks():
    """Dims subsets and mirror boundaries, which the array layer now has,
    equal JAX's; a staggered grid whose walls carry no constant normal
    velocity still raises instead of computing something else."""
    g, jg = _grid_pair(_random((8, 6), 11), 'BOUNDARY', (8., 6.))
    grad = tf.spatial_gradient(g, tm.extrapolation.ZERO, at='face', dims=['x'])
    jgrad = jf.spatial_gradient(jg, jm.extrapolation.ZERO, at='face', dims=['x'])
    assert grad.values.shape.get_labels('~vector') == ('x',)
    _close(grad.values[{'~vector': 'x'}], jgrad.values[{'~vector': 'x'}])
    st = tf.stagger(g, tm.minimum, tm.extrapolation.ZERO, dims=['y'])
    jst = jf.stagger(jg, jm.minimum, jm.extrapolation.ZERO, dims=['y'])
    _close(st.values[{'~vector': 'y'}], jst.values[{'~vector': 'y'}])
    with pytest.raises(NotImplementedError, match='scalar constant'):
        tf.divergence(tf.StaggeredGrid(0., tm.extrapolation.ANTISYMMETRIC, x=8, y=6))
    mixed = g.with_boundary(tm.extrapolation.combine_sides(x=tm.extrapolation.SYMMETRIC, y=tm.extrapolation.BOUNDARY))
    jmixed = jg.with_boundary(jm.extrapolation.combine_sides(x=jm.extrapolation.SYMMETRIC,
                                                             y=jm.extrapolation.BOUNDARY))
    _close(tf.laplace(mixed).values, jf.laplace(jmixed).values)

"""The port's higher-order finite-difference engine against the JAX
package's, on the CPU: the operator matrices of `_stencil1d`
(`derivative_matrix`, `interp_matrix`) to 1e-12 for orders 2/4/6,
derivatives 1 and 2, periodic, Dirichlet and zero-gradient sides, centre and
face outputs; `apply_axis_matrix` in float64; the Field functions
`laplace`, `spatial_gradient` (centres and faces) and the centred
`divergence` at orders 4 and 6 within 1e-5 (float32, scaled by the field);
`fourier_laplace`, `fourier_poisson` and `diffuse.fourier` within 1e-5; the
random draws of `math.seed`. Inputs are numpy arrays from a seed."""
import numpy as np
import pytest
import torch

import phiflow_tpu.field as jf
import phiflow_tpu.math as jm
from phiflow_tpu.field import _stencil1d as jst
from phiflow_tpu.geom import Box as JBox
from phiflow_tpu.physics import diffuse as jdiffuse

import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.field import _stencil1d as st
from phiflow_tpu_torch.geom import Box
from phiflow_tpu_torch.physics import diffuse

BCS = {'periodic': ('periodic', 'periodic'), 'dirichlet': (('dirichlet', 0.5), ('dirichlet', -1.0)),
       'zero-gradient': ('zero-gradient', 'zero-gradient'), 'mixed': (('dirichlet', 0.0), 'zero-gradient')}
BOUNDARIES = {'periodic': 'PERIODIC', 'zero': 'ZERO', 'zero-gradient': 'BOUNDARY'}


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _random(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _grids(arr, boundary, size=(2 * np.pi, 2 * np.pi), vector=False):
    """The same values as a port and a JAX CenteredGrid on (x, y[, vector])."""
    names = 'x,y,vector' if vector else 'x,y'
    t = tm.wrap(torch.from_numpy(arr.copy()), tm.spatial('x,y') & tm.channel(vector='x,y') if vector
                else tm.spatial(names))
    j = jm.wrap(arr, jm.spatial('x,y') & jm.channel(vector='x,y') if vector else jm.spatial(names))
    nx, ny = arr.shape[:2]
    g = tf.CenteredGrid(t, getattr(tm.extrapolation, boundary), x=nx, y=ny, bounds=Box(x=size[0], y=size[1]))
    jg = jf.CenteredGrid(j, getattr(jm.extrapolation, boundary), x=nx, y=ny, bounds=JBox(x=size[0], y=size[1]))
    return g, jg


def _assert_scaled(port, ref, tol, order=None):
    order = order or ref.shape.names
    got = port.numpy(order)
    want = np.asarray(ref.native(order))
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, float(np.abs(got - want).max()) / scale


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('order', [2, 4, 6])
@pytest.mark.parametrize('bc', list(BCS))
def test_derivative_matrices_match_jax(order, bc):
    """Derivatives 1 and 2, explicit and compact, centre and face outputs
    (with and without the outer faces), to 1e-12."""
    lo, hi = BCS[bc]
    n = 24
    for deriv in (1, 2):
        for implicit_order in ((0, 2) if order >= 4 else (0,)):
            for staggered, lo_v, hi_v in ((False, True, True), (True, True, True), (True, False, False),
                                          (True, True, False)):
                if bc == 'periodic' and staggered and (lo_v, hi_v) != (True, True):
                    continue
                args = (n, deriv, order, 0.37, lo, hi, staggered, lo_v, hi_v, implicit_order)
                M, aff = st.derivative_matrix(*args)
                jM, jaff = jst.derivative_matrix(*args)
                assert M.shape == jM.shape
                np.testing.assert_allclose(M, jM, rtol=0, atol=1e-12 * max(1.0, np.abs(jM).max()))
                np.testing.assert_allclose(aff, jaff, rtol=0, atol=1e-12 * max(1.0, np.abs(jaff).max()))


@pytest.mark.parametrize('order', [2, 4, 6])
@pytest.mark.parametrize('bc', list(BCS))
def test_interp_matrices_match_jax(order, bc):
    """Centre → face (n ± 1 outputs) and face → centre, explicit and compact, to 1e-12."""
    lo, hi = BCS[bc]
    n = 20
    cases = [(-0.5, n), (0.5, n)] if bc == 'periodic' else [(-0.5, n + 1), (0.5, n - 1), (0.5, n)]
    for start, n_out in cases:
        if bc != 'periodic' and n_out == n and start == 0.5:
            n_out = n - 1
        for implicit_order in ((0, 2) if order >= 4 else (0,)):
            M, aff = st.interp_matrix(n, order, start, n_out, lo, hi, implicit_order)
            jM, jaff = jst.interp_matrix(n, order, start, n_out, lo, hi, implicit_order)
            np.testing.assert_allclose(M, jM, rtol=0, atol=1e-12)
            np.testing.assert_allclose(aff, jaff, rtol=0, atol=1e-12)


def test_fd_coefficients_and_classify_side_match_jax():
    for offsets, deriv, lhs, bc in (([-1., 0., 1.], 1, (), None), ([-1.5, -0.5, 0.5, 1.5], 1, (-1., 1.), None),
                                    ([0., 1., 2., 3.], 2, (), (-0.5, 0, 2.0)), ([0., 1., 2.], 1, (), (-0.5, 1, 0.))):
        for a, b in zip(st.fd_coefficients(offsets, deriv, lhs, bc), jst.fd_coefficients(offsets, deriv, lhs, bc)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    ext = tm.extrapolation.combine_sides(x=tm.extrapolation.PERIODIC, y=(0.5, tm.extrapolation.BOUNDARY))
    jext = jm.extrapolation.combine_sides(x=jm.extrapolation.PERIODIC, y=(0.5, jm.extrapolation.BOUNDARY))
    for dim in 'xy':
        for upper in (False, True):
            assert st.classify_side(ext, dim, upper) == jst.classify_side(jext, dim, upper)
    assert st.classify_side(tm.extrapolation.SYMMETRIC, 'x', False) is None


def test_apply_axis_matrix_float64_and_float32():
    """One contraction along any axis of a 3-axis array, the affine vector
    added; float64 in float64, float32 in float32."""
    M, aff = st.derivative_matrix(12, 1, 6, 0.5, ('dirichlet', 1.0), 'zero-gradient', implicit_order=2)
    arr = np.random.default_rng(3).standard_normal((12, 5, 12))
    for axis in (0, 2):
        ref = np.moveaxis(np.tensordot(arr, M, axes=((axis,), (1,))), -1, axis)
        ref = ref + aff.reshape((-1,) + (1,) * (2 - axis))
        got = st.apply_axis_matrix(torch.from_numpy(arr), axis, M, aff)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
        got32 = st.apply_axis_matrix(torch.from_numpy(arr.astype(np.float32)), axis, M, aff)
        assert got32.dtype == torch.float32
        np.testing.assert_allclose(got32.numpy(), ref, rtol=0, atol=2e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the Field functions of orders 4 and 6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('order', [4, 6])
@pytest.mark.parametrize('boundary', list(BOUNDARIES))
def test_laplace_and_gradients_match_jax(order, boundary):
    """`laplace`, `spatial_gradient` at the centres (of a scalar and of a
    vector grid, stacked along `_gradient`) and at the faces: within 1e-5
    of the result's scale. The periodic box takes the ghost-cell stencil at
    order 4, every other case the operator matrices."""
    name = BOUNDARIES[boundary]
    g, jg = _grids(_random((24, 20), 1), name, size=(3.0, 2.5))
    _assert_scaled(tf.laplace(g, order=order).values, jf.laplace(jg, order=order).values, 1e-5)
    grad, jgrad = tf.spatial_gradient(g, order=order), jf.spatial_gradient(jg, order=order)
    assert grad.boundary == tf.spatial_gradient(g).boundary
    _assert_scaled(grad.values, jgrad.values, 1e-5)
    face, jface = tf.spatial_gradient(g, at='face', order=order), jf.spatial_gradient(jg, at='face', order=order)
    for d in 'xy':
        _assert_scaled(face.vector[d].values, jface.vector[d].values, 1e-5)
    gv, jgv = _grids(_random((24, 20, 2), 2), name, size=(3.0, 2.5), vector=True)
    stack_dim = tm.channel('_gradient')
    _assert_scaled(tf.spatial_gradient(gv, order=order, stack_dim=stack_dim).values,
                   jf.spatial_gradient(jgv, order=order, stack_dim=jm.channel('_gradient')).values, 1e-5)
    _assert_scaled(tf.divergence(gv, order=order).values, jf.divergence(jgv, order=order).values, 1e-5)
    _assert_scaled(g.gradient(order=order).values, jg.gradient(order=order).values, 1e-5)
    _assert_scaled(gv.laplace(order=order).values, jgv.laplace(order=order).values, 1e-5)


@pytest.mark.parametrize('order', [2, 4, 6])
def test_centred_divergence_matches_jax(order):
    g, jg = _grids(_random((16, 32, 2), 4), 'PERIODIC', vector=True)
    _assert_scaled(g.divergence(order=order).values, jg.divergence(order=order).values, 1e-5)


def test_order4_laplace_over_some_axes_and_weights():
    g, jg = _grids(_random((16, 12), 5), 'PERIODIC')
    w = _random((16, 12), 6)
    weights, jweights = _grids(w, 'PERIODIC')
    for axes in (['x'], ['y']):
        _assert_scaled(tf.laplace(g, axes=axes, order=4).values, jf.laplace(jg, axes=axes, order=4).values, 1e-5)
    _assert_scaled(tf.laplace(g, order=4, weights=weights).values, jf.laplace(jg, order=4, weights=jweights).values,
                   1e-5)


# ---------------------------------------------------------------------------
# the spectral functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('times', [1, 2])
def test_fourier_laplace_and_poisson_match_jax(times):
    g, jg = _grids(_random((16, 24), 7), 'PERIODIC', size=(2.0, 3.0))
    _assert_scaled(tf.fourier_laplace(g, times=times).values, jf.fourier_laplace(jg, times=times).values, 1e-5)
    _assert_scaled(tf.fourier_poisson(g, times=times).values, jf.fourier_poisson(jg, times=times).values, 1e-5)
    _assert_scaled(tm.fourier_laplace(g.values, g.dx, times), jm.fourier_laplace(jg.values, jg.dx, times), 1e-5)


def test_fourier_diffusion_matches_jax():
    g, jg = _grids(_random((16, 24, 2), 8), 'PERIODIC', size=(2.0, 3.0), vector=True)
    _assert_scaled(diffuse.fourier(g, 0.1, 0.05).values, jdiffuse.fourier(jg, 0.1, 0.05).values, 1e-5)


def test_fourier_poisson_inverts_fourier_laplace():
    """The zero-mean part comes back (float32, 1e-4 of its scale)."""
    g, _ = _grids(_random((16, 16), 9), 'PERIODIC')
    zero_mean = g.values - tm.mean(g.values)
    back = tf.fourier_poisson(tf.fourier_laplace(g))
    assert float(tm.max(abs(back.values - zero_mean))) <= 1e-4 * float(tm.max(abs(zero_mean)))


# ---------------------------------------------------------------------------
# the random draws
# ---------------------------------------------------------------------------

def test_seed_restarts_the_draws_and_generators_are_separate():
    tm.seed(5)
    a = tm.random_normal(tm.spatial(x=64)).numpy()
    b = tm.random_uniform(tm.spatial(x=8), low=-1., high=2.).numpy()
    tm.seed(5)
    assert np.array_equal(tm.random_normal(tm.spatial(x=64)).numpy(), a)
    assert a.dtype == np.float32 and abs(float(a.mean())) < 0.5
    c = tm.random_uniform(tm.spatial(x=8), low=-1., high=2.).numpy()
    assert np.array_equal(b, c) and b.min() >= -1 and b.max() < 2
    ints = tm.random_uniform(tm.spatial(x=100), low=0, high=3, dtype=np.int32).numpy()
    assert set(np.unique(ints)) <= {0, 1, 2}
    from phiflow_tpu_torch.math._ops import using_generator
    with using_generator(torch.Generator().manual_seed(1)):
        d = tm.random_normal(tm.spatial(x=4)).numpy()
    with using_generator(torch.Generator().manual_seed(1)):
        assert np.array_equal(tm.random_normal(tm.spatial(x=4)).numpy(), d)
    with tm.precision(64):
        assert tm.random_normal(tm.spatial(x=4)).numpy().dtype == np.float64

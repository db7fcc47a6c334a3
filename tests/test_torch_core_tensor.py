"""`phiflow_tpu_torch.math`'s Tensor and operations against `phiflow_tpu.math`'s:
the cases of `tests/math/test_tensor.py` that this package has, and the
operations the Field layer uses, on the same numpy inputs from a seed. Shapes
exactly, float32 values exactly — except sums and means, whose order of
addition is each library's own (XLA's, numpy's, torch's): those within one
float32 rounding per addend (rtol 1e-6). Each case runs on a host (numpy)
native and on a torch native."""
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
import phiflow_tpu_torch.math as tm

NATIVE = ['host', 'torch']


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _rng(seed=0):
    return np.random.default_rng(seed)


def _pair(arr, kind, *dims):
    """The same array as a port Tensor (numpy or torch native) and a JAX Tensor."""
    arr = np.asarray(arr)
    port = tm.wrap(arr if kind == 'host' else torch.from_numpy(arr.copy()), *[d(tm) for d in dims])
    return port, jm.wrap(arr, *[d(jm) for d in dims])


def _check(port, ref, summed=False):
    assert port.shape.names == ref.shape.names and port.shape.sizes == ref.shape.sizes
    assert port.shape.labels == ref.shape.labels
    got, want = np.asarray(port.numpy()), np.asarray(ref.numpy())
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if summed:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _yx(m):
    return m.spatial('y,x')


@pytest.mark.parametrize('kind', NATIVE)
def test_wrap_and_native(kind):
    t, j = _pair(np.arange(12, dtype=np.float32).reshape(3, 4), kind, _yx)
    assert t.shape.names == ('y', 'x')
    assert tuple(t.native(('x', 'y')).shape) == (4, 3)
    np.testing.assert_array_equal(t.numpy(('x', 'y')), np.asarray(j.numpy(('x', 'y'))))
    assert t.native(('y', 'x')) is t.native()


@pytest.mark.parametrize('kind', NATIVE)
def test_broadcast_by_name(kind):
    a = tm.ones(tm.spatial(x=4)) if kind == 'host' else tm.wrap(torch.ones(4), tm.spatial('x'))
    c = a + tm.ones(tm.spatial(y=3)) * 2
    ref = jm.ones(jm.spatial(x=4)) + jm.ones(jm.spatial(y=3)) * 2
    _check(c, ref)
    assert float(c.x[0].y[0]) == 3.0


def test_labels_getitem():
    v, j = tm.vec(x=1.0, y=2.0), jm.vec(x=1.0, y=2.0)
    _check(v, j)
    assert float(v.vector['y']) == 2.0 and float(v[{'vector': 'x'}]) == 1.0


@pytest.mark.parametrize('kind', NATIVE)
def test_slicing(kind):
    t, j = _pair(np.arange(12, dtype=np.float32).reshape(3, 4), kind, _yx)
    _check(t.y[0], j.y[0])
    _check(t[{'y': slice(1, 3)}], j[{'y': slice(1, 3)}])
    _check(t[{'x': [3, 1]}], j[{'x': [3, 1]}])
    assert float(t[{'y': 1, 'x': 2}]) == 6.0


@pytest.mark.parametrize('kind', NATIVE)
def test_non_uniform_stack(kind):
    a, ja = _pair(np.ones((3, 4), np.float32), kind, lambda m: m.spatial('x,y'))
    b, jb = _pair(np.ones((4, 3), np.float32), kind, lambda m: m.spatial('x,y'))
    st, jst = tm.stack([a, b], tm.dual(vector='x,y')), jm.stack([ja, jb], jm.dual(vector='x,y'))
    assert isinstance(st, tm.TensorStack)
    assert st.components[0] is a and st.components[1] is b  # the components, not copies
    _check(st[{'~vector': 'x'}], jst[{'~vector': 'x'}])
    _check((st * 2)[{'~vector': 'y'}], (jst * 2)[{'~vector': 'y'}])
    assert st.shape.names == jst.shape.names


@pytest.mark.parametrize('kind', NATIVE)
def test_reductions(kind):
    t, j = _pair(_rng(1).standard_normal((2, 3)).astype(np.float32), kind, _yx)
    for fn in ('sum', 'max', 'min', 'mean'):
        _check(getattr(tm, fn)(t), getattr(jm, fn)(j), summed=fn in ('sum', 'mean'))
        _check(getattr(tm, fn)(t, 'x'), getattr(jm, fn)(j, 'x'), summed=fn in ('sum', 'mean'))
    _check(tm.finite_mean(t), jm.finite_mean(j), summed=True)


@pytest.mark.parametrize('kind', NATIVE)
def test_pack_unpack(kind):
    t, j = _pair(_rng(2).standard_normal((4, 3)).astype(np.float32), kind, lambda m: m.spatial('x,y'))
    p, jp = tm.pack_dims(t, 'x,y', tm.instance('points')), jm.pack_dims(j, 'x,y', jm.instance('points'))
    _check(p, jp)
    _check(tm.unpack_dim(p, 'points', tm.spatial(x=4, y=3)), jm.unpack_dim(jp, 'points', jm.spatial(x=4, y=3)))


@pytest.mark.parametrize('kind', NATIVE)
def test_elementwise(kind):
    a = _rng(3).standard_normal((5, 4)).astype(np.float32)
    a[1, 2] = np.nan
    a[3, 0] = np.inf
    b = _rng(4).standard_normal((5, 4)).astype(np.float32)
    t, j = _pair(a, kind, _yx)
    u, k = _pair(b, kind, _yx)
    _check(tm.maximum(t, u), jm.maximum(j, k))
    _check(tm.minimum(t, 0.5), jm.minimum(j, 0.5))
    _check(tm.clip(u, -0.5, 0.25), jm.clip(k, -0.5, 0.25))
    _check(tm.where(u > 0, t, u), jm.where(k > 0, j, k))
    _check(tm.is_finite(t), jm.is_finite(j))
    _check(tm.nan_to_0(t), jm.nan_to_0(j))
    _check(tm.safe_div(u, tm.where(u > 0, u, 0.)), jm.safe_div(k, jm.where(k > 0, k, 0.)))
    _check(tm.abs(u) ** 0.5, jm.abs(k) ** 0.5)
    _check(tm.sqrt(tm.abs(u)) - u * 3 / 7 + 1, jm.sqrt(jm.abs(k)) - k * 3 / 7 + 1)
    _check(tm.finite_sum(t, 'x'), jm.finite_sum(j, 'x'), summed=True)
    _check(tm.finite_max(t), jm.finite_max(j))
    _check(tm.finite_min(t, 'y'), jm.finite_min(j, 'y'))
    _check(tm.to_float(u > 0), jm.to_float(k > 0))


@pytest.mark.parametrize('kind', NATIVE)
def test_vectors_and_dot(kind):
    a = _rng(5).standard_normal((6, 2)).astype(np.float32)
    t, j = _pair(a, kind, lambda m: m.instance('points'), lambda m: m.channel(vector='x,y'))
    _check(tm.vec_squared(t), jm.vec_squared(j), summed=True)
    _check(tm.vec_length(t, eps=1e-6), jm.vec_length(j, eps=1e-6), summed=True)
    m = _rng(6).standard_normal((2, 3)).astype(np.float32)
    mt, mj = _pair(m, kind, lambda m_: m_.channel(vector='x,y'), lambda m_: m_.channel('out'))
    got, ref = tm.dot(t, 'vector', mt, 'vector'), jm.dot(j, 'vector', mj, 'vector')
    assert got.shape.names == ref.shape.names
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.numpy()), rtol=1e-6)


@pytest.mark.parametrize('kind', NATIVE)
def test_shape_operations(kind):
    a, ja = _pair(_rng(7).standard_normal((3, 4)).astype(np.float32), kind, lambda m: m.spatial('x,y'))
    b, jb = _pair(_rng(8).standard_normal((2, 4)).astype(np.float32), kind, lambda m: m.spatial('x,y'))
    _check(tm.concat([a, b], 'x'), jm.concat([ja, jb], 'x'))
    _check(tm.expand(a, tm.batch(b=2)), jm.expand(ja, jm.batch(b=2)))
    _check(tm.rename_dims(a, 'x', 'u'), jm.rename_dims(ja, 'x', 'u'))
    _check(tm.transpose(a, 'y,x'), jm.transpose(ja, 'y,x'))
    for st, jst in zip(tm.unstack(a, 'x'), jm.unstack(ja, 'x')):
        _check(st, jst)
    lo, up = tm.shift(a, (-1, 1), 'x', tm.extrapolation.ZERO, stack_dim=None)
    jlo, jup = jm.shift(ja, (-1, 1), 'x', jm.extrapolation.ZERO, stack_dim=None)
    _check(lo, jlo)
    _check(up, jup)


def test_close_equal_and_precision():
    a = _rng(9).standard_normal(5).astype(np.float32)
    t = tm.wrap(torch.from_numpy(a), tm.spatial('x'))
    assert tm.close(t, t + 1e-7, rel_tolerance=1e-5, abs_tolerance=1e-6) and not tm.equal(t, t + 1.)
    assert tm.close(t, t, rel_tolerance=0, abs_tolerance=0) == jm.close(jm.wrap(a, jm.spatial('x')), jm.wrap(a, jm.spatial('x')))
    tm.assert_close(t, tm.wrap(a, tm.spatial('x')), abs_tolerance=0)
    with tm.precision(64), jm.precision(64):
        _check(tm.wrap(0.1) * 3, jm.wrap(0.1) * 3)
        assert tm.wrap(0.1).dtype == np.float64
    assert tm.wrap(0.1).dtype == np.float32 and tm.tensor(np.float64(2.5)).dtype == np.float32


def test_host_constants_meet_torch_tensors():
    """A host constant takes the device of the torch tensor it meets; host
    arithmetic stays numpy (as the JAX package keeps it on the host)."""
    t = tm.wrap(torch.arange(4.), tm.spatial('x'))
    c = tm.wrap([1., 2.], tm.channel(vector='a,b'))
    r = t * c
    assert isinstance(r.native(), torch.Tensor) and r.shape.names == ('x', 'vector')
    assert isinstance((c * 2).native(), np.ndarray)
    assert isinstance(tm.Tensor(np.zeros(3, np.float32), tm.spatial(x=3)).torch(), torch.Tensor)


def test_default_device():
    assert tm.get_default_device().type == 'cpu'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            tm.set_default_device(None)


@pytest.mark.parametrize('kind', NATIVE)
def test_sign_of_nan_is_nan(kind):
    """Fault 3.2: `math.sign` keeps NaN, as `jnp.sign` does."""
    t, j = _pair(np.asarray([np.nan, -2., 0., 3.], np.float32), kind, lambda m: m.spatial('x'))
    got, want = tm.sign(t), jm.sign(j)
    assert got.numpy().dtype == np.asarray(want.numpy()).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))  # NaN where NaN


@pytest.mark.parametrize('kind', NATIVE)
def test_integer_and_boolean_sum_prod_keep_jax_dtypes(kind):
    """Fault 3.3: integer and boolean sums and products are int32, as in JAX."""
    t, j = _pair(_rng(7).uniform(-3, 3, (3, 4)).astype(np.float32), kind, _yx)
    _check(tm.sum(tm.to_int32(t)), jm.sum(jm.to_int32(j)))
    _check(tm.prod(tm.to_int32(t), 'x'), jm.prod(jm.to_int32(j), 'x'))
    _check(tm.sum(t > 0), jm.sum(j > 0))
    _check(tm.sum(t > 0, 'y'), jm.sum(j > 0, 'y'))


@pytest.mark.parametrize('kind', NATIVE)
def test_mean_of_integers_and_booleans(kind):
    """Fault 3.4: the mean of an int or bool Tensor is float32, as in JAX."""
    t, j = _pair(_rng(8).uniform(-3, 3, (3, 4)).astype(np.float32), kind, _yx)
    _check(tm.mean(tm.to_int32(t)), jm.mean(jm.to_int32(j)), summed=True)
    _check(tm.mean(t > 0), jm.mean(j > 0), summed=True)
    _check(tm.mean(t > 0, 'x'), jm.mean(j > 0, 'x'), summed=True)


@pytest.mark.parametrize('kind', NATIVE)
def test_losses_of_a_staggered_stack(kind):
    """`math.l2_loss` / `l1_loss` of a non-uniform TensorStack (a staggered
    grid's values) sum over the components, as in JAX (they raised TypeError:
    the builtin `sum` was shadowed by `math.sum`)."""
    a, ja = _pair(_rng(9).standard_normal((3, 4)).astype(np.float32), kind, lambda m: m.spatial('x,y'))
    b, jb = _pair(_rng(10).standard_normal((4, 3)).astype(np.float32), kind, lambda m: m.spatial('x,y'))
    st, jst = tm.stack([a, b], tm.dual(vector='x,y')), jm.stack([ja, jb], jm.dual(vector='x,y'))
    _check(tm.l2_loss(st), jm.l2_loss(jst), summed=True)
    _check(tm.l1_loss(st), jm.l1_loss(jst), summed=True)

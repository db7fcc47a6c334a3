"""Sparse tensors and layouts of the port against the JAX package's, on the
CPU: every case of `tests/math/test_sparse.py` — COO creation, densifying,
the product with a dense Tensor, format round trips through 'coo', 'csr',
'csc' and 'compact', operations with a number, `matrix_from_function` of an
affine periodic stencil (its exact 3 × 8 entries) — each held to JAX's
result on the same numpy input (exact, or within 1e-6 where float32 sums
differ in order), and `Layout` / `layout` on nested Python trees."""
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.math._shape import Dim as JDim, Shape as JShape

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.math._shape import Dim, Shape


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _coo(m):
    idx = m.wrap(np.array([[0, 1], [1, 0], [2, 2]], np.int32), m.instance(entries=3),
                 m.channel(sparse_idx=['rows', '~rows']))
    vals = m.wrap(np.array([2., 3., 4.], np.float32), m.instance(entries=3))
    return m.sparse_tensor(idx, vals, m.instance(rows=3) & m.dual(rows=3))


def test_create_and_densify():
    m, jmat = _coo(tm), _coo(jm)
    assert tm.is_sparse(m)
    np.testing.assert_array_equal(tm.dense(m).numpy(('rows', '~rows')),
                                  np.asarray(jm.dense(jmat).numpy(('rows', '~rows'))))


def test_matmul():
    v = np.array([1., 10., 100.], np.float32)
    out = _coo(tm) @ tm.wrap(v, tm.instance(rows=3))
    ref = _coo(jm) @ jm.wrap(v, jm.instance(rows=3))
    np.testing.assert_array_equal(out.numpy('rows'), [20., 3., 400.])
    np.testing.assert_array_equal(out.numpy('rows'), np.asarray(ref.numpy('rows')))


def test_roundtrip_format():
    d = tm.dense(_coo(tm))
    s = tm.to_format(d, 'coo')
    assert tm.is_sparse(s)
    np.testing.assert_array_equal(tm.dense(s).numpy(('rows', '~rows')), d.numpy(('rows', '~rows')))
    assert tm.stored_values(s).shape.get_size('entries') == 3
    assert 'index' in tm.stored_indices(s).shape
    js = jm.to_format(jm.dense(_coo(jm)), 'coo')
    np.testing.assert_array_equal(tm.stored_indices(s).numpy(('entries', 'index')),
                                  np.asarray(jm.stored_indices(js).numpy(('entries', 'index'))))
    np.testing.assert_array_equal(tm.stored_values(s).numpy('entries'), np.asarray(jm.stored_values(js).numpy('entries')))


def test_scalar_ops():
    m = _coo(tm)
    np.testing.assert_array_equal(tm.dense(m * 2).numpy(('rows', '~rows')), 2 * tm.dense(m).numpy(('rows', '~rows')))
    assert tm.is_sparse(m * 2)


def test_matrix_from_function():
    """An affine periodic stencil: 3 entries a row (exact coefficients, no rounding nonzeros), the bias, and
    matrix @ v + bias == f(v)."""
    def f(m):
        def fn(x):
            lo, up = m.shift(x, (-1, 1), dims='x', padding=m.extrapolation.PERIODIC)
            return lo[{'shift': 0}] + up[{'shift': 0}] - 2 * x + 1.0
        return fn

    matrix, bias = tm.matrix_from_function(f(tm), tm.wrap(np.zeros(8, np.float32), tm.spatial(x=8)))
    jmatrix, jbias = jm.matrix_from_function(f(jm), jm.wrap(np.zeros(8, np.float32), jm.spatial(x=8)))
    assert tm.is_sparse(matrix) and matrix.entries == 3 * 8 == jmatrix.entries
    np.testing.assert_array_equal(bias.numpy('x'), 1.0)
    np.testing.assert_array_equal(tm.dense(matrix).numpy(('x', '~x')), np.asarray(jm.dense(jmatrix).numpy(('x', '~x'))))
    v = np.random.default_rng(0).standard_normal(8).astype(np.float32)
    out = matrix @ tm.wrap(v, tm.spatial(x=8)) + bias
    np.testing.assert_allclose(out.numpy('x'), f(tm)(tm.wrap(v, tm.spatial(x=8))).numpy('x'), atol=1e-5)


def _random_matrix(n=7, m=5, seed=0):
    rng = np.random.default_rng(seed)
    arr = rng.standard_normal((n, m)).astype(np.float32)
    arr[rng.uniform(size=(n, m)) < 0.6] = 0.0
    shape = Shape((Dim('rows', n, 'instance', None), Dim('~cols', m, 'dual', None)))
    jshape = JShape((JDim('rows', n, 'instance', None), JDim('~cols', m, 'dual', None)))
    return arr, tm.Tensor(torch.from_numpy(arr), shape), jm.Tensor(arr, jshape)


@pytest.mark.parametrize('fmt', ['csr', 'csc', 'compact'])
def test_format_roundtrip_and_matmul(fmt):
    arr, t, jt = _random_matrix()
    sp, jsp = tm.to_format(t, fmt), jm.to_format(jt, fmt)
    np.testing.assert_array_equal(tm.dense(sp).numpy(('rows', '~cols')), arr)
    assert sp.entries == jsp.entries if fmt != 'compact' else sp.capacity == jsp.capacity
    x = np.arange(arr.shape[1], dtype=np.float32) + 1
    out = sp @ tm.Tensor(torch.from_numpy(x), Shape((Dim('cols', arr.shape[1], 'instance', None),)))
    ref = jsp @ jm.Tensor(x, JShape((JDim('cols', arr.shape[1], 'instance', None),)))
    np.testing.assert_allclose(out.numpy(), arr @ x, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.native()), rtol=1e-6)


def test_format_scalar_ops():
    arr, t, _ = _random_matrix()
    sp = tm.to_format(t, 'csr')
    np.testing.assert_allclose(tm.dense(sp * 2.0).numpy(('rows', '~cols')), arr * 2, rtol=1e-6)


def test_layout():
    """`layout` of a nested dict and list: one batch dim a level, dict keys as labels; indexing and unstacking,
    as JAX's."""
    tree = {'a': [1, 2, 3], 'b': [4, 5, 6]}
    lay, jlay = tm.layout(tree), jm.layout(tree)
    assert lay.shape.names == jlay.shape.names and lay.shape.sizes == jlay.shape.sizes
    assert lay.shape.get_labels('layout0') == ('a', 'b')
    assert lay['b'][{'layout1': 2}] == jlay['b'][{'layout1': 2}] == 6
    assert [x.native for x in lay.unstack()] == [[1, 2, 3], [4, 5, 6]]
    given = tm.layout([[1, 2], [3, 4]], tm.channel('outer'), tm.spatial('inner'))
    assert given.shape.names == ('outer', 'inner') and given[1][{'inner': 0}] == 3
    assert isinstance(lay, tm.Layout)

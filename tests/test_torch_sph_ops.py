"""The particle ops of the port's named-dim core — `gather`, `scatter`,
`boolean_mask`, `nonzero`, `quantile`, `median`, `pairwise_differences`
(dense and cell list) and `find_closest` — against the JAX package's on the
same numpy inputs, on the CPU, with torch natives and with host (numpy)
natives. Integer results exactly; float results within 1e-6 (gathers and
scatters of float32 values: exact), quantiles within 1e-5 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm

import phiflow_tpu_torch.math as tm


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _both(arr, *dims, host=False):
    """The numpy array as a JAX Tensor and as a port Tensor (a torch native, or numpy with `host`)."""
    names = [(getattr(jm, kind)(**spec), getattr(tm, kind)(**spec)) for kind, spec in dims]
    j = jm.wrap(jnp.asarray(arr), *[a for a, _ in names])
    t = tm.wrap(arr if host else torch.from_numpy(np.ascontiguousarray(arr)), *[b for _, b in names])
    return j, t


def _np(t, order=None):
    return np.asarray(t.native(order) if order else t.native()) if not isinstance(t, tm.Tensor) else t.numpy(order)


def test_gather_scatter_analogue():
    """`tests/math/test_tensor.py::test_gather_scatter` on the port."""
    base = tm.zeros(tm.spatial(x=5))
    idx = tm.wrap(np.array([[1], [3]], np.int32), tm.instance(points=2), tm.channel(vector='x'))
    vals = tm.wrap(torch.tensor([10., 20.]), tm.instance(points=2))
    r = tm.scatter(base, idx, vals, mode='add')
    assert np.allclose(r.numpy('x'), [0, 10, 0, 20, 0])
    g = tm.gather(r, idx)
    assert np.allclose(g.numpy('points'), [10, 20])


@pytest.mark.parametrize('host', [False, True], ids=['torch', 'host'])
def test_gather_labelled_channel_2d(host):
    rng = np.random.default_rng(0)
    grid = rng.standard_normal((6, 5, 3)).astype(np.float32)
    idx = np.stack([rng.integers(0, 6, 7), rng.integers(0, 5, 7)], -1).astype(np.int32)
    jg, tg = _both(grid, ('spatial', dict(x=6, y=5)), ('channel', dict(c=3)), host=host)
    ji, ti = _both(idx, ('instance', dict(points=7)), ('channel', dict(vector='x,y')), host=host)
    ref, got = jm.gather(jg, ji), tm.gather(tg, ti)
    assert got.shape.names == tuple(ref.shape.names)
    np.testing.assert_array_equal(_np(got, ('points', 'c')), np.asarray(ref.native(('points', 'c'))))


@pytest.mark.parametrize('host', [False, True], ids=['torch', 'host'])
def test_gather_dims_form(host):
    """`dims=` with integer indices of a 2D list shape, as SPH's `gather_neighbors` calls it."""
    rng = np.random.default_rng(1)
    values = rng.standard_normal((9, 2)).astype(np.float32)
    idx = rng.integers(0, 9, (9, 4)).astype(np.int32)
    jv, tv = _both(values, ('instance', dict(points=9)), ('channel', dict(vector='x,y')), host=host)
    ji, ti = _both(idx, ('instance', dict(points=9)), ('dual', dict(neighbors=4)), host=host)
    ref, got = jm.gather(jv, ji, dims='points'), tm.gather(tv, ti, dims='points')
    order = ('points', '~neighbors', 'vector')
    np.testing.assert_array_equal(_np(got, order), np.asarray(ref.native(order)))


@pytest.mark.parametrize('mode', ['update', 'add', 'mean', 'max', 'min'])
@pytest.mark.parametrize('outside', ['discard', 'clamp'])
@pytest.mark.parametrize('host', [False, True], ids=['torch', 'host'])
def test_scatter_modes(mode, outside, host):
    """Distinct targets for 'update' (JAX leaves duplicates' order open); a
    repeated target and indices outside the grid for the others."""
    rng = np.random.default_rng(2)
    base = rng.standard_normal((4, 5)).astype(np.float32)
    if mode == 'update':
        idx = np.array([[0, 0], [1, 4], [3, 2], [6, 1], [2, -1]], np.int32)
        if outside == 'clamp':
            idx = np.array([[0, 0], [1, 4], [3, 2], [6, 1], [2, -2]], np.int32)
    else:
        idx = np.array([[0, 0], [1, 4], [1, 4], [6, 1], [2, -1], [3, 3]], np.int32)
    vals = rng.standard_normal((idx.shape[0],)).astype(np.float32)
    jb, tb = _both(base, ('spatial', dict(x=4, y=5)), host=host)
    ji, ti = _both(idx, ('instance', dict(points=idx.shape[0])), ('channel', dict(vector='x,y')), host=host)
    jv, tv = _both(vals, ('instance', dict(points=idx.shape[0])), host=host)
    ref = jm.scatter(jb, ji, jv, mode=mode, outside_handling=outside)
    got = tm.scatter(tb, ti, tv, mode=mode, outside_handling=outside)
    assert got.is_host == host
    np.testing.assert_allclose(_np(got, ('x', 'y')), np.asarray(ref.native(('x', 'y'))), rtol=1e-6, atol=1e-6)


def test_scatter_onto_shape_with_vector_values():
    """A Shape as the base (zeros), vector values kept along their channel dim."""
    idx = np.array([[1], [3], [1]], np.int32)
    vals = np.array([[1., 2.], [3., 4.], [5., 6.]], np.float32)
    ji, ti = _both(idx, ('instance', dict(points=3)), ('channel', dict(vector='x')))
    jv, tv = _both(vals, ('instance', dict(points=3)), ('channel', dict(c='a,b')))
    jbase = jm.zeros(jm.spatial(x=5), jm.channel(c='a,b'))
    tbase = tm.zeros(tm.spatial(x=5), tm.channel(c='a,b'))
    for mode in ('add', 'mean'):
        ref = jm.scatter(jbase, ji, jv, mode=mode)
        got = tm.scatter(tbase, ti, tv, mode=mode)
        np.testing.assert_allclose(got.numpy(('x', 'c')), np.asarray(ref.native(('x', 'c'))), atol=1e-6)
    got = tm.scatter(tm.spatial(x=5), ti, tm.wrap(torch.tensor([1., 2., 3.]), tm.instance(points=3)), mode='add',
                     default=0.5)
    np.testing.assert_allclose(got.numpy('x'), [0.5, 4.5, 0.5, 2.5, 0.5])


@pytest.mark.parametrize('host', [False, True], ids=['torch', 'host'])
def test_boolean_mask_and_nonzero(host):
    rng = np.random.default_rng(3)
    values = rng.standard_normal((7, 3)).astype(np.float32)
    mask = rng.uniform(size=7) > 0.4
    jv, tv = _both(values, ('instance', dict(points=7)), ('channel', dict(vector='x,y,z')), host=host)
    jmask, tmask = _both(mask, ('instance', dict(points=7)), host=host)
    ref, got = jm.boolean_mask(jv, 'points', jmask), tm.boolean_mask(tv, 'points', tmask)
    assert got.shape.get_size('points') == int(mask.sum())
    np.testing.assert_array_equal(_np(got, ('points', 'vector')), np.asarray(ref.native(('points', 'vector'))))
    grid = (rng.uniform(size=(4, 6)) > 0.6).astype(np.float32)
    jg, tg = _both(grid, ('spatial', dict(x=4, y=6)), host=host)
    ref, got = jm.nonzero(jg), tm.nonzero(tg)
    assert got.shape.get_labels('vector') == tuple(ref.shape.get_labels('vector'))
    assert got.dtype in (np.int32, torch.int32)
    np.testing.assert_array_equal(_np(got, ('nonzero', 'vector')), np.asarray(ref.native(('nonzero', 'vector'))))


def test_quantile_median_analogue():
    """`tests/math/test_tensor.py::test_quantile_median` on the port."""
    t = tm.wrap(torch.arange(101, dtype=torch.float32), tm.spatial('x'))
    assert abs(float(tm.median(t).native()) - 50.0) < 1e-5
    q = tm.quantile(t, [0.25, 0.75])
    np.testing.assert_allclose(q.numpy(), [25., 75.], atol=1e-4)


@pytest.mark.parametrize('host', [False, True], ids=['torch', 'host'])
def test_quantile_over_dims(host):
    rng = np.random.default_rng(4)
    data = rng.standard_normal((3, 50)).astype(np.float32)
    jd, td = _both(data, ('batch', dict(b=3)), ('instance', dict(points=50)), host=host)
    for q in (0.9, [0.1, 0.5, 0.9]):
        ref, got = jm.quantile(jd, q, 'points'), tm.quantile(td, q, 'points')
        assert got.shape.names == tuple(ref.shape.names)
        np.testing.assert_allclose(_np(got), np.asarray(ref.native()), rtol=1e-5)
    np.testing.assert_allclose(_np(tm.median(td)), np.asarray(jm.median(jd).native()), rtol=1e-5)


@pytest.mark.parametrize('periodic', [False, True], ids=['closed', 'periodic'])
def test_pairwise_differences_dense(periodic):
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, 1, (30, 2)).astype(np.float32)
    jp, tp = _both(pos, ('instance', dict(points=30)), ('channel', dict(vector='x,y')))
    jd = jm.pairwise_differences(jp, 0.3, domain=(jm.vec(x=0., y=0.), jm.vec(x=1., y=1.)), periodic=periodic)
    td = tm.pairwise_differences(tp, 0.3, domain=(tm.vec(x=0., y=0.), tm.vec(x=1., y=1.)), periodic=periodic)
    order = ('points', '~points', 'vector')
    assert td.shape.names == tuple(jd.shape.names)
    np.testing.assert_allclose(td.numpy(order), np.asarray(jd.native(order)), atol=1e-6, equal_nan=True)
    assert np.isnan(td.numpy(order)).any()


@pytest.mark.parametrize('periodic', [False, True], ids=['closed', 'periodic'])
def test_pairwise_differences_cell_list(periodic):
    """The compact form: '~neighbors' of 3^d · capacity slots, NaN (or `default`) in empty ones."""
    rng = np.random.default_rng(6)
    pos = rng.uniform(0, 1, (400, 2)).astype(np.float32)
    jp, tp = _both(pos, ('instance', dict(points=400)), ('channel', dict(vector='x,y')))
    order = ('points', '~neighbors', 'vector')
    for default in (None, 0.):
        jd = jm.pairwise_differences(jp, 0.1, method='cell-list', domain=([0., 0.], [1., 1.]), periodic=periodic,
                                     default=default)
        td = tm.pairwise_differences(tp, 0.1, method='cell-list', domain=([0., 0.], [1., 1.]), periodic=periodic,
                                     default=default)
        assert td.shape.get_size('~neighbors') == jd.shape.get_size('~neighbors')
        got, ref = td.numpy(order), np.asarray(jd.native(order))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize('queries', [0, 5], ids=['one', 'instance'])
def test_find_closest(queries):
    rng = np.random.default_rng(7)
    vectors = rng.uniform(0, 1, (40, 2)).astype(np.float32)
    jv, tv = _both(vectors, ('instance', dict(points=40)), ('channel', dict(vector='x,y')))
    if queries:
        q = rng.uniform(0, 1, (queries, 2)).astype(np.float32)
        jq, tq = _both(q, ('instance', dict(q=queries)), ('channel', dict(vector='x,y')))
    else:
        q = np.array([0.3, 0.6], np.float32)
        jq, tq = _both(q, ('channel', dict(vector='x,y')))
    ref, got = jm.find_closest(jv, jq), tm.find_closest(tv, tq)
    assert got.shape.names == tuple(ref.shape.names)
    np.testing.assert_array_equal(_np(got), np.asarray(ref.native()))

"""The Field names of `phiflow_tpu_torch.field` (and `geom`'s
`sample_uniform`, `physics.advect.advect`) ported with the optimisation
slice, against `phiflow_tpu`'s on the same numpy inputs from a seed: the
port of `tests/field/test_grids.py::test_curl_2d`, then one parametrised
comparison of the Field operations.

Tolerances: dims, dtypes and shapes exactly; the elementwise functions
within 2e-6 of scale (XLA's and torch's transcendental functions may differ
in the last float32 bit); the rest within 1e-5 of each result's scale
(sums, interpolation and transforms add in each library's own order)."""
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
import phiflow_tpu.field as jf
import phiflow_tpu.geom as jg
import phiflow_tpu_torch.math as tm
import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.geom as tg

@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _rng(seed=0):
    return np.random.default_rng(seed)


def _pair(arr, kind, *dims):
    arr = np.asarray(arr)
    port = tm.wrap(arr if kind == 'host' else torch.from_numpy(arr.copy()), *[d(tm) for d in dims])
    return port, jm.wrap(arr, *[d(jm) for d in dims])


def _np(t, order=None):
    return np.asarray(t.numpy(order) if order is not None else t.numpy())


def _same(port, ref, rtol=0., atol=0., scale=False):
    """Equal dims (names, sizes, labels, types; in any order), dtype and values."""
    assert set(port.shape.names) == set(ref.shape.names), (port.shape, ref.shape)
    for n in ref.shape.names:
        assert port.shape.get_size(n) == ref.shape.get_size(n) and port.shape.get_labels(n) == ref.shape.get_labels(n)
        assert port.shape.get_dim(n).dim_type == ref.shape.get_dim(n).dim_type
    order = ref.shape.names
    got, want = _np(port, order), _np(ref, order)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if scale:
        atol = atol * max(float(np.nanmax(np.abs(want))) if want.size else 0., 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


# ---------------------------------------------------------------------------
# the JAX suite's case
# ---------------------------------------------------------------------------

def test_curl_2d():
    v = tf.CenteredGrid(lambda pos: tm.stack({'x': -pos.vector['y'], 'y': pos.vector['x']}, tm.channel('vector')),
                        tm.extrapolation.BOUNDARY, x=8, y=8, bounds=tg.Box(x=8, y=8))
    inner = tf.curl(v, at='center').values[{'x': slice(1, -1), 'y': slice(1, -1)}]
    assert np.allclose(inner.numpy(('x', 'y')), 2.0, atol=1e-4)


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------

def _boundary(m, boundary):
    """A boundary of the package `m`: a number, or the name of an extrapolation."""
    return getattr(m.extrapolation, boundary) if isinstance(boundary, str) else boundary


def _staggered_pair(n, seed, boundary=0.):
    """A staggered grid of `n`² cells in Box(x=2, y=2) from one seed, in both packages."""
    rng = _rng(seed)
    comps = [rng.standard_normal((n - 1, n)).astype(np.float32), rng.standard_normal((n, n - 1)).astype(np.float32)]
    port = tf.StaggeredGrid(tm.stack([tm.wrap(torch.from_numpy(c), tm.spatial('x,y')) for c in comps],
                                     tm.dual(vector='x,y')), _boundary(tm, boundary), tg.Box(x=2, y=2), x=n, y=n)
    ref = jf.StaggeredGrid(jm.stack([jm.wrap(c, jm.spatial('x,y')) for c in comps], jm.dual(vector='x,y')),
                           _boundary(jm, boundary), jg.Box(x=2, y=2), x=n, y=n)
    return port, ref


def _centred_pair(n, seed, boundary=0., vector=False):
    arr = _rng(seed).standard_normal((n, n, 2) if vector else (n, n)).astype(np.float32)
    dims = (lambda m: m.spatial('x,y') & m.channel(vector='x,y')) if vector else (lambda m: m.spatial('x,y'))
    t, j = _pair(arr, 'torch', dims)
    return (tf.CenteredGrid(t, _boundary(tm, boundary), tg.Box(x=2, y=2), x=n, y=n),
            jf.CenteredGrid(j, _boundary(jm, boundary), jg.Box(x=2, y=2), x=n, y=n))


def _values_close(port, ref, tol=1e-5):
    pv, rv = port.values, ref.values
    if isinstance(rv, jm.TensorStack) or '~vector' in rv.shape:
        for d in ref.resolution.names:
            _values_close_tensor(pv[{'~vector': d}], rv[{'~vector': d}], tol)
    else:
        _values_close_tensor(pv, rv, tol)
    assert port.resolution.sizes == ref.resolution.sizes


def _values_close_tensor(p, r, tol):
    _same(p, r, atol=tol, scale=True)


FIELD_OPS = ['abs', 'sign', 'round', 'ceil', 'floor', 'sqrt', 'exp', 'sin', 'cos', 'sigmoid', 'real', 'imag',
             'stop_gradient', 'normalize', 'center_of_mass', 'vec_length', 'vec_squared', 'discretize', 'integrate',
             'support', 'data_bounds', 'l1_loss', 'l2_loss', 'frequency_loss', 'pad', 'downsample2x', 'upsample2x',
             'bake_extrapolation', 'bake_staggered', 'curl_corner', 'curl_staggered', 'concat', 'stack',
             'pack_dims', 'assert_close', 'isfinite', 'convert', 'nonzero', 'reduce_sample', 'grid_scatter',
             'resample_coarse', 'advect']


@pytest.mark.parametrize('case', FIELD_OPS)
def test_field_ops_against_jax(case):
    n = 8
    if case in ('abs', 'sign', 'round', 'ceil', 'floor', 'exp', 'sin', 'cos', 'sigmoid', 'real', 'imag',
                'stop_gradient'):
        p, r = _centred_pair(n, 20)
        _values_close(getattr(tf, case)(p), getattr(jf, case)(r), 2e-6)
    elif case == 'sqrt':
        p, r = _centred_pair(n, 21)
        _values_close(tf.sqrt(tf.abs(p)), jf.sqrt(jf.abs(r)), 2e-6)
    elif case in ('normalize', 'discretize', 'pad', 'downsample2x', 'upsample2x', 'bake_extrapolation'):
        p, r = _centred_pair(n, 22, boundary='BOUNDARY' if case != 'pad' else 1.)
        args = ((2,), (2,)) if case == 'pad' else ((), ())
        pf, rf = getattr(tf, case)(p, *args[0]), getattr(jf, case)(r, *args[1])
        _values_close(pf, rf)
        assert pf.geometry.bounds == tg.Box(rf.bounds.lower.numpy(), rf.bounds.upper.numpy()) or np.allclose(
            pf.bounds.lower.numpy(), np.asarray(rf.bounds.lower.numpy()))
    elif case == 'frequency_loss':
        # the JAX package's function raises (it reads `.is_batch` of a Shape); its formula in numpy:
        # ½ Σ |DFT(v)|² · exp(−½ (k · falloff)²), k in cycles per sample
        p, _ = _centred_pair(n, 23)
        v = p.values.numpy(('x', 'y')).astype(np.float64)
        k2 = np.fft.fftfreq(n)[:, None] ** 2 + np.fft.fftfreq(n)[None, :] ** 2
        want = 0.5 * np.sum(np.abs(np.fft.fft2(v)) ** 2 * np.exp(-0.5 * k2 * 10 ** 2))
        got = tf.frequency_loss(p, frequency_falloff=10)
        assert got.shape.rank == 0 and abs(float(got) - want) <= 1e-5 * abs(want)
    elif case in ('center_of_mass', 'integrate', 'l1_loss', 'l2_loss'):
        p, r = _centred_pair(n, 23)
        _same(getattr(tf, case)(tf.abs(p)), getattr(jf, case)(jf.abs(r)), atol=1e-5, scale=True)
    elif case in ('vec_length', 'vec_squared'):
        p, r = _centred_pair(n, 24, vector=True)
        _values_close(getattr(tf, case)(p), getattr(jf, case)(r))
        if case == 'vec_length':
            _values_close(tf.vec_abs(p), jf.vec_abs(r))
        ps, rs = _staggered_pair(n, 25)
        _values_close(getattr(tf, case)(ps), getattr(jf, case)(rs))
    elif case == 'support':
        p, r = _centred_pair(n, 26)
        _same(tf.support(p > 0.5), jf.support(r > 0.5), atol=1e-6, scale=True)
    elif case == 'nonzero':
        p, r = _centred_pair(n, 26)
        _same(tf.nonzero(p > 0.5).geometry.center, jf.nonzero(r > 0.5).geometry.center, atol=1e-6, scale=True)
    elif case == 'data_bounds':
        pts = _rng(27).uniform(0, 3, (9, 2)).astype(np.float32)
        t, j = _pair(pts, 'torch', lambda m: m.instance('p') & m.channel(vector='x,y'))
        b, jb = tf.data_bounds(t), jf.data_bounds(j)
        np.testing.assert_allclose(b.lower.numpy(), np.asarray(jb.lower.numpy()))
        np.testing.assert_allclose(b.upper.numpy(), np.asarray(jb.upper.numpy()))
    elif case == 'bake_staggered':
        p, r = _staggered_pair(n, 28, boundary=1.)
        _values_close(tf.bake_extrapolation(p), jf.bake_extrapolation(r))
    elif case == 'curl_corner':
        p, r = _centred_pair(n, 29, boundary='BOUNDARY', vector=True)
        pc, rc = tf.curl(p), jf.curl(r)
        _values_close(pc, rc)
        np.testing.assert_allclose(pc.bounds.lower.numpy(), np.asarray(rc.bounds.lower.numpy()))
    elif case == 'curl_staggered':
        p, r = _staggered_pair(n, 30)
        _values_close(p.curl(), r.curl())
        _values_close(tf.curl(p, at='center'), jf.curl(r, at='center'))
    elif case in ('concat', 'stack'):
        p1, r1 = _centred_pair(n, 31)
        p2, r2 = _centred_pair(n, 32)
        if case == 'concat':
            pb = [tf.pack_dims(f, (), tm.batch('b')) for f in (p1, p2)]
            rb = [jf.pack_dims(f, (), jm.batch('b')) for f in (r1, r2)]
            pf, rf = tf.concat(pb, tm.batch('b')), jf.concat(rb, jm.batch('b'))
        else:
            pf, rf = tf.stack([p1, p2], tm.batch(b=2)), jf.stack([r1, r2], jm.batch(b=2))
        _same(pf.values, rf.values)
    elif case == 'pack_dims':
        arr = _rng(33).standard_normal((2, 3, n, n)).astype(np.float32)
        t, j = _pair(arr, 'torch', lambda m: m.batch('a,b') & m.spatial('x,y'))
        pf = tf.pack_dims(tf.CenteredGrid(t, 0., x=n, y=n), 'a,b', tm.batch('ab'))
        rf = jf.pack_dims(jf.CenteredGrid(j, 0., x=n, y=n), 'a,b', jm.batch('ab'))
        _same(pf.values, rf.values)
    elif case == 'assert_close':
        p, r = _centred_pair(n, 34)
        tf.assert_close(p, p * 1.0000001)
        jf.assert_close(r, r * 1.0000001)
        with pytest.raises(AssertionError):
            tf.assert_close(p, p + 1)
    elif case == 'isfinite':
        p, r = _centred_pair(n, 35)
        _same(tf.isfinite(p / p).values, jf.isfinite(r / r).values)
    elif case == 'convert':
        p, _ = _centred_pair(n, 36)
        assert tf.convert(p) is p
    elif case == 'reduce_sample':
        p, r = _staggered_pair(n, 37)
        pts = _rng(38).uniform(0, 2, (11, 2)).astype(np.float32)
        t, j = _pair(pts, 'torch', lambda m: m.instance('p') & m.channel(vector='x,y'))
        _same(tf.reduce_sample(p, t), jf.reduce_sample(r, j), atol=1e-6, scale=True)
    elif case == 'grid_scatter':
        pts = _rng(39).uniform(0, 2, (40, 2)).astype(np.float32)
        vals = _rng(40).standard_normal(40).astype(np.float32)
        t, j = _pair(pts, 'torch', lambda m: m.instance('p') & m.channel(vector='x,y'))
        v, jv = _pair(vals, 'torch', lambda m: m.instance('p'))
        pc = tf.PointCloud(tg.Point(t), v)
        rc = jf.PointCloud(jg.Point(j), jv)
        _same(tf.grid_scatter(pc, tg.Box(x=2, y=2), tm.spatial(x=4, y=4)),
              jf.grid_scatter(rc, jg.Box(x=2, y=2), jm.spatial(x=4, y=4)), atol=1e-6, scale=True)
    elif case == 'advect':  # physics.advect.advect of a point cloud through a staggered velocity, rk4
        import phiflow_tpu.physics as jp
        import phiflow_tpu_torch.physics as tp
        v, jv = _staggered_pair(n, 43)
        pts = _rng(44).uniform(0.2, 1.8, (13, 2)).astype(np.float32)
        t, j = _pair(pts, 'torch', lambda m: m.instance('p') & m.channel(vector='x,y'))
        moved = tp.advect.advect(tf.PointCloud(tg.Point(t)), v, 0.05, integrator=tp.advect.rk4)
        ref = jp.advect.advect(jf.PointCloud(jg.Point(j)), jv, 0.05, integrator=jp.advect.rk4)
        _same(moved.geometry.center, ref.geometry.center, atol=1e-6, scale=True)
    else:  # a staggered grid onto a finer one: math.grid_sample at the target's faces
        p, r = _staggered_pair(4, 41)
        pt, rt = tf.StaggeredGrid(0, 0, tg.Box(x=2, y=2), x=n, y=n), jf.StaggeredGrid(0, 0, jg.Box(x=2, y=2), x=n, y=n)
        _values_close(tf.resample(p, to=pt), jf.resample(r, to=rt))


def test_staggered_downsample_keeps_faces():
    """`Field.downsample` of a closed-box staggered grid (the JAX package
    refuses staggered grids): every second interior face along its own axis,
    pairs averaged along the other; a grid of zeros gives the coarse zeros."""
    p, _ = _staggered_pair(8, 42)
    d = p.downsample(2)
    x = p.values[{'~vector': 'x'}].numpy(('x', 'y'))
    np.testing.assert_allclose(d.values[{'~vector': 'x'}].numpy(('x', 'y')), (x[1::2, 0::2] + x[1::2, 1::2]) / 2,
                               rtol=1e-6)
    z = (0 * p).downsample(4)
    assert [c.shape.sizes for c in z.values.components] == [(1, 2), (2, 1)]


def test_sample_uniform():
    """`sample_uniform` of a Box, a Sphere and a Point, drawn from the port's
    generator: inside, of JAX's shape, the same values after the same seed."""
    box, jbox = tg.Box(x=(1, 3), y=(0, 2)), jg.Box(x=(1, 3), y=(0, 2))
    tm.seed(4)
    pts = box.sample_uniform(tm.instance(markers=500))
    assert pts.shape.names == jbox.sample_uniform(jm.instance(markers=500)).shape.names
    a = pts.numpy(('markers', 'vector'))
    assert (a[:, 0] >= 1).all() and (a[:, 0] <= 3).all() and (a[:, 1] >= 0).all() and (a[:, 1] <= 2).all()
    tm.seed(4)
    np.testing.assert_array_equal(box.sample_uniform(tm.instance(markers=500)).numpy(('markers', 'vector')), a)
    sphere = tg.Sphere(x=1., y=1., radius=0.5)
    s = sphere.sample_uniform(tm.instance(p=300)).numpy(('p', 'vector'))
    assert (np.linalg.norm(s - 1., axis=1) <= 0.5 + 1e-6).all()
    assert jg.Sphere(x=1., y=1., radius=0.5).sample_uniform(jm.instance(p=300)).shape.names == ('p', 'vector')
    point = tg.Point(tm.vec(x=1., y=2.))
    assert point.sample_uniform(tm.instance(p=3)).shape.get_size('p') == 3
    with pytest.raises(NotImplementedError):
        tg.Geometry.sample_uniform(box)

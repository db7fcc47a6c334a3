"""The names of `phiflow_tpu_torch.math` ported with the optimisation slice,
against `phiflow_tpu`'s on the same numpy inputs from a seed: the ports of
`tests/math/test_tensor.py::test_fft_roundtrip`, `test_grid_sample_linear`,
`test_neighbor_mean`, `test_sample_subgrid`, `test_histogram` and
`test_grid_sample_slab_path_matches_generic_and_nan_safe`, then one
parametrised comparison a group (elementwise, statistics, grids,
structure); the Field names are in `test_torch_field_names.py`.

Tolerances: shapes, labels and dtypes exactly; the elementwise functions
within 2e-6 relative (1e-7 absolute near 0) — XLA's and torch's
transcendental functions may differ in the last float32 bit; reductions,
interpolation and transforms, whose order of addition is each library's
own, within 1e-5 of the result's scale; integer results and counts exactly.
NaN where JAX has NaN. Each elementwise case runs on a host (numpy) native
and on a torch native."""
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
# the JAX suite's cases
# ---------------------------------------------------------------------------

def test_fft_roundtrip():
    t = tm.wrap(torch.from_numpy(_rng(1).standard_normal((16, 8)).astype(np.float32)), tm.spatial('x,y'))
    rt = tm.real(tm.ifft(tm.fft(t)))
    tm.assert_close(t, rt, abs_tolerance=1e-5)


def test_grid_sample_linear():
    g = tm.wrap(np.array([0., 1., 2., 3.], np.float32), tm.spatial('x'))
    coords = tm.wrap(np.array([[0.5], [1.25]], np.float32), tm.instance(p=2), tm.channel(vector='x'))
    v = tm.grid_sample(g, coords, tm.extrapolation.ZERO)
    assert np.allclose(v.numpy('p'), [0.5, 1.25])


def test_neighbor_mean():
    out = tm.neighbor_mean(tm.wrap(np.arange(6, dtype=np.float32), tm.spatial('x')), 'x')
    np.testing.assert_allclose(out.numpy(), np.arange(5) + 0.5)


def test_sample_subgrid():
    g = tm.wrap(np.arange(20, dtype=np.float32).reshape(4, 5), tm.spatial(x=4, y=5))
    sub = tm.sample_subgrid(g, tm.wrap([0.5, 1.0], tm.channel(vector=['x', 'y'])), tm.spatial(x=3, y=3))
    expected = (np.arange(20).reshape(4, 5)[:3, 1:4] + np.arange(20).reshape(4, 5)[1:4, 1:4]) / 2
    np.testing.assert_allclose(sub.numpy(('x', 'y')), expected)


def test_histogram():
    t = tm.wrap(_rng(0).uniform(0, 1, 1000).astype(np.float32), tm.instance('samples'))
    counts, edges = tm.histogram(t, bins=10)
    assert counts.shape.get_size('bins') == 10 and edges.shape.get_size('bins') == 11
    assert int(counts.numpy().sum()) == 1000


def test_grid_sample_slab_path_matches_generic_and_nan_safe():
    """The slab route (at ≥ 2048 queries) equals the per-corner route, and a
    NaN ghost cell reaches no query whose weights miss it."""
    from phiflow_tpu_torch.math import _nd
    rng = np.random.default_rng(3)
    grid = tm.wrap(torch.from_numpy(rng.standard_normal((12, 10, 140)).astype(np.float32)), tm.spatial(x=12, y=10, z=140))
    coords = rng.uniform(-1.0, 14.0, (4096, 3)).astype(np.float32)

    def points(c):
        return tm.wrap(torch.from_numpy(c), tm.spatial(points=c.shape[0]) & tm.channel(vector='x,y,z'))
    fast = _nd.grid_sample_tensor(grid, points(coords), tm.extrapolation.BOUNDARY).numpy('points')
    slow = _nd.grid_sample_tensor(grid, points(coords[:64]), tm.extrapolation.BOUNDARY).numpy('points')
    assert np.abs(fast[:64] - slow).max() < 1e-5
    assert _nd.slab_route(_nd._lookup_setup(grid, points(coords), tm.extrapolation.BOUNDARY))
    corners = _nd._corner_sample(_nd._lookup_setup(grid, points(coords), tm.extrapolation.BOUNDARY)).numpy()
    assert np.abs(fast - corners).max() < 1e-5
    nan_ext = tm.extrapolation.ConstantExtrapolation(float('nan'))
    out = _nd.grid_sample_tensor(grid, points(rng.uniform(2.0, 7.0, (4096, 3)).astype(np.float32)), nan_ext)
    assert np.isfinite(out.numpy('points')).all(), "interior queries must not see NaN ghosts"


# ---------------------------------------------------------------------------
# against JAX, a group at a time
# ---------------------------------------------------------------------------

ELEMENTWISE = ['tan', 'tanh', 'sinh', 'cosh', 'arcsin', 'arccos', 'arctan', 'sigmoid', 'erf', 'log2', 'log10',
               'factorial', 'real', 'imag', 'conjugate', 'degrees_to_radians', 'radians_to_degrees', 'sign']


@pytest.mark.parametrize('kind', NATIVE)
@pytest.mark.parametrize('name', ELEMENTWISE)
def test_elementwise_against_jax(name, kind):
    """Each function on values with NaN, ±0 and out-of-domain entries (NaN
    where JAX gives NaN), and on int32 input (float32 out, as in JAX)."""
    x = np.asarray([np.nan, -2.5, -0.5, 0., 0.25, 0.9, 3., 7.], np.float32)
    t, j = _pair(x, kind, lambda m: m.spatial('x'))
    _same(getattr(tm, name)(t), getattr(jm, name)(j), rtol=2e-6, atol=1e-7)
    ti, ji = _pair(np.asarray([-2, 0, 1, 3], np.int32), kind, lambda m: m.spatial('x'))
    try:
        ref = getattr(jm, name)(ji)
    except TypeError:  # lax.logistic and lax.erf take floats only; the port casts to the default float
        ref = getattr(jm, name)(jm.to_float(ji))
    _same(getattr(tm, name)(ti), ref, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize('kind', NATIVE)
def test_arctan2_against_jax(kind):
    y, jy = _pair(np.asarray([1., -1., 0., -0., 2., np.nan], np.float32), kind, lambda m: m.spatial('x'))
    x, jx = _pair(np.asarray([-1., -1., -1., 1., 0., 1.], np.float32), kind, lambda m: m.spatial('x'))
    _same(tm.arctan2(y, x), jm.arctan2(jy, jx), rtol=2e-6)
    _same(tm.arctan(y, divide_by=x), jm.arctan(jy, divide_by=jx), rtol=2e-6)


STATISTICS = ['std', 'std_x', 'argmax', 'argmin', 'at_max', 'cumulative_sum', 'cumulative_sum_int', 'norm', 'length',
              'squared_norm', 'normalize', 'histogram', 'histogram_weights']


@pytest.mark.parametrize('kind', NATIVE)
@pytest.mark.parametrize('case', STATISTICS)
def test_statistics_against_jax(case, kind):
    arr = _rng(4).standard_normal((5, 6)).astype(np.float32)
    t, j = _pair(arr, kind, lambda m: m.spatial('x') & m.channel(vector=6))
    if case == 'std':
        _same(tm.std(t), jm.std(j), rtol=1e-5)
    elif case == 'std_x':
        _same(tm.std(t, 'x'), jm.std(j, 'x'), rtol=1e-5)
    elif case in ('argmax', 'argmin'):
        _same(getattr(tm, case)(t, 'x'), getattr(jm, case)(j, 'x'))
    elif case == 'at_max':
        k, jk = _pair(_rng(5).standard_normal(5).astype(np.float32), kind, lambda m: m.spatial('x'))
        _same(tm.at_max(t, k, 'x'), jm.at_max(j, jk, 'x'))
    elif case == 'cumulative_sum':
        _same(tm.cumulative_sum(t, 'x'), jm.cumulative_sum(j, 'x'), atol=1e-5, scale=True)
    elif case == 'cumulative_sum_int':
        _same(tm.cumulative_sum(tm.to_int32(t * 3), 'x'), jm.cumulative_sum(jm.to_int32(j * 3), 'x'))
    elif case in ('norm', 'length', 'squared_norm', 'normalize'):
        _same(getattr(tm, case)(t), getattr(jm, case)(j), rtol=1e-5)
    else:
        w, jw = _pair(_rng(6).uniform(0, 2, (5, 6)).astype(np.float32), kind, lambda m: m.spatial('x') & m.channel(vector=6))
        kw = (dict(weights=w), dict(weights=jw)) if case == 'histogram_weights' else ({}, {})
        counts, edges = tm.histogram(t, bins=7, **kw[0])
        jcounts, jedges = jm.histogram(j, bins=7, **kw[1])
        _same(edges, jedges, rtol=1e-6)
        _same(counts, jcounts, atol=1e-5, scale=True)


def test_assert_finite_and_argmax_of_nan():
    t = tm.wrap(np.asarray([1., np.nan, 3.], np.float32), tm.spatial('x'))
    j = jm.wrap(np.asarray([1., np.nan, 3.], np.float32), jm.spatial('x'))
    _same(tm.argmax(t, 'x'), jm.argmax(j, 'x'))
    with pytest.raises(AssertionError):
        tm.assert_finite(t)
    tm.assert_finite(t[{'x': 0}])


GRIDS = ['grid_sample_zero', 'grid_sample_boundary', 'grid_sample_periodic', 'grid_sample_vector', 'closest',
         'fft', 'ifft', 'fftfreq', 'convolve_valid', 'convolve_padded', 'laplace', 'spatial_gradient',
         'downsample2x', 'upsample2x', 'neighbor_mean_padded', 'sample_subgrid']


@pytest.mark.parametrize('case', GRIDS)
def test_grid_names_against_jax(case):
    rng = _rng(9)
    arr = rng.standard_normal((7, 6)).astype(np.float32)
    t, j = _pair(arr, 'torch', lambda m: m.spatial('x,y'))
    coords = rng.uniform(-1.5, 8.0, (50, 2)).astype(np.float32)
    c, jc = _pair(coords, 'torch', lambda m: m.instance('p') & m.channel(vector='x,y'))
    if case.startswith('grid_sample'):
        mode = case.split('_')[-1]
        if mode == 'vector':
            v, jv = _pair(rng.standard_normal((7, 6, 2)).astype(np.float32), 'torch',
                          lambda m: m.spatial('x,y') & m.channel(vector='a,b'))
            _same(tm.grid_sample(v, c, tm.extrapolation.ZERO), jm.grid_sample(jv, jc, jm.extrapolation.ZERO),
                  atol=1e-6, scale=True)
        else:
            ext = {'zero': 'ZERO', 'boundary': 'BOUNDARY', 'periodic': 'PERIODIC'}[mode]
            _same(tm.grid_sample(t, c, getattr(tm.extrapolation, ext)),
                  jm.grid_sample(j, jc, getattr(jm.extrapolation, ext)), atol=1e-6, scale=True)
    elif case == 'closest':
        _same(tm.closest_grid_values(t, c, tm.extrapolation.BOUNDARY),
              jm.closest_grid_values(j, jc, jm.extrapolation.BOUNDARY))
    elif case in ('fft', 'ifft'):
        _same(getattr(tm, case)(t), getattr(jm, case)(j), atol=1e-5, scale=True)
    elif case == 'fftfreq':
        _same(tm.fftfreq(tm.spatial(x=7, y=6), dx=0.5), jm.fftfreq(jm.spatial(x=7, y=6), dx=0.5), rtol=1e-6)
    elif case.startswith('convolve'):
        k, jk = _pair(rng.standard_normal((3, 3)).astype(np.float32), 'torch', lambda m: m.spatial('x,y'))
        ext = (tm.extrapolation.ZERO, jm.extrapolation.ZERO) if case == 'convolve_padded' else (None, None)
        _same(tm.convolve(t, k, ext[0]), jm.convolve(j, jk, ext[1]), atol=1e-5, scale=True)
    elif case == 'laplace':  # one dim at a time, as the JAX package's shift stacks them
        _same(tm.laplace(t, dx=0.5, padding=tm.extrapolation.PERIODIC, dims=['x']),
              jm.laplace(j, dx=0.5, padding=jm.extrapolation.PERIODIC, dims=['x']), atol=1e-6, scale=True)
    elif case == 'spatial_gradient':
        for diff in ('central', 'forward', 'backward'):
            _same(tm.spatial_gradient(t, dx=2., difference=diff, padding=tm.extrapolation.BOUNDARY, dims=['y']),
                  jm.spatial_gradient(j, dx=2., difference=diff, padding=jm.extrapolation.BOUNDARY, dims=['y']),
                  atol=1e-6, scale=True)
    elif case == 'downsample2x':
        _same(tm.downsample2x(t, tm.extrapolation.BOUNDARY), jm.downsample2x(j, jm.extrapolation.BOUNDARY))
    elif case == 'upsample2x':
        _same(tm.upsample2x(t, tm.extrapolation.PERIODIC), jm.upsample2x(j, jm.extrapolation.PERIODIC), atol=1e-6,
              scale=True)
    elif case == 'neighbor_mean_padded':
        _same(tm.neighbor_mean(t, 'x,y', tm.extrapolation.ZERO), jm.neighbor_mean(j, 'x,y', jm.extrapolation.ZERO))
    else:
        s, js = tm.wrap([1.25, 0.5], tm.channel(vector='x,y')), jm.wrap([1.25, 0.5], jm.channel(vector='x,y'))
        _same(tm.sample_subgrid(t, s, tm.spatial(x=4, y=3)), jm.sample_subgrid(j, js, jm.spatial(x=4, y=3)),
              atol=1e-6, scale=True)


STRUCTURE = ['flatten', 'range_tensor', 'reshaped_native', 'reshaped_tensor', 'cross2', 'cross3', 'const_vec',
             'copy_with', 'masked', 'map', 'print']


@pytest.mark.parametrize('case', STRUCTURE)
def test_structure_against_jax(case, capsys):
    arr = _rng(10).standard_normal((3, 4)).astype(np.float32)
    t, j = _pair(arr, 'torch', lambda m: m.spatial('x') & m.instance('p'))
    if case == 'flatten':
        _same(tm.flatten(t), jm.flatten(j))
    elif case == 'range_tensor':
        _same(tm.range_tensor(tm.spatial(x=5)), jm.range_tensor(jm.spatial(x=5)))
    elif case == 'reshaped_native':
        got = tm.reshaped_native(t, [tm.instance('p'), tm.spatial('x')])
        np.testing.assert_array_equal(got.numpy(), np.asarray(jm.reshaped_native(j, [jm.instance('p'), jm.spatial('x')])))
    elif case == 'reshaped_tensor':
        _same(tm.reshaped_tensor(torch.from_numpy(arr), [tm.spatial(a=2, b=6)]),
              jm.reshaped_tensor(arr, [jm.spatial(a=2, b=6)]))
    elif case.startswith('cross'):
        n = int(case[-1])
        labels = 'x,y' if n == 2 else 'x,y,z'
        a, ja = _pair(_rng(11).standard_normal((5, n)).astype(np.float32), 'torch', lambda m: m.instance('p') & m.channel(vector=labels))
        b, jb = _pair(_rng(12).standard_normal((5, n)).astype(np.float32), 'torch', lambda m: m.instance('p') & m.channel(vector=labels))
        _same(tm.cross_product(a, b), jm.cross_product(ja, jb), rtol=1e-6, atol=1e-6)
    elif case == 'const_vec':
        _same(tm.const_vec(1.5, tm.spatial(x=3, y=2)), jm.const_vec(1.5, jm.spatial(x=3, y=2)))
    elif case == 'copy_with':
        s = tm.copy_with(tm.Solve('CG', 1e-3, 1e-4), rel_tol=1e-6)
        js = jm.copy_with(jm.Solve('CG', 1e-3, 1e-4), rel_tol=1e-6)
        assert (s.method, s.rel_tol, s.abs_tol) == (js.method, js.rel_tol, js.abs_tol)
    elif case == 'masked':
        assert tm.masked(t) is t and jm.masked(j) is j
    elif case == 'map':
        _same(tm.map(lambda v: v * 2 + 1, t, dims='x'), jm.map(lambda v: v * 2 + 1, j, dims='x'))
    else:
        tm.print(tm.wrap(1.5), name='value')
        assert capsys.readouterr().out.splitlines()[0] == 'value'

"""The port's `vis` (`phiflow_tpu_torch.vis`) against the JAX package's, the
analogues of `tests/vis/*`: each recipe's `can_plot` on the same Fields,
the arrays each matplotlib recipe hands its axis (a recording stand-in for
matplotlib's axis) and each plotly recipe hands plotly (the faked `go` of
`tests/vis/test_plotly_recipes.py`), the console plots' text, `SceneLog`'s
files, `Viewer` / `Record` trajectories, `plot` / `write_image` through
matplotlib itself, and the web GUI's round trip and pages (every request
with its own timeout). The Fields are made from the same numpy values in
both packages."""
import json
import os
import sys
import urllib.request

import numpy as np
import pytest

import phiflow_tpu.field as jf
import phiflow_tpu.geom as jg
import phiflow_tpu.math as jm
from phiflow_tpu.vis import _console as jconsole, _matplotlib_plots as jmp, _plotly_plots as jpp
import phiflow_tpu.vis as jvis
import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.geom as tg
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.vis import _console as tconsole, _matplotlib_plots as tmp, _plotly_plots as tpp
import phiflow_tpu_torch.vis as tvis

PKGS = {'jax': (jm, jg, jf), 'torch': (tm, tg, tf)}
RNG = np.random.default_rng(11)
A2 = RNG.normal(size=(12, 10)).astype(np.float32)
V2 = RNG.normal(size=(12, 10, 2)).astype(np.float32)
A3 = RNG.normal(size=(6, 5, 4)).astype(np.float32)
V3 = RNG.normal(size=(6, 5, 4, 3)).astype(np.float32)
P2 = RNG.uniform(0, 4, (9, 2)).astype(np.float32)
P3 = RNG.uniform(0, 4, (9, 3)).astype(np.float32)
PV2 = RNG.normal(size=(9, 2)).astype(np.float32)
PV3 = RNG.normal(size=(9, 3)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    with tm.default_device('cpu'):
        yield


def _staggered(m, f, vals, dims):
    """A closed-box staggered grid whose centred resample is `vals`."""
    centred = f.CenteredGrid(m.tensor(vals, m.spatial(dims), m.channel(vector=dims)), 0,
                             **{d: n for d, n in zip(dims.split(','), vals.shape)})
    return f.resample(centred, f.StaggeredGrid(0, 0, **{d: n for d, n in zip(dims.split(','), vals.shape)}))


CASES = {
    'grid-2d': lambda m, g, f: f.CenteredGrid(m.tensor(A2, m.spatial('x,y')), 0, x=12, y=10),
    'grid-2d-bounds': lambda m, g, f: f.CenteredGrid(m.tensor(A2, m.spatial('x,y')), 0, g.Box(x=(1, 4), y=(0, 2)),
                                                     x=12, y=10),
    'vector-2d': lambda m, g, f: f.CenteredGrid(m.tensor(V2, m.spatial('x,y'), m.channel(vector='x,y')), 0,
                                                x=12, y=10),
    'staggered-2d': lambda m, g, f: _staggered(m, f, V2, 'x,y'),
    'grid-1d': lambda m, g, f: f.CenteredGrid(m.tensor(A2[:, 0], m.spatial('x')), 0, x=12),
    'grid-3d': lambda m, g, f: f.CenteredGrid(m.tensor(A3, m.spatial('x,y,z')), 0, x=6, y=5, z=4),
    'vector-3d': lambda m, g, f: f.CenteredGrid(m.tensor(V3, m.spatial('x,y,z'), m.channel(vector='x,y,z')), 0,
                                                x=6, y=5, z=4),
    'cloud-2d': lambda m, g, f: f.PointCloud(m.tensor(P2, m.instance('points'), m.channel(vector='x,y'))),
    'cloud-3d': lambda m, g, f: f.PointCloud(m.tensor(P3, m.instance('points'), m.channel(vector='x,y,z'))),
    'vector-cloud-2d': lambda m, g, f: f.PointCloud(m.tensor(P2, m.instance('points'), m.channel(vector='x,y')))
    .with_values(m.tensor(PV2, m.instance('points'), m.channel(vector='x,y'))),
    'vector-cloud-3d': lambda m, g, f: f.PointCloud(m.tensor(P3, m.instance('points'), m.channel(vector='x,y,z')))
    .with_values(m.tensor(PV3, m.instance('points'), m.channel(vector='x,y,z'))),
    'mesh-2d': lambda m, g, f: f.Field(g.build_mesh(g.Box(x=2, y=1), x=6, y=3), m.vec(x=1., y=0.),
                                       {'x-': m.vec(x=1., y=0.), 'x+': m.extrapolation.ZERO_GRADIENT, 'y-': 0., 'y+': 0.}),
    'tensor-1d': lambda m, g, f: m.tensor(A2[:, 0], m.instance('samples')),
    'tensor-2d': lambda m, g, f: m.tensor(A2, m.spatial('t'), m.channel('c')),
    'labelled': lambda m, g, f: m.wrap(np.array([3., 1., 2.], np.float32), m.channel(metric='a,b,c')),
    'sphere-2d': lambda m, g, f: g.Sphere(x=1, y=1, radius=0.5),
    'box-2d': lambda m, g, f: g.Box(x=(0, 2), y=(1, 3)),
    'sphere-3d': lambda m, g, f: g.Sphere(x=1, y=1, z=1, radius=0.5),
    'heightmap': lambda m, g, f: g.Heightmap(m.tensor(A2, m.spatial('x,y')), g.Box(x=4, y=4, z=4)),
}


def _recipes(module):
    return [type(r).__name__ for r in module.MATPLOTLIB.recipes]


def test_recipe_lists_equal():
    assert _recipes(tmp) == _recipes(jmp)
    names = [n for n in dir(jpp) if n.endswith('P') and isinstance(getattr(jpp, n), type)]
    assert names and all(isinstance(getattr(tpp, n), type) for n in names)


@pytest.mark.parametrize('case', list(CASES))
def test_can_plot_equal(case):
    """Every recipe of both libraries answers can_plot on the same data as JAX's."""
    j = CASES[case](*PKGS['jax'])
    t = CASES[case](*PKGS['torch'])
    for jr, tr in zip(jmp.MATPLOTLIB.recipes, tmp.MATPLOTLIB.recipes):
        assert bool(jr.can_plot(j, None)) == bool(tr.can_plot(t, None)), (case, type(jr).__name__)
    for name in [n for n in dir(jpp) if n.endswith('P') and isinstance(getattr(jpp, n), type)]:
        assert bool(getattr(jpp, name)().can_plot(j, None)) == bool(getattr(tpp, name)().can_plot(t, None)), (case, name)


class _Recorder:
    """A stand-in for a matplotlib axis or figure: records every call's
    arrays (numbers and sequences as numpy), returns itself."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith('__'):
            raise AttributeError(name)

        def record(*args, **kwargs):
            self.calls.append((name, [self._host(a) for a in args],
                               {k: self._host(v) for k, v in kwargs.items()}))
            return self
        return record

    @staticmethod
    def _host(x):
        if isinstance(x, _Recorder):
            return x
        if hasattr(x, '_vec'):  # a Poly3DCollection: its vertices
            return np.asarray(x._vec, np.float64)
        if isinstance(x, (list, tuple)) and x and all(isinstance(v, (int, float, np.number)) for v in x):
            return np.asarray(x, np.float64)
        if isinstance(x, np.ndarray):
            return x
        if hasattr(x, 'center') and hasattr(x, 'radius'):  # a matplotlib patch
            return (type(x).__name__, np.asarray(x.center), float(x.radius))
        if hasattr(x, 'get_xy'):
            return (type(x).__name__, np.asarray(x.get_xy()), float(x.get_width()), float(x.get_height()))
        return x


def _same_calls(a, b, what):
    assert [c[0] for c in a] == [c[0] for c in b], what
    for (name, args_a, kw_a), (_, args_b, kw_b) in zip(a, b):
        assert len(args_a) == len(args_b) and set(kw_a) == set(kw_b), (what, name)
        for x, y in list(zip(args_a, args_b)) + [(kw_a[k], kw_b[k]) for k in kw_a]:
            _same(x, y, f'{what} {name}')


def _same(x, y, what):
    if isinstance(x, tuple) and isinstance(y, tuple):
        assert len(x) == len(y), what
        for u, v in zip(x, y):
            _same(u, v, what)
    elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, (what, x.shape, y.shape)
        if x.dtype.kind in 'fc':
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6, err_msg=what)
        else:
            np.testing.assert_array_equal(x, y, err_msg=what)
    elif isinstance(x, (_Recorder,)) or callable(x):
        pass
    else:
        assert x == y, (what, x, y)


MPL_CASES = [c for c in CASES if c not in ('grid-3d',)]  # Heatmap3D's marching cubes: `test_plot_figures`


@pytest.mark.parametrize('case', MPL_CASES)
def test_matplotlib_arrays_equal(case):
    """The first recipe that plots the case (and each plot_type's) hands the
    axis the same arrays as JAX's, or raises as JAX's does (a histogram of a
    staggered grid's non-uniform values)."""
    for plot_type in (None, 'stream', 'histogram', 'bar'):
        rec = {}
        for pkg, module in (('jax', jmp), ('torch', tmp)):
            data = CASES[case](*PKGS[pkg])
            axis, figure = _Recorder(), _Recorder()
            try:
                recipe = type(module.MATPLOTLIB.plot(data, figure, axis, None, plot_type=plot_type)).__name__
            except (NotImplementedError, AssertionError) as e:  # no recipe; JAX's densify assertion
                recipe = type(e).__name__
            rec[pkg] = (recipe, axis.calls, figure.calls)
        assert rec['torch'][0] == rec['jax'][0], (case, plot_type)
        _same_calls(rec['torch'][1], rec['jax'][1], f'{case} {plot_type} axis')
        _same_calls(rec['torch'][2], rec['jax'][2], f'{case} {plot_type} figure')


class _FakeTrace:
    def __init__(self, kind, **kwargs):
        self.kind = kind
        self.kwargs = kwargs


class _FakeGo:
    def __getattr__(self, kind):
        return lambda **kwargs: _FakeTrace(kind, **kwargs)


class _FakeFigure:
    def __init__(self):
        self.traces = []

    def add_trace(self, trace, row=None, col=None):
        self.traces.append(trace)


PLOTLY_CASES = {
    **{k: CASES[k] for k in ('grid-1d', 'grid-2d', 'vector-2d', 'staggered-2d', 'grid-3d', 'cloud-2d', 'cloud-3d',
                             'vector-cloud-3d', 'vector-3d')},
    'spheres-3d': lambda m, g, f: f.Field(g.Sphere(m.tensor(P3[:2], m.instance('points'), m.channel(vector='x,y,z')),
                                                   radius=1.), m.wrap(1.), 0.),
    'box-3d': lambda m, g, f: f.Field(g.Box(x=(0, 1.), y=(0, 2.), z=(0, 3.)), m.wrap(1.), 0.),
    'cylinder-3d': lambda m, g, f: f.Field(g.Cylinder(m.vec(x=0., y=0., z=0.), radius=1., depth=2., axis='z'),
                                           m.wrap(1.), 0.),
    'graph-3d': lambda m, g, f: g.graph(f.PointCloud(m.tensor(P3[:3], m.instance('points'),
                                                              m.channel(vector='x,y,z'))).geometry,
                                        m.wrap(np.array([[0, 1, 1], [1, 0, 0], [1, 0, 0]], np.float32),
                                               m.instance('points'), m.instance('points2'))),
    'spline-sheet': lambda m, g, f: g.BSplineSheet(np.stack(list(np.meshgrid(np.arange(4.), np.arange(4.), indexing='ij'))
                                                            + [np.zeros((4, 4))], -1).astype(np.float32), (2, 2)),
}


@pytest.mark.parametrize('case', list(PLOTLY_CASES))
def test_plotly_arrays_equal(case, monkeypatch):
    """Each plotly recipe that can plot the case hands the faked plotly the
    same traces as JAX's."""
    monkeypatch.setattr(jpp, 'go', _FakeGo())
    monkeypatch.setattr(tpp, 'go', _FakeGo())
    names = [n for n in dir(jpp) if n.endswith('P') and isinstance(getattr(jpp, n), type)]
    plotted = 0
    for name in names:
        traces = {}
        for pkg, module in (('jax', jpp), ('torch', tpp)):
            data = PLOTLY_CASES[case](*PKGS[pkg])
            recipe = getattr(module, name)()
            if not recipe.can_plot(data, None):
                continue
            fig = _FakeFigure()
            recipe.plot(data, fig, (0, 0), None)
            traces[pkg] = fig.traces
        if not traces:
            continue
        assert set(traces) == {'jax', 'torch'}, (case, name)
        plotted += 1
        for a, b in zip(traces['torch'], traces['jax']):
            assert a.kind == b.kind and set(a.kwargs) == set(b.kwargs), (case, name)
            for k in a.kwargs:
                x, y = a.kwargs[k], b.kwargs[k]
                if isinstance(x, (list, np.ndarray)) or isinstance(y, (list, np.ndarray)):
                    x = np.asarray([np.nan if v is None else v for v in x] if isinstance(x, list) else x, np.float64)
                    y = np.asarray([np.nan if v is None else v for v in y] if isinstance(y, list) else y, np.float64)
                    np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6, err_msg=f'{case} {name} {k}')
                else:
                    assert x == y, (case, name, k)
    assert plotted, case


def test_tessellation_helpers_equal():
    for fn, args in ((lambda p: p.sphere_surface(np.array([[1., 2., 3.], [0, 0, 0]]), np.array([0.5, 2.]), n=6), ()),
                     (lambda p: p.cuboid_surface(np.zeros((1, 3)), np.array([[1., 2., 3.]])), ()),
                     (lambda p: p.cylinder_surface(np.zeros((2, 3)), 1.0, 4.0, axis_index=1, n=8), ())):
        for a, b in zip(fn(tpp), fn(jpp)):
            np.testing.assert_array_equal(a, b)
    assert tpp.plotly_available() == jpp.plotly_available()
    assert (tpp.PLOTLY is None) == (jpp.PLOTLY is None)


def test_console_plots_equal():
    j = CASES['grid-2d'](*PKGS['jax'])
    t = CASES['grid-2d'](*PKGS['torch'])
    assert tconsole.heatmap(t) == jconsole.heatmap(j)
    assert tconsole.heatmap(t, cols=20, rows=7) == jconsole.heatmap(j, cols=20, rows=7)
    for case in ('vector-2d', 'staggered-2d'):
        assert tconsole.quiver(CASES[case](*PKGS['torch'])) == jconsole.quiver(CASES[case](*PKGS['jax']))


def test_scene_log_files_equal(tmp_path):
    """log_scalars' files byte for byte, load_scalars' Tensors, info.log's lines."""
    out = {}
    for pkg, vis, field in (('jax', jvis, jf), ('torch', tvis, tf)):
        scene = field.Scene.create(str(tmp_path / pkg))
        log = vis.SceneLog(scene)
        for i in range(5):
            log.log_scalars(i, energy=float(i) ** 2, loss=1. / (i + 1))
        log.log_scalars(None, plain=3.5)
        log.log(f'hello from {pkg}')
        with open(os.path.join(scene.path, 'log_energy.txt')) as f1, open(os.path.join(scene.path, 'log_loss.txt')) as f2, \
                open(os.path.join(scene.path, 'log_plain.txt')) as f3:
            files = (f1.read(), f2.read(), f3.read())
        out[pkg] = files, vis.load_scalars(scene, 'energy'), vis.load_scalars(scene.path, 'plain')
        with open(os.path.join(scene.path, 'info.log')) as f:
            assert f'hello from {pkg}' in f.read()
    assert out['torch'][0] == out['jax'][0]
    for a, b in zip(out['torch'][1:], out['jax'][1:]):
        assert a.shape.names == b.shape.names and a.shape.sizes == b.shape.sizes
        np.testing.assert_array_equal(a.numpy(a.shape.names), b.numpy(b.shape.names))
    assert tvis.load_scalars(str(tmp_path / 'torch' / 'sim_000000'), 'energy').shape.get_labels('vector') == \
        ('iteration', 'energy')


def test_smooth_and_controls():
    data = RNG.normal(size=100).astype(np.float32)
    np.testing.assert_allclose(tvis.smooth(tm.wrap(data, tm.spatial('t')), 10),
                               jvis.smooth(jm.wrap(data, jm.spatial('t')), 10))
    curve = np.stack([np.arange(20.), RNG.normal(size=20)], -1)
    np.testing.assert_allclose(tvis.smooth(curve, 4), jvis.smooth(curve, 4))
    assert tvis.control(1.5, (0, 3)) == 1.5 and tvis.action(test_smooth_and_controls) is test_smooth_and_controls
    assert tvis.overlay(1, 2) == jvis.overlay(1, 2)


def _viewer_run(pkg):
    """The JAX test's recording: smoke + 1 a frame, 4 frames."""
    m, g, f = PKGS[pkg]
    vis = jvis if pkg == 'jax' else tvis
    smoke = f.CenteredGrid(m.tensor(A2[:8, :8], m.spatial('x,y')), m.extrapolation.ZERO, x=8, y=8)
    viewer = vis.view('smoke', log_performance=False)
    frames = []
    for frame in viewer.range(frames=4):
        smoke = smoke + 1.0
        frames.append(frame)
    plain = vis.view('smoke', log_performance=False)
    return frames, viewer, [f for f in plain.range(3)], plain.steps


def test_viewer_and_record_equal():
    (jframes, jv, jplain, jsteps), (tframes, tv, tplain, tsteps) = _viewer_run('jax'), _viewer_run('torch')
    assert tframes == jframes == [0, 1, 2, 3] and tplain == jplain and tsteps == jsteps == 3
    assert isinstance(tv.rec, tvis.Record) and tv.rec.recording_size('smoke') == 5
    jt, tt = jv.rec.smoke, tv.rec.smoke
    assert tt.shape.names == jt.shape.names and tt.shape.sizes == jt.shape.sizes
    np.testing.assert_array_equal(tt.values.numpy(('frames', 'x', 'y')), jt.values.numpy(('frames', 'x', 'y')))
    assert repr(tv.rec) == repr(jv.rec) and tv.rec['smoke'] is not None
    with pytest.raises(AttributeError):
        tv.rec.velocity


@pytest.mark.parametrize('case', ['grid-2d', 'vector-2d', 'staggered-2d', 'grid-1d', 'grid-3d', 'vector-3d',
                                  'cloud-2d', 'cloud-3d', 'vector-cloud-2d', 'mesh-2d', 'sphere-2d', 'box-2d',
                                  'sphere-3d', 'heightmap'])
def test_plot_figures(case, tmp_path):
    """plot() through matplotlib itself, as tests/vis/test_plots.py: a
    figure for every case, saved by write_image."""
    fig = tvis.plot(CASES[case](*PKGS['torch']))
    assert fig is not None
    path = str(tmp_path / f'{case}.png')
    tvis.write_image(path, fig)
    assert os.path.getsize(path) > 0


def test_plot_layouts():
    """dicts, overlays, row / col dims, animation, histograms, show_hist."""
    g = CASES['grid-2d'](*PKGS['torch'])
    assert tvis.plot({'a': g, 'b': g}) is not None
    assert tvis.plot(tvis.overlay(g, tg.Sphere(x=2, y=2, radius=1))) is not None
    batched = tf.CenteredGrid(tm.tensor(RNG.normal(size=(2, 3, 8, 8)).astype(np.float32), tm.batch('b,c'),
                                        tm.spatial('x,y')), 0, x=8, y=8)
    fig = tvis.plot(batched, row_dims='b', col_dims='c')
    assert len(fig.axes) >= 6
    anim = tvis.plot(tf.CenteredGrid(tm.tensor(RNG.normal(size=(3, 8, 8)).astype(np.float32), tm.batch('time'),
                                               tm.spatial('x,y')), 0, x=8, y=8), animate='time')
    assert anim is not None
    t = CASES['tensor-1d'](*PKGS['torch'])
    assert tvis.plot(t, plot_type='histogram') is not None and tvis.show_hist(t) is not None
    assert tvis.plot_scalars({'a': tm.wrap(np.arange(5.), tm.spatial('t'))}) is not None
    tvis.close()
    with pytest.raises(ValueError):
        tvis.plot(g, lib='bokeh')
    with pytest.raises(ValueError):
        tvis.show(object())


def test_matplotlib_missing_raises_import_error(monkeypatch):
    """Without matplotlib, vis imports and a plot raises ImportError naming it."""
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    tmp._pyplot.cache_clear()
    try:
        with pytest.raises(ImportError, match='matplotlib'):
            tvis.plot(CASES['grid-2d'](*PKGS['torch']))
    finally:
        tmp._pyplot.cache_clear()


# ---------------------------------------------------------------------------
# the web GUI (std-lib http.server on 127.0.0.1, an ephemeral port)
# ---------------------------------------------------------------------------

class _Model(tvis.VisModel):
    def __init__(self, scene=None):
        super().__init__(name='TestSim', scene=scene)
        self.grid = CASES['grid-2d'](*PKGS['torch'])

    @property
    def field_names(self):
        return ('grid',)

    def get_field(self, name, dim_selection=None):
        return self.grid

    def progress(self):
        self.grid = self.grid * 1.1
        self.steps += 1


def _get(url, method='GET', timeout=10):
    with urllib.request.urlopen(urllib.request.Request(url, method=method), timeout=timeout) as r:
        return r.read(), r.headers.get('Content-Type')


@pytest.fixture()
def gui(tmp_path):
    scene = tf.Scene.create(str(tmp_path))
    tvis.SceneLog(scene).log('hello from the simulation')
    g = tvis.WebGui(port=0)
    g.setup(_Model(scene))
    g.show(block=False)
    yield g, f'http://127.0.0.1:{g.port}'
    g.close()


def test_web_gui_round_trip(gui):
    g, base = gui
    page, ctype = _get(base + '/')
    assert b'TestSim' in page and 'text/html' in ctype
    s = json.loads(_get(base + '/api/status')[0])
    assert s['steps'] == 0 and s['fields'] == ['grid'] and s['playing'] is False
    assert json.loads(_get(base + '/api/step', 'POST')[0])['steps'] == 1 and g.app.steps == 1
    png, ctype = _get(base + '/plot?field=grid')
    assert png[:8] == b'\x89PNG\r\n\x1a\n' and 'image/png' in ctype
    assert _get(base + '/curves')[0][:8] == b'\x89PNG\r\n\x1a\n'
    assert json.loads(_get(base + '/api/nonsense')[0])['ok'] is False
    with pytest.raises(urllib.error.HTTPError):
        _get(base + '/missing')


def test_web_gui_pages(gui):
    g, base = gui
    sbs, ctype = _get(base + '/side-by-side')
    assert 'text/html' in ctype and sbs.count(b'class="view"') == 2
    assert _get(base + '/quad')[0].count(b'class="view"') == 4
    info = _get(base + '/info')[0]
    assert b'TestSim' in info and b'Backend' in info and b'torch' in info and b'cpu' in info
    assert b'Log' in _get(base + '/log')[0]
    assert 'hello from the simulation' in json.loads(_get(base + '/api/log')[0])['text']
    board = _get(base + '/board')[0].decode()
    assert 'Board' in board and 'torch.profiler' in board and 'jax' not in board.lower()
    sysinfo = json.loads(_get(base + '/api/sysinfo')[0])
    assert sysinfo['devices'][0] == 'cpu' and sysinfo['device_count'] >= 1
    bench = json.loads(_get(base + '/api/benchmark?n=3', 'POST', timeout=30)[0])
    assert bench['steps'] == 3 and bench['ms_per_step'] >= 0


def test_web_gui_profile_and_play(gui, tmp_path):
    g, base = gui
    trace_dir = str(tmp_path / 'trace')
    prof = json.loads(_get(base + f'/api/profile?n=2&dir={trace_dir}', 'POST', timeout=60)[0])
    assert prof['steps'] == 2 and os.path.isfile(os.path.join(trace_dir, 'trace.json'))
    assert json.loads(_get(base + '/api/play', 'POST')[0])['ok']
    assert json.loads(_get(base + '/api/status')[0])['playing'] is True
    assert json.loads(_get(base + '/api/pause', 'POST')[0])['ok']
    assert json.loads(_get(base + '/api/control?name=none&value=1', 'POST')[0])['ok'] is False

"""The port's user namespace (`phiflow_tpu_torch.flow`) and top-level helpers
against the JAX package's, the analogue of `tests/test_namespace.py`:
`flow`'s public names equal JAX's less its parallel names (domain
decomposition is not ported yet), `verify()` with the CPU asked for (and
raising without a card when none is), `detect_backends()`, `troubleshoot()`
building nothing, `math.iterate` of a diffusion against JAX's on the same
grid, a `Scene` round trip, and `AngularVelocity`, the one `flow` name the
port's `field` lacked."""
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import phiflow_tpu
import phiflow_tpu.flow as jflow
import phiflow_tpu_torch
import phiflow_tpu_torch.flow as tflow
from phiflow_tpu_torch import math as tm

PARALLEL = {'parallel', 'create_mesh', 'shard_field', 'shard_tensor', 'simulation_mesh'}
RNG = np.random.default_rng(3)


@pytest.fixture(autouse=True)
def _cpu():
    with tm.default_device('cpu'):
        yield


def _public(module):
    return {n for n in dir(module) if not n.startswith('_')}


def test_flow_names_equal_jax_less_parallel():
    assert _public(tflow) == _public(jflow) - PARALLEL
    assert PARALLEL <= _public(jflow)
    namespace = {}
    exec('from phiflow_tpu_torch.flow import *', namespace)
    assert {n for n in namespace if not n.startswith('_')} >= _public(tflow) - {'annotations'}
    assert tflow.np is np and tflow.numpy is np
    for name in ('math', 'geom', 'field', 'physics', 'vis', 'advect', 'diffuse', 'fluid', 'sph'):
        assert getattr(tflow, name).__name__.startswith('phiflow_tpu_torch'), name


@pytest.mark.parametrize('name', sorted(_public(jflow) - PARALLEL - {'np', 'numpy', 'PI', 'INF', 'NAN', 'NUMPY'}))
def test_flow_name_kinds_match(name):
    """Each name is the same kind of object as JAX's: module, class, function or constant."""
    j, t = getattr(jflow, name), getattr(tflow, name)
    kind = lambda x: 'module' if type(x).__name__ == 'module' else 'class' if isinstance(x, type) else \
        'callable' if callable(x) else 'value'
    assert kind(t) == kind(j), (name, kind(t), kind(j))


def test_constants():
    assert tflow.PI == jflow.PI and tflow.INF == jflow.INF and np.isnan(tflow.NAN)


def test_verify_on_the_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        phiflow_tpu_torch.verify('cpu')
    text = buf.getvalue()
    assert f'phiflow_tpu_torch {phiflow_tpu_torch.__version__}' in text and 'basic field ops on cpu: OK' in text
    assert phiflow_tpu_torch.__version__ == phiflow_tpu.__version__
    if not torch.cuda.is_available():  # the card by default: no silent fall back to the CPU
        with pytest.raises(RuntimeError, match='CUDA'):
            phiflow_tpu_torch.verify()


def test_detect_backends_and_logging():
    backends = phiflow_tpu_torch.detect_backends()
    assert backends[0] == 'torch-cpu' and len(backends) == 1 + torch.cuda.device_count()
    import logging
    phiflow_tpu_torch.set_logging_level('warning')
    assert logging.getLogger('phiflow_tpu_torch').level == logging.WARNING
    phiflow_tpu_torch.set_logging_level('info')
    assert logging.getLogger('phiflow_tpu_torch').level == logging.INFO


def test_troubleshoot_builds_nothing():
    from phiflow_tpu_torch.ops import _build
    before = sorted(os.listdir(_build.BUILD_DIR)) if os.path.isdir(_build.BUILD_DIR) else []
    launches = dict(_build.LAUNCHES)
    report = phiflow_tpu_torch.troubleshoot()
    after = sorted(os.listdir(_build.BUILD_DIR)) if os.path.isdir(_build.BUILD_DIR) else []
    assert before == after and dict(_build.LAUNCHES) == launches
    for part in ('phiflow_tpu_torch', f'torch {torch.__version__}', 'nvcc', 'CUDA kernels built', 'matplotlib',
                 'web GUI'):
        assert part in report, part
    phiflow_tpu_torch.assert_minimal_config()
    assert 'torch' in phiflow_tpu_torch._troubleshoot.troubleshoot_torch()


def test_iterate_trajectory_matches_jax():
    """math.iterate of explicit diffusion over batch(time=4): the trajectory
    (initial state included) within 1e-6 of JAX's on the same grid."""
    values = RNG.normal(size=(8, 8)).astype(np.float32)
    out = {}
    for pkg, flow in (('jax', jflow), ('torch', tflow)):
        g = flow.CenteredGrid(flow.tensor(values, flow.spatial('x,y')), flow.PERIODIC, x=8, y=8)
        traj = flow.iterate(lambda f: flow.diffuse.explicit(f, 0.1, 1.), flow.batch(time=4), g)
        assert traj.shape.get_size('time') == 5
        out[pkg] = np.asarray(traj.values.numpy(('time', 'x', 'y')))
    np.testing.assert_allclose(out['torch'], out['jax'], rtol=0, atol=1e-6)
    assert out['torch'][4].std() < out['torch'][0].std()


def test_scene_round_trip(tmp_path):
    """The JAX test's Scene round trip through the port's namespace; the
    files read back by JAX's `Scene` too."""
    scene = tflow.Scene.create(str(tmp_path))
    s = tflow.CenteredGrid(tflow.tensor(RNG.normal(size=(8, 8)).astype(np.float32), tflow.spatial('x,y')),
                           tflow.PERIODIC, x=8, y=8)
    v = tflow.StaggeredGrid(tflow.Noise(vector='x,y'), tflow.extrapolation.ZERO, x=8, y=8)
    scene.write(smoke=s, velocity=v, frame=3)
    scene.put_properties(dt=0.5, description="test run")
    s2 = scene.read_field('smoke', frame=3)
    tflow.assert_close(s.values, s2.values)
    v2 = scene.read_field('velocity', frame=3)
    tflow.assert_close(v.vector['x'].values, v2.vector['x'].values)
    assert scene.properties['dt'] == 0.5
    assert 'smoke' in scene.fieldnames and 3 in scene.frames
    assert tflow.Scene.at(scene.path).properties['description'] == "test run"
    assert len(tflow.Scene.list(str(tmp_path))) == 1
    j = jflow.Scene.at(scene.path).read_field('smoke', frame=3)
    np.testing.assert_array_equal(np.asarray(j.values.numpy(('x', 'y'))), s.values.numpy(('x', 'y')))


@pytest.mark.parametrize('dims', [2, 3])
@pytest.mark.parametrize('grid', ['centred', 'staggered'])
def test_angular_velocity_matches_jax(dims, grid):
    """AngularVelocity(location, strength, falloff) sampled on a grid, two centres along an instance dim."""
    names = 'xyz'[:dims]
    loc = RNG.uniform(2, 6, (2, dims)).astype(np.float32)
    strength = 1.5 if dims == 2 else np.array([0.3, -0.2, 0.7], np.float32)
    out = {}
    for pkg, flow in (('jax', jflow), ('torch', tflow)):
        location = flow.tensor(loc, flow.instance('c'), flow.channel(vector=','.join(names)))
        w = strength if dims == 2 else flow.tensor(strength, flow.channel(vector=','.join(names)))
        init = flow.AngularVelocity(location, w, falloff=lambda d: flow.math.exp(-flow.math.vec_squared(d) / 8))
        cls = flow.CenteredGrid if grid == 'centred' else flow.StaggeredGrid
        f = cls(init, 0, **{n: 8 for n in names})
        out[pkg] = [np.asarray(f.values.vector[n].numpy(','.join(names))) for n in names]
    for a, b in zip(out['torch'], out['jax']):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

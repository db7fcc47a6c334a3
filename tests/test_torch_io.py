"""I/O, utilities and the entry point of the port against the JAX package:
`.npz` Fields written by either package and read by both (centred and
staggered, batched file names), `Scene` / `SceneBatch` (the analogue of
`tests/field/test_grids.py::test_scene_batch_create_write_read`, and a
scene written by one package read by the other), the analogues of
`tests/test_utils.py` (`benchmark`, `Timer`, checkpoints and their manager)
on `phiflow_tpu_torch.utils`, a checkpoint of Fields restored onto a chosen
device, `profile`'s trace, and `_entry.entry('cpu')`'s step against
`__graft_entry__.entry()`'s. Values read back bit for bit; the entry's step
within 2e-4 (the smoke steps' tolerance) with equal CG counts."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import phiflow_tpu.field as jf
import phiflow_tpu.math as jm
import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch import utils
from phiflow_tpu_torch._entry import entry

PKGS = {'jax': (jm, jf), 'port': (tm, tf)}


@pytest.fixture(autouse=True)
def _cpu():
    with tm.default_device('cpu'):
        yield


def _grids(m, f, rng):
    vals = rng.standard_normal((6, 5)).astype(np.float32)
    centred = f.CenteredGrid(m.tensor(vals, m.spatial('x,y')), m.extrapolation.PERIODIC, x=6, y=5,
                             bounds=f.CenteredGrid(0, 0, x=6, y=5).bounds)
    staggered = f.StaggeredGrid(lambda x: m.sin(x * 0.7) + 0.1, m.extrapolation.ZERO_GRADIENT, x=6, y=5)
    return {'centred': centred, 'staggered': staggered}


def _arrays(field):
    """A grid Field's values as numpy: one array, or one per face component (by label)."""
    names = tuple(sorted(field.resolution.names))  # a read Field may hold its dims in another order
    if field.is_staggered:
        return {d: np.asarray(field.vector[d].values.numpy(names)) for d in names}
    return {'': np.asarray(field.values.numpy(field.values.shape.names))}


def _boundary(field):
    return field.boundary.to_dict()


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('kind', ['centred', 'staggered'])
def test_npz_fields_cross_read(tmp_path, writer, kind):
    """A Field written by either package reads in both the same, bit for bit,
    with its boundary, bounds and type; the port's file equals JAX's key by key."""
    rng = np.random.default_rng(1)
    m, f = PKGS[writer]
    field = _grids(m, f, rng)[kind]
    path = str(tmp_path / f'{kind}_{writer}')
    f.write(field, path)
    other = 'port' if writer == 'jax' else 'jax'
    twin = _grids(*PKGS[other], np.random.default_rng(1))[kind]
    PKGS[other][1].write(twin, str(tmp_path / f'{kind}_{other}'))
    a, b = np.load(path + '.npz'), np.load(str(tmp_path / f'{kind}_{other}.npz'))
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        if key == 'data':
            np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=1e-6)  # sin in two libraries
        else:
            assert np.array_equal(a[key], b[key]), key
    reads = {name: pkg[1].read(path) for name, pkg in PKGS.items()}
    ref = _arrays(field)
    for name, got in reads.items():
        assert got.is_staggered == field.is_staggered, name
        assert _boundary(got) == _boundary(field), name
        np.testing.assert_array_equal(np.asarray(got.bounds.upper.numpy()), np.asarray(field.bounds.upper.numpy()))
        arrays = _arrays(got)
        assert arrays.keys() == ref.keys(), name
        for key in ref:
            np.testing.assert_array_equal(arrays[key], ref[key], err_msg=f'{name} {key}')


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_batched_file_names_cross_read(tmp_path, writer):
    """A Tensor of file names writes one file an entry; the other package
    reads the batch back through its own Tensor of names, bit for bit."""
    m, f = PKGS[writer]
    vals = np.random.default_rng(2).standard_normal((3, 6, 5)).astype(np.float32)
    field = f.CenteredGrid(m.tensor(vals, m.batch('b'), m.spatial('x,y')), 0., x=6, y=5)
    files = [str(tmp_path / f'b{i}') for i in range(3)]
    f.write(field, m.wrap(files, m.batch('b')))
    assert all(os.path.isfile(p + '.npz') for p in files)
    om, of = PKGS['port' if writer == 'jax' else 'jax']
    back = of.read(om.wrap(files, om.batch('b')))
    np.testing.assert_array_equal(np.asarray(back.values.numpy('b,x,y')), vals)


def test_scene_batch_create_write_read(tmp_path):
    """Batch dims → one directory an entry (`tests/field/test_grids.py`'s test
    on the port), each entry's file the entry's values."""
    sb = tf.Scene.create(str(tmp_path), tm.batch(b=3), copy_calling_script=False)
    assert len(sb.paths) == 3 and len(sb) == 3
    g = tf.CenteredGrid(tm.tensor(np.random.default_rng(3).standard_normal((3, 8, 8)).astype(np.float32),
                                  tm.batch('b'), tm.spatial('x,y')), tm.extrapolation.PERIODIC, x=8, y=8)
    sb.write(smoke=g)
    back = sb.read_field('smoke')
    np.testing.assert_array_equal(np.asarray(back.values.numpy('b,x,y')), np.asarray(g.values.numpy('b,x,y')))
    for i, path in enumerate(sb.paths):
        one = jf.read(os.path.join(path, 'smoke_000000'))
        np.testing.assert_array_equal(np.asarray(one.values.numpy('x,y')), np.asarray(g.values.numpy('b,x,y'))[i])
    sb.remove()
    assert not any(os.path.isdir(p) for p in sb.paths)


def test_scene_surface_matches_jax(tmp_path):
    """create, list, at, properties, write / read over frames, fieldnames,
    copy_calling_script, subpath and remove: a scene the port writes is the
    directory JAX's `Scene` reads, and the reverse."""
    rng = np.random.default_rng(4)
    for writer, reader in (('port', 'jax'), ('jax', 'port')):
        wm, wf = PKGS[writer]
        rm, rf = PKGS[reader]
        parent = str(tmp_path / writer)
        s0 = wf.Scene.create(parent, copy_calling_script=False, dt=0.5, name='run')
        s1 = wf.Scene.create(parent, copy_calling_script=True)
        assert [os.path.basename(s.path) for s in rf.Scene.list(parent)] == ['sim_000000', 'sim_000001']
        assert os.path.isfile(os.path.join(s1.path, 'src', os.path.basename(__file__)))
        frames = {}
        for frame in (0, 3):
            grids = _grids(wm, wf, rng)
            frames[frame] = grids
            s0.write(frame=frame, smoke=grids['centred'], velocity=grids['staggered'])
        s0.put_properties(steps=2)
        back = rf.Scene.at(parent, 0)
        assert back.properties == {'dt': 0.5, 'name': 'run', 'steps': 2}
        assert back.frames == (0, 3) and back.fieldnames == ('smoke', 'velocity')
        for frame, grids in frames.items():
            smoke, velocity = back.read('smoke', 'velocity', frame=frame)
            for got, ref in ((smoke, grids['centred']), (velocity, grids['staggered'])):
                for key, arr in _arrays(ref).items():
                    np.testing.assert_array_equal(_arrays(got)[key], arr)
        assert back.subpath('extra', create=True) == os.path.join(back.path, 'extra')
        assert os.path.isdir(back.subpath('extra'))
        s1.remove()
        assert not s1.exists and [s.path for s in rf.Scene.list(parent)] == [s0.path]
        with open(os.path.join(s0.path, 'description.json')) as fh:
            assert json.load(fh)['steps'] == 2


def test_benchmark():
    g = tf.CenteredGrid(tf.Noise(), tm.extrapolation.PERIODIC, x=16, y=16)
    per_step, state = utils.benchmark(lambda f: f * 1.001, (g,), n=3, warmup=1)
    assert per_step > 0 and isinstance(state, tuple) and state[0].resolution == g.resolution


def test_timer():
    with utils.Timer() as t:
        sum(range(1000))
    assert t.elapsed >= 0


def test_checkpoint_roundtrip(tmp_path):
    state = {'step': np.asarray(5), 'values': np.random.randn(4, 4).astype(np.float32)}
    path = utils.save_checkpoint(str(tmp_path / 'ckpt'), state)
    restored = utils.load_checkpoint(path, template=state)
    assert np.allclose(restored['values'], state['values'])
    assert not os.path.exists(path + '.tmp')


def test_checkpoint_manager(tmp_path):
    mgr = utils.CheckpointManager(str(tmp_path / 'runs'), max_to_keep=2)
    for step in range(3):
        mgr.save(step, {'w': np.full((2,), float(step), np.float32)})
    assert mgr.latest_step == 2 and mgr.all_steps() == [1, 2]
    restored = mgr.restore(template={'w': np.zeros((2,), np.float32)})
    assert np.allclose(restored['w'], 2.0)


def test_checkpoint_of_fields_on_a_device(tmp_path):
    """A state of Fields and torch tensors restores without a template, bit
    for bit, its arrays as torch tensors on the device asked for (numpy
    without one)."""
    rng = np.random.default_rng(5)
    grids = _grids(tm, tf, rng)
    state = (grids['staggered'], grids['centred'], torch.arange(4.))
    path = utils.save_checkpoint(str(tmp_path / 'fields'), state)
    v, s, t = utils.load_checkpoint(path, device='cpu')
    assert isinstance(t, torch.Tensor) and torch.equal(t, state[2])
    assert isinstance(s.values.native(), torch.Tensor)
    for got, ref in ((v, state[0]), (s, state[1])):
        assert got.is_staggered == ref.is_staggered and _boundary(got) == _boundary(ref)
        for key, arr in _arrays(ref).items():
            np.testing.assert_array_equal(_arrays(got)[key], arr)
    host = utils.load_checkpoint(path)
    assert isinstance(host[2], np.ndarray)


def test_profile_writes_a_trace(tmp_path):
    g = tf.CenteredGrid(tf.Noise(), tm.extrapolation.PERIODIC, x=8, y=8)
    result, log_dir = utils.profile_function(lambda f: f * 2., g, log_dir=str(tmp_path / 'trace'), runs=2)
    with open(os.path.join(log_dir, 'trace.json')) as fh:
        assert 'traceEvents' in json.load(fh)
    np.testing.assert_allclose(result.values.numpy('x,y'), g.values.numpy('x,y') * 2)


def test_entry_step_matches_jax():
    """`entry('cpu')` and `__graft_entry__.entry()`: the same initial state,
    and two steps within 2e-4 with equal CG counts."""
    from __graft_entry__ import entry as jax_entry
    jfn, jargs = jax_entry()
    fn, args = entry('cpu')
    assert all(a.values.native().device.type == 'cpu' for a in args[1:])

    def arrays(state):
        v, s, p = state
        return [np.asarray(v.vector[d].values.numpy('x,y,z')) for d in 'xyz'] + \
            [np.asarray(s.values.numpy('x,y,z')), np.asarray(p.values.numpy('x,y,z'))]
    for a, b in zip(arrays(args), arrays(jargs)):
        np.testing.assert_array_equal(a, b)
    jstep = jax.jit(jfn)
    with jm.SolveTape(record_runtime=True) as jtape:
        for _ in range(2):
            with tm.SolveTape() as tape:
                args = fn(*args)
            jargs = jstep(*jargs)
            jax.block_until_ready(jargs[2].values.native())
            assert tape[0].iterations == jtape.solve_infos[-1].runtime_stats['iterations']
    for a, b in zip(arrays(args), arrays(jargs)):
        assert np.abs(a - b).max() < 2e-4 * max(1.0, np.abs(b).max())
    assert np.abs(arrays(args)[3]).max() > 0

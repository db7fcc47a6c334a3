"""The port's grid models through their Field faces (`initial_state()` and
`step(...)` on Fields, JAX's signatures) against the JAX models' `step` on
the CPU, and bit-equal to the port's own array layer (`step_native`) with
equal CG counts: `LidDrivenCavity`, `MovingObstacles` and `SmokePlume`
(closed and periodic 3D, 2D; the fused `_fused_advect` on Fields against
JAX's in interpret mode). Also the crossing between array and Field state
(`state_fields` / `state_natives`, no copy) and `to_device`. State crosses
between the packages as numpy arrays."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiflow_tpu.math import SolveTape as JSolveTape, Tensor as JTensor, dual as jdual, stack as jstack
from phiflow_tpu.models import LidDrivenCavity as JaxCavity, MovingObstacles as JaxMovingObstacles
from phiflow_tpu.models import SmokePlume as JaxSmoke

import phiflow_tpu_torch.math as math
from phiflow_tpu_torch.field import Field
from phiflow_tpu_torch.field._field import face_components
from phiflow_tpu_torch.math import SolveTape
from phiflow_tpu_torch.models import LidDrivenCavity, MovingObstacles, SmokePlume, to_device
from phiflow_tpu_torch.models import state_from_numpy as smoke_from_numpy

SMOKE_CONFIGS = [dict(dims=3, resolution=16), dict(dims=3, resolution=16, periodic=True),
                 dict(dims=2, resolution=32)]
SMOKE_IDS = ['3d', '3d-periodic', '2d']


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with math.default_device('cpu'):
        yield


def _jax_components(field, names):
    return [np.asarray(field.vector[n].values.native(names)) for n in names]


def _jax_cells(field, names):
    return np.asarray(field.values.native(names))


def _scaled_error(got, ref):
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _equal(a, b):
    """Bit-equal nested tuples of tensors (NaN in the same places)."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and torch.equal(torch.nan_to_num(a, nan=7.), torch.nan_to_num(b, nan=7.)) \
            and torch.equal(torch.isnan(a), torch.isnan(b))
    return a is b


@contextlib.contextmanager
def _one_torch_thread():
    """The port's CPU twins in the calling thread alone. In a process that
    has imported JAX, `torch.sqrt` on the CPU has come out up to 3e-4
    relative off in some runs where PyTorch's worker threads shared the
    work; the calling thread computes it as everywhere else."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _jax_runtime_iterations(tape):
    return tape.solve_infos[-1].runtime_stats['iterations']


# ---------------------------------------------------------------------------
# LidDrivenCavity
# ---------------------------------------------------------------------------

def test_cavity_field_steps_match_jax_and_native():
    """LidDrivenCavity(32, obstacle=True) from rest, 3 steps: velocity and
    pressure within 1e-6 of JAX's; bit-equal to `step_native` from the array
    state with the same CG counts."""
    names = ('x', 'y')
    jm = JaxCavity(resolution=32, obstacle=True)
    model = LidDrivenCavity(resolution=32, obstacle=True, device='cpu')
    jstate, state, native = jm.initial_state(), model.initial_state(), model.initial_state_native()
    assert _equal(model.state_natives(*state), native)
    assert state[0].boundary == model.v0.boundary and state[1].boundary == model.p0.boundary
    jstep = jax.jit(jm.step)
    for _ in range(3):
        with SolveTape() as tape:
            state = model.step(*state)
        native = model.step_native(*native)
        jstate = jstep(*jstate)
        assert tape[0].iterations == model.last_solve.iterations and tape[0].converged
        assert _equal(model.state_natives(*state), native)
        for got, ref in zip(model.state_natives(*state)[0], _jax_components(jstate[0], names)):
            assert float(np.abs(got.numpy() - ref).max()) <= 1e-6
        assert float(np.abs(model.state_natives(*state)[1].numpy() - _jax_cells(jstate[1], names)).max()) <= 1e-6
    assert float(np.abs(native[0][0].numpy()).max()) > 0.01  # the lid has set the fluid in motion


# ---------------------------------------------------------------------------
# MovingObstacles
# ---------------------------------------------------------------------------

def test_moving_obstacles_field_steps_match_jax_and_native():
    """MovingObstacles(64, dt=0.5) from rest, 4 steps: each field within 5e-4
    of its scale of JAX's — the logged exception of the singular obstacle
    system (ROADMAP.md §3), every solve converged — and the obstacle centres
    equal; bit-equal to `step_native`, the same CG counts. The cuboid is
    JAX's `Cuboid(vec(x=20., y=80.), x=20., y=20.)`."""
    names = ('x', 'y')
    jm = JaxMovingObstacles(resolution=64, dt=0.5)
    model = MovingObstacles(resolution=64, dt=0.5, device='cpu')
    jstate, state, native = jm.initial_state(), model.initial_state(), model.initial_state_native()
    cuboid = state[2].geometry
    assert cuboid.center.tolist() == [20., 80.] and cuboid.half_size.tolist() == [20., 20.]
    assert cuboid.center.shape.get_labels('vector') == names
    jstep = jax.jit(lambda *s: jm.step(*s))
    for _ in range(4):
        with SolveTape() as tape:
            state = model.step(*state)
        native = model.step_native(*native)
        jstate = jstep(*jstate)
        assert tape[0].iterations == model.last_solve.iterations and tape[0].converged
        v, p, *obstacles = model.state_natives(*state)
        assert _equal((v, p), native[:2])
        for o, n, j in zip(obstacles, native[2:], jstate[2:]):
            assert np.array_equal(o.geometry.center.numpy(), n.geometry.center.numpy())
            assert np.array_equal(o.geometry.center.numpy(), np.asarray(j.geometry.center.native()))
        for got, ref in zip(v, _jax_components(jstate[0], names)):
            assert _scaled_error(got.numpy(), ref) <= 5e-4
        assert _scaled_error(p.numpy(), _jax_cells(jstate[1], names)) <= 5e-4
    assert [o.geometry.center.tolist() for o in state[2:]] == [[30., 80.], [22., 28.]]


# ---------------------------------------------------------------------------
# SmokePlume
# ---------------------------------------------------------------------------

def _smooth(shape, rng, amp, n):
    grids = np.meshgrid(*[np.arange(s) / n for s in shape], indexing='ij')
    out = np.zeros(shape)
    for _ in range(3):
        k = rng.integers(1, 3, len(shape))
        ph = rng.uniform(0, 2 * np.pi, len(shape))
        out += np.prod([np.sin(2 * np.pi * k[i] * grids[i] + ph[i]) for i in range(len(shape))], axis=0)
    return (amp * out / np.abs(out).max()).astype(np.float32)


def _smoke_arrays(model, seed, amp=1.2):
    """A smooth random (velocity components, smoke) in the model's layout."""
    rng = np.random.default_rng(seed)
    comps, cells = model._shapes()
    n = model._resolution
    return [_smooth(s, rng, amp, n) for s in comps], (0.5 + _smooth(cells, rng, 0.5, n)).astype(np.float32)


def _jax_smoke_state(jax_model, vel, smoke):
    names = tuple('xyz'[:len(vel)])
    v0, s0, p0 = jax_model.initial_state()
    comps = [JTensor(jnp.asarray(a), v0.vector[d].values.shape.only(names, reorder=True)) for d, a in zip(names, vel)]
    return (v0.with_values(jstack(comps, jdual(vector=list(names)))),
            s0.with_values(JTensor(jnp.asarray(smoke), s0.values.shape.only(names, reorder=True))), p0)


@pytest.mark.parametrize('kwargs', SMOKE_CONFIGS, ids=SMOKE_IDS)
def test_smoke_field_steps_match_jax_and_native(kwargs):
    """3 steps from a smooth random state carried across with
    `state_from_numpy` + `state_fields`: within 2e-4 of JAX's `step` (its
    per-phase path here, as the port's) with equal CG counts, and bit-equal
    to `step_native`."""
    kw = dict(kwargs, cg_tol=1e-5, max_iterations=200)
    jax_model, model = JaxSmoke(**kw), SmokePlume(device='cpu', **kw)
    names = tuple('xyz'[:model.dims])
    vel, smoke = _smoke_arrays(model, seed=3)
    pressure = np.zeros_like(smoke)
    native = smoke_from_numpy(*vel, smoke, pressure, device='cpu')
    state = model.state_fields(*smoke_from_numpy(*vel, smoke, pressure, device='cpu'))
    jstate = _jax_smoke_state(jax_model, vel, smoke)
    assert not model._fused_advect_available(*state[:2])
    with JSolveTape(record_runtime=True) as jtape:
        jstep = jax.jit(jax_model.step)
        for _ in range(3):
            with SolveTape() as tape:
                state = model.step(*state)
            native = model.step_native(*native)
            jstate = jstep(*jstate)
            jax.block_until_ready(jstate[2].values.native())
            assert tape[0].iterations == model.last_solve.iterations == _jax_runtime_iterations(jtape)
            assert _equal(model.state_natives(*state), native)
    v, s, p = model.state_natives(*state)
    for got, ref in zip(v, _jax_components(jstate[0], names)):
        assert float(np.abs(got.numpy() - ref).max()) < 2e-4
    assert float(np.abs(s.numpy() - _jax_cells(jstate[1], names)).max()) < 2e-4
    assert float(np.abs(p.numpy() - _jax_cells(jstate[2], names)).max()) < 2e-4
    assert float(s.max()) > 0.5


@pytest.mark.parametrize('periodic', [False, True], ids=['closed', 'periodic'])
def test_smoke_field_fused_advect_matches_pallas_model(periodic):
    """The Field `_fused_advect` at 64³ — K5's three calls, the plain twin on
    the CPU — against JAX's `_fused_advect(..., interpret=True)` on the same
    state, and bit-equal to `_fused_advect_native`."""
    kw = dict(dims=3, resolution=64, periodic=periodic)
    model = SmokePlume(device='cpu', **kw)
    vel, smoke = _smoke_arrays(model, seed=11, amp=1.8)
    native = smoke_from_numpy(*vel, smoke, smoke, device='cpu')
    v, s, _ = model.state_fields(*native)
    assert model._fused_advect_available(v, s)
    with _one_torch_thread():
        v_new, s_new = model._fused_advect(v, s)
        got_v, got_s, _ = model.state_natives(v_new, s_new, None)
        assert _equal((got_v, got_s), model._fused_advect_native(*native[:2]))
    jax_model = JaxSmoke(**kw)
    jv, js, _ = _jax_smoke_state(jax_model, vel, smoke)
    jv_new, js_new = jax_model._fused_advect(jv, js, interpret=True)
    names = ('x', 'y', 'z')
    assert float(np.abs(got_s.numpy() - _jax_cells(js_new, names)).max()) < 1.5e-6
    for got, ref in zip(got_v, _jax_components(jv_new, names)):
        assert got.shape == ref.shape
        assert float(np.abs(got.numpy() - ref).max()) < 1.5e-6


@pytest.mark.parametrize('kwargs,fused', [(dict(dims=3, resolution=32), False),
                                          (dict(dims=3, resolution=64), True),
                                          (dict(dims=3, resolution=64, periodic=True), True),
                                          (dict(dims=2, resolution=64), False)],
                         ids=['32-3d', '64-3d', '64-3d-periodic', '64-2d'])
def test_smoke_field_step_gate(monkeypatch, kwargs, fused):
    """The Field `step` takes the fused path exactly where `step_native`
    does; Fields outside the model's own layout (a smoke boundary it does not
    build) take the per-phase path."""
    model = SmokePlume(device='cpu', **kwargs)
    state = model.initial_state()
    assert model._fused_advect_available(*state[:2]) == fused \
        == model._fused_advect_available_native(*model.initial_state_native()[:2])
    calls = []

    def stub(name, result):
        def fn(*args):
            calls.append(name)
            return result
        return fn
    monkeypatch.setattr(model, '_fused_advect', stub('fused', (state[0], state[1])))
    monkeypatch.setattr(model, 'advect_smoke', stub('smoke', state[1]))
    monkeypatch.setattr(model, 'advect_velocity', stub('velocity', state[0]))
    monkeypatch.setattr(model, 'project', stub('project', (state[0], state[2])))
    model.step(*state)
    assert calls == (['fused', 'project'] if fused else ['smoke', 'velocity', 'project'])
    if fused:
        assert not model._fused_advect_available(state[0], state[1].with_boundary(0.))


# ---------------------------------------------------------------------------
# the crossing between array and Field state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('make', [lambda: SmokePlume(resolution=8, dims=3, device='cpu'),
                                  lambda: SmokePlume(resolution=8, dims=2, periodic=True, device='cpu'),
                                  lambda: LidDrivenCavity(resolution=8, device='cpu'),
                                  lambda: MovingObstacles(resolution=8, device='cpu')],
                         ids=['smoke-3d', 'smoke-2d-periodic', 'cavity', 'moving-obstacles'])
def test_state_fields_and_natives_share_the_tensors(make):
    """`initial_state()` holds contiguous CPU tensors equal to
    `initial_state_native()`; `state_fields` wraps the array state and
    `state_natives` returns the very same tensors."""
    model = make()
    state = model.initial_state()
    native = model.initial_state_native()
    assert _equal(model.state_natives(*state), native)
    fields = [f for f in state if isinstance(f, Field)]
    for f in fields:
        for t in (face_components(f.values) if f.is_staggered else (f.values,)):
            assert isinstance(t.native(), torch.Tensor) and t.native().is_contiguous() and t.device.type == 'cpu'
    back = model.state_natives(*model.state_fields(*native))
    flat = lambda s: [t for x in s for t in (x if isinstance(x, tuple) else (x,))]
    assert all(a is b for a, b in zip(flat(back), flat(native)))


def test_to_device_materialises_host_constants():
    """A Field of host constants becomes contiguous tensors on the device;
    tensors already there are kept; other objects pass."""
    model = SmokePlume(resolution=8, dims=3, device='cpu')
    v, s, p = to_device((model.velocity0, model.smoke0, model.pressure0), 'cpu')
    assert model.velocity0.values.components[0].is_host and not v.values.components[0].is_host
    assert v.values.components[0].native().stride() == (64, 8, 1)
    again = to_device((v, 'other'))
    assert again[0].values.components[2] is v.values.components[2] and again[1] == 'other'

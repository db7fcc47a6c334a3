"""The per-phase advection path of the port's `SmokePlume` (`advect_smoke`,
`advect_velocity`, whole steps) in 2D and 3D, closed and periodic box, against
the JAX `SmokePlume` on the CPU, where JAX takes its per-phase path too; the
port's periodic fused path against JAX's per-phase step; and the gate that
picks between the two paths."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phiflow_tpu.models import SmokePlume as JaxSmoke
from phiflow_tpu_torch.models import SmokePlume, state_from_numpy, state_to_numpy

CONFIGS = [dict(dims=3, resolution=16), dict(dims=2, resolution=32),
           dict(dims=3, resolution=16, periodic=True), dict(dims=2, resolution=32, periodic=True)]
IDS = ['3d', '2d', '3d-periodic', '2d-periodic']


def _names(dims):
    return tuple('xyz'[:dims])


def _smooth_arrays(model: SmokePlume, seed, amp=1.2):
    """A smooth random state in the model's layout: |v|·dt/dx ≤ 0.6 cells."""
    rng = np.random.default_rng(seed)
    N = model._resolution
    comps, cells = model._shapes()

    def field(shape, a):
        grids = np.meshgrid(*[np.arange(n) / N for n in shape], indexing='ij')
        out = np.zeros(shape)
        for _ in range(3):
            k = rng.integers(1, 3, len(shape))
            ph = rng.uniform(0, 2 * np.pi, len(shape))
            out += np.prod([np.sin(2 * np.pi * k[i] * grids[i] + ph[i]) for i in range(len(shape))], axis=0)
        return (a * out / np.abs(out).max()).astype(np.float32)
    return [field(s, amp) for s in comps], (0.5 + field(cells, 0.5)).astype(np.float32)


def _jax_state(jax_model, vel, smoke):
    """JAX Fields holding the given raw arrays (JAX's own layout)."""
    from phiflow_tpu.math import Tensor, dual, stack
    names = _names(len(vel))
    v0, s0, p0 = jax_model.initial_state()
    comps = [Tensor(jnp.asarray(a), v0.vector[d].values.shape.only(names, reorder=True))
             for d, a in zip(names, vel)]
    v = v0.with_values(stack(comps, dual(vector=list(names))))
    s = s0.with_values(Tensor(jnp.asarray(smoke), s0.values.shape.only(names, reorder=True)))
    return v, s, p0


def _jax_arrays(jv, js):
    names = _names(len(js.values.shape.spatial.names))
    return ([np.asarray(jv.vector[d].values.native(names)) for d in names],
            np.asarray(js.values.native(names)))


def _max_err(got, ref):
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max())


@pytest.mark.parametrize('kwargs', CONFIGS, ids=IDS)
def test_advection_phases_match_jax(kwargs):
    """`advect_smoke` and `advect_velocity` on a smooth random state, 1e-5:
    both sides run the same float32 arithmetic up to summation order."""
    jax_model = JaxSmoke(**kwargs)
    model = SmokePlume(device='cpu', **kwargs)
    vel, smoke = _smooth_arrays(model, seed=3)
    jv, js, _ = _jax_state(jax_model, vel, smoke)
    tv, ts, _ = state_from_numpy(*vel, smoke, smoke, device='cpu')
    js_new = jax_model.advect_smoke(jv, js)
    ts_new = model.advect_smoke_native(tv, ts)
    jv_new = jax_model.advect_velocity(jv, js_new)
    tv_new = model.advect_velocity_native(tv, ts_new)
    ref_v, ref_s = _jax_arrays(jv_new, js_new)
    assert _max_err(ts_new.numpy(), ref_s) < 1e-5
    for d in range(model.dims):
        assert _max_err(tv_new[d].numpy(), ref_v[d]) < 1e-5, d


@pytest.mark.parametrize('kwargs', CONFIGS, ids=IDS)
def test_three_steps_match_jax(kwargs):
    """3 whole steps from rest (per-phase on both sides), cg_tol 1e-5: every
    state array within 2e-4 and the projection's CG iteration counts equal."""
    from phiflow_tpu.math import SolveTape
    kw = dict(kwargs, cg_tol=1e-5, max_iterations=200)
    jax_model = JaxSmoke(**kw)
    model = SmokePlume(device='cpu', **kw)
    jv, js, jp = jax_model.initial_state()
    v, s, p = model.initial_state_native()
    names = _names(model.dims)
    for _ in range(3):
        with SolveTape(record_runtime=True) as tape:
            jv, js, jp = jax_model.step(jv, js, jp)
        v, s, p = model.step_native(v, s, p)
        assert model.last_solve.iterations == tape.solve_infos[-1].runtime_stats['iterations']
    ref_v, ref_s = _jax_arrays(jv, js)
    *got_v, got_s, got_p = state_to_numpy((v, s, p))
    assert _max_err(got_s, ref_s) < 2e-4
    assert _max_err(got_p, np.asarray(jp.values.native(names))) < 2e-4
    for d in range(model.dims):
        assert _max_err(got_v[d], ref_v[d]) < 2e-4, d
    assert float(s.max()) > 0.5  # the inflow has filled in
    assert all(bool(torch.isfinite(t).all()) for t in (*v, s, p))


def test_fused_periodic_step_matches_jax_per_phase():
    """The port's fused path with `periodic=True` at 64³, one step's advection
    from a non-trivial state, against JAX's per-phase result for the same
    state within 2e-5 — the tolerance at which the JAX suite holds its own
    fused path to its per-phase path."""
    kw = dict(dims=3, resolution=64, periodic=True)
    jax_model = JaxSmoke(**kw)
    model = SmokePlume(device='cpu', **kw)
    vel, smoke = _smooth_arrays(model, seed=5, amp=1.8)
    jv, js, _ = _jax_state(jax_model, vel, smoke)
    tv, ts, _ = state_from_numpy(*vel, smoke, smoke, device='cpu')
    assert model._fused_advect_available_native(tv, ts)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # torch.sqrt in shared worker threads ran off after JAX's import (ROADMAP §3)
    try:
        tv_new, ts_new = model._fused_advect_native(tv, ts)
    finally:
        torch.set_num_threads(threads)
    js_new = jax_model.advect_smoke(jv, js)
    jv_new = jax_model.advect_velocity(jv, js_new)
    ref_v, ref_s = _jax_arrays(jv_new, js_new)
    assert _max_err(ts_new.numpy(), ref_s) < 2e-5
    for d in range(3):
        assert _max_err(tv_new[d].numpy(), ref_v[d]) < 2e-5, d


@pytest.mark.parametrize('kwargs,fused', [(dict(dims=3, resolution=32), False),
                                          (dict(dims=3, resolution=64), True),
                                          (dict(dims=3, resolution=64, periodic=True), True),
                                          (dict(dims=3, resolution=64, max_cells=8), False),
                                          (dict(dims=2, resolution=64), False)],
                         ids=['3d-32', '3d-64', '3d-64-periodic', '3d-64-K8', '2d-64'])
def test_step_gate(monkeypatch, kwargs, fused):
    """`step` takes the fused path exactly where JAX's gate does (3D,
    `max_cells` set, a grid `ops/advect3d.py::supported` takes) and the
    per-phase path otherwise."""
    from phiflow_tpu.ops import advect3d as jadvect3d
    N = (kwargs['resolution'],) * kwargs['dims']
    assert fused == (kwargs['dims'] == 3 and jadvect3d.supported(N, kwargs.get('max_cells', 1)))
    model = SmokePlume(device='cpu', **kwargs)
    calls = []
    state = model.initial_state_native()

    def stub(name, result):
        def fn(*args):
            calls.append(name)
            return result
        return fn
    monkeypatch.setattr(model, '_fused_advect_native', stub('fused', (state[0], state[1])))
    monkeypatch.setattr(model, 'advect_smoke_native', stub('smoke', state[1]))
    monkeypatch.setattr(model, 'advect_velocity_native', stub('velocity', state[0]))
    monkeypatch.setattr(model, 'project_native', stub('project', (state[0], state[2])))
    model.step_native(*state)
    assert calls == (['fused', 'project'] if fused else ['smoke', 'velocity', 'project'])


@pytest.mark.parametrize('kwargs', CONFIGS, ids=IDS)
def test_state_layout_and_round_trip(kwargs):
    model = SmokePlume(device='cpu', **kwargs)
    jv, js, jp = JaxSmoke(**kwargs).initial_state()
    ref_v, ref_s = _jax_arrays(jv, js)
    v, s, p = model.initial_state_native()
    assert [tuple(c.shape) for c in v] == [a.shape for a in ref_v]
    assert tuple(s.shape) == tuple(p.shape) == ref_s.shape
    vel, smoke = _smooth_arrays(model, seed=9)
    state = state_from_numpy(*vel, smoke, smoke, device='cpu')
    assert all(np.array_equal(a, b) for a, b in zip((*vel, smoke, smoke), state_to_numpy(state)))
    with pytest.raises(ValueError, match='layout'):
        model.step_native(tuple(c[..., :-1] for c in state[0]), state[1], state[2])

"""Batched smoke in the port against the JAX package, on the CPU:
`SmokePlume(16, dims=3, batch_shape=batch(b=2))` through its Field `step`
from two distinct smooth states (numpy, one a batch entry), 2 steps within
2e-4 of JAX's jitted `step` with equal CG counts, bit-equal to `step_native`
on the arrays, each entry within 1e-6 of the port's own unbatched step on
that entry; and the recipe of
`examples/batched_smoke.py` (a batch dim of four inflow rates through
MacCormack, buoyancy, self-advection and the projection) at 32² against the
same recipe in JAX, with the example's assert that a stronger inflow holds
more smoke."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.math import SolveTape as JSolveTape, Tensor as JTensor
from phiflow_tpu.models import SmokePlume as JaxSmoke

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.math import SolveTape
from phiflow_tpu_torch.models import SmokePlume, state_from_numpy

B = 2


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _smooth(shape, rng, amp, n):
    grids = np.meshgrid(*[np.arange(s) / n for s in shape], indexing='ij')
    out = np.zeros(shape)
    for _ in range(3):
        k = rng.integers(1, 3, len(shape))
        ph = rng.uniform(0, 2 * np.pi, len(shape))
        out += np.prod([np.sin(2 * np.pi * k[i] * grids[i] + ph[i]) for i in range(len(shape))], axis=0)
    return (amp * out / np.abs(out).max()).astype(np.float32)


def _state(model, seed):
    """A smooth random (velocity components, smoke) in the model's unbatched layout."""
    rng = np.random.default_rng(seed)
    comps, cells = model._shapes()
    n = model._resolution
    return [_smooth(s, rng, 1.2, n) for s in comps], (0.5 + _smooth(cells, rng, 0.5, n)).astype(np.float32)


def _scaled(got, ref):
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def _jax_state(jax_model, vel, smoke, pressure):
    """JAX's Fields from the batched numpy arrays (batch dim `b` first)."""
    names = tuple('xyz'[:len(vel)])
    v0, s0, p0 = jax_model.initial_state()

    def values(arr, like):
        return JTensor(jnp.asarray(arr), jm.batch(b=arr.shape[0]) & like.shape.only(names, reorder=True))
    comps = [values(a, v0.vector[d].values) for d, a in zip(names, vel)]
    return (v0.with_values(jm.stack(comps, jm.dual(vector=list(names)))), s0.with_values(values(smoke, s0.values)),
            p0.with_values(values(pressure, p0.values)))


def test_batched_smoke_plume_matches_jax_and_entries():
    """Two Field steps of the batched 16³ closed-box plume from distinct
    states: within 2e-4 of JAX's with equal CG counts (JAX's, like the port's,
    one loop for both systems: the larger count), the per-phase path (JAX's
    gate refuses batch dims), bit-equal to `step_native` on the arrays with
    a leading batch axis, and each entry as the port's unbatched step."""
    kw = dict(resolution=16, dims=3, cg_tol=1e-5, max_iterations=200)
    jax_model = JaxSmoke(batch_shape=jm.batch(b=B), **kw)
    model = SmokePlume(batch_shape=tm.batch(b=B), device='cpu', **kw)
    single = SmokePlume(device='cpu', **kw)
    entries = [_state(model, seed) for seed in (3, 4)]
    vel = [np.stack([e[0][d] for e in entries]) for d in range(3)]
    smoke = np.stack([e[1] for e in entries])
    pressure = np.zeros_like(smoke)
    state = model.state_fields(*state_from_numpy(*vel, smoke, pressure, device='cpu'))
    native = state_from_numpy(*vel, smoke, pressure, device='cpu')
    assert state[1].values.shape.get_size('b') == B and not model._fused_advect_available(*state[:2])
    jstate = _jax_state(jax_model, vel, smoke, pressure)
    jstep = jax.jit(jax_model.step)
    singles = [single.state_fields(*state_from_numpy(*v, s, np.zeros_like(s), device='cpu')) for v, s in entries]
    with JSolveTape(record_runtime=True) as jtape:
        for _ in range(2):
            with SolveTape() as tape:
                state = model.step(*state)
            native = model.step_native(*native)
            assert model.last_solve.iterations == tape[0].iterations
            jstate = jstep(*jstate)
            jax.block_until_ready(jstate[2].values.native())
            counts = []
            for e in range(B):
                with SolveTape() as etape:
                    singles[e] = single.step(*singles[e])
                counts.append(etape[0].iterations)
            assert tape[0].iterations == int(np.max(jtape.solve_infos[-1].runtime_stats['iterations'])) == max(counts)
    names = ('x', 'y', 'z')
    v, s, p = model.state_natives(*state)
    for got, ref in zip((*v, s, p), (*native[0], native[1], native[2])):  # the array layer, bit for bit
        assert torch.equal(got, ref)
    for d, got in enumerate(v):
        assert _scaled(got.numpy(), np.asarray(jstate[0].vector[names[d]].values.native(('b',) + names))) < 2e-4
    assert _scaled(s.numpy(), np.asarray(jstate[1].values.native(('b',) + names))) < 2e-4
    assert _scaled(p.numpy(), np.asarray(jstate[2].values.native(('b',) + names))) < 2e-4
    for e in range(B):
        ve, se, pe = single.state_natives(*singles[e])
        for got, ref in zip((*v, s, p), (*ve, se, pe)):
            assert got.shape[0] == B and _scaled(got[e].numpy(), ref.numpy()) <= 1e-6
    assert float(s.max()) > 0.5


def _recipe(flow, N, steps, rates, jit):
    """examples/batched_smoke.py's recipe on the names of `flow` (the JAX package's or the port's)."""
    bounds = flow.Box(x=float(N), y=float(N))
    velocity = flow.StaggeredGrid(0.0, flow.extrapolation.ZERO, x=N, y=N, bounds=bounds)
    smoke = flow.CenteredGrid(0.0, flow.extrapolation.ZERO_GRADIENT, x=N, y=N, bounds=bounds)
    inflow = flow.resample(flow.Sphere(x=N / 2, y=6, radius=4), to=smoke, soft=True) * \
        flow.wrap(list(rates), flow.batch('inflow_rate'))

    def step(v, s, dt=1.0):
        s = flow.advect.mac_cormack(s, v, dt) + dt * inflow
        buoyancy = flow.resample(s * (0.0, 0.1), to=v)
        v = flow.advect.semi_lagrangian(v, v, dt) + dt * buoyancy
        v, _ = flow.fluid.make_incompressible(v, (), flow.Solve('CG', 1e-3, 0.,
                                                                suppress=(flow.ConvergenceException,)))
        return v, s
    step = jax.jit(step) if jit else step
    for _ in range(steps):
        velocity, smoke = step(velocity, smoke)
    return np.asarray(smoke.values.numpy(('inflow_rate', 'x', 'y')))


class _Names:
    """The names the recipe uses, from one package."""

    def __init__(self, field, geom, math, physics):
        self.Box, self.Sphere = geom.Box, geom.Sphere
        self.StaggeredGrid, self.CenteredGrid, self.resample = field.StaggeredGrid, field.CenteredGrid, field.resample
        self.extrapolation, self.wrap, self.batch = math.extrapolation, math.wrap, math.batch
        self.Solve, self.ConvergenceException = math.Solve, math.ConvergenceException
        self.advect, self.fluid = physics.advect, physics.fluid


def test_batched_smoke_recipe_matches_jax():
    """The recipe at 32² with the example's four inflow rates, 8 steps: the
    smoke of every entry within 1e-4 of JAX's scale, and the example's
    assert: the total smoke grows with the inflow rate."""
    import phiflow_tpu.field as jf
    import phiflow_tpu.geom as jg
    import phiflow_tpu.physics as jp
    import phiflow_tpu_torch.field as tf
    import phiflow_tpu_torch.geom as tg
    import phiflow_tpu_torch.physics as tp
    rates = (0.2, 0.5, 1.0, 2.0)
    got = _recipe(_Names(tf, tg, tm, tp), 32, 8, rates, jit=False)
    ref = _recipe(_Names(jf, jg, jm, jp), 32, 8, rates, jit=True)
    assert got.shape == ref.shape == (4, 32, 32)
    assert _scaled(got, ref) <= 1e-4
    totals = got.sum(axis=(1, 2))
    assert all(totals[i] < totals[i + 1] for i in range(len(totals) - 1)), totals

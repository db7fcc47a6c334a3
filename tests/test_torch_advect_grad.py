"""Gradients through the port's advection (`physics/advect.py`:
`semi_lagrangian`, `mac_cormack`) and through 2 steps of `SmokePlume`
(advection through the window interpolation and its backward, the
projection through the implicit CG), against `jax.grad` of the JAX
package's functions and model on the same numpy state, on the CPU: from
rest (every displacement 0, the window's kinks; the MacCormack clamp's ties
in zero-smoke regions) and from a smooth random state. Tolerance: 1e-4 of
each gradient's largest entry (the solves converge to 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiflow_tpu.models import SmokePlume as JaxSmoke
from phiflow_tpu.physics import advect as jadvect
import phiflow_tpu_torch.math as math
from phiflow_tpu_torch.field import CenteredGrid, StaggeredGrid
from phiflow_tpu_torch.field._field import face_components
from phiflow_tpu_torch.geom import Box
from phiflow_tpu_torch.math import dual, extrapolation, spatial, stack
from phiflow_tpu_torch.models import SmokePlume
from phiflow_tpu_torch.physics import advect

from test_torch_field_paths import _jax_fields, _names, _state_arrays

TOL = 1e-4
CONFIGS = {'3d-16': dict(dims=3, resolution=16, cg_tol=1e-6, max_iterations=500),
           '2d-32': dict(dims=2, resolution=32, cg_tol=1e-6, max_iterations=500)}


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with math.default_device('cpu'):
        yield


def _fields(vel, smoke, pressure, periodic, size):
    """The port's (velocity, smoke, pressure) Fields on torch tensors, kept as they are."""
    names = _names(len(vel))
    bounds = Box(**{n: float(size) for n in names})
    res = {n: smoke.shape[i] for i, n in enumerate(names)}
    v = StaggeredGrid(stack([math.wrap(a, spatial(*names)) for a in vel], dual(vector=names)),
                      extrapolation.PERIODIC if periodic else 0., bounds=bounds, **res)
    ext = extrapolation.PERIODIC if periodic else extrapolation.BOUNDARY
    return (v, CenteredGrid(math.wrap(smoke, spatial(*names)), ext, bounds=bounds, **res),
            CenteredGrid(math.wrap(pressure, spatial(*names)), ext, bounds=bounds, **res))


def _states(model, seed):
    """From rest (the model's initial state) and a smooth random state."""
    comps, cells = model._shapes()
    rest = ([np.zeros(s, np.float32) for s in comps], np.zeros(cells, np.float32))
    return {'rest': rest, 'random': _state_arrays(model, seed, amp=1.4)}


def _close(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g - r).max() <= TOL * max(np.abs(r).max(), 1e-12), (np.abs(g - r).max(), np.abs(r).max())


def _port_grads(model, vel, smoke, loss):
    tv = [torch.tensor(a, requires_grad=True) for a in vel]
    ts = torch.tensor(smoke, requires_grad=True)
    v, s, p = _fields(tv, ts, torch.zeros(smoke.shape), model.periodic, model._resolution)
    loss(v, s, p).backward()
    return [t.grad.numpy() for t in (*tv, ts)]


@pytest.mark.parametrize('config', list(CONFIGS))
def test_advection_gradients_match_jax(config):
    """`mac_cormack` of the velocity and `semi_lagrangian` of the smoke by the
    velocity with max_cells 2 (the rollout below takes the other pairing at
    max_cells 1): the gradient of a weighted sum of both results with
    respect to the velocity and the smoke."""
    kwargs = CONFIGS[config]
    model, jax_model = SmokePlume(device='cpu', **kwargs), JaxSmoke(**kwargs)
    names = _names(model.dims)
    cases = [('mac_cormack', 2, 'velocity'), ('semi_lagrangian', 2, 'smoke')]
    rng = np.random.default_rng(1)
    comps, cells = model._shapes()
    weights = [[rng.standard_normal(cells if kind == 'smoke' else c).astype(np.float32)
                for c in ([None] if kind == 'smoke' else comps)] for _, _, kind in cases]

    def values(field, values_of):
        return [values_of(field)] if not field.is_staggered else [values_of(field.vector[d]) for d in names]

    def jloss(vel, smoke):
        jv, js, _ = _jax_fields(jax_model, vel, smoke, smoke)
        total = 0.
        for (scheme, max_cells, kind), ws in zip(cases, weights):
            out = getattr(jadvect, scheme)(js if kind == 'smoke' else jv, jv, model.dt, max_cells=max_cells)
            total = total + sum(jnp.sum(o * w) for o, w in zip(values(out, lambda f: f.values.native(names)), ws))
        return total

    def loss(v, s, _):
        total = 0.
        for (scheme, max_cells, kind), ws in zip(cases, weights):
            out = getattr(advect, scheme)(s if kind == 'smoke' else v, v, model.dt, max_cells=max_cells)
            total = total + sum((o * torch.from_numpy(w)).sum()
                                for o, w in zip(values(out, lambda f: f.values.torch(names)), ws))
        return total

    grad = jax.jit(jax.grad(jloss, argnums=(0, 1)))
    for vel, smoke in _states(model, 11).values():
        jg = grad([jnp.asarray(a) for a in vel], jnp.asarray(smoke))
        _close(_port_grads(model, vel, smoke, loss), [*jg[0], jg[1]])


@pytest.mark.parametrize('config', list(CONFIGS))
def test_smoke_rollout_gradient_matches_jax(config):
    """2 steps of `SmokePlume.step` (per-phase: MacCormack smoke, inflow,
    self-advection, buoyancy, projection), loss Σ w·smoke + Σ w·v_x at the
    end, its gradient with respect to the initial velocity and smoke."""
    kwargs = CONFIGS[config]
    model, jax_model = SmokePlume(device='cpu', **kwargs), JaxSmoke(**kwargs)
    names = _names(model.dims)
    comps, cells = model._shapes()
    rng = np.random.default_rng(2)
    w_s, w_v = rng.standard_normal(cells).astype(np.float32), rng.standard_normal(comps[0]).astype(np.float32)
    zeros = np.zeros(cells, np.float32)

    def jloss(vel, smoke):
        v, s, p = _jax_fields(jax_model, vel, smoke, zeros)
        for _ in range(2):
            v, s, p = jax_model.step(v, s, p)
        return jnp.sum(s.values.native(names) * w_s) + jnp.sum(v.vector[names[0]].values.native(names) * w_v)

    def loss(v, s, p):
        for _ in range(2):
            v, s, p = model.step(v, s, p)
        return ((s.values.torch(names) * torch.from_numpy(w_s)).sum()
                + (face_components(v.values)[0].torch(names) * torch.from_numpy(w_v)).sum())

    grad = jax.jit(jax.grad(jloss, argnums=(0, 1)))
    for vel, smoke in _states(model, 3).values():
        jg = grad([jnp.asarray(a) for a in vel], jnp.asarray(smoke))
        _close(_port_grads(model, vel, smoke, loss), [*jg[0], jg[1]])


def test_differentiated_step_leaves_the_fused_path():
    """K5 has no backward: the fused gate says no under grad mode when the
    state requires grad, and yes otherwise (decided by grad mode alone)."""
    model = SmokePlume(64, dims=3, device='cpu')
    velocity, smoke, _ = model.initial_state_native()
    assert model._fused_advect_available_native(velocity, smoke)
    leaves = tuple(c.clone().requires_grad_() for c in velocity)
    assert not model._fused_advect_available_native(leaves, smoke)
    with torch.no_grad():
        assert model._fused_advect_available_native(leaves, smoke)
    v, s, _ = model.state_fields(leaves, smoke, None)
    assert not model._fused_advect_available(v, s)

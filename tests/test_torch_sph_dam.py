"""The port's `SphDamBreak` against the JAX package's on the CPU.

`rho0` within 1e-6 relative at nx=20, ny=40 (the JAX suite's size) and at
the default 50 × 200. From the same initial state: at nx=20, ny=40, 5 steps
within 1e-6 in positions and 2e-4 in velocities; at the default, step 1
only, within 2e-6 and 2e-4 — its block is taller than the box, the cell
list drops 3688 particles at step 0 and the first step clips them onto
y = 1.02, after which a 1e-7 perturbation of the positions moves the
velocities by O(1) in the JAX package itself. Then the port's analogue of
`tests/physics/test_sph_e2e.py::test_dam_break_smoke` (300 steps)."""
import jax
import numpy as np
import pytest
import torch

from phiflow_tpu.models import SphDamBreak as JaxSphDamBreak

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.field import Field
from phiflow_tpu_torch.geom import Sphere
from phiflow_tpu_torch.models import SphDamBreak

SIZES = {'20x40': dict(nx=20, ny=40), 'default': dict()}


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


@pytest.fixture(scope='module')
def models():
    return {name: (JaxSphDamBreak(**kw), SphDamBreak(**kw, device='cpu')) for name, kw in SIZES.items()}


def _state(particles, native=lambda t: np.asarray(t.native(('points', 'vector')))):
    return native(particles.geometry.center), native(particles.values)


@pytest.mark.parametrize('size', list(SIZES))
def test_rest_density(models, size):
    jax_model, model = models[size]
    assert model.n_particles == jax_model.n_particles
    assert model.support == jax_model.support
    assert abs(model.rho0 - jax_model.rho0) <= 1e-6 * jax_model.rho0


@pytest.mark.parametrize('size,steps,pos_tol', [('20x40', 5, 1e-6), ('default', 1, 2e-6)])
def test_steps_match_jax(models, size, steps, pos_tol):
    jax_model, model = models[size]
    (jp,), (p,) = jax_model.initial_state(), model.initial_state()
    np.testing.assert_array_equal(p.geometry.center.numpy(('points', 'vector')),
                                  np.asarray(jp.geometry.center.native(('points', 'vector'))))
    jax_step = jax.jit(jax_model.step)
    for k in range(steps):
        (jp,), (p,) = jax_step(jp), model.step(p)
        ref_pos, ref_vel = _state(jp)
        pos, vel = _state(p, lambda t: t.numpy(('points', 'vector')))
        assert np.isfinite(pos).all() and np.isfinite(vel).all()
        np.testing.assert_allclose(pos, ref_pos, rtol=0, atol=pos_tol, err_msg=f'positions, step {k + 1}')
        np.testing.assert_allclose(vel, ref_vel, rtol=0, atol=2e-4, err_msg=f'velocities, step {k + 1}')
    assert np.abs(vel).max() > 1e-3  # the block moved


def test_initial_state_is_a_point_cloud(models):
    """JAX's Field: spheres of radius dx/2 at the lattice, values (0, 0), on the model's device."""
    _, model = models['20x40']
    (p,) = model.initial_state()
    assert isinstance(p, Field) and isinstance(p.geometry, Sphere)
    assert float(p.geometry.radius) == pytest.approx(0.004)
    assert p.geometry.center.shape.get_size('points') == 800 and p.geometry.center.native().device.type == 'cpu'
    assert p.values.shape.get_labels('vector') == ('x', 'y') and not p.values.numpy().any()


def test_runs_on_the_card_unless_told():
    """Without a card the model raises rather than falling back to the CPU."""
    if torch.cuda.is_available():
        assert SphDamBreak(nx=4, ny=4).device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            SphDamBreak(nx=4, ny=4)


def test_dam_break_smoke():
    """300 steps at nx=20, ny=40: finite, contained, and the column has started to drop."""
    model = SphDamBreak(nx=20, ny=40, device='cpu')
    (p,) = model.initial_state()
    for _ in range(300):
        (p,) = model.step(p)
    pos = p.geometry.center.numpy(('points', 'vector'))
    assert np.isfinite(pos).all()
    assert pos.min() > -0.05 and pos.max() < 1.05
    assert pos[:, 1].mean() < 0.05 + 40 * 0.008 / 2, "the column should start collapsing within 300 steps"

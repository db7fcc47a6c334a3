"""The port's 2D obstacle models (`models/moving_obstacle.py`, `models/cavity.py`)
and the pieces only they use (`PerSide`, `diffuse.explicit_native`) against the JAX
package on the CPU, and the obstacle inputs of `tests/golden/golden.npz`
through both packages in float32. State crosses between the packages as numpy
arrays and the obstacles' plain numbers."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiflow_tpu.field import StaggeredGrid
from phiflow_tpu.geom import Box as JBox, Sphere as JSphere
from phiflow_tpu.math import ConvergenceException, Solve, Tensor, dual, extrapolation, spatial, stack, vec
from phiflow_tpu.models import LidDrivenCavity as JaxCavity, MovingObstacles as JaxMovingObstacles
from phiflow_tpu.physics import advect as jax_advect, diffuse as jax_diffuse, fluid as jax_fluid

from phiflow_tpu_torch.field import divergence_native, face_layout, geometry_mask, cell_grid
from phiflow_tpu_torch.geom import Sphere, UniformGrid_native, union
from phiflow_tpu_torch.math import PerSide
from phiflow_tpu_torch.math._nd import pad
from phiflow_tpu_torch.models import LidDrivenCavity, MovingObstacles, cavity, moving_obstacle
from phiflow_tpu_torch.physics import advect, diffuse, fluid
from phiflow_tpu_torch.physics.fluid import Obstacle

NAMES = ('x', 'y')
GOLDEN = os.path.join(os.path.dirname(__file__), 'golden', 'golden.npz')


def _components(field):
    return [np.asarray(field.vector[n].values.native(NAMES)) for n in NAMES]


def _native(field):
    return np.asarray(field.values.native(NAMES))


def _scaled_error(got, ref):
    """max |got − ref| over the largest magnitude of ref."""
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


# ---------------------------------------------------------------------------
# MovingObstacles
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def moving_trajectory():
    """Four steps of MovingObstacles(64) from rest in both packages."""
    jm = JaxMovingObstacles(resolution=64, dt=0.5)
    model = MovingObstacles(resolution=64, dt=0.5, device='cpu')
    jstate, state = jm.initial_state(), model.initial_state_native()
    step = jax.jit(lambda *s: jm.step(*s))
    states, solves = [], []
    for _ in range(4):
        jstate, state = step(*jstate), model.step_native(*state)
        states.append((jstate, state))
        solves.append(model.last_solve)
    return model, states, solves


def test_moving_obstacles_four_steps_match_jax(moving_trajectory):
    """After 4 steps at 64²: velocity and pressure within 5e-4 absolute,
    obstacle centres within 1e-4 (they are equal). The steps along the way
    within 5e-4 of the field's scale (max |v| ≈ 9, max |p| 16–98) — a
    documented exception, logged in ROADMAP.md §3 under the singular obstacle
    system: steps 2 and 3 miss 5e-4 absolute (1.03e-3 in the velocity, 5.7e-3
    in the pressure at step 2), because the model's rel_tol 1e-4 lies within a
    factor of ten of the residual floor that the plain-mean handling leaves in
    float32, where the two packages' CG roundoff shows most."""
    model, states, solves = moving_trajectory
    assert all(r.converged and 0 < r.iterations < model.max_iterations for r in solves), solves
    for jstate, state in states:
        for got, ref in zip(state[0], _components(jstate[0])):
            assert _scaled_error(got.numpy(), ref) <= 5e-4
        assert _scaled_error(state[1].numpy(), _native(jstate[1])) <= 5e-4
    jstate, state = states[-1]
    velocity, pressure, centres = moving_obstacle.state_to_numpy(state)
    for got, ref in zip(velocity, _components(jstate[0])):
        assert float(np.abs(got - ref).max()) <= 5e-4
        assert float(np.abs(ref).max()) > 1.0  # the obstacles set the fluid in motion
    assert float(np.abs(pressure - _native(jstate[1])).max()) <= 5e-4
    ref_centres = np.stack([np.asarray(o.geometry.center.native()) for o in jstate[2:]])
    assert float(np.abs(centres - ref_centres).max()) <= 1e-4
    # cuboid: +x at 5 per unit time, dt = 0.5, 4 steps → +10; sphere: (1, 4) → (+2, +8)
    np.testing.assert_allclose(centres, [[30., 80.], [22., 28.]], atol=1e-4)
    assert float(state[3].angular_velocity) == 0.5 and state[3].velocity.tolist() == [1., 4.]


def test_moving_obstacles_projection_is_divergence_free_outside(moving_trajectory):
    """The JAX suite's check: velocities are O(5), the masked CG runs at rel_tol 1e-4."""
    model, states, _ = moving_trajectory
    v, p, o1, o2 = states[-1][1]
    div = divergence_native(v, model._dx, face_layout(True, 2))
    hard = geometry_mask(union(o1.geometry, o2.geometry), cell_grid((64, 64), model._dx, 'cpu'))
    assert float((div.abs() * (1 - hard)).max()) < 2e-2
    assert 0 < hard.sum() < hard.numel()


def test_moving_obstacle_wraps_periodically():
    """20 + 5 · 0.5 · 40 = 120 → wraps to 20; the centre equals the JAX model's."""
    model = MovingObstacles(resolution=32, dt=0.5, device='cpu')
    jm = JaxMovingObstacles(resolution=32, dt=0.5)
    o1, jo1 = model.initial_state_native()[2], jm.initial_state()[2]
    for _ in range(40):
        o1, jo1 = model.move_obstacle(o1), jm.move_obstacle(jo1)
    np.testing.assert_allclose(o1.geometry.center, [20., 80.], atol=1e-3)
    assert np.array_equal(o1.geometry.center, np.asarray(jo1.geometry.center.native()))


def test_moving_obstacles_state_round_trip_and_default_device(monkeypatch):
    model = MovingObstacles(resolution=16, device='cpu')
    rng = np.random.default_rng(0)
    arrays = ([rng.standard_normal((16, 16)).astype(np.float32) for _ in range(2)], rng.standard_normal((16, 16)))
    obstacles = (model.obstacles0[0].at((31., 42.)), model.obstacles0[1].at((5., 6.)))
    state = moving_obstacle.state_from_numpy(*arrays, obstacles, device='cpu')
    assert len(state) == 4 and all(t.dtype == torch.float32 for t in (*state[0], state[1]))
    velocity, pressure, centres = moving_obstacle.state_to_numpy(state)
    assert all(np.array_equal(a, b) for a, b in zip(velocity, arrays[0]))
    assert np.array_equal(pressure, arrays[1].astype(np.float32))
    assert centres.tolist() == [[31., 42.], [5., 6.]]
    assert state[2].velocity.tolist() == [5., 0.] and state[2].geometry.half_size.tolist() == [20., 20.]
    out = model.step_native(*state)
    assert len(out) == 4 and all(bool(torch.isfinite(t).all()) for t in (*out[0], out[1]))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for make in (MovingObstacles, LidDrivenCavity):
        with pytest.raises(RuntimeError, match='CUDA'):
            make(16)
    with pytest.raises(RuntimeError, match='CUDA'):
        cavity.state_from_numpy(arrays[0], arrays[1])
    # the grids a caller builds for `geometry_mask` go to the card by default too
    with pytest.raises(RuntimeError, match='CUDA'):
        cell_grid((16, 16), 1.0)
    with pytest.raises(RuntimeError, match='CUDA'):
        UniformGrid_native((16, 16), (0., 0.), (16., 16.))
    assert cell_grid((16, 16), 1.0, 'cpu').center[0].device.type == 'cpu'


# ---------------------------------------------------------------------------
# LidDrivenCavity and its pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('obstacle', [True, False], ids=['obstacle', 'empty'])
def test_cavity_three_steps_match_jax(obstacle):
    """LidDrivenCavity(48) from rest: velocity and pressure within 5e-4 after
    each of 3 steps (measured: 1e-8; the lid's flow is still slow)."""
    jm = JaxCavity(resolution=48, obstacle=obstacle)
    model = LidDrivenCavity(resolution=48, obstacle=obstacle, device='cpu')
    jstate, state = jm.initial_state(), model.initial_state_native()
    step = jax.jit(jm.step)
    for _ in range(3):
        jstate, state = step(*jstate), model.step_native(*state)
        assert model.last_solve.converged
        for got, ref in zip(state[0], _components(jstate[0])):
            assert got.shape == ref.shape
            assert float(np.abs(got.numpy() - ref).max()) <= 5e-4
            assert _scaled_error(got.numpy(), ref) <= 5e-4
        assert float(np.abs(state[1].numpy() - _native(jstate[1])).max()) <= 5e-4
    velocity, pressure = cavity.state_to_numpy(state)
    assert float(velocity[0][:, -1].mean()) > 1e-3  # the lid drags the top row along +x
    if obstacle:
        inside = geometry_mask(model.obstacles[0].geometry, cell_grid((48, 48), 1.0, 'cpu')).numpy()
        assert inside.sum() > 0 and float(np.abs(pressure[inside == 1]).max()) < 1e-3 * float(np.abs(pressure).max())
    again = cavity.state_from_numpy(velocity, pressure, device='cpu')
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(again[0], velocity))


def _lid_velocity(N, seed=0):
    """A random closed-box velocity with the cavity's boundary on both sides."""
    rng = np.random.default_rng(seed)
    comps = [rng.uniform(-1.5, 1.5, (N - 1, N)).astype(np.float32), rng.uniform(-1.5, 1.5, (N, N - 1)).astype(np.float32)]
    boundary = extrapolation.combine_sides(**{'x-': 0., 'x+': 0., 'y-': 0., 'y+': vec(x=0.8, y=0.)})
    tensors = [Tensor(jnp.asarray(c), spatial(**dict(zip(NAMES, c.shape)))) for c in comps]
    jv = StaggeredGrid(stack(tensors, dual(vector=list(NAMES))), boundary, bounds=JBox(x=float(N), y=float(N)), x=N, y=N)
    return comps, jv, (PerSide((0., 0.), (0., 0.8)), PerSide((0., 0.), (0., 0.)))


def test_per_side_pad_matches_jax():
    """The lid's extrapolation, two cells wide on every side, axis after
    axis: equal, corners included."""
    comps, jv, boundary = _lid_velocity(12)
    for d, name in enumerate(NAMES):
        comp = jv.vector[name]
        ref = np.asarray(comp.boundary.pad(comp.values, {'x': (2, 2), 'y': (2, 2)}).native(NAMES))
        got = torch.from_numpy(comps[d])
        for axis in range(2):
            got = pad(got, axis, 2, 2, boundary[d])
        assert np.array_equal(got.numpy(), ref)
    assert PerSide((0, 1), (2, 3)) == ((0., 1.), (2., 3.))


def test_semi_lagrangian_under_the_lid_matches_jax():
    """Self-advection with the per-side, per-component boundary (the window
    kernel's twin gets the padded array): within 1e-5."""
    comps, jv, boundary = _lid_velocity(24, seed=1)
    ref = _components(jax_advect.semi_lagrangian(jv, jv, 0.5))
    v = [torch.from_numpy(c) for c in comps]
    got = advect.semi_lagrangian_native(v, v, 0.5, 1.0, boundary, velocity_extrap=boundary)
    plain = advect.semi_lagrangian_native(v, v, 0.5, 1.0, 0.0)
    for g, r in zip(got, ref):
        assert float(np.abs(g.numpy() - r).max()) <= 1e-5
    assert float((got[0] - plain[0]).abs().max()) > 1e-2  # the lid is felt


@pytest.mark.parametrize('substeps', [1, 3])
def test_explicit_diffusion_matches_jax(substeps):
    """u + ν·dt·Δu per component under its own boundary: within 1e-6."""
    comps, jv, boundary = _lid_velocity(24, seed=2)
    ref = _components(jax_diffuse.explicit(jv, 0.1, 0.5, substeps=substeps))
    got = diffuse.explicit_native([torch.from_numpy(c) for c in comps], 0.1, 0.5, 1.0, boundary, substeps=substeps)
    for g, r, c in zip(got, ref, comps):
        assert float(np.abs(g.numpy() - r).max()) <= 1e-6
        assert float(np.abs(g.numpy() - c).max()) > 0.05


# ---------------------------------------------------------------------------
# the golden file's obstacle inputs, float32 in both packages
# ---------------------------------------------------------------------------

def _golden_staggered(ux, uy, n):
    tensors = [Tensor(jnp.asarray(a, jnp.float32), spatial(x=a.shape[0], y=a.shape[1])) for a in (ux, uy)]
    return StaggeredGrid(stack(tensors, dual(vector=['x', 'y'])), 0., bounds=JBox(x=1., y=1.), x=n, y=n)


def _solve():
    return Solve('CG', 1e-5, 0., max_iterations=2000, suppress=(ConvergenceException,), implicit_diff=False)


def test_golden_obstacle_projection_inputs_match_jax():
    """`obs_*0`: a stationary sphere in the unit box at 24² (dx = 1/24).
    Both packages in float32, rel_tol 1e-5: within 1e-4. The float64 run
    against the stored result at 1e-5 needs the named-dim core."""
    data = np.load(GOLDEN)
    n = int(data['n'])
    centre, radius = [float(c) for c in data['obs_center']], float(data['obs_radius'])
    jv = _golden_staggered(data['obs_ux0'], data['obs_uy0'], n)
    jv2, jp = jax_fluid.make_incompressible(jv, [JSphere(x=centre[0], y=centre[1], radius=radius)], _solve())
    v = [torch.from_numpy(np.asarray(data[k], np.float32)) for k in ('obs_ux0', 'obs_uy0')]
    v2, p, result = fluid.make_incompressible_native(v, None, 1.0 / n, rel_tol=1e-5, abs_tol=0., max_iterations=2000,
                                              obstacles=[Sphere(centre, radius)])
    assert result.converged
    for got, ref, stored in zip(v2, _components(jv2), (data['obs_ux'], data['obs_uy'])):
        assert float(np.abs(got.numpy() - ref).max()) <= 1e-4
        assert float(np.abs(got.numpy() - stored).max()) <= 1e-3  # the float64 result, at float32's reach
    assert float(np.abs(p.numpy() - _native(jp)).max()) <= 1e-4


def test_golden_moving_obstacle_projection_inputs_match_jax():
    """`mv_*0`: two projections around a translating, spinning sphere whose
    centre moves between them. Within 1e-4 of the JAX package in float32."""
    data = np.load(GOLDEN)
    n = int(data['n'])
    centre, radius = np.asarray(data['mv_center'], np.float64), float(data['mv_radius'])
    vel, omega, dt = [float(c) for c in data['mv_vel']], float(data['mv_omega']), float(data['mv_dt'])
    jv = _golden_staggered(data['mv_ux0'], data['mv_uy0'], n)
    v = [torch.from_numpy(np.asarray(data[k], np.float32)) for k in ('mv_ux0', 'mv_uy0')]
    for k in range(2):
        c = [float(centre[0] + vel[0] * dt * k), float(centre[1] + vel[1] * dt * k)]
        jobs = jax_fluid.Obstacle(JSphere(vec(x=c[0], y=c[1]), radius=radius), velocity=vec(x=vel[0], y=vel[1]),
                                  angular_velocity=omega)
        jv, _ = jax_fluid.make_incompressible(jv, [jobs], _solve())
        v, _, result = fluid.make_incompressible_native(v, None, 1.0 / n, rel_tol=1e-5, abs_tol=0., max_iterations=2000,
                                                 obstacles=[Obstacle(Sphere(c, radius), velocity=vel, angular_velocity=omega)])
        assert result.converged
    for got, ref, stored in zip(v, _components(jv), (data['mv_ux'], data['mv_uy'])):
        assert float(np.abs(got.numpy() - ref).max()) <= 1e-4
        assert float(np.abs(got.numpy() - stored).max()) <= 1e-3

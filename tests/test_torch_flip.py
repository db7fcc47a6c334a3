"""The port's FLIP liquid slice (`models/flip.py` and the modules under it)
against the JAX package on the CPU: the same particles, made with numpy from a
seed, go through both. The port takes its plain twins on the CPU (K8's
`index_add_` scatter, K1m's roll stencil); the JAX package takes its generic
scatter, or its Pallas P2G kernel in interpret mode where a test says so."""
import jax
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jmath
from phiflow_tpu.field import CenteredGrid, StaggeredGrid, distribute_points as jax_distribute_points
from phiflow_tpu.field import finite_fill as jax_finite_fill, mask as jax_mask, resample as jax_resample
from phiflow_tpu.field._resample import sample as jax_sample
from phiflow_tpu.geom import Box, Point
from phiflow_tpu.math import channel, extrapolation, instance, wrap
from phiflow_tpu.models import FlipLiquid as JaxFlip
from phiflow_tpu.ops import p2g as jax_p2g
from phiflow_tpu.physics import advect as jax_advect, fluid as jax_fluid

from phiflow_tpu_torch.field import distribute_points, finite_fill, scatter_to_grid
from phiflow_tpu_torch.field._resample import sample_staggered_at_points
from phiflow_tpu_torch.geom import box_push
from phiflow_tpu_torch.models import FlipLiquid
from phiflow_tpu_torch.models.flip import state_from_numpy, state_to_numpy
from phiflow_tpu_torch.ops.poisson import poisson_apply
from phiflow_tpu_torch.physics import advect, fluid

ORDER = ('x', 'y', 'z')


def _points_tensor(a, names):
    return wrap(a, instance('points'), channel(vector=','.join(names)))


def _jax_particles(model: JaxFlip, positions, velocities):
    """The JAX model's particle field moved to `positions` with `velocities`."""
    names = ORDER[:positions.shape[1]]
    p = model.particles0
    p = p.with_geometry(p.geometry.at(_points_tensor(positions, names)))
    return p.with_values(_points_tensor(velocities, names))


def _jax_positions(particles):
    return np.asarray(particles.geometry.center.native(('points', 'vector')))


def _jax_components(grid, dims):
    names = ORDER[:dims]
    return [np.array(grid.vector[d].values.native(names)) for d in names]


def _smooth_velocities(positions, R, amp=1.5):
    d = positions.shape[1]
    return (amp * np.stack([np.sin(2 * np.pi * positions[:, (a + 1) % d] / R) * np.cos(2 * np.pi * positions[:, a] / R)
                            for a in range(d)], axis=1)).astype(np.float32)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', [dict(lower=(3.6, 3.6, 10.8), upper=(13.2, 13.2, 20.4), res=(24, 24, 24), ppc=8),
                                  dict(lower=(2, 2, 2), upper=(6, 8, 6), res=(12, 12, 12), ppc=2),
                                  dict(lower=(0, 10), upper=(1, 11), res=(16, 16), ppc=1),
                                  dict(lower=(6, 24), upper=(10, 28), res=(16, 32), ppc=8)],
                         ids=['3d-block', '3d-ppc2', '2d-single-cell', '2d-non-square'])
def test_distribute_points_matches_jax_exactly(case):
    names = ORDER[:len(case['res'])]
    box = Box(wrap(list(case['lower']), channel(vector=','.join(names))),
              wrap(list(case['upper']), channel(vector=','.join(names))))
    ref = _jax_positions(jax_distribute_points(box, points_per_cell=case['ppc'], **dict(zip(names, case['res']))))
    got = distribute_points(case['lower'], case['upper'], case['res'], points_per_cell=case['ppc'])
    assert got.dtype == np.float32 and got.shape == ref.shape and got.shape[0] > 0
    assert np.array_equal(got, ref)
    other = distribute_points(case['lower'], case['upper'], case['res'], points_per_cell=case['ppc'], seed=1)
    assert not np.array_equal(other, got)


@pytest.fixture(scope='module')
def scattered():
    """One particle set at 16³ with a smooth velocity and the JAX package's
    grids of it: the raw staggered scatter, its one-cell fill, the occupancy."""
    R = 16
    jm = JaxFlip(resolution=R, dims=3, points_per_cell=4)
    pos = _jax_positions(jm.particles0)
    pos = (pos + np.random.default_rng(0).uniform(-3, 3, pos.shape)).astype(np.float32)  # some leave the face grids
    vel = _smooth_velocities(pos, R)
    particles = _jax_particles(jm, pos, vel)
    sizes = dict(x=R, y=R, z=R)
    raw = jax_resample(particles, StaggeredGrid(0, 0, jm.bounds, **sizes), scatter=True, outside_handling='clamp')
    occupied = jax_resample(jax_mask(particles), CenteredGrid(0, raw.boundary.spatial_gradient(), jm.bounds, **sizes),
                            scatter=True)
    return dict(R=R, pos=pos, vel=vel, particles=particles, jax_raw=raw, jax_filled=jax_finite_fill(raw),
                jax_occupied=occupied)


def test_staggered_scatter_and_finite_fill_match_jax(scattered):
    """NaN in exactly the same faces before and after the fill; values within
    1e-6. The occupancy grid (base 0, particles outside dropped) exactly."""
    R, pos, vel = scattered['R'], torch.from_numpy(scattered['pos']), torch.from_numpy(scattered['vel'])
    raw = scatter_to_grid(pos, vel, (R,) * 3, 1.0, outside_handling='clamp', base=float('nan'))
    filled = [finite_fill(c) for c in raw]
    for got, ref in ((raw, scattered['jax_raw']), (filled, scattered['jax_filled'])):
        for d, r in enumerate(_jax_components(ref, 3)):
            g = got[d].numpy()
            assert g.shape == r.shape == tuple(R - (a == d) for a in range(3))
            assert np.array_equal(np.isnan(g), np.isnan(r))
            assert float(np.nanmax(np.abs(g - r))) <= 1e-6
    n_raw = sum(int(np.isnan(c.numpy()).sum()) for c in raw)
    n_filled = sum(int(np.isnan(c.numpy()).sum()) for c in filled)
    assert 0 < n_filled < n_raw  # the fill reaches one cell, not the whole grid
    occupied = scatter_to_grid(pos, torch.ones(pos.shape[0]), (R,) * 3, 1.0)
    assert np.array_equal(occupied.numpy(), np.asarray(scattered['jax_occupied'].values.native(ORDER)))


def test_finite_fill_two_cells_deep_matches_jax(scattered):
    ref = _jax_components(jax_finite_fill(scattered['jax_raw'], distance=2), 3)
    for d, r in enumerate(_jax_components(scattered['jax_raw'], 3)):
        got = finite_fill(torch.from_numpy(r), distance=2).numpy()
        assert np.array_equal(np.isnan(got), np.isnan(ref[d]))
        assert float(np.nanmax(np.abs(got - ref[d]))) <= 1e-6
        assert np.isnan(got).sum() < np.isnan(finite_fill(torch.from_numpy(r)).numpy()).sum()


def test_sample_at_points_matches_jax(scattered):
    """G2P on a grid that holds NaN: the same particles get NaN, the others
    agree within 1e-6."""
    R = scattered['R']
    rng = np.random.default_rng(1)
    pts = np.concatenate([scattered['pos'], rng.uniform(-1, R + 1, (4000, 3)).astype(np.float32)])
    ref = np.asarray(jax_sample(scattered['jax_filled'], Point(_points_tensor(pts, ORDER))).native(('points', 'vector')))
    grid = [torch.from_numpy(c) for c in _jax_components(scattered['jax_filled'], 3)]
    got = sample_staggered_at_points(grid, torch.from_numpy(pts), 1.0).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(ref).any() and not np.isnan(ref).all()
    assert float(np.nanmax(np.abs(got - ref))) <= 1e-6


def test_finite_rk4_matches_jax(scattered):
    R, dt = scattered['R'], 0.1
    ref = np.asarray(jax_advect.finite_rk4(scattered['particles'], scattered['jax_filled'], dt)
                     .native(('points', 'vector')))
    grid = [torch.from_numpy(c) for c in _jax_components(scattered['jax_filled'], 3)]
    got = advect.finite_rk4(torch.from_numpy(scattered['pos']), grid, dt, 1.0).numpy()
    assert np.isfinite(got).all()
    assert float(np.abs(got - ref).max()) <= 2e-6
    assert float(np.abs(got - scattered['pos']).max()) > 0.05  # the particles did move


@pytest.mark.parametrize('dims', [2, 3])
def test_box_push_matches_jax(dims):
    names = ORDER[:dims]
    rng = np.random.default_rng(2)
    size = (16.0, 12.0, 20.0)[:dims]
    pos = rng.uniform(-3, 23, (2000, dims)).astype(np.float32)
    box = Box(**dict(zip(names, size)))
    ref_in = np.asarray((~box).push(_points_tensor(pos, names), shift_amount=0.5).native(('points', 'vector')))
    got_in = box_push(torch.from_numpy(pos), (0.0,) * dims, size, outward=False, shift_amount=0.5).numpy()
    assert np.array_equal(got_in, ref_in)
    was_inside = (pos >= 0) & (pos <= np.asarray(size, np.float32))
    assert np.array_equal(got_in[was_inside], pos[was_inside]) and not was_inside.all()  # only violators move,
    moved = got_in[~was_inside]                                                         # to 0.5 inside the wall
    assert (np.minimum(np.abs(moved - 0.5), np.abs(moved - (np.broadcast_to(size, pos.shape)[~was_inside] - 0.5)))
            <= 1e-5).all()
    assert np.array_equal(fluid.boundary_push(torch.from_numpy(pos), size).numpy(), ref_in)
    ref_out = np.asarray(box.push(_points_tensor(pos, names), shift_amount=0.25).native(('points', 'vector')))
    got_out = box_push(torch.from_numpy(pos), (0.0,) * dims, size, outward=True, shift_amount=0.25).numpy()
    assert float(np.abs(got_out - ref_out).max()) <= 1e-6


def test_masked_diagonal_and_chebyshev_match_jax():
    """The free surface's preconditioner: the probed diagonal exactly equal in
    structure (identity rows 1) and one application within 1e-5."""
    R = 12
    rng = np.random.default_rng(3)
    act = (rng.uniform(size=(R,) * 3) > 0.4).astype(np.float32)
    r = rng.standard_normal((R,) * 3).astype(np.float32)
    bounds = Box(x=float(R), y=float(R), z=float(R))
    sizes = dict(x=R, y=R, z=R)
    shape = jmath.spatial(**sizes)
    x0 = CenteredGrid(0., extrapolation.BOUNDARY, bounds, **sizes)
    active = CenteredGrid(jmath.tensor(act, shape), 0., bounds, **sizes)
    ref_diag = np.asarray(jax_fluid._masked_diagonal(x0, extrapolation.ZERO, None, active).native(ORDER))
    M = jax_fluid._masked_chebyshev_preconditioner(x0, extrapolation.ZERO, None, active)
    ref_z = np.asarray(M(x0.with_values(jmath.tensor(r, shape))).values.native(ORDER))

    bcs = fluid._classify_pressure_bc(False, 3)
    active_t = torch.from_numpy(act)
    apply_A = lambda p: poisson_apply(p, (1.0,) * 3, bcs, active=active_t)
    diag = fluid._masked_diagonal(apply_A, active_t, bcs).numpy()
    assert float(np.abs(diag - ref_diag).max()) <= 1e-6
    assert (diag[act == 0] == 1.0).all() and (diag[act != 0] < 0).all()
    z, rz = fluid._masked_chebyshev_preconditioner(apply_A, active_t, bcs)(torch.from_numpy(r))
    assert rz is None
    assert float(np.abs(z.numpy() - ref_z).max()) <= 1e-5
    assert fluid._masked_diagonal(apply_A, torch.zeros(5, 6, 6), (('periodic', 'periodic'),) * 3) is None


def test_active_projection_matches_jax(scattered):
    """`make_incompressible(..., active=occupied)` on a grid with NaN faces:
    pressure within 1e-4, the projected velocity's NaN pattern equal and its
    values within 1e-4; the divergence of active cells is gone."""
    R = scattered['R']
    forced = scattered['jax_filled'] + (0, 0, -0.981)
    ref_v, ref_p = jax_fluid.make_incompressible(
        forced, [], active=scattered['jax_occupied'],
        solve=jmath.Solve('CG', 1e-5, 0., max_iterations=500, suppress=(jmath.ConvergenceException,)))
    grid = [torch.from_numpy(c) for c in _jax_components(forced, 3)]
    occupied = torch.from_numpy(np.array(scattered['jax_occupied'].values.native(ORDER)))
    v, p, result = fluid.make_incompressible(grid, None, 1.0, rel_tol=1e-5, abs_tol=0., max_iterations=500,
                                             active=occupied)
    assert result.converged and 0 < result.iterations < 100
    assert float(np.abs(p.numpy() - np.asarray(ref_p.values.native(ORDER))).max()) <= 1e-4
    for d, r in enumerate(_jax_components(ref_v, 3)):
        assert np.array_equal(np.isnan(v[d].numpy()), np.isnan(r))
        assert float(np.nanmax(np.abs(v[d].numpy() - r))) <= 1e-4
    from phiflow_tpu_torch.field import divergence
    div = torch.nan_to_num(divergence(v, 1.0) * occupied, nan=0.0)
    assert float(div.abs().max()) < 1e-4
    assert float(p[occupied == 0].abs().max()) < 1e-6  # identity rows: p = 0 outside the liquid


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def _run_both(R, dims, steps, ppc=8, cg_tol=1e-5, velocities=False):
    jm = JaxFlip(resolution=R, dims=dims, points_per_cell=ppc, cg_tol=cg_tol, max_iterations=500)
    model = FlipLiquid(R, dims=dims, points_per_cell=ppc, cg_tol=cg_tol, max_iterations=500, device='cpu')
    assert np.array_equal(model.positions0, _jax_positions(jm.particles0))
    jstate = jm.initial_state()
    state = model.initial_state()
    if velocities:
        vel = _smooth_velocities(model.positions0, R, amp=0.5)
        jstate = (_jax_particles(jm, model.positions0, vel), jstate[1])
        state = state_from_numpy(model.positions0, vel, np.zeros((R,) * dims, np.float32), device='cpu')
    step = jax.jit(lambda s: jm.step(*s))
    iterations = []
    for _ in range(steps):
        jstate = step(jstate)
        state = model.step(*state)
        iterations.append(model.last_solve.iterations)
    return jstate, state, iterations


def test_flip_3d_two_steps_match_jax():
    """FlipLiquid(24, dims=3), 5832 particles, from a moving state so that
    both steps solve: positions within 5e-4 (the bar of the JAX package's own
    P2G dispatch test), velocities and pressure too."""
    (jp, jpress), ((pos, vel), pressure), iterations = _run_both(24, 3, 2, velocities=True)
    assert pos.shape[0] >= 4096  # the size from which the JAX dispatch engages its kernel
    assert float(np.abs(pos.numpy() - _jax_positions(jp)).max()) <= 5e-4
    ref_vel = np.asarray(jp.values.native(('points', 'vector')))
    assert np.array_equal(np.isnan(vel.numpy()), np.isnan(ref_vel))
    assert float(np.nanmax(np.abs(vel.numpy() - ref_vel))) <= 5e-4
    assert float(np.abs(pressure.numpy() - np.asarray(jpress.values.native(ORDER))).max()) <= 5e-4
    assert all(0 < it < 500 for it in iterations), iterations


def test_flip_3d_matches_jax_with_pallas_p2g():
    """The same two steps from rest with the JAX side's P2G through its
    Pallas kernel in interpret mode."""
    jax_p2g.FORCE_INTERPRET = True
    try:
        (jp, _), ((pos, _), _), iterations = _run_both(24, 3, 2)
    finally:
        jax_p2g.FORCE_INTERPRET = False
    assert float(np.abs(pos.numpy() - _jax_positions(jp)).max()) <= 5e-4
    assert iterations[0] == 0 and iterations[1] > 0  # the block falls freely first, then the solve works


def test_flip_2d_steps_match_jax():
    """dims=2 runs the same code through the plain routes: 4 steps at 32²."""
    (jp, jpress), ((pos, vel), pressure), iterations = _run_both(32, 2, 4)
    assert float(np.abs(pos.numpy() - _jax_positions(jp)).max()) <= 5e-4
    assert float(np.abs(pressure.numpy() - np.asarray(jpress.values.native(('x', 'y')))).max()) <= 5e-4
    assert iterations[-1] > 0


def test_flip_3d_step_is_sane():
    """The JAX suite's 3D FLIP check: finite, inside the box ± 0.5, the block
    falls."""
    r = 12
    model = FlipLiquid(r, dims=3, block=(2 / r, 6 / r, 2 / r, 6 / r, 2 / r, 8 / r), points_per_cell=2,
                       max_iterations=500, device='cpu')
    state = model.initial_state()
    z0 = float(state[0][0][:, 2].mean())
    for _ in range(2):
        state = model.step(*state)
    (pos, vel), pressure = state
    assert pos.shape == vel.shape == (model.positions0.shape[0], 3) and pressure.shape == (r,) * 3
    assert bool(torch.isfinite(pos).all())
    assert bool((pos > -0.5).all()) and bool((pos < r + 0.5).all()), "particles left the box"
    assert float(pos[:, 2].mean()) < z0


def test_flip_state_numpy_round_trip_and_checks():
    rng = np.random.default_rng(7)
    arrays = (rng.uniform(0, 8, (50, 3)).astype(np.float32), rng.standard_normal((50, 3)).astype(np.float32),
              rng.standard_normal((8, 8, 8)).astype(np.float32))
    state = state_from_numpy(*arrays, device='cpu')
    (pos, vel), pressure = state
    assert all(t.dtype == torch.float32 and t.device.type == 'cpu' for t in (pos, vel, pressure))
    assert all(np.array_equal(a, b) for a, b in zip(arrays, state_to_numpy(state)))
    model = FlipLiquid(8, dims=3, device='cpu')
    with pytest.raises(ValueError, match='particles'):
        model.step((pos, vel[:, :2]), pressure)
    with pytest.raises(ValueError, match='dims'):
        FlipLiquid(8, dims=1, device='cpu')


def test_flip_default_device_raises_without_cuda(monkeypatch):
    """The model and its state helper run on CUDA unless the caller asks for
    the CPU; with no card they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        FlipLiquid(8, dims=3)
    with pytest.raises(RuntimeError, match='CUDA'):
        state_from_numpy(np.zeros((4, 3), np.float32), np.zeros((4, 3), np.float32), np.zeros((2, 2, 2), np.float32))

"""The six golden trajectories of `tests/golden/test_golden.py` through the
port's Field API: Burgers, projection, obstacle projection, moving obstacle,
3D projection and smoke — the same `golden.npz`, the same `Solve` arguments,
float64 and the JAX suite's bar, L2 < 1e-5. The arrays come from an
independent numpy MAC implementation; this file reads them itself."""
import os

import numpy as np
import pytest
import torch

import phiflow_tpu_torch.math as math
from phiflow_tpu_torch.field import CenteredGrid, StaggeredGrid, resample
from phiflow_tpu_torch.geom import Box, Sphere
from phiflow_tpu_torch.math import ConvergenceException, Solve, channel, dual, extrapolation, spatial, stack, vec
from phiflow_tpu_torch.physics import advect, diffuse, fluid
from phiflow_tpu_torch.physics.fluid import Obstacle

_GOLDEN = os.path.join(os.path.dirname(__file__), 'golden', 'golden.npz')


@pytest.fixture(autouse=True, scope='module')
def _cpu_float64():
    with math.default_device('cpu'), math.precision(64):
        yield


@pytest.fixture(scope='module')
def golden():
    return dict(np.load(_GOLDEN, allow_pickle=False).items())


def _tensor(arr):
    names = 'x,y,z'.split(',')[:arr.ndim]
    return math.wrap(torch.from_numpy(np.ascontiguousarray(arr, np.float64)), spatial(*names))


def _staggered_from(arrays, n, bounds):
    return StaggeredGrid(stack([_tensor(a) for a in arrays], dual(vector=','.join('xyz'[:len(arrays)]))), 0.,
                         bounds=bounds, **{d: n for d in 'xyz'[:len(arrays)]})


def _solve(tol, max_iter):
    return Solve('CG', tol, tol, max_iterations=max_iter, suppress=(ConvergenceException,), implicit_diff=False)


def _components(v, names=('x', 'y')):
    return [v.values[{'~vector': d}].numpy(names) for d in names]


def _l2(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def test_burgers_golden(golden):
    n, dt, nu, steps = int(golden['n']), float(golden['burgers_dt']), float(golden['burgers_nu']), int(golden['steps'])
    values = stack({'x': _tensor(golden['burgers_vx0']), 'y': _tensor(golden['burgers_vy0'])}, channel('vector'))
    v = CenteredGrid(values, extrapolation.PERIODIC, x=n, y=n, bounds=Box(x=1., y=1.))
    for _ in range(steps):
        v = advect.semi_lagrangian(v, v, dt)
        v = diffuse.explicit(v, nu, dt)
    assert v.values.dtype == torch.float64
    assert _l2(v.values[{'vector': 'x'}].numpy(('x', 'y')), golden['burgers_vx']) < 1e-5
    assert _l2(v.values[{'vector': 'y'}].numpy(('x', 'y')), golden['burgers_vy']) < 1e-5


def test_projection_golden(golden):
    n = int(golden['n'])
    v = _staggered_from([golden['proj_ux0'], golden['proj_uy0']], n, Box(x=1., y=1.))
    v2, p = fluid.make_incompressible(v, (), _solve(1e-12, 2000))
    ux, uy = _components(v2)
    assert _l2(ux, golden['proj_ux']) < 1e-5
    assert _l2(uy, golden['proj_uy']) < 1e-5


def test_obstacle_projection_golden(golden):
    n = int(golden['n'])
    cx, cy = (float(c) for c in golden['obs_center'])
    v = _staggered_from([golden['obs_ux0'], golden['obs_uy0']], n, Box(x=1., y=1.))
    v2, p = fluid.make_incompressible(v, [Sphere(x=cx, y=cy, radius=float(golden['obs_radius']))],
                                      _solve(1e-12, 8000))
    ux, uy = _components(v2)
    assert _l2(ux, golden['obs_ux']) < 1e-5
    assert _l2(uy, golden['obs_uy']) < 1e-5


def test_moving_obstacle_projection_golden(golden):
    n = int(golden['n'])
    cx, cy = (float(c) for c in golden['mv_center'])
    vx_o, vy_o = (float(c) for c in golden['mv_vel'])
    omega, dt, radius = float(golden['mv_omega']), float(golden['mv_dt']), float(golden['mv_radius'])
    v = _staggered_from([golden['mv_ux0'], golden['mv_uy0']], n, Box(x=1., y=1.))
    for k in range(2):
        center = vec(x=cx + vx_o * dt * k, y=cy + vy_o * dt * k)
        obstacle = Obstacle(Sphere(center, radius=radius), velocity=vec(x=vx_o, y=vy_o), angular_velocity=omega)
        v, p = fluid.make_incompressible(v, [obstacle], _solve(1e-12, 8000))
    ux, uy = _components(v)
    assert _l2(ux, golden['mv_ux']) < 1e-5
    assert _l2(uy, golden['mv_uy']) < 1e-5


def test_projection_3d_golden(golden):
    n = int(golden['p3_n'])
    v = _staggered_from([golden['p3_ux0'], golden['p3_uy0'], golden['p3_uz0']], n, Box(x=1., y=1., z=1.))
    v2, p = fluid.make_incompressible(v, (), Solve('CG', 1e-12, 1e-12, max_iterations=4000,
                                                   suppress=(ConvergenceException,)))
    for got, key in zip(_components(v2, ('x', 'y', 'z')), ('p3_ux', 'p3_uy', 'p3_uz')):
        assert _l2(got, golden[key]) < 1e-5


def test_smoke_golden(golden):
    n, steps = int(golden['n']), int(golden['steps'])
    dt, buoy = float(golden['smoke_dt']), float(golden['smoke_buoy'])
    smoke = CenteredGrid(_tensor(golden['smoke_s0']), extrapolation.BOUNDARY, x=n, y=n, bounds=Box(x=1., y=1.))
    v = _staggered_from([golden['smoke_ux0'], golden['smoke_uy0']], n, Box(x=1., y=1.))
    for _ in range(steps):
        smoke = advect.semi_lagrangian(smoke, v, dt)
        buoyancy = resample(smoke * (0., buoy), to=v)
        v = advect.semi_lagrangian(v, v, dt) + buoyancy * dt
        v, p = fluid.make_incompressible(v, (), _solve(1e-12, 2000))
    assert _l2(smoke.values.numpy(('x', 'y')), golden['smoke_s']) < 1e-5
    ux, uy = _components(v)
    assert _l2(ux, golden['smoke_ux']) < 1e-5
    assert _l2(uy, golden['smoke_uy']) < 1e-5

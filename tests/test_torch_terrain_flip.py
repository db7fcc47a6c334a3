"""terrain-flip: a 3D version of `examples/terrain_flip.py` — a block of
liquid drops onto a heightmap terrain — written once against the Field API
and run by both packages: a `Heightmap` obstacle in the masked projection
(its signed distance in the obstacle masks) and in `boundary_push` (its push
along the finite-difference normal), P2G by scatter, `finite_fill`, the FLIP
update, `advect.points` with `finite_rk4`. At 12³, one step: positions and
velocities within FLIP's 5e-4 of their scale, CG counts at most 1 apart."""
import numpy as np
import pytest

from phiflow_tpu import field as jfield, geom as jgeom, math as jmath
from phiflow_tpu.physics import advect as jadvect, fluid as jfluid
from phiflow_tpu_torch import field as tfield, geom as tgeom, math as tmath
from phiflow_tpu_torch.physics import advect as tadvect, fluid as tfluid

PKGS = {'jax': (jmath, jgeom, jfield, jfluid, jadvect), 'torch': (tmath, tgeom, tfield, tfluid, tadvect)}


@pytest.fixture(autouse=True)
def _cpu():
    with tmath.default_device('cpu'):
        yield


def terrain_setup(pkg, N):
    """The domain, the terrain (h = 24 + 16 sin(2πx/128) + 8 cos(2πy/128) at
    128³, scaled by N / 128) and the liquid block Box['x,y,z', 16:80, 16:80,
    56:96] at 128³ (scaled likewise), 8 particles a cell, at rest."""
    math, geom, field, fluid, advect = PKGS[pkg]
    s = N / 128
    domain = geom.Box(x=N, y=N, z=N)
    xs = math.linspace(0., N, math.spatial(x=N + 1))
    ys = math.linspace(0., N, math.spatial(y=N + 1))
    heights = 24 * s + 16 * s * math.sin(xs / N * 2 * np.pi) + 8 * s * math.cos(ys / N * 2 * np.pi)
    terrain = geom.Heightmap(heights, domain, max_dist=4.)
    block = geom.Box['x,y,z', 16 * s:80 * s, 16 * s:80 * s, 56 * s:96 * s]
    particles = field.distribute_points(block, x=N, y=N, z=N) * (0, 0, 0)
    return domain, terrain, particles


def terrain_step(pkg, N, domain, terrain, particles, dt=0.1):
    """One step of the recipe; returns (particles, CG iterations)."""
    math, geom, field, fluid, advect = PKGS[pkg]
    grid_v = prev_v = field.finite_fill(field.resample(particles, field.StaggeredGrid(0, 0, domain, x=N, y=N, z=N),
                                                       scatter=True, outside_handling='clamp'))
    occupied = field.resample(field.mask(particles), field.CenteredGrid(0, grid_v.boundary.spatial_gradient(), domain,
                                                                        x=N, y=N, z=N), scatter=True)
    with math.SolveTape() as tape:
        grid_v, _ = fluid.make_incompressible(grid_v + (0, 0, -9.81 * dt), [fluid.Obstacle(terrain)], active=occupied,
                                              solve=math.Solve('CG', 1e-4, suppress=(math.ConvergenceException,)))
    particles = particles + field.resample(grid_v - prev_v, particles)
    particles = advect.points(particles, grid_v, dt, advect.finite_rk4)
    particles = fluid.boundary_push(particles, [terrain, ~domain])
    return particles, [int(np.asarray(info.iterations).max()) for info in tape]


def _scaled(got, ref, what, tol=5e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


def test_terrain_flip_step_matches_jax():
    N = 12
    out = {}
    for pkg in PKGS:
        domain, terrain, particles = terrain_setup(pkg, N)
        particles, iters = terrain_step(pkg, N, domain, terrain, particles)
        out[pkg] = (particles.points.numpy(('points', 'vector')), particles.values.numpy(('points', 'vector')), iters)
    (jp, jv, jit), (tp, tv, tit) = out['jax'], out['torch']
    assert jp.shape[0] > 100
    _scaled(tp, jp, 'positions')
    _scaled(tv, jv, 'velocities')
    # JAX's eager masked solve reports no count (-1); where it does, the counts are at most 1 apart
    assert len(jit) == len(tit) and all(a < 0 or abs(a - b) <= 1 for a, b in zip(jit, tit)), (jit, tit)
    assert all(b > 0 for b in tit)
    # the example's own check: (nearly) every particle at or above the terrain less one cell
    h = 24 / 128 * N + 16 / 128 * N * np.sin(tp[:, 0] / N * 2 * np.pi) + 8 / 128 * N * np.cos(tp[:, 1] / N * 2 * np.pi)
    assert (tp[:, 2] >= h - 1.0).mean() >= 0.97


OBSTACLES = {
    'cylinder': lambda g, m: g.cylinder(x=6, y=6, z=5, radius=2.5, depth=4., axis='z'),
    'heightmap': lambda g, m: g.Heightmap(m.wrap((2.5 + np.sin(np.arange(13) / 2)).astype(np.float32) * np.ones((1, 1),
                                                  np.float32), m.spatial('x,y')), g.Box(x=12, y=12, z=12), max_dist=4.),
    'sdf': lambda g, m: g.SDF(lambda loc: m.vec_length(loc - m.vec(x=6., y=6., z=6.)) - 3., g.Box(x=(3, 9), y=(3, 9),
                                                                                                  z=(3, 9))),
    'sdf-grid': lambda g, m: g.sample_sdf(g.Sphere(x=6, y=6, z=6, radius=3), g.Box(x=12, y=12, z=12), x=12, y=12, z=12),
    'union': lambda g, m: g.union(g.Box(x=(2, 5), y=(2, 10), z=(0, 4)), g.Sphere(x=8, y=7, z=6, radius=2)),
    'intersection': lambda g, m: g.intersection(g.Box(x=(2, 10), y=(2, 10), z=(0, 6)), g.Sphere(x=6, y=6, z=3,
                                                                                                 radius=3.5)),
}


@pytest.mark.parametrize('name', list(OBSTACLES))
def test_new_obstacles_in_the_projection_match_jax(name):
    """An obstacle of each new shape in `make_incompressible` at 12³: the
    projected velocity within 1e-4 of its scale, the same CG count ±1 — the
    shape's masks reached the masked stencil's mA / c0 (K1m on the card).
    In the terrain step's file: both compile JAX's masked projection, which
    takes most of a cold process's time."""
    N = 12
    out = {}
    for pkg in PKGS:
        math, geom, field, fluid, advect = PKGS[pkg]
        flow = lambda p: math.stack({'x': math.sin(p.vector['y'] / 2) + 0.3, 'y': math.cos(p.vector['z'] / 3),
                                     'z': math.sin(p.vector['x'] / 2) - 0.5}, math.channel(vector='x,y,z'))
        v = field.StaggeredGrid(flow, 0, geom.Box(x=N, y=N, z=N), x=N, y=N, z=N)
        with math.SolveTape() as tape:
            v, _ = fluid.make_incompressible(v, [fluid.Obstacle(OBSTACLES[name](geom, math))],
                                             solve=math.Solve('CG', 1e-5, 1e-5, max_iterations=500))
        out[pkg] = ([np.asarray(v.values.vector[d].numpy('x,y,z')) for d in 'xyz'], tape[0].iterations)
    (jv, ji), (tv, ti) = out['jax'], out['torch']
    for d in range(3):
        _scaled(tv[d], jv[d], f'{name} v{"xyz"[d]}', 1e-4)
    ji, ti = int(np.asarray(ji).max()), int(np.asarray(ti).max())
    assert ti > 0 and (ji < 0 or abs(ji - ti) <= 1), (ji, ti)

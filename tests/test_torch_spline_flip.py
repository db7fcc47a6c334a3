"""spline-flip: a block of liquid slides down a spline chute — the FLIP
step of `test_torch_terrain_flip.py` with a `SplineSolid` in place of the
heightmap — written once against the Field API and run by both packages:
the chute's signed distance shapes the obstacle masks of the masked
projection (mA / c0 of K1m on the card) and `boundary_push` (its push along
the finite-difference normal). Three steps at 16³ (the 128³ recipe of
`chip_smoke.py` scaled by 16 / 128); the chute's masks, push and obstacle
projection alone are in `test_torch_spline_obstacle.py`.

Each query shape costs JAX about 3 s of tracing op by op (12 Gauss-Newton
steps of five sheet evaluations), and a jit of the queries is not JAX's
eager arithmetic: XLA's fusions round otherwise, and points whose closest
parameter sits on an edge take the other fillet branch, 0.25 cells apart
at 16³. So JAX's side queries its `SplineSolid` through `_FlatJaxChute`:
the query points flattened and padded to one length, then JAX's own
`approximate_closest_surface` op by op in a host callback — one shape for
every query, each point's value the unpadded eager call's, and the rest of
JAX's step traced in one jit around it."""  
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from phiflow_tpu import field as jfield, geom as jgeom, math as jmath
from phiflow_tpu.physics import advect as jadvect, fluid as jfluid
from phiflow_tpu_torch import field as tfield, geom as tgeom, math as tmath
from phiflow_tpu_torch.physics import advect as tadvect, fluid as tfluid

PKGS = {'jax': (jmath, jgeom, jfield, jfluid, jadvect), 'torch': (tmath, tgeom, tfield, tfluid, tadvect)}
N = 16
PAD = 4608  # ≥ every query's point count at 16³: 17·16·16 faces, the particles


@pytest.fixture(autouse=True)
def _cpu():
    with tmath.default_device('cpu'):
        yield


def chute_net(n):
    """The chute's 5 × 3 control net at n³ (the 128³ net scaled by n / 128): u along x at x = 16, 40, 64, 88,
    112, v along y at y = 24, 64, 104, z = 64, 44, 28, 24, 34 along u — a concave slide with a lip."""
    s = n / 128
    xs, ys = np.array([16, 40, 64, 88, 112.]) * s, np.array([24, 64, 104.]) * s
    zs = np.array([64, 44, 28, 24, 34.]) * s
    return np.stack(np.broadcast_arrays(xs[:, None], ys[None, :], zs[:, None]), -1).astype(np.float32)


class _FlatJaxChute(jgeom.SplineSolid):
    """JAX's SplineSolid whose inside test and signed distance run its own
    `approximate_closest_surface`, op by op in a host callback, on the query
    points flattened and padded to PAD."""

    def approximate_signed_distance(self, location):
        dims = location.shape.without('vector')
        flat = location.native(dims.names + ('vector',)).reshape(-1, 3)
        n = flat.shape[0]
        assert n <= PAD, n

        def eager(points):
            padded = jmath.wrap(jnp.pad(jnp.asarray(points), ((0, PAD - n), (0, 0))), jmath.instance('q'),
                                jmath.channel(vector='x,y,z'))
            return np.asarray(jgeom.SplineSolid.approximate_closest_surface(self, padded)[0].native('q')[:n])

        d = jax.pure_callback(eager, jax.ShapeDtypeStruct((n,), flat.dtype), flat)
        return jmath.wrap(d.reshape(dims.sizes), dims)

    def lies_inside(self, location):
        return self.approximate_signed_distance(location) <= 0


def chute(pkg, n=N):
    math, geom = PKGS[pkg][:2]
    points = math.tensor(chute_net(n), math.spatial('u,v'), math.channel(vector='x,y,z'))
    cls = _FlatJaxChute if pkg == 'jax' else geom.SplineSolid
    return cls(points, thickness=8 * n / 128, fillet={'u-': 1, 'u+': 1, 'v-': .5, 'v+': .5}, order={'u': 2, 'v': 1})


def spline_setup(pkg, n=N):
    """The domain, the chute and the liquid block Box['x,y,z', 16:64, 16:112, 80:116] at 128³ (scaled by
    n / 128), 8 particles a cell, at rest."""
    math, geom, field, fluid, advect = PKGS[pkg]
    s = n / 128
    domain = geom.Box(x=n, y=n, z=n)
    block = geom.Box['x,y,z', 16 * s:64 * s, 16 * s:112 * s, 80 * s:116 * s]
    particles = field.distribute_points(block, x=n, y=n, z=n) * (0, 0, 0)
    return domain, chute(pkg, n), particles


def spline_step(pkg, domain, ch, particles, n=N, dt=0.1):
    """One step but the push: P2G (clamp), finite_fill, the occupied cells, make_incompressible with the chute
    as an Obstacle and `active` the occupied cells (CG 1e-4), the FLIP update, finite_rk4. The step ends with
    `push(pkg, domain, ch, particles)`."""
    math, geom, field, fluid, advect = PKGS[pkg]
    grid_v = prev_v = field.finite_fill(field.resample(particles, field.StaggeredGrid(0, 0, domain, x=n, y=n, z=n),
                                                       scatter=True, outside_handling='clamp'))
    occupied = field.resample(field.mask(particles), field.CenteredGrid(0, grid_v.boundary.spatial_gradient(), domain,
                                                                        x=n, y=n, z=n), scatter=True)
    grid_v, _ = fluid.make_incompressible(grid_v + (0, 0, -9.81 * dt), [fluid.Obstacle(ch)], active=occupied,
                                          solve=math.Solve('CG', 1e-4, suppress=(math.ConvergenceException,)))
    particles = particles + field.resample(grid_v - prev_v, particles)
    return advect.points(particles, grid_v, dt, advect.finite_rk4)


def push(pkg, domain, ch, particles):
    """The step's end: out of the chute, into the domain."""
    return PKGS[pkg][3].boundary_push(particles, [ch, ~domain])


def _scaled(got, ref, what, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (what, err, scale)


def test_spline_flip_three_steps_match_jax():
    """Three steps at 16³ (JAX's traced in one jit but its chute queries)
    from the block falling at 10 cells a unit of time (so that it reaches
    the chute in the third). Before each push, positions and velocities
    within FLIP's 5e-4 of their scale. The push itself runs the chute's
    finite-difference normal (eps 1e-3) at float32 signed distances, which
    jump where the Gauss-Newton parameter's float32 rounding flips a point
    inside the slab to the other fillet branch (ROADMAP §3, 3.15). So the
    port's push of the two packages' last positions before the push is
    taken in float64, where those positions' 1e-5 gaps stay 1e-5 gaps:
    within 5e-4 of the scale for every particle. In float32 the particles
    that part by more are counted (at most 1%, all within the push's band, a
    float64 signed distance < 0.5 before it) and the rest held within
    5e-4. (The float32 push alone is held to JAX's at 2000 points in
    `test_torch_spline_obstacle.py`.)"""
    state = {}
    for pkg in PKGS:
        math = PKGS[pkg][0]
        domain, ch, particles = spline_setup(pkg)
        state[pkg] = (domain, ch, particles.with_values(particles.values * 0 + math.vec(x=0., y=0., z=-10.)))
    jax_step = jax.jit(lambda p: spline_step('jax', *state['jax'][:2], p))
    for step in range(3):
        pre, post = {}, {}
        for pkg in PKGS:
            domain, ch, particles = state[pkg]
            particles = jax_step(particles) if pkg == 'jax' else spline_step(pkg, domain, ch, particles)
            pre[pkg] = (np.asarray(particles.points.numpy(('points', 'vector'))),
                        np.asarray(particles.values.numpy(('points', 'vector'))))
            particles = push(pkg, domain, ch, particles)
            post[pkg] = np.asarray(particles.points.numpy(('points', 'vector')))
            state[pkg] = (domain, ch, particles)
        _scaled(pre['torch'][0], pre['jax'][0], f'positions before push {step}', 5e-4)
        _scaled(pre['torch'][1], pre['jax'][1], f'velocities {step}', 5e-4)
        scale = float(np.abs(post['jax']).max())
        parted = np.abs(post['torch'] - post['jax']).max(-1) > 5e-4 * scale
        if step < 2:
            assert not parted.any(), step
    assert pre['jax'][0].shape[0] > 1000
    with tmath.precision(64):
        ch = tgeom.SplineSolid(tmath.tensor(chute_net(N).astype(np.float64), tmath.spatial('u,v'),
                                            tmath.channel(vector='x,y,z')), thickness=8 * N / 128,
                               fillet={'u-': 1, 'u+': 1, 'v-': .5, 'v+': .5}, order={'u': 2, 'v': 1})
        locs = {pkg: tmath.tensor(pre[pkg][0].astype(np.float64), tmath.instance('p'), tmath.channel(vector='x,y,z'))
                for pkg in PKGS}
        pushed64 = {pkg: np.asarray(ch.push(loc, shift_amount=0.5).numpy(('p', 'vector'))) for pkg, loc in locs.items()}
        sdf64 = np.asarray(ch.approximate_signed_distance(locs['jax']).numpy('p'))
    assert np.abs(pushed64['torch'] - pushed64['jax']).max() <= 5e-4 * scale
    assert parted.mean() <= 0.01 and (sdf64[parted] < 0.5).all(), (parted.sum(), sdf64[parted])
    _scaled(post['torch'][~parted], post['jax'][~parted], 'positions after push', 5e-4)
    assert (sdf64 < 1.0).mean() > 0.01

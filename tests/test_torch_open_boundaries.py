"""Advection and lookups in open and mixed boxes, the port against the JAX
package on the CPU: `semi_lagrangian` and `mac_cormack` of centred and
staggered fields in 2D at 16² and 3D at 12³ in every face layout — the open
box (ZERO_GRADIENT), an inflow wall with a vector-valued constant beside an
open outflow, an open top over walls, walls beside a periodic axis, and a
field in another layout than its velocity's — within 1e-5 of each field's
scale; 3 steps of `examples/wake_flow.py`'s recipe at 32 × 16 and 2 steps
of an open-top plume (SmokePlume(16, dims=3)'s inflow and buoyancy) within
2e-4 of scale at equal CG counts, both solves converged; lookups at points
in those layouts and on a grid whose lower corner is not the origin.

The inputs are numpy arrays from a seed; JAX's side runs jitted, all cases
of one file at once (its tracing dominates). A staggered field in another
layout than its velocity's takes JAX's generic route (`_displacement` and
`_window_interp_field`): its fast route aliases the velocity's own faces,
which a field of other face counts does not have."""
import jax
import numpy as np
import pytest
import torch

import phiflow_tpu.field as jf
import phiflow_tpu.geom as jg
import phiflow_tpu.math as jm
from phiflow_tpu.physics import advect as jadvect, fluid as jfluid

import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.geom as tg
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.physics import advect, fluid

TOL = 1e-5
STEP_TOL = 2e-4
DT = 1.0
SIZES = {2: (16, 16), 3: (12, 12, 12)}
LAYOUTS = ['open', 'inflow', 'open-top', 'walls-periodic']
SCHEMES = ['semi_lagrangian', 'mac_cormack']


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _names(dims):
    return ('x', 'y', 'z')[:dims]


def velocity_boundary(m, layout, names):
    """The velocity's extrapolation of `layout` in the package whose math module is `m`."""
    e = m.extrapolation
    if layout == 'open':
        return e.ZERO_GRADIENT
    if layout == 'inflow':
        inflow = m.vec(**{n: 1. if n == names[0] else 0. for n in names})
        return e.combine_sides(**{names[0]: (inflow, e.ZERO_GRADIENT)}, **{n: 0 for n in names[1:]})
    if layout == 'open-top':
        return e.combine_sides(**{n: 0 for n in names[:-1]}, **{names[-1]: (0, e.ZERO_GRADIENT)})
    assert layout == 'walls-periodic'
    return e.combine_sides(**{names[0]: e.PERIODIC}, **{n: 0 for n in names[1:]})


def smoke_boundary(m, layout, names):
    e = m.extrapolation
    if layout == 'walls-periodic':
        return e.combine_sides(**{names[0]: e.PERIODIC}, **{n: e.ZERO_GRADIENT for n in names[1:]})
    if layout == 'symmetric':
        return e.SYMMETRIC
    return e.ZERO_GRADIENT


def _random(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def grid_pair(dims, boundary_of, staggered, seed, scale=1.0, bounds=None):
    """The same numpy-seeded grid in JAX and the port: a staggered grid (face arrays of the sizes its boundary
    gives) or a centred one, on Box(bounds) (default the cells)."""
    names = _names(dims)
    res = dict(zip(names, SIZES[dims]))
    lim = bounds or {n: float(s) for n, s in res.items()}
    grids = []
    for m, f, g, wrap in ((jm, jf, jg, lambda a: a), (tm, tf, tg, torch.from_numpy)):
        make = f.StaggeredGrid if staggered else f.CenteredGrid
        grids.append(make(0., boundary_of(m, names), bounds=g.Box(**lim), **res))
    jgrid, grid = grids
    if staggered:
        arrays = [_random(tuple(jgrid.vector[d].values.shape.only(names, reorder=True).sizes), seed + i, scale)
                  for i, d in enumerate(names)]
        return (jgrid.with_values(jm.stack([jm.wrap(a, jm.spatial(*names)) for a in arrays], jm.dual(vector=names))),
                grid.with_values(tm.stack([tm.wrap(torch.from_numpy(a), tm.spatial(*names)) for a in arrays],
                                          tm.dual(vector=names))))
    arr = _random(SIZES[dims], seed, scale) + 1.0
    return (jgrid.with_values(jm.wrap(arr, jm.spatial(*names))),
            grid.with_values(tm.wrap(torch.from_numpy(arr), tm.spatial(*names))))


def arrays(field):
    names = field.resolution.names
    values = field.values
    if field.is_staggered:
        return [np.asarray(values[{'~vector': d}].numpy(names)) for d in names]
    return [np.asarray(values.numpy(names))]


def assert_close(port, ref, tol):
    for got, want in zip(arrays(port), arrays(ref)):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def advection_cases():
    """2D: every layout, centred and staggered, both schemes; 3D (JAX's tracing costs twice 2D's): every layout
    with the smoke step's pair, MacCormack of the centred field and semi-Lagrangian self-advection. Then a field
    in another layout than its velocity's: SYMMETRIC smoke, an inflow-walled staggered field in an open top."""
    cases = [(2, layout, kind, scheme) for layout in LAYOUTS for kind in ('centred', 'staggered') for scheme in SCHEMES]
    cases += [(3, layout, kind, scheme) for layout in LAYOUTS
              for kind, scheme in (('centred', 'mac_cormack'), ('staggered', 'semi_lagrangian'))]
    cases += [(2, 'open-top', kind, scheme) for kind in ('symmetric', 'inflow-field') for scheme in SCHEMES]
    cases += [(3, 'open-top', 'symmetric', 'mac_cormack'), (3, 'open-top', 'inflow-field', 'semi_lagrangian')]
    return cases


CASES = advection_cases()


def case_inputs(dims, layout, kind):
    """(JAX field, port field, JAX velocity, port velocity) of one case."""
    jv, v = grid_pair(dims, lambda m, n: velocity_boundary(m, layout, n), True, 10 * dims, 0.6)
    if kind == 'staggered':
        jfield, field = jv, v
    elif kind == 'inflow-field':
        jfield, field = grid_pair(dims, lambda m, n: velocity_boundary(m, 'inflow', n), True, 40 + dims)
    else:
        jfield, field = grid_pair(dims, lambda m, n: smoke_boundary(m, 'symmetric' if kind == 'symmetric' else layout,
                                                                    n), False, 20 + dims)
    return jfield, field, jv, v


def _jax_advect(scheme, jfield, jv, generic):
    if not generic:
        return getattr(jadvect, scheme)(jfield, jv, DT)
    if scheme == 'semi_lagrangian':
        return jfield.with_values(jadvect._window_interp_field(
            jfield, jadvect._displacement(jfield, jv, -DT, jadvect.euler), 2))
    return jfield.with_values(jadvect._mac_cormack_window(
        jfield, jadvect._displacement(jfield, jv, -DT, jadvect.euler),
        jadvect._displacement(jfield, jv, DT, jadvect.euler), 1.0, 2))


@pytest.fixture(scope='module')
def jax_results():
    """JAX's result of every advection case, from one jitted call per case group."""
    results = {}
    for dims in (2, 3):
        group = [c for c in CASES if c[0] == dims]
        inputs = [case_inputs(*c[:3]) for c in group]

        def run(pairs):
            return [_jax_advect(c[3], jfield, jv, c[2] == 'inflow-field') for c, (jfield, jv) in zip(group, pairs)]
        outs = jax.jit(run)([(i[0], i[2]) for i in inputs])
        results.update(dict(zip(group, outs)))
    return results


@pytest.mark.parametrize('case', CASES, ids=['-'.join(map(str, c)) for c in CASES])
def test_advection_matches_jax(case, jax_results):
    dims, layout, kind, scheme = case
    _, field, _, v = case_inputs(dims, layout, kind)
    got = getattr(advect, scheme)(field, v, DT)
    assert got.boundary == field.boundary
    assert_close(got, jax_results[case], TOL)


def _wake(m, f, g, a, fl, nx, ny):
    """`examples/wake_flow.py` at nx × ny in either package: (its initial velocity, its step(velocity,
    pressure)), CG at 1e-5."""
    e = m.extrapolation
    boundary = e.combine_sides(x=(m.vec(x=1.0, y=0.0), e.ZERO_GRADIENT), y=e.ZERO_GRADIENT)
    velocity = f.StaggeredGrid((1.0, 0.0), boundary, x=nx, y=ny, bounds=g.Box(x=float(nx), y=float(ny)))
    cylinder = fl.Obstacle(g.Sphere(x=8, y=ny / 2 + 1, radius=3))

    def step(velocity, pressure):
        velocity = a.semi_lagrangian(velocity, velocity, 1.0)
        return fl.make_incompressible(velocity, (cylinder,), m.Solve('CG', 1e-5, 1e-5, x0=pressure,
                                                                     max_iterations=300))
    return velocity, step


def _steps(step, state, steps):
    """`steps` calls of `step` on `state`."""
    for _ in range(steps):
        state = step(*state)
    return state


def test_wake_flow_recipe_matches_jax():
    """3 steps of the wake recipe at 32 × 16 (inflow vec(x=1, y=0), ZERO_GRADIENT outflow and sides, a cylinder)
    within 2e-4 of each field's scale, the CG counts equal and converged at 1e-5. JAX's rollout is jitted."""
    from phiflow_tpu.math import SolveTape as JSolveTape
    nx, ny, steps = 32, 16, 3
    jvel, jstep = _wake(jm, jf, jg, jadvect, jfluid, nx, ny)
    vel, step = _wake(tm, tf, tg, advect, fluid, nx, ny)
    with JSolveTape(record_runtime=True) as jtape:
        jvel, jp = jax.jit(lambda v: _steps(jstep, (v, None), steps))(jvel)
        jax.block_until_ready(jp.values.native())
    with tm.SolveTape() as tape:
        vel, p = _steps(step, (vel, None), steps)
    assert [i.iterations for i in tape] == [s.runtime_stats['iterations'] for s in jtape.solve_infos]
    assert all(i.converged for i in tape)
    assert_close(vel, jvel, STEP_TOL)
    assert_close(p, jp, STEP_TOL)


def _open_plume(m, f, g, a, fl, n, inflow_mask):
    """A smoke plume with an open top in either package: SmokePlume(n, dims=3)'s inflow sphere (`inflow_mask`,
    its soft mask × the inflow rate), buoyancy 0.1 and dt 0.5, the velocity under combine_sides(x=0, y=0,
    z=(0, ZERO_GRADIENT)), the smoke ZERO_GRADIENT: (velocity, smoke, step(v, s, p)), CG at 1e-5."""
    e = m.extrapolation
    names = ('x', 'y', 'z')
    res = dict(x=n, y=n, z=n)
    box = g.Box(x=float(n), y=float(n), z=float(n))
    v = f.StaggeredGrid(0., e.combine_sides(x=0, y=0, z=(0, e.ZERO_GRADIENT)), bounds=box, **res)
    s = f.CenteredGrid(0., e.ZERO_GRADIENT, bounds=box, **res)
    inflow = s.with_values(inflow_mask)

    def step(v, s, p):
        s = a.mac_cormack(s, v, 0.5, max_cells=1) + inflow
        v = a.semi_lagrangian(v, v, 0.5, max_cells=1)
        lift = f.resample(s * 0.05, to=v.vector['z'])
        v = v.with_values(m.stack([v.vector[d].values + lift.values if d == 'z' else v.vector[d].values
                                   for d in names], m.dual(vector=names)))
        v, p = fl.make_incompressible(v, (), m.Solve('CG', 1e-5, 1e-5, x0=p, max_iterations=300))
        return v, s, p
    return v, s, step


def test_open_plume_matches_jax():
    """2 steps of the open-top plume at 16³ within 2e-4 of each field's scale, CG counts equal and converged."""
    from phiflow_tpu.math import SolveTape as JSolveTape
    from phiflow_tpu_torch.models import SmokePlume
    n, steps = 16, 2
    model = SmokePlume(resolution=n, dims=3, device='cpu')
    mask = (model._inflow_mask_values_native(torch.zeros((n,) * 3)) * model.inflow_rate).numpy()
    jv, js, jstep = _open_plume(jm, jf, jg, jadvect, jfluid, n, jm.wrap(mask, jm.spatial('x,y,z')))
    v, s, step = _open_plume(tm, tf, tg, advect, fluid, n, tm.wrap(torch.from_numpy(mask), tm.spatial('x,y,z')))
    with JSolveTape(record_runtime=True) as jtape:
        jv, js, jp = jax.jit(lambda v, s: _steps(jstep, (v, s, None), steps))(jv, js)
        jax.block_until_ready(jp.values.native())
    with tm.SolveTape() as tape:
        v, s, p = _steps(step, (v, s, None), steps)
    assert [i.iterations for i in tape] == [s_.runtime_stats['iterations'] for s_ in jtape.solve_infos]
    assert all(i.converged for i in tape)
    for got, ref in ((v, jv), (s, js), (p, jp)):
        assert_close(got, ref, STEP_TOL)


POINT_CASES = [(2, layout, kind) for layout in LAYOUTS for kind in ('centred', 'staggered')]
OFF_ORIGIN = dict(x=(-2., 4.), y=(1., 7.), z=(0.5, 3.5))  # cells of unequal size


def point_inputs(dims, layout, kind):
    """(JAX grid, port grid, points as numpy): a 2D grid of the cells sampled at 64 points, some beyond it by
    up to 3 cells; a 3D grid on OFF_ORIGIN at 40 points around it."""
    boundary = velocity_boundary if kind == 'staggered' else smoke_boundary
    if dims == 2:
        jgrid, grid = grid_pair(2, lambda m, n: boundary(m, layout, n), kind == 'staggered', 50)
        return jgrid, grid, np.random.default_rng(51).uniform(-3, 19, (64, 2)).astype(np.float32)
    jgrid, grid = grid_pair(3, lambda m, n: boundary(m, layout, n), kind == 'staggered', 60, 0.3, OFF_ORIGIN)
    return jgrid, grid, np.random.default_rng(61).uniform((-2.5, 0.5, 0.), (4.5, 7.5, 4.), (40, 3)).astype(np.float32)


def _points(m, arr):
    return m.wrap(arr, m.instance('p'), m.channel(vector='x,y,z'[:2 * arr.shape[1] - 1]))


@pytest.fixture(scope='module')
def jax_point_results():
    """JAX's lookups of every point case, and the 3D staggered grid's `advect.points` with `rk4`, jitted at once."""
    cases = POINT_CASES + [(3, 'inflow', 'centred'), (3, 'inflow', 'staggered')]
    inputs = [point_inputs(*c) for c in cases]

    def run(grids):
        outs = [g.sample(jg.Point(_points(jm, i[2]))) for g, i in zip(grids, inputs)]
        moved = jadvect.points(jg.Point(_points(jm, inputs[-1][2])), grids[-1], 0.5, integrator=jadvect.rk4)
        return outs, moved.center
    outs, moved = jax.jit(run)([i[0] for i in inputs])
    return dict(zip(cases, outs), moved=moved)


def _assert_lookup(got, ref, kind):
    order = ('p', 'vector') if kind == 'staggered' else ('p',)
    want = np.asarray(ref.numpy(order))
    assert np.abs(got.numpy(order) - want).max() <= TOL * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize('case', POINT_CASES, ids=['-'.join(map(str, c[1:])) for c in POINT_CASES])
def test_lookups_at_points_match_jax(case, jax_point_results):
    """A 2D grid in each layout sampled at 64 points, some beyond the grid by up to 3 cells: within 1e-5."""
    _, grid, pts = point_inputs(*case)
    _assert_lookup(grid.sample(tg.Point(_points(tm, torch.from_numpy(pts)))), jax_point_results[case], case[2])


@pytest.mark.parametrize('kind', ['centred', 'staggered'])
def test_lookups_on_a_grid_off_the_origin(kind, jax_point_results):
    """A 3D grid on OFF_ORIGIN in the inflow layout sampled at 40 points, and (staggered) the points moved by
    `advect.points` with `rk4`: within 1e-5."""
    _, grid, pts = point_inputs(3, 'inflow', kind)
    tp = _points(tm, torch.from_numpy(pts))
    _assert_lookup(grid.sample(tg.Point(tp)), jax_point_results[(3, 'inflow', kind)], kind)
    if kind == 'staggered':
        moved = advect.points(tg.Point(tp), grid, 0.5, integrator=advect.rk4).center.numpy(('p', 'vector'))
        jmoved = np.asarray(jax_point_results['moved'].numpy(('p', 'vector')))
        assert np.abs(moved - jmoved).max() <= TOL * np.abs(jmoved).max()

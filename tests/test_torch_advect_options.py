"""The advection options of the Field API against the JAX package on the CPU:
the analogues of `tests/physics/test_advect_cfl.py`'s seven tests (the CFL
probe, `substeps='auto'` at CFL 3.3 and 4.0 and below 1, its gradient,
MacCormack and a staggered velocity), of
`tests/physics/test_advect_diffuse.py::test_semi_lagrangian_substeps_high_cfl`,
the `rk4` and `finite_rk4` integrators on grids, and the gather lookups of
`max_cells=None`. Each port result is held to JAX's within 1e-5 of its scale
(the gradient of an auto-substepped advection within 1e-4 of `jax.grad`'s)
and to the JAX test's own assertions. The port reads the substep count on
the host (one sync a call); JAX decides it in the graph. Inputs from numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.field as jf
import phiflow_tpu.geom as jg
import phiflow_tpu.math as jm
from phiflow_tpu.physics import advect as jadvect

import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.geom as tg
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.physics import advect

N = 64
TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _setup(speed, n=N):
    """A sine along x in a periodic box, advected by a uniform velocity `speed` along x: (JAX field, JAX velocity,
    port field, port velocity, the exact result)."""
    xs = np.arange(n) + 0.5
    f0 = (np.sin(2 * np.pi * xs / n)[:, None] * np.ones((1, n))).astype(np.float32)
    exact = np.sin(2 * np.pi * (xs - speed) / n)[:, None] * np.ones((1, n))
    out = []
    for m, f, g, wrap in ((jm, jf, jg, jnp.asarray), (tm, tf, tg, torch.from_numpy)):
        bounds = g.Box(x=float(n), y=float(n))
        out.append(f.CenteredGrid(m.wrap(wrap(f0), m.spatial(x=n, y=n)), m.extrapolation.PERIODIC, bounds, x=n, y=n))
        out.append(f.StaggeredGrid((speed, 0.), m.extrapolation.PERIODIC, bounds, x=n, y=n))
    return (*out, exact)


def _np(field):
    if field.is_staggered:
        return [np.asarray(field.vector[d].values.numpy(('x', 'y'))) for d in ('x', 'y')]
    return [np.asarray(field.values.numpy(('x', 'y')))]


def _close(port, ref, tol=TOL):
    for got, want in zip(_np(port), _np(ref)):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _l2(result, exact):
    return float(np.sqrt(np.mean((_np(result)[0] - exact) ** 2)))


def test_max_displacement_cells_probe():
    jfield, jvel, field, vel, _ = _setup(3.3)
    m = float(advect.max_displacement_cells(field, vel, 1.0))
    assert abs(m - 3.3) < 1e-5
    assert abs(m - float(jadvect.max_displacement_cells(jfield, jvel, 1.0))) < 1e-6


def test_auto_substeps_match_gather_at_high_cfl():
    """CFL 3.3 > max_cells=2: the plain window clamps; 'auto' (2 substeps) lands near the gather."""
    jfield, jvel, field, vel, exact = _setup(3.3)
    auto = advect.semi_lagrangian(field, vel, 1.0, max_cells=2, substeps='auto')
    _close(auto, jax.jit(lambda f: jadvect.semi_lagrangian(f, jvel, 1.0, max_cells=2, substeps='auto'))(jfield))
    clamped = advect.semi_lagrangian(field, vel, 1.0, max_cells=2)
    gather = advect.semi_lagrangian(field, vel, 1.0, max_cells=None)
    e_clamp, e_auto, e_gather = _l2(clamped, exact), _l2(auto, exact), _l2(gather, exact)
    assert e_clamp > 0.05
    assert e_auto < 0.005
    assert e_auto < e_clamp / 10
    assert abs(e_auto - e_gather) < 0.005


def test_auto_substeps_integer_displacement_exact():
    """4.0 cells at max_cells=2: 2 substeps of exactly 2 cells equal the gather."""
    jfield, jvel, field, vel, _ = _setup(4.0)
    auto = advect.semi_lagrangian(field, vel, 1.0, max_cells=2, substeps='auto')
    gather = advect.semi_lagrangian(field, vel, 1.0, max_cells=None)
    np.testing.assert_allclose(_np(auto)[0], _np(gather)[0], atol=1e-5)
    _close(auto, jax.jit(lambda f: jadvect.semi_lagrangian(f, jvel, 1.0, max_cells=2, substeps='auto'))(jfield))


def test_auto_substeps_low_cfl_noop():
    """CFL 0.7 < max_cells: one substep, bit-equal to the plain window."""
    jfield, jvel, field, vel, _ = _setup(0.7)
    auto = advect.semi_lagrangian(field, vel, 1.0, max_cells=2, substeps='auto')
    np.testing.assert_array_equal(_np(auto)[0], _np(advect.semi_lagrangian(field, vel, 1.0, max_cells=2))[0])
    _close(auto, jax.jit(lambda f: jadvect.semi_lagrangian(f, jvel, 1.0, max_cells=2, substeps='auto'))(jfield))


def test_auto_substeps_differentiable():
    """The gradient of Σ out² through 'auto' (2 substeps at CFL 3.3) with respect to the field's values:
    finite, nonzero, within 1e-4 of `jax.grad`'s."""
    jfield, jvel, field, vel, _ = _setup(3.3)

    def jloss(values):
        out = jadvect.semi_lagrangian(jfield.with_values(values), jvel, 1.0, max_cells=2, substeps='auto')
        return jnp.sum(out.values.native(('x', 'y')) ** 2)
    ref = np.asarray(jax.jit(jax.grad(jloss))(jfield.values).native(('x', 'y')))
    leaf = field.values.torch(('x', 'y')).clone().requires_grad_()
    out = advect.semi_lagrangian(field.with_values(tm.wrap(leaf, tm.spatial('x,y'))), vel, 1.0, max_cells=2,
                                 substeps='auto')
    (out.values.torch(('x', 'y')) ** 2).sum().backward()
    got = leaf.grad.numpy()
    assert np.all(np.isfinite(got)) and np.abs(got).max() > 0
    assert np.abs(got - ref).max() <= GRAD_TOL * np.abs(ref).max()


def test_mac_cormack_auto_substeps():
    jfield, jvel, field, vel, exact = _setup(3.3)
    auto = advect.mac_cormack(field, vel, 1.0, max_cells=2, substeps='auto')
    _close(auto, jax.jit(lambda f: jadvect.mac_cormack(f, jvel, 1.0, max_cells=2, substeps='auto'))(jfield))
    e_auto = _l2(auto, exact)
    assert e_auto < 0.005
    assert e_auto < _l2(advect.mac_cormack(field, vel, 1.0, max_cells=2), exact) / 5


def test_staggered_auto_substeps():
    """Self-advection of a staggered velocity at CFL 3 > K: 'auto' within 1e-4 of the gather, and of JAX's."""
    out = []
    for m, f, g in ((jm, jf, jg), (tm, tf, tg)):
        out.append(f.StaggeredGrid((3.0, 0.), m.extrapolation.PERIODIC, g.Box(x=float(N), y=float(N)), x=N, y=N))
    jvel, vel = out
    auto = advect.semi_lagrangian(vel, vel, 1.0, max_cells=2, substeps='auto')
    gather = advect.semi_lagrangian(vel, vel, 1.0, max_cells=None)
    for a, b in zip(_np(auto), _np(gather)):
        np.testing.assert_allclose(a, b, atol=1e-4)
    _close(auto, jax.jit(lambda v: jadvect.semi_lagrangian(v, v, 1.0, max_cells=2, substeps='auto'))(jvel))


def test_semi_lagrangian_substeps_high_cfl():
    """At CFL 4, 4 substeps of the K=2 window track the gather within 1e-5 (a uniform velocity), a clamped
    step does not; each equals JAX's."""
    n = 32
    xs = np.arange(n) + 0.5
    blob = np.exp(-0.5 * ((xs[:, None] - 16) ** 2 + (xs[None, :] - 16) ** 2) / 4).astype(np.float32)
    fields = []
    for m, f, g, wrap in ((jm, jf, jg, jnp.asarray), (tm, tf, tg, torch.from_numpy)):
        bounds = g.Box(x=n, y=n)
        fields.append((f.CenteredGrid(m.wrap(wrap(blob), m.spatial(x=n, y=n)), m.extrapolation.PERIODIC, bounds=bounds,
                                      x=n, y=n),
                       f.StaggeredGrid((4.0, 0.0), m.extrapolation.PERIODIC, bounds=bounds, x=n, y=n)))
    (jsmoke, jvel), (smoke, vel) = fields
    exact = advect.semi_lagrangian(smoke, vel, 1.0, max_cells=None)
    sub = advect.semi_lagrangian(smoke, vel, 1.0, substeps=4)
    clamped = advect.semi_lagrangian(smoke, vel, 1.0)
    assert np.abs(_np(sub)[0] - _np(exact)[0]).max() < 1e-5
    assert np.abs(_np(clamped)[0] - _np(exact)[0]).max() > 0.1
    jexact, jsub = jax.jit(lambda s: (jadvect.semi_lagrangian(s, jvel, 1.0, max_cells=None),
                                      jadvect.semi_lagrangian(s, jvel, 1.0, substeps=4)))(jsmoke)
    _close(exact, jexact)
    _close(sub, jsub)


def _box_pair(boundary_name, staggered, seed, scale, n=12):
    """A numpy-seeded 2D grid at n × 12 of Box(x=6, y=3) in both packages: a staggered velocity (closed box or
    open with a vector inflow) or a centred field under BOUNDARY."""
    rng = np.random.default_rng(seed)
    out = []
    for m, f, g, wrap in ((jm, jf, jg, jnp.asarray), (tm, tf, tg, torch.from_numpy)):
        e = m.extrapolation
        boundary = {'closed': 0., 'inflow': e.combine_sides(x=(m.vec(x=1., y=0.), e.ZERO_GRADIENT), y=0),
                    'boundary': e.BOUNDARY}[boundary_name]
        make = f.StaggeredGrid if staggered else f.CenteredGrid
        out.append(make(0., boundary, bounds=g.Box(x=6., y=3.), x=n, y=12))
    jgrid, grid = out
    names = ('x', 'y')
    if staggered:
        arrays = [(scale * rng.standard_normal(tuple(jgrid.vector[d].values.shape.only(names, reorder=True).sizes)))
                  .astype(np.float32) for d in names]
        return (jgrid.with_values(jm.stack([jm.wrap(a, jm.spatial(*names)) for a in arrays], jm.dual(vector=names))),
                grid.with_values(tm.stack([tm.wrap(torch.from_numpy(a), tm.spatial(*names)) for a in arrays],
                                          tm.dual(vector=names))))
    arr = (1 + scale * rng.standard_normal((n, 12))).astype(np.float32)
    return jgrid.with_values(jm.wrap(arr, jm.spatial(*names))), grid.with_values(tm.wrap(torch.from_numpy(arr),
                                                                                          tm.spatial(*names)))


INTEGRATOR_CASES = [(scheme, integrator, layout) for scheme in ('semi_lagrangian', 'mac_cormack')
                    for integrator in ('rk4', 'finite_rk4') for layout in ('closed', 'inflow')]


@pytest.mark.parametrize('case', INTEGRATOR_CASES, ids=['-'.join(c) for c in INTEGRATOR_CASES])
def test_integrators_on_grids_match_jax(case):
    """A centred field advected with `rk4` / `finite_rk4` lookup points in a closed or an inflow-walled box
    (cells of 0.5 × 0.25): the window lookups along the integrator's displacement, within 1e-5 of JAX's."""
    scheme, integrator, layout = case
    jv, v = _box_pair(layout, True, 3, 0.4)
    js, s = _box_pair('boundary', False, 4, 0.5)
    got = getattr(advect, scheme)(s, v, 0.2, integrator=getattr(advect, integrator))
    ref = jax.jit(lambda a, b: getattr(jadvect, scheme)(a, b, 0.2, integrator=getattr(jadvect, integrator)))(js, jv)
    _close(got, ref)


GATHER_CASES = [(scheme, kind) for scheme in ('semi_lagrangian', 'mac_cormack') for kind in ('centred', 'staggered')]


@pytest.mark.parametrize('case', GATHER_CASES, ids=['-'.join(c) for c in GATHER_CASES])
def test_gather_lookups_match_jax(case):
    """`max_cells=None`: the field looked up at the backtraced points by `math.grid_sample` (MacCormack clamped
    to the backward point's neighbours), in an inflow-walled box at a CFL near 3, within 1e-5 of JAX's."""
    scheme, kind = case
    jv, v = _box_pair('inflow', True, 5, 1.5)
    jfield, field = (jv, v) if kind == 'staggered' else _box_pair('boundary', False, 6, 0.5)
    got = getattr(advect, scheme)(field, v, 0.5, max_cells=None)
    ref = jax.jit(lambda a, b: getattr(jadvect, scheme)(a, b, 0.5, max_cells=None))(jfield, jv)
    assert got.boundary == field.boundary
    _close(got, ref)

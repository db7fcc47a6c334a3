"""Batch dims through the port's Field layer against the JAX package's, on the
CPU: the analogue of `tests/field/test_grids.py::test_batch_dims`, then
batched `spatial_gradient` (at the centres and the faces), `divergence`,
`stagger`, `resample` (centres to faces and faces to centres), lookups at
points and
`semi_lagrangian` / `mac_cormack` with the grid batched, the velocity
batched, or both; and the window interpolation's backward (the K6ᵀ / K7ᵀ
twin) over a batch against `jax.grad` of the JAX package's window sum. The
inputs are numpy arrays from a seed with distinct entries (`Noise` draws
differ between the packages). Every result is held to JAX's within 1e-5 and,
entry by entry, to the port's own unbatched result within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.field as jf
import phiflow_tpu.math as jm
from phiflow_tpu.math import _nd as jnd, extrapolation as jext
from phiflow_tpu.physics import advect as jadvect

import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.ops import interp as TI
from phiflow_tpu_torch.physics import advect

TOL = 1e-5
ENTRY_TOL = 1e-6
B = 3


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _random(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _shapes(names, sizes, batched):
    """(port Shape, JAX Shape) of `names` with a batch dim `b` of B first where `batched`."""
    sp, jsp = tm.spatial(**dict(zip(names, sizes))), jm.spatial(**dict(zip(names, sizes)))
    if batched:
        return tm.batch(b=B) & sp, jm.batch(b=B) & jsp
    return sp, jsp


def _pair(arr, names, batched):
    shape, jshape = _shapes(names, arr.shape[int(batched):], batched)
    return tm.wrap(torch.from_numpy(arr.copy()), shape), jm.wrap(arr, jshape)


def _order(values, names):
    return (('b',) if 'b' in values.shape else ()) + tuple(names)


def _numpy(values, names):
    return values.numpy(_order(values, names))


def _close_jax(port, ref, names, tol=TOL):
    """Equal shapes (names and sizes) and values within `tol` of the largest."""
    assert set(port.shape.names) == set(ref.shape.names)
    order = _order(port, names)
    got, want = port.numpy(order), np.asarray(ref.numpy(order))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _close_entries(batched, per_entry, names):
    """Entry e of a batched result against the port's unbatched result on entry e's inputs."""
    got = _numpy(batched, names)
    assert got.shape[0] == B
    for e, one in enumerate(per_entry):
        ref = one.numpy(tuple(names))
        assert np.abs(got[e] - ref).max() <= ENTRY_TOL * max(np.abs(ref).max(), 1.0)


def _grid(arr, names, batched, ext, jext_):
    values, jvalues = _pair(arr, names, batched)
    sizes = dict(zip(names, arr.shape[int(batched):]))
    return tf.CenteredGrid(values, ext, **sizes), jf.CenteredGrid(jvalues, jext_, **sizes)


def _staggered(comps, names, batched, ext, jext_, sizes):
    port = tm.stack([_pair(c, names, batched)[0] for c in comps], tm.dual(vector=','.join(names)))
    jax_ = jm.stack([_pair(c, names, batched)[1] for c in comps], jm.dual(vector=','.join(names)))
    return tf.StaggeredGrid(port, ext, **sizes), jf.StaggeredGrid(jax_, jext_, **sizes)


def _entry(arr, e, batched):
    return arr[e] if batched else arr


# ---------------------------------------------------------------------------
# the analogue of test_batch_dims, and the differential operators
# ---------------------------------------------------------------------------

def test_batch_dims():
    """A CenteredGrid with a batch dim b=3 (periodic 8²) keeps it through `laplace`."""
    names = ('x', 'y')
    arr = _random((B, 8, 8), 0)
    g, jg = _grid(arr, names, True, tm.extrapolation.PERIODIC, jm.extrapolation.PERIODIC)
    assert g.shape.batch.sizes == (3,)
    lap = tf.laplace(g)
    assert lap.shape.batch.sizes == (3,)
    _close_jax(lap.values, jf.laplace(jg).values, names)
    _close_entries(lap.values, [tf.laplace(_grid(arr[e], names, False, tm.extrapolation.PERIODIC,
                                                 jm.extrapolation.PERIODIC)[0]).values for e in range(B)], names)


BOUNDARIES = {'periodic': (tm.extrapolation.PERIODIC, jm.extrapolation.PERIODIC),
              'zero-gradient': (tm.extrapolation.ZERO_GRADIENT, jm.extrapolation.ZERO_GRADIENT),
              'zero': (tm.extrapolation.ZERO, jm.extrapolation.ZERO)}


GRADIENT_CASES = [(2, 'periodic'), (2, 'zero-gradient'), (3, 'zero')]


@pytest.mark.parametrize('dims,boundary', GRADIENT_CASES, ids=[f'{d}d-{b}' for d, b in GRADIENT_CASES])
def test_batched_gradients_and_stagger(dims, boundary):
    """`spatial_gradient` at the centres and at the faces, `laplace` and
    `stagger(minimum)` of a batched centred grid."""
    names = ('x', 'y', 'z')[:dims]
    n = 8 if dims == 3 else 12
    arr = _random((B,) + (n,) * dims, 1 + dims)
    ext, jext_ = BOUNDARIES[boundary]
    g, jg = _grid(arr, names, True, ext, jext_)
    singles = [_grid(arr[e], names, False, ext, jext_)[0] for e in range(B)]
    grad, jgrad = tf.spatial_gradient(g, at='center'), jf.spatial_gradient(jg, at='center')
    for d in names:
        _close_jax(grad.values[{'vector': d}], jgrad.values[{'vector': d}], names)
        _close_entries(grad.values[{'vector': d}], [tf.spatial_gradient(s, at='center').values[{'vector': d}]
                                                    for s in singles], names)
    face, jface = tf.spatial_gradient(g, at='face'), jf.spatial_gradient(jg, at='face')
    stag = tf.stagger(g, tm.minimum, ext)
    jstag = jf.stagger(jg, jm.minimum, jext_)
    for d in names:
        _close_jax(face.vector[d].values, jface.vector[d].values, names)
        _close_entries(face.vector[d].values, [tf.spatial_gradient(s, at='face').vector[d].values
                                               for s in singles], names)
        _close_jax(stag.vector[d].values, jstag.vector[d].values, names)
        _close_entries(stag.vector[d].values, [tf.stagger(s, tm.minimum, ext).vector[d].values for s in singles],
                       names)
    _close_jax(tf.laplace(g).values, jf.laplace(jg).values, names)


def _velocity_arrays(names, n, periodic, seed, batched, scale=0.6):
    """Face components of a staggered velocity (the closed box's interior faces, or the periodic box's)."""
    comps = []
    for a in range(len(names)):
        shape = tuple(n - (a == b and not periodic) for b in range(len(names)))
        comps.append(_random(((B,) if batched else ()) + shape, seed + a, scale))
    return comps


DIVERGENCE_CASES = [(2, False), (2, True), (3, False)]


@pytest.mark.parametrize('dims,periodic', DIVERGENCE_CASES,
                         ids=[f'{d}d-{"periodic" if p else "closed"}' for d, p in DIVERGENCE_CASES])
def test_batched_divergence_and_resample(dims, periodic):
    """`divergence` of a batched staggered grid, `resample` of it to the
    centres, and of a batched centred grid (a vector: smoke · (0, …, b)) to
    the faces, as the buoyancy of a smoke step resamples it."""
    names = ('x', 'y', 'z')[:dims]
    n = 8 if dims == 3 else 12
    sizes = dict(zip(names, (n,) * dims))
    ext, jext_ = (tm.extrapolation.PERIODIC, jm.extrapolation.PERIODIC) if periodic else \
        (tm.extrapolation.ZERO, jm.extrapolation.ZERO)
    comps = _velocity_arrays(names, n, periodic, 10 * dims, True)
    v, jv = _staggered(comps, names, True, ext, jext_, sizes)
    singles = [_staggered([c[e] for c in comps], names, False, ext, jext_, sizes)[0] for e in range(B)]
    div, jdiv = tf.divergence(v), jf.divergence(jv)
    _close_jax(div.values, jdiv.values, names)
    _close_entries(div.values, [tf.divergence(s).values for s in singles], names)
    s_ext, s_jext = (tm.extrapolation.PERIODIC, jm.extrapolation.PERIODIC) if periodic else \
        (tm.extrapolation.ZERO_GRADIENT, jm.extrapolation.ZERO_GRADIENT)
    smoke, jsmoke = _grid(_random((B,) + (n,) * dims, 7), names, True, s_ext, s_jext)
    centres, jcentres = tf.resample(v, to=smoke), jf.resample(jv, to=jsmoke)
    for d in names:
        _close_jax(centres.values[{'vector': d}], jcentres.values[{'vector': d}], names)
    lift = (0.,) * (dims - 1) + (0.1,)
    faces, jfaces = tf.resample(smoke * lift, to=v), jf.resample(jsmoke * lift, to=jv)
    smoke_singles = [_grid(_numpy(smoke.values, names)[e], names, False, s_ext, s_jext)[0] for e in range(B)]
    for d in names:
        _close_jax(faces.vector[d].values, jfaces.vector[d].values, names)
        _close_entries(faces.vector[d].values, [tf.resample(s * lift, to=v).vector[d].values
                                                for s in smoke_singles], names)


# ---------------------------------------------------------------------------
# advection: the grid batched, the velocity batched, or both
# ---------------------------------------------------------------------------

ADVECTION_CASES = [(2, 'grid'), (2, 'velocity'), (3, 'both')]


@pytest.mark.parametrize('scheme', ['semi_lagrangian', 'mac_cormack'])
@pytest.mark.parametrize('dims,batched', ADVECTION_CASES, ids=[f'{d}d-{b}' for d, b in ADVECTION_CASES])
def test_batched_advection(dims, batched, scheme):
    """A centred smoke (zero-gradient) advected with dt = 0.8 through the
    window kernels' twin, and a batched velocity (closed box) advecting
    itself semi-Lagrangian, as a smoke step does: the result has the batch
    of whichever input carries it. A batch on the velocity alone the JAX
    package refuses (its window sum takes the grid's dims): there the JAX
    side advects the smoke expanded to the batch."""
    names = ('x', 'y', 'z')[:dims]
    n = 8 if dims == 3 else 12
    sizes = dict(zip(names, (n,) * dims))
    grid_b, vel_b = batched in ('grid', 'both'), batched in ('velocity', 'both')
    comps = _velocity_arrays(names, n, False, 20 + dims, vel_b)
    v, jv = _staggered(comps, names, vel_b, tm.extrapolation.ZERO, jm.extrapolation.ZERO, sizes)
    smoke_arr = (0.5 + _random(((B,) if grid_b else ()) + (n,) * dims, 30, 0.3)).astype(np.float32)
    s, js = _grid(smoke_arr, names, grid_b, tm.extrapolation.ZERO_GRADIENT, jm.extrapolation.ZERO_GRADIENT)
    port_fn = getattr(advect, scheme)
    jax_fn = jax.jit(lambda f, u: getattr(jadvect, scheme)(f, u, 0.8, max_cells=1))  # JAX's tracing: jitted
    out = port_fn(s, v, 0.8, max_cells=1)
    if not grid_b:  # the JAX package's window sum takes the grid's dims only: the smoke expanded to the batch
        js = js.with_values(jm.expand(js.values, jm.batch(b=B)))
    _close_jax(out.values, jax_fn(js, jv).values, names)
    self_advect = vel_b and scheme == 'semi_lagrangian'
    if self_advect:
        vout, jvout = advect.semi_lagrangian(v, v, 0.8, max_cells=1), jax_fn(jv, jv)
        for d in names:
            _close_jax(vout.vector[d].values, jvout.vector[d].values, names)
    singles = []
    for e in range(B):
        ve = _staggered([_entry(c, e, vel_b) for c in comps], names, False, tm.extrapolation.ZERO,
                        jm.extrapolation.ZERO, sizes)[0]
        se = _grid(_entry(smoke_arr, e, grid_b), names, False, tm.extrapolation.ZERO_GRADIENT,
                   jm.extrapolation.ZERO_GRADIENT)[0]
        singles.append((se, ve))
    _close_entries(out.values, [port_fn(se, ve, 0.8, max_cells=1).values for se, ve in singles], names)
    if self_advect:
        for d in names:
            _close_entries(vout.vector[d].values, [advect.semi_lagrangian(ve, ve, 0.8, max_cells=1).vector[d].values
                                                   for _, ve in singles], names)


# ---------------------------------------------------------------------------
# the K6ᵀ / K7ᵀ twin over a batch
# ---------------------------------------------------------------------------

def _jax_batched_grads(grid, disps, K, extrema, scale, ext, weights):
    names = tuple('xyz'[:len(disps)])
    shape = jm.batch(b=grid.shape[0]) & jm.spatial(**dict(zip(names, grid.shape[1:])))
    order = ('b',) + names

    def f(g, *ds):
        r = jnd.shift_window_interp(jm.Tensor(g, shape), list(ds), ext, K, compute_extrema=extrema, disp_scale=scale)
        r = r if extrema else (r,)
        return sum(jnp.sum(ri.native(order) * w) for ri, w in zip(r, weights))
    grads = jax.grad(f, argnums=tuple(range(1 + len(disps))))(jnp.asarray(grid), *[jnp.asarray(x) for x in disps])
    return [np.asarray(g) for g in grads]


def _port_grads(grid, disps, K, extrema, scale, halo, weights):
    g = torch.tensor(grid, requires_grad=True)
    ds = [torch.tensor(x, requires_grad=True) for x in disps]
    fn = TI.window_interp_3d if len(disps) == 3 else TI.window_interp_2d
    r = fn(g, ds, K, compute_extrema=extrema, disp_scale=scale, **halo)
    r = r if extrema else (r,)
    sum((ri * torch.tensor(w)).sum() for ri, w in zip(r, weights)).backward()
    return [g.grad.numpy()] + [x.grad.numpy() for x in ds]


@pytest.mark.parametrize('d,shared', [(2, True), (3, False)], ids=['2d-shared-displacement',
                                                                   '3d-batched-displacement'])
def test_batched_window_gradient_matches_jax(d, shared):
    """The VJP of the window interpolation over a batch of grids (edge halo,
    with the extrema's upstream gradients), the displacement batched too or
    shared by every entry, against `jax.grad` of the JAX package's window sum;
    each entry's gradients against the port's unbatched VJP on that entry (a
    shared displacement's gradient is the sum over the entries')."""
    rng = np.random.default_rng(40 + d)
    shape = (6, 7, 9)[:d] if d == 3 else (10, 13)
    scale = (0.8, -1.1, 0.6)[:d]
    grid = rng.standard_normal((B,) + shape).astype(np.float32)
    dshape = shape if shared else (B,) + shape
    disps = [rng.uniform(-2.0, 2.0, dshape).astype(np.float32) for _ in range(d)]
    weights = [rng.standard_normal((B,) + shape).astype(np.float32) for _ in range(3)]
    got = _port_grads(grid, disps, 1, True, scale, dict(halo='edge'), weights)
    ref = _jax_batched_grads(grid, disps, 1, True, scale, jext.BOUNDARY, weights)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-6)
    singles = [_port_grads(grid[e], [x if shared else x[e] for x in disps], 1, True, scale, dict(halo='edge'),
                           [w[e] for w in weights]) for e in range(B)]
    for e in range(B):
        assert np.abs(got[0][e] - singles[e][0]).max() <= ENTRY_TOL * max(np.abs(singles[e][0]).max(), 1e-6)
    for i in range(d):
        want = sum(s[1 + i] for s in singles) if shared else np.stack([s[1 + i] for s in singles])
        assert np.abs(got[1 + i] - want).max() <= ENTRY_TOL * max(np.abs(want).max(), 1e-6)


def test_batched_lookup_at_points():
    """A batched centred grid (constant boundary, from the origin) and a
    batched staggered velocity (closed box) sampled at a point cloud: each
    entry as JAX's lookup of the batch and as the port's lookup of that
    entry alone."""
    from phiflow_tpu.geom import Point as JPoint
    from phiflow_tpu_torch.geom import Point
    names = ('x', 'y')
    pts = np.random.default_rng(50).uniform(0.5, 11.5, (20, 2)).astype(np.float32)
    points = tm.wrap(torch.from_numpy(pts), tm.instance('points'), tm.channel(vector='x,y'))
    jpoints = jm.wrap(pts, jm.instance('points'), jm.channel(vector='x,y'))
    arr = _random((B, 12, 12), 51)
    g, jg = _grid(arr, names, True, tm.extrapolation.ZERO, jm.extrapolation.ZERO)
    got, ref = tf.sample(g, Point(points)), jf.sample(jg, JPoint(jpoints))
    _close_jax(got, ref, ('points',))
    _close_entries(got, [tf.sample(_grid(arr[e], names, False, tm.extrapolation.ZERO, jm.extrapolation.ZERO)[0],
                                   Point(points)) for e in range(B)], ('points',))
    comps = _velocity_arrays(names, 12, False, 52, True)
    v, jv = _staggered(comps, names, True, tm.extrapolation.ZERO, jm.extrapolation.ZERO, dict(x=12, y=12))
    vgot, vref = tf.sample(v, Point(points)), jf.sample(jv, JPoint(jpoints))
    _close_jax(vgot, vref, ('points', 'vector'))
    for e in range(B):
        ve = _staggered([c[e] for c in comps], names, False, tm.extrapolation.ZERO, jm.extrapolation.ZERO,
                        dict(x=12, y=12))[0]
        one = tf.sample(ve, Point(points)).numpy(('points', 'vector'))
        assert np.abs(vgot.numpy(('b', 'points', 'vector'))[e] - one).max() <= ENTRY_TOL * np.abs(one).max()

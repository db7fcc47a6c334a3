"""The batched pressure projection of the port against the JAX package's, on
the CPU: the analogue of `tests/physics/test_fluid.py::test_batched_incompressible`
(2D 16², b = 2, ZERO walls); 3D 16³, b = 3, closed and periodic, with the
V-cycle preconditioner (one CG loop for all systems, equal CG counts, 1e-4
of scale); the other boxes and a nested domain, entry by entry; the batched twins of K1–K4 against JAX's `poisson_apply`,
`poisson_smooth`, `residual_restrict` and `prolong_add` with a leading batch
(JAX's Pallas kernels in interpret mode under `lax.map`); and a system that
converges early keeping its x. Inputs are numpy arrays from a seed, each
entry distinct. Every batched result is also held, entry by entry, to the
port's own unbatched result: on the CPU an entry's reductions run as an
unbatched system's, so the two agree to 1e-6 of scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.field as jf
import phiflow_tpu.math as jm
from phiflow_tpu.ops import poisson as JP, transfer as JT
from phiflow_tpu.physics import fluid as jfluid

import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.math import SolveTape
from phiflow_tpu_torch.math._solve import cg
from phiflow_tpu_torch.ops import poisson as TP, transfer as TT
from phiflow_tpu_torch.physics import fluid

ENTRY_TOL = 1e-6
BCS = [(('neumann', 'neumann'),) * 3, (('periodic', 'periodic'),) * 3,
       (('neumann', 'ghost0'), ('periodic', 'periodic'), ('ghost0', 'neumann'))]
BC_IDS = ['neumann', 'periodic', 'mixed']
INV = (1.0, 0.7, 1.3)
SHAPE = (8, 16, 128)  # JAX's Pallas forms need z a multiple of 128 and y of 8


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _random(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _scaled(got, ref):
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def _velocity(names, n, periodic, B, seed):
    """Face components (B, …) of a staggered velocity in the closed box (interior faces) or the periodic box."""
    comps = []
    for a in range(len(names)):
        shape = tuple(n - (a == b and not periodic) for b in range(len(names)))
        comps.append(_random((B,) + shape, seed + a))
    return comps


def _staggered(comps, names, ext, jext, batched=True):
    sizes = {d: max(c.shape[int(batched) + a] for c in comps) for a, d in enumerate(names)}
    shape = lambda c, m: (m.batch(b=c.shape[0]) & m.spatial(**dict(zip(names, c.shape[1:])))) if batched \
        else m.spatial(**dict(zip(names, c.shape)))  # noqa: E731
    port = tm.stack([tm.wrap(torch.from_numpy(c.copy()), shape(c, tm)) for c in comps],
                    tm.dual(vector=','.join(names)))
    jax_ = jm.stack([jm.wrap(c, shape(c, jm)) for c in comps], jm.dual(vector=','.join(names)))
    return tf.StaggeredGrid(port, ext, **sizes), jf.StaggeredGrid(jax_, jext, **sizes)


def _components(v, names):
    return [v.vector[d].values.numpy(('b',) + tuple(names)) for d in names]


def _project_both(comps, names, periodic, tol):
    ext, jext = (tm.extrapolation.PERIODIC, jm.extrapolation.PERIODIC) if periodic else \
        (tm.extrapolation.ZERO, jm.extrapolation.ZERO)
    v, jv = _staggered(comps, names, ext, jext)
    with SolveTape() as tape:
        v2, p = fluid.make_incompressible(v, (), tm.Solve('CG', tol, tol))
    with jm.SolveTape(record_runtime=True) as jtape:  # JAX's tracing: jitted
        jv2, jp = jax.jit(lambda u: jfluid.make_incompressible(u, (), jm.Solve('CG', tol, tol)))(jv)
    return (v, v2, p, tape[0]), (jv2, jp, jtape.solve_infos[-1])


def _entry_projection(comps, names, periodic, tol, e):
    ext = tm.extrapolation.PERIODIC if periodic else tm.extrapolation.ZERO
    v, _ = _staggered([c[e] for c in comps], names, ext,
                      jm.extrapolation.PERIODIC if periodic else jm.extrapolation.ZERO, batched=False)
    with SolveTape() as tape:
        v2, p = fluid.make_incompressible(v, (), tm.Solve('CG', tol, tol))
    return v2, p, tape[0]


def test_batched_incompressible():
    """StaggeredGrid with a batch dim b=2 (ZERO walls, 16²) projected by CG
    at 1e-5: 'b' stays, every entry divergence-free, each as JAX's and as the
    port's unbatched projection of that entry."""
    names = ('x', 'y')
    comps = _velocity(names, 16, False, 2, 0)
    (v, v2, p, info), (jv2, jp, jinfo) = _project_both(comps, names, False, 1e-5)
    assert 'b' in v2.shape and p.shape.get_size('b') == 2
    div = tf.divergence(v2).values
    assert float(tm.max(abs(div), div.shape)) < 5e-4
    for got, ref in zip(_components(v2, names), [np.asarray(c) for c in _components(jv2, names)]):
        assert _scaled(got, ref) <= 1e-4
    assert _scaled(p.values.numpy(('b', 'x', 'y')), np.asarray(jp.values.numpy(('b', 'x', 'y')))) <= 1e-4
    assert info.iterations == int(np.max(jinfo.runtime_stats['iterations']))
    for e in range(2):
        ve, pe, _ = _entry_projection(comps, names, False, 1e-5, e)
        for got, ref in zip(_components(v2, names), [ve.vector[d].values.numpy(names) for d in names]):
            assert _scaled(got[e], ref) <= ENTRY_TOL
        assert _scaled(p.values.numpy(('b',) + names)[e], pe.values.numpy(names)) <= ENTRY_TOL


@pytest.mark.parametrize('periodic', [False, True], ids=['closed', 'periodic'])
def test_batched_projection_3d_vcycle(periodic):
    """3D 16³, b = 3, closed and periodic, CG at 1e-4 preconditioned by the
    V-cycle (16 cells an axis: the projection's own preconditioner): one CG
    loop, its count JAX's (the largest of the entries' own counts), each
    field within 1e-4 of JAX's scale, each entry as its unbatched projection
    with its own count."""
    names = ('x', 'y', 'z')
    comps = _velocity(names, 16, periodic, 3, 10 + int(periodic))
    (v, v2, p, info), (jv2, jp, jinfo) = _project_both(comps, names, periodic, 1e-4)
    for got, ref in zip(_components(v2, names), [np.asarray(c) for c in _components(jv2, names)]):
        assert _scaled(got, ref) <= 1e-4
    order = ('b',) + names
    assert _scaled(p.values.numpy(order), np.asarray(jp.values.numpy(order))) <= 1e-4
    assert info.iterations == int(np.max(jinfo.runtime_stats['iterations']))
    counts = []
    for e in range(3):
        ve, pe, einfo = _entry_projection(comps, names, periodic, 1e-4, e)
        counts.append(einfo.iterations)
        for got, ref in zip(_components(v2, names), [ve.vector[d].values.numpy(names) for d in names]):
            assert _scaled(got[e], ref) <= ENTRY_TOL
        assert _scaled(p.values.numpy(order)[e], pe.values.numpy(names)) <= ENTRY_TOL
    assert info.iterations == max(counts)
    assert tuple(np.asarray(info.residual).shape) == (3,)


BOXES = {'open': lambda E: E.ZERO_GRADIENT,
         'wall-with-normal-velocity': lambda E: E.combine_sides(x=(E.ConstantExtrapolation(1.0), E.ZERO), y=E.ZERO),
         'periodic-and-open': lambda E: E.combine_sides(x=E.PERIODIC, y=(E.ZERO, E.ZERO_GRADIENT))}


@pytest.mark.parametrize('box', list(BOXES))
def test_batched_projection_in_every_box(box):
    """The boxes beyond the closed and periodic ones (an open box: ghost0
    pressure beyond it; a wall with a normal velocity; periodic beside open
    sides), 2D 16², b = 2: each entry its own unbatched projection, its CG
    count, the batch's the larger. (Each unbatched case is held to JAX in
    test_torch_projection_cases.py.)"""
    from phiflow_tpu_torch.field._field import face_components
    ext = BOXES[box](tm.extrapolation)
    like = tf.StaggeredGrid(0., ext, x=16, y=16)
    shapes = [c.shape.only(('x', 'y'), reorder=True) for c in face_components(like.values)]
    arrays = [_random((2,) + tuple(sh.sizes), 20 + a) for a, sh in enumerate(shapes)]

    def project(batched, e=None):
        comps = [tm.wrap(torch.from_numpy(a.copy() if batched else a[e].copy()),
                         (tm.batch(b=2) & sh) if batched else sh) for a, sh in zip(arrays, shapes)]
        with SolveTape() as tape:
            v2, p = fluid.make_incompressible(like.with_values(tm.stack(comps, tm.dual(vector='x,y'))), (),
                                              tm.Solve('CG', 1e-5, 1e-5))
        return v2, p, tape[0].iterations
    v2, p, iterations = project(True)
    counts = []
    for e in range(2):
        ve, pe, n = project(False, e)
        counts.append(n)
        assert _scaled(p.values.numpy(('b', 'x', 'y'))[e], pe.values.numpy(('x', 'y'))) <= ENTRY_TOL
        for d in ('x', 'y'):
            assert _scaled(v2.vector[d].values.numpy(('b', 'x', 'y'))[e], ve.vector[d].values.numpy(('x', 'y'))) \
                <= ENTRY_TOL
    assert iterations == max(counts)


def test_batched_nested_domain():
    """A nested domain (x0's boundary samples a coarse pressure Field, the
    Field-level projection of `_make_incompressible_fields`: `solve_linear`
    over K1 and the V-cycle) with a batched velocity, b = 2: each entry its
    own unbatched projection. (The unbatched case is held to JAX in
    test_torch_projection_cases.py::test_nested_domain.)"""
    from phiflow_tpu_torch.field._field import face_components
    from phiflow_tpu_torch.geom import Box
    coarse = tf.CenteredGrid(tm.wrap(torch.from_numpy(_random((32, 32), 30, 0.1)), tm.spatial('x,y')),
                             tm.extrapolation.BOUNDARY, Box(x=100, y=100), x=32, y=32)
    like = tf.StaggeredGrid(0, tm.extrapolation.ZERO_GRADIENT, bounds=Box(x=(30, 70), y=(40, 80)), x=24, y=24)
    x0 = tf.CenteredGrid(0, coarse, bounds=Box(x=(30, 70), y=(40, 80)), resolution=like.resolution)
    shapes = [c.shape.only(('x', 'y'), reorder=True) for c in face_components(like.values)]
    arrays = [_random((2,) + tuple(sh.sizes), 31 + a, 0.1) for a, sh in enumerate(shapes)]

    def project(batched, e=None):
        comps = [tm.wrap(torch.from_numpy(a.copy() if batched else a[e].copy()),
                         (tm.batch(b=2) & sh) if batched else sh) for a, sh in zip(arrays, shapes)]
        with SolveTape() as tape:
            v2, p = fluid.make_incompressible(like.with_values(tm.stack(comps, tm.dual(vector='x,y'))), (),
                                              tm.Solve('CG', 1e-5, 1e-5, x0=x0, max_iterations=4000))
        return v2, p, tape[0].iterations
    v2, p, iterations = project(True)
    counts = []
    for e in range(2):
        ve, pe, n = project(False, e)
        counts.append(n)
        assert _scaled(p.values.numpy(('b', 'x', 'y'))[e], pe.values.numpy(('x', 'y'))) <= ENTRY_TOL
        for d in ('x', 'y'):
            assert _scaled(v2.vector[d].values.numpy(('b', 'x', 'y'))[e], ve.vector[d].values.numpy(('x', 'y'))) \
                <= ENTRY_TOL
    assert iterations == max(counts)


def test_converged_system_keeps_its_x():
    """Two systems in one CG loop, one of which converges iterations before
    the other: its x is frozen from then on (α × 0), so it is its own solve's
    x, and the loop runs until the second converges."""
    rng = np.random.default_rng(5)
    n = (8, 8, 8)
    bcs = BCS[0]
    smooth = np.sin(2 * np.pi * np.arange(8) / 8)[:, None, None] * np.ones(n)
    rhs = np.stack([smooth - smooth.mean(), rng.standard_normal(n)]).astype(np.float32)
    rhs[1] -= rhs[1].mean()
    b = torch.from_numpy(rhs)

    def A(p):
        return TP.poisson_apply(p, (1., 1., 1.), bcs, with_dot=True)
    batched = cg(A, b, torch.zeros_like(b), 1e-5, 0., 200, nb=1)
    singles = [cg(A, b[e], torch.zeros_like(b[e]), 1e-5, 0., 200) for e in range(2)]
    assert singles[0].iterations < singles[1].iterations == batched.iterations
    for e in range(2):
        assert torch.equal(batched.x[e], singles[e].x)
    assert batched.converged and batched.residual.shape == (2,)


# ---------------------------------------------------------------------------
# the batched twins of K1–K4 against JAX's kernels with a leading batch
# ---------------------------------------------------------------------------

def _batch(seed, B=2, shape=SHAPE, n=2):
    return [_random((B,) + shape, seed + k) for k in range(n)]


@pytest.mark.parametrize('bcs', BCS[1:], ids=BC_IDS[1:])
def test_batched_twins_of_k1_k2_match_jax(bcs):
    """K1 (each epilogue) and K2 (zero-init triple, and warm sweeps) over
    (B, X, Y, Z) against JAX's Pallas kernels in interpret mode mapped over
    the batch; the dots one per entry; each entry as the unbatched twin."""
    p, b = _batch(0)
    pt, bt = torch.from_numpy(p), torch.from_numpy(b)
    for mode in ('matvec', 'residual', 'jacobi'):
        ref = JP.poisson_apply(jnp.asarray(p), INV, bcs, b=jnp.asarray(b), mode=mode, omega_over_diag=0.15,
                               interpret=True)
        got, dot = TP.poisson_apply(pt, INV, bcs, b=bt, mode=mode, omega_over_diag=0.15, with_dot=True)
        assert got.shape == pt.shape and dot.shape == (2,)
        assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 2e-5
        for e in range(2):
            one, one_dot = TP.poisson_apply(pt[e], INV, bcs, b=bt[e], mode=mode, omega_over_diag=0.15,
                                            with_dot=True)
            assert torch.equal(got[e], one) and float(dot[e]) == float(one_dot)
            assert abs(float(dot[e]) - float((pt[e].double() * got[e].double()).sum())) <= \
                1e-5 * max(abs(float(dot[e])), 1.)
    w = 0.9 / (-2.0 * sum(INV))
    for zero_init, sweeps in ((True, 3), (False, 2)):
        ref = JP.poisson_smooth(None if zero_init else jnp.asarray(p), jnp.asarray(b), INV, bcs, w, sweeps,
                                zero_init=zero_init, interpret=True)
        got, dot = TP.poisson_smooth(None if zero_init else pt, bt, INV, bcs, w, sweeps, zero_init=zero_init,
                                     emit_dot=True)
        assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 2e-5
        for e in range(2):
            one, one_dot = TP.poisson_smooth(None if zero_init else pt[e], bt[e], INV, bcs, w, sweeps,
                                             zero_init=zero_init, emit_dot=True)
            assert torch.equal(got[e], one) and float(dot[e]) == float(one_dot)


@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
def test_batched_twins_of_k3_k4_match_jax(bcs):
    """K3 (residual + restriction) and K4 (prolongation + add) over a leading
    batch against JAX's Pallas kernels in interpret mode (K3 at a shape its
    Pallas form takes: z 256, y 16) and XLA's prolongation; each entry as the
    unbatched twin."""
    u, b = _batch(3, shape=(4, 16, 256))
    ut, bt = torch.from_numpy(u), torch.from_numpy(b)
    ref = JP.residual_restrict(jnp.asarray(u), jnp.asarray(b), INV, bcs, interpret=True)
    got = TP.residual_restrict(ut, bt, INV, bcs)
    assert tuple(got.shape) == (2, 2, 8, 128)
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 1e-5
    for e in range(2):
        assert torch.equal(got[e], TP.residual_restrict(ut[e], bt[e], INV, bcs))
    c = _random((2, 4, 8, 128), 6)
    fine = _random((2, 8, 16, 256), 7)
    ref = JT.prolong_add(jnp.asarray(c), jnp.asarray(fine), 3, interpret=True)
    got = TT.prolong_add(torch.from_numpy(c), torch.from_numpy(fine))
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) == 0.0
    for e in range(2):
        assert torch.equal(got[e], TT.prolong_add(torch.from_numpy(c[e]), torch.from_numpy(fine[e])))

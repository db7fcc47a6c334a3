"""Batched masked projections in the port against the JAX package on the CPU:
K1m over a leading batch axis (`ops/poisson.py::poisson_apply`, its twin here)
with masks shared by the batch and with per-entry masks; the projection of a
batch of staggered velocities with obstacles or a free surface shared by the
batch (`physics/fluid.py::make_incompressible_native` and the Field
`make_incompressible`) under both masked preconditioners; The ValueError for masks with batch dims (JAX's AssertionError), the batched
centred and mesh projections and `SmokePlume(max_cells=None)` are in
`test_torch_batched_cases.py`, which keeps each file's time small.

Inputs are numpy from a seed, fed to both packages; JAX's projections are
traced in one jit each. Tolerances are stated at each test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.field import CenteredGrid as JCenteredGrid, StaggeredGrid as JStaggeredGrid
from phiflow_tpu.geom import Box as JBox
from phiflow_tpu.math import ConvergenceException, Solve as JSolve, SolveTape, Tensor as JTensor
from phiflow_tpu.math import extrapolation as jext
from phiflow_tpu.ops import poisson as JP
from phiflow_tpu.physics import fluid as jax_fluid

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.field import CenteredGrid, StaggeredGrid, face_layout
from phiflow_tpu_torch.geom import Box, Sphere
from phiflow_tpu_torch.ops import poisson as TP
from phiflow_tpu_torch.physics import fluid

import test_torch_obstacles as TO

ORDER = ('x', 'y', 'z')
INV = (1.0, 0.7, 1.3)
BCS = (('neumann', 'ghost0'), ('periodic', 'periodic'), ('neumann', 'neumann'))
B = 2


@pytest.fixture(autouse=True)
def _cpu():
    with tm.default_device('cpu'):
        yield


# ---------------------------------------------------------------------------
# K1m over a batch
# ---------------------------------------------------------------------------

def _masks(rng, shape):
    faces = []
    for d, (lo, _) in enumerate(BCS):
        s = list(shape)
        s[d] += 0 if lo == 'periodic' else 1
        faces.append((rng.uniform(size=s) > 0.25).astype(np.float32))
    return faces, (rng.uniform(size=shape) > 0.3).astype(np.float32)


@pytest.mark.parametrize('masks', ['shared', 'per-entry'])
def test_k1m_batched_twin_matches_jax(masks):
    """K1m's twin on p (2, 8, 8, 128) with the coefficient arrays and the
    active cells, within 2e-5 of JAX's `poisson_apply`: shared masks (the
    JAX package maps its Pallas kernel over the entries, here in interpret
    mode) and masks of the batch's shape (its XLA route). Each entry equals
    its own unbatched twin bit for bit; the dot is one per entry."""
    shape = (8, 8, 128)
    rng = np.random.default_rng(3)
    p = rng.standard_normal((B,) + shape).astype(np.float32)
    sets = [_masks(rng, shape) for _ in range(1 if masks == 'shared' else B)]
    faces = [np.stack([s[0][d] for s in sets]) if masks == 'per-entry' else sets[0][0][d] for d in range(3)]
    act = np.stack([s[1] for s in sets]) if masks == 'per-entry' else sets[0][1]
    jmA, jc0 = JP.stage_masks([jnp.asarray(f) for f in faces], BCS, INV)
    ref = JP.poisson_apply(jnp.asarray(p), INV, BCS, mA_list=jmA, c0=jc0, active=jnp.asarray(act),
                           interpret=masks == 'shared')
    mA, c0 = TP.stage_masks([torch.from_numpy(f) for f in faces], BCS, INV)
    got, dot = TP.poisson_apply(torch.from_numpy(p), INV, BCS, mA_list=mA, c0=c0, active=torch.from_numpy(act),
                                with_dot=True)
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 2e-5
    assert tuple(dot.shape) == (B,)
    for e in range(B):
        one = (lambda m: m if masks == 'shared' else m[e])
        own, own_dot = TP.poisson_apply(torch.from_numpy(p[e]), INV, BCS, mA_list=[one(m) for m in mA], c0=one(c0),
                                        active=one(torch.from_numpy(act)), with_dot=True)
        assert torch.equal(got[e], own) and torch.equal(dot[e], own_dot)


def test_k1m_batched_masks_layout_and_plan():
    """The card's wrapper: shared masks stay one entry's size at an entry
    stride of 0 (never expanded to the batch), per-entry masks (one carrying
    the batch is enough) come at the entry's cell count; the launch plan of a
    batch gives each entry its unbatched launch's chunk and partials."""
    shape = (2, 8, 8, 16)
    p = torch.zeros(shape)
    shared = torch.ones(shape[1:])
    fields, stride = TP._mask_fields([('a', shared), ('b', None), ('c', shared[None])], p)
    assert stride == 0 and tuple(fields[0].shape) == shape[1:] and fields[1] is None
    assert fields[0].data_ptr() == shared.data_ptr()  # read in place
    fields, stride = TP._mask_fields([('a', shared), ('c', torch.ones(shape))], p)
    assert stride == 8 * 8 * 16 and all(tuple(f.shape) == shape for f in fields)
    with pytest.raises(ValueError, match='broadcast'):
        TP._mask_fields([('a', torch.ones(3, 8, 8, 16))], p)
    for form in ('active', 'coeffs'):
        one = TP.stencil_plan((128, 128, 128), torch.float32, form=form)
        four = TP.stencil_plan((128, 128, 128), torch.float32, form=form, batch=4)
        assert four['chunk'] == one['chunk'] and four['partials'] == 4 * one['partials']


# ---------------------------------------------------------------------------
# the batched masked projection
# ---------------------------------------------------------------------------

def _jax_batched(comps, periodic):
    dims = len(comps)
    names = ORDER[:dims]
    N = comps[0].shape[2]
    tensors = [JTensor(jnp.asarray(c), jm.batch(b=c.shape[0]) & jm.spatial(**dict(zip(names, c.shape[1:]))))
               for c in comps]
    return JStaggeredGrid(jm.stack(tensors, jm.dual(vector=list(names))),
                          jext.PERIODIC if periodic else jext.ZERO, bounds=JBox(**{n: float(N) for n in names}),
                          **{n: N for n in names})


def _jax_project(jv, jobs, active=None, tol=1e-5):
    def project(v):
        solve = JSolve('CG', tol, 0., max_iterations=2000, suppress=(ConvergenceException,), implicit_diff=False)
        with SolveTape() as tape:
            v2, p2 = jax_fluid.make_incompressible(v, jobs, solve, active=active)
        return v2, p2, tape.solve_infos[-1].iterations
    return jax.jit(project)(jv)


def _batched_velocity(N, dims, periodic, seeds):
    entries = [TO._random_velocity(N, dims, periodic, seed=s) for s in seeds]
    return [np.stack([e[d] for e in entries]) for d in range(dims)]


def _close_to_jax(v, p, jv2, jp, dims, tol):
    """Velocity and pressure within `tol` of each field's largest magnitude."""
    names = ('b',) + ORDER[:dims]
    ref_p = np.asarray(jp.values.native(names))
    assert float(np.abs(p.numpy() - ref_p).max()) <= tol * float(np.abs(ref_p).max())
    for d, n in enumerate(ORDER[:dims]):
        ref = np.asarray(jv2.vector[n].values.native(names))
        assert float(np.abs(v[d].numpy() - ref).max()) <= tol * float(np.abs(ref).max())


@pytest.mark.parametrize('preconditioner', ['chebyshev', 'vcycle'])
@pytest.mark.parametrize('dims,N', [(2, 32), (3, 16)], ids=['2d-32', '3d-16'])
def test_batched_obstacle_projection_matches_jax(dims, N, preconditioner, monkeypatch):
    """Two entries in a closed box with a moving cuboid and a sphere shared
    by the batch, CG at 1e-5: within 1e-4 of JAX's batched projection (the
    obstacle tests' tolerance), the CG count JAX's (its entries' largest),
    and each entry bit-equal to its own unbatched projection."""
    monkeypatch.setattr(jax_fluid, 'MASKED_PRECONDITIONER', preconditioner)
    monkeypatch.setattr(fluid, 'MASKED_PRECONDITIONER', preconditioner)
    comps = _batched_velocity(N, dims, False, (5, 6))
    obs, jobs = TO._obstacles(N, dims, 'moving')
    jv2, jp, jit = _jax_project(_jax_batched(comps, False), jobs)
    kw = dict(rel_tol=1e-5, abs_tol=0., max_iterations=2000, faces=face_layout(False, dims), obstacles=obs)
    v, p, result = fluid.make_incompressible_native([torch.from_numpy(c) for c in comps], None, 1.0, **kw)
    assert result.converged and abs(result.iterations - int(np.asarray(jit))) <= 1
    _close_to_jax(v, p, jv2, jp, dims, 1e-4)
    for e in range(B):
        v1, p1, r1 = fluid.make_incompressible_native([torch.from_numpy(c[e]) for c in comps], None, 1.0, **kw)
        assert torch.equal(p[e], p1) and all(torch.equal(a[e], b) for a, b in zip(v, v1))
        assert r1.iterations <= result.iterations


@pytest.mark.parametrize('preconditioner', ['chebyshev', 'vcycle'])
def test_batched_masked_preconditioners_match_jax(preconditioner):
    """The masked preconditioners on a batch of residuals (2 × 16³, a closed
    box with the stationary sphere and cuboid): one diagonal (or one V-cycle)
    for the batch, the polynomial (the projection) applied to each entry,
    within 1e-5 of JAX's `_masked_chebyshev_preconditioner` /
    `_masked_vcycle_preconditioner` of the same residuals, and each entry
    equal to the port's preconditioner of that entry alone."""
    from phiflow_tpu_torch.field import cell_grid, geometry_mask, stagger_native
    from phiflow_tpu_torch.geom import union
    N, dims = 16, 3
    names = ORDER[:dims]
    obs, jobs = TO._obstacles(N, dims, 'stationary')
    jv = TO._jax_staggered(TO._random_velocity(N, dims, False), False)
    hard_bcs, active = TO._jax_masks(jv, jobs)
    x0 = JCenteredGrid(0., jax_fluid._pressure_extrapolation(jv.boundary), bounds=jv.bounds, **{n: N for n in names})
    r = np.random.default_rng(12).standard_normal((B,) + (N,) * dims).astype(np.float32)
    make = {'chebyshev': jax_fluid._masked_chebyshev_preconditioner, 'vcycle': jax_fluid._masked_vcycle_preconditioner}

    def jax_M(rr):
        jr = x0.with_values(JTensor(rr, jm.batch(b=B) & jm.spatial(**{n: N for n in names})))
        return make[preconditioner](x0, jv.boundary, hard_bcs, active)(jr).values.native(('b',) + names)
    ref = np.asarray(jax.jit(jax_M)(jnp.asarray(r)))
    faces = face_layout(False, dims)
    bcs = fluid.pressure_modes(faces)
    accessible = geometry_mask(~union([o.geometry for o in fluid._get_obstacles_for(obs)]),
                               cell_grid((N,) * dims, 1.0, 'cpu'))
    full = fluid._full_face_masks(stagger_native(accessible, torch.minimum, 0.0, faces), faces)
    mA, c0 = TP.stage_masks(full, bcs, (1.0,) * dims)
    apply_A = lambda p: TP.poisson_apply(p, (1.0,) * dims, bcs, mA_list=mA, c0=c0, active=accessible)  # noqa: E731
    if preconditioner == 'chebyshev':
        M = fluid._masked_chebyshev_preconditioner(apply_A, torch.from_numpy(r), bcs)
    else:
        M = fluid._masked_vcycle_preconditioner((N,) * dims, (1.0,) * dims, bcs, accessible)
    got = M(torch.from_numpy(r))[0]
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max())
    for e in range(B):
        assert torch.equal(got[e], M(torch.from_numpy(r[e]))[0])


def test_batched_shared_active_matches_jax():
    """A free surface (the lower two thirds) shared by two entries, no
    obstacle: the nonsingular system, within 1e-4 of JAX, entries bit-equal
    to their own projections."""
    N, dims = 32, 2
    comps = _batched_velocity(N, dims, False, (7, 8))
    active = np.zeros((N, N), np.float32)
    active[:, :2 * N // 3] = 1.0
    jactive = JCenteredGrid(JTensor(jnp.asarray(active), jm.spatial(x=N, y=N)), 0., bounds=JBox(x=N, y=N), x=N, y=N)
    jv2, jp, jit = _jax_project(_jax_batched(comps, False), (), active=jactive)
    kw = dict(rel_tol=1e-5, abs_tol=0., max_iterations=2000, faces=face_layout(False, dims),
              active=torch.from_numpy(active))
    v, p, result = fluid.make_incompressible_native([torch.from_numpy(c) for c in comps], None, 1.0, **kw)
    assert result.converged and abs(result.iterations - int(np.asarray(jit))) <= 1
    _close_to_jax(v, p, jv2, jp, dims, 1e-4)
    assert float(p[..., 2 * N // 3:].abs().max()) < 1e-6  # identity rows
    for e in range(B):
        v1, p1, _ = fluid.make_incompressible_native([torch.from_numpy(c[e]) for c in comps], None, 1.0, **kw)
        assert torch.equal(p[e], p1) and all(torch.equal(a[e], b) for a, b in zip(v, v1))


def test_field_batched_obstacles_match_the_array_layer_and_jax():
    """The Field `make_incompressible` of a batched StaggeredGrid with a
    sphere: bit-equal to `make_incompressible_native` on its components and
    within 1e-4 of JAX."""
    N = 32
    comps = _batched_velocity(N, 2, False, (9, 10))
    values = tm.stack([tm.tensor(torch.from_numpy(c), tm.batch('b'), tm.spatial(x=c.shape[1], y=c.shape[2]))
                       for c in comps], tm.dual(vector='x,y'))
    v = StaggeredGrid(values, 0., bounds=Box(x=N, y=N), x=N, y=N)
    solve = tm.Solve('CG', 1e-5, 0., max_iterations=2000)
    v2, p = fluid.make_incompressible(v, [Sphere(x=12., y=15., radius=5.)], solve)
    from phiflow_tpu.geom import Sphere as JSphere
    jv2, jp, _ = _jax_project(_jax_batched(comps, False), [JSphere(x=12., y=15., radius=5.)])
    nv, np_, _ = fluid.make_incompressible_native([torch.from_numpy(c) for c in comps], None, 1.0, rel_tol=1e-5,
                                                  abs_tol=0., max_iterations=2000, obstacles=[Sphere(x=12., y=15.,
                                                                                                    radius=5.)])
    assert torch.equal(p.values.torch(('b', 'x', 'y')), np_)
    got = [v2.vector[n].values.torch(('b', 'x', 'y')) for n in 'xy']
    assert all(torch.equal(a, b) for a, b in zip(got, nv))
    _close_to_jax(got, p.values.torch(('b', 'x', 'y')), jv2, jp, 2, 1e-4)

"""The port's obstacle projection (`physics/fluid.py`: `Obstacle`,
`apply_boundary_conditions`, `make_incompressible(..., obstacles=...)`, the
masked preconditioners) against the JAX package on the CPU. Velocities are
made with numpy from a seed and go through both packages; the port's masked
stencil takes its plain twin, the JAX package its XLA stencil."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiflow_tpu.field import CenteredGrid, Field, StaggeredGrid, stagger as jax_stagger
from phiflow_tpu.geom import Box as JBox, Cuboid as JCuboid, Sphere as JSphere, union as jax_union
from phiflow_tpu.math import ConvergenceException, Solve, SolveTape, Tensor, dual, extrapolation, spatial, stack, vec
from phiflow_tpu.math import _ops as jops
from phiflow_tpu.ops import poisson as jax_poisson
from phiflow_tpu.physics import fluid as jax_fluid

from phiflow_tpu_torch.field import cell_grid, divergence_native, face_layout, geometry_mask, stagger_native
from phiflow_tpu_torch.geom import Box, Cuboid, Sphere, union
from phiflow_tpu_torch.models import LidDrivenCavity
from phiflow_tpu_torch.ops import poisson
from phiflow_tpu_torch.physics import advect, diffuse, fluid
from phiflow_tpu_torch.physics.fluid import Obstacle

ORDER = ('x', 'y', 'z')
LAYOUTS = [(2, False), (2, True), (3, False), (3, True)]
LAYOUT_IDS = ['2d-closed', '2d-periodic', '3d-closed', '3d-periodic']


def _vec(values):
    return vec(**dict(zip(ORDER, [float(v) for v in values])))


def _random_velocity(N, dims, periodic, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(tuple(N - (a == d and not periodic) for a in range(dims))).astype(np.float32)
            for d in range(dims)]


def _jax_staggered(comps, periodic):
    dims = len(comps)
    names = ORDER[:dims]
    N = comps[0].shape[1]
    tensors = [Tensor(jnp.asarray(c), spatial(**dict(zip(names, c.shape)))) for c in comps]
    ext = extrapolation.PERIODIC if periodic else extrapolation.ZERO
    return StaggeredGrid(stack(tensors, dual(vector=list(names))), ext,
                         bounds=JBox(**{n: float(N) for n in names}), **{n: N for n in names})


def _components(field):
    names = tuple(field.resolution.names)
    return [np.asarray(field.vector[n].values.native(names)) for n in names]


def _obstacles(N, dims, kind):
    """(port obstacles, JAX obstacles) from the same plain numbers."""
    c = [N / 2] * dims
    lin = [1., 0.5, 0.25][:dims]
    spin, jspin = (0.3, 0.3) if dims == 2 else ([0.1, 0.2, 0.3], _vec([0.1, 0.2, 0.3]))
    corner, half = [N / 6] * dims, [N / 12] * dims
    if kind == 'stationary':  # a bare geometry and a stationary obstacle; the sphere's surface meets cell centres
        return ([Sphere(c, N / 6 + 0.5), Obstacle(Cuboid(corner, half))],
                [JSphere(_vec(c), radius=N / 6 + 0.5), jax_fluid.Obstacle(JCuboid(_vec(corner), _vec(half)))])
    if kind == 'moving':
        return ([Obstacle(Cuboid(c, half, rotation=None), velocity=lin), Obstacle(Sphere(corner, N / 8))],
                [jax_fluid.Obstacle(JCuboid(_vec(c), _vec(half)), velocity=_vec(lin)),
                 jax_fluid.Obstacle(JSphere(_vec(corner), radius=N / 8))])
    if kind == 'rotating':  # translating and spinning sphere, and a stationary cuboid
        return ([Obstacle(Sphere(c, N / 6 + 0.5), velocity=lin, angular_velocity=spin), Cuboid(corner, half)],
                [jax_fluid.Obstacle(JSphere(_vec(c), radius=N / 6 + 0.5), velocity=_vec(lin), angular_velocity=jspin),
                 JCuboid(_vec(corner), _vec(half))])
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def test_obstacle_holds_float32_numbers_and_moves_like_jax():
    o = Obstacle(Sphere((3., 4.), 1.5), velocity=(1, 2), angular_velocity=0.5)
    assert o.velocity.dtype == np.float32 and o.angular_velocity.dtype == np.float32
    assert o.is_moving and o.is_rotating and not o.is_stationary
    assert Obstacle(Sphere((3., 4.), 1.5)).is_stationary
    assert Obstacle(Sphere((3., 4., 5.), 1.5)).angular_velocity.tolist() == [0., 0., 0.]
    for geometry, spin in ((Sphere((3., 4.), 1.5), (0., 0., 1.)), (Sphere((3., 4., 5.), 1.5), 0.5)):
        with pytest.raises(ValueError, match='angular_velocity'):
            Obstacle(geometry, angular_velocity=spin)
    jo = jax_fluid.Obstacle(JSphere(_vec((3., 4.)), radius=1.5), velocity=_vec((1, 2)), angular_velocity=0.5)
    size = np.array([5., 5.], np.float32)
    for _ in range(7):  # (centre + velocity · dt) % size in float32, as the moving-obstacle model steps
        o = o.at((o.geometry.center + o.velocity * np.float32(0.3)) % size)
        jo = jo.at((jo.geometry.center + jo.velocity * 0.3) % _vec(size))
    assert np.array_equal(o.geometry.center, np.asarray(jo.geometry.center.native()))
    assert o.shifted((1., 1.)).geometry.center.tolist() == (o.geometry.center + 1).tolist()
    assert o.velocity.tolist() == [1., 2.] and float(o.angular_velocity) == 0.5
    assert [type(x) for x in fluid._get_obstacles_for(Sphere((1., 1.), 1.))] == [Obstacle]
    with pytest.raises(TypeError, match='obstacles'):
        fluid._get_obstacles_for(3)


@pytest.mark.parametrize('kind', ['stationary', 'moving', 'rotating'])
@pytest.mark.parametrize('dims,periodic', LAYOUTS, ids=LAYOUT_IDS)
def test_apply_boundary_conditions_matches_jax(dims, periodic, kind):
    """The obstacles' velocities blended into a random field: within 1e-6."""
    N = 24 if dims == 2 else 16
    comps = _random_velocity(N, dims, periodic)
    obs, jobs = _obstacles(N, dims, kind)
    ref = _components(jax_fluid.apply_boundary_conditions(_jax_staggered(comps, periodic), jobs))
    got = fluid.apply_boundary_conditions_native([torch.from_numpy(c) for c in comps], obs, 1.0, face_layout(periodic, dims))
    for g, r, c in zip(got, ref, comps):
        assert g.shape == r.shape
        assert float(np.abs(g.numpy() - r).max()) <= 1e-6
        assert float(np.abs(g.numpy() - c).max()) > 0.1  # the obstacles did change the field


def test_apply_boundary_conditions_keeps_nan_outside_obstacles():
    """`safe_mul`: a NaN face (unset, FLIP) inside a stationary obstacle
    becomes 0, outside it stays NaN — as in the JAX package."""
    N = 16
    comps = _random_velocity(N, 2, False)
    comps[0][7, 8] = np.nan   # inside the sphere
    comps[0][1, 14] = np.nan  # outside every obstacle
    obs, jobs = _obstacles(N, 2, 'stationary')
    ref = _components(jax_fluid.apply_boundary_conditions(_jax_staggered(comps, False), jobs))
    got = fluid.apply_boundary_conditions_native([torch.from_numpy(c) for c in comps], obs, 1.0)
    assert np.array_equal(np.isnan(got[0].numpy()), np.isnan(ref[0]))
    assert got[0][7, 8] == 0 and bool(torch.isnan(got[0][1, 14]))


def _jax_masks(jv, jobs):
    """(hard_bcs, active, accessible array) as `make_incompressible` builds them."""
    jobs = jax_fluid._get_obstacles_for(jobs, jv)
    accessible = Field(jv.geometry, ~jax_union([o.geometry for o in jobs]),
                       jax_fluid._accessible_extrapolation(jv.boundary))
    hard_bcs = jax_stagger(accessible, jops.minimum, jv.boundary, at=jv.sampled_at, dims=jv.resolution.names)
    return hard_bcs, accessible.with_boundary(extrapolation.NONE)


@pytest.mark.parametrize('dims,periodic', LAYOUTS, ids=LAYOUT_IDS)
def test_staged_coefficients_match_jax(dims, periodic):
    """`hard_bcs` of a sphere and a cuboid, padded to every face and staged:
    the full-face masks, `mA` and `c0` equal the JAX package's."""
    N = 24 if dims == 2 else 16
    comps = _random_velocity(N, dims, periodic)
    obs, jobs = _obstacles(N, dims, 'stationary')
    jv = _jax_staggered(comps, periodic)
    hard_bcs, _ = _jax_masks(jv, jobs)
    bc = (('periodic', 'periodic') if periodic else ('neumann', 'neumann'),) * dims
    inv_dx2 = (1.0,) * dims
    ref_full = []
    for d, m in enumerate(_components(hard_bcs)):  # the padding of `_fused_masked_laplace`
        ref_full.append(jnp.asarray(m) if periodic else jnp.pad(jnp.asarray(m), [(int(a == d),) * 2 for a in range(dims)]))
    ref_mA, ref_c0 = jax_poisson.stage_masks(ref_full, bc, inv_dx2)

    accessible = geometry_mask(~union([fluid._get_obstacles_for(obs)[i].geometry for i in range(2)]), cell_grid((N,) * dims, 1.0, 'cpu'))
    faces = face_layout(periodic, dims)
    full = fluid._full_face_masks(stagger_native(accessible, torch.minimum, fluid._accessible_extrapolation(
        'periodic' if periodic else 0.0), faces), faces)
    mA, c0 = poisson.stage_masks(full, fluid.pressure_modes(faces), inv_dx2)
    for g, r in zip(full, ref_full):
        assert np.array_equal(g.numpy(), np.asarray(r))
    for g, r in zip(mA, ref_mA):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert np.array_equal(c0.numpy(), np.asarray(ref_c0))
    # what the kernel's wrapper does with them at every launch: nothing
    p = torch.zeros((N,) * dims)
    for m in (*mA, c0, accessible.contiguous()):
        assert m.dtype == torch.float32 and m.is_contiguous() and tuple(m.shape) == (N,) * dims
        assert poisson._mask_field('m', m, p).data_ptr() == m.data_ptr()


@pytest.mark.parametrize('dims,periodic', LAYOUTS, ids=LAYOUT_IDS)
def test_masked_diagonal_with_obstacles_matches_jax(dims, periodic):
    """The probed diagonal of the obstacle operator within 1e-5; identity
    rows (cells inside an obstacle) are 1."""
    N = 24 if dims == 2 else 16
    names = ORDER[:dims]
    obs, jobs = _obstacles(N, dims, 'stationary')
    jv = _jax_staggered(_random_velocity(N, dims, periodic), periodic)
    hard_bcs, active = _jax_masks(jv, jobs)
    x0 = CenteredGrid(0., jax_fluid._pressure_extrapolation(jv.boundary), bounds=jv.bounds, **{n: N for n in names})
    ref = np.asarray(jax_fluid._masked_diagonal(x0, jv.boundary, hard_bcs, active).native(names))

    faces = face_layout(periodic, dims)
    bcs = fluid.pressure_modes(faces)
    accessible = geometry_mask(~union([o.geometry for o in fluid._get_obstacles_for(obs)]), cell_grid((N,) * dims, 1.0, 'cpu'))
    full = fluid._full_face_masks(stagger_native(accessible, torch.minimum, 'periodic' if periodic else 0.0, faces), faces)
    mA, c0 = poisson.stage_masks(full, bcs, (1.0,) * dims)
    apply_A = lambda p: poisson.poisson_apply(p, (1.0,) * dims, bcs, mA_list=mA, c0=c0, active=accessible)
    diag = fluid._masked_diagonal(apply_A, accessible, bcs).numpy()
    assert float(np.abs(diag - ref).max()) <= 1e-5
    assert (diag[accessible.numpy() == 0] == 1.0).all() and (diag[accessible.numpy() != 0] <= 0).all()
    # the probe against brute force: column i of A at row i, for a few cells
    rng = np.random.default_rng(1)
    for _ in range(5):
        idx = tuple(int(i) for i in rng.integers(0, N, dims))
        e = torch.zeros((N,) * dims)
        e[idx] = 1.0
        assert abs(float(apply_A(e)[idx]) - float(diag[idx])) <= 1e-6


# ---------------------------------------------------------------------------
# the projection
# ---------------------------------------------------------------------------

def _project_both(comps, periodic, obs, jobs, preconditioner='chebyshev', active=None, tol=1e-5, x0=None):
    dims = len(comps)
    names = ORDER[:dims]
    N = comps[0].shape[1]
    jv = _jax_staggered(comps, periodic)
    jactive = None
    if active is not None:
        jactive = CenteredGrid(Tensor(jnp.asarray(active), spatial(**{n: N for n in names})), 0., bounds=jv.bounds,
                               **{n: N for n in names})
    old = jax_fluid.MASKED_PRECONDITIONER, fluid.MASKED_PRECONDITIONER
    jax_fluid.MASKED_PRECONDITIONER = fluid.MASKED_PRECONDITIONER = preconditioner
    try:
        def project(v):
            solve = Solve('CG', tol, 0., max_iterations=2000, suppress=(ConvergenceException,), implicit_diff=False)
            with SolveTape() as tape:
                v2, p2 = jax_fluid.make_incompressible(v, jobs, solve, active=jactive)
            return v2, p2, tape.solve_infos[-1].iterations
        jv2, jp, jit = jax.jit(project)(jv)
        v2, p, result = fluid.make_incompressible_native(
            [torch.from_numpy(c) for c in comps], x0, 1.0, rel_tol=tol, abs_tol=0., max_iterations=2000,
            faces=face_layout(periodic, len(comps)), obstacles=obs,
            active=None if active is None else torch.from_numpy(active))
    finally:
        jax_fluid.MASKED_PRECONDITIONER, fluid.MASKED_PRECONDITIONER = old
    return (_components(jv2), np.asarray(jp.values.native(names)), int(np.asarray(jit))), (v2, p, result)


def _assert_projection_matches(ref, got, tol=1e-4, iterations_within=1):
    """Velocity and pressure within `tol` of the field's scale (its largest
    magnitude), CG iterations equal or within 1."""
    (ref_v, ref_p, ref_it), (v, p, result) = ref, got
    assert result.converged and 0 < result.iterations < 2000
    if iterations_within is not None:
        assert abs(result.iterations - ref_it) <= iterations_within, (result.iterations, ref_it)
    assert float(np.abs(p.numpy() - ref_p).max()) <= tol * float(np.abs(ref_p).max())
    for g, r in zip(v, ref_v):
        assert float(np.abs(g.numpy() - r).max()) <= tol * float(np.abs(r).max())


@pytest.mark.parametrize('kind', ['stationary', 'rotating'])
@pytest.mark.parametrize('dims,N,periodic', [(3, 24, False), (3, 24, True), (2, 48, False), (2, 48, True)],
                         ids=['3d-24-closed', '3d-24-periodic', '2d-48-closed', '2d-48-periodic'])
def test_make_incompressible_with_obstacles_matches_jax(dims, N, periodic, kind):
    comps = _random_velocity(N, dims, periodic)
    obs, jobs = _obstacles(N, dims, kind)
    ref, got = _project_both(comps, periodic, obs, jobs)
    _assert_projection_matches(ref, got)
    # what the projection is for: outside the obstacles the divergence is the constant that balancing leaves
    v, _, _ = got
    accessible = geometry_mask(~union([o.geometry for o in fluid._get_obstacles_for(obs)]), cell_grid((N,) * dims, 1.0, 'cpu'))
    div = divergence_native(v, 1.0, face_layout(periodic, dims)) * accessible
    mean_active = div.sum() / accessible.sum()
    assert float(((div - mean_active) * accessible).abs().max()) < 1e-3


@pytest.mark.parametrize('dims,N,periodic', [(3, 32, False), (2, 48, True)], ids=['3d-32-closed', '2d-48-periodic'])
def test_make_incompressible_with_vcycle_preconditioner_matches_jax(dims, N, periodic):
    """MASKED_PRECONDITIONER = 'vcycle': the projected V-cycle on both sides."""
    comps = _random_velocity(N, dims, periodic, seed=1)
    obs, jobs = _obstacles(N, dims, 'moving')
    _assert_projection_matches(*_project_both(comps, periodic, obs, jobs, preconditioner='vcycle'))


@pytest.mark.parametrize('dims,N', [(3, 24), (2, 48)], ids=['3d-24', '2d-48'])
def test_make_incompressible_without_preconditioner_matches_jax(dims, N):
    comps = _random_velocity(N, dims, False, seed=2)
    obs, jobs = _obstacles(N, dims, 'stationary')
    """MASKED_PRECONDITIONER = None: the same solution. The iteration counts
    are not compared: plain CG takes hundreds of float32 iterations here, and
    the two packages' roundoff decides when each crosses the tolerance."""
    ref, got = _project_both(comps, False, obs, jobs, preconditioner=None)
    _assert_projection_matches(ref, got, iterations_within=None)
    print('iterations without a preconditioner: JAX', ref[2], 'port', got[2].iterations)
    cheb = _project_both(comps, False, obs, jobs)[1][2]
    assert cheb.iterations * 2 < got[2].iterations and cheb.iterations * 2 < ref[2]  # Chebyshev more than halves it


@pytest.mark.parametrize('dims,N', [(3, 24), (2, 48)], ids=['3d-24', '2d-48'])
def test_make_incompressible_with_obstacles_and_active_matches_jax(dims, N):
    """A caller's active cells (a free surface: the lower two thirds) and an
    obstacle: the system is nonsingular and no mean is removed."""
    comps = _random_velocity(N, dims, False, seed=3)
    active = np.zeros((N,) * dims, np.float32)
    active[..., :2 * N // 3] = 1.0
    obs, jobs = _obstacles(N, dims, 'moving')
    ref, got = _project_both(comps, False, obs, jobs, active=active)
    _assert_projection_matches(ref, got)
    p = got[1].numpy()
    assert float(np.abs(p[..., 2 * N // 3:]).max()) < 1e-6  # identity rows: p = 0 outside the liquid


def test_unknown_masked_preconditioner_raises(monkeypatch):
    monkeypatch.setattr(fluid, 'MASKED_PRECONDITIONER', 'ilu')
    with pytest.raises(ValueError, match='MASKED_PRECONDITIONER'):
        fluid.make_incompressible_native([torch.zeros(7, 8), torch.zeros(8, 7)], None, 1.0, obstacles=[Sphere((4., 4.), 2.)])


# --- analogues of the JAX suite's obstacle tests -----------------------------

def test_moving_obstacle_imposes_its_velocity():
    v = [torch.zeros(23, 24), torch.zeros(24, 23)]
    obs = Obstacle(Cuboid((12., 12.), (3., 3.)), velocity=(1., 0.))
    v2, _, _ = fluid.make_incompressible_native(v, None, 1.0, 1e-5, 1e-5, obstacles=[obs])
    assert abs(float(v2[0][11, 12]) - 1.0) < 0.5   # the x face at (12, 12.5), inside the cuboid


def test_rotating_obstacle_imposes_a_tangential_field():
    """v = ω × r: above the fan's centre the x-velocity is negative, below positive."""
    v = [torch.zeros(23, 24), torch.zeros(24, 23)]
    fan = Obstacle(Sphere((12., 12.), 5.), angular_velocity=1.0)
    v2, _, result = fluid.make_incompressible_native(v, None, 1.0, 1e-4, 1e-4, obstacles=[fan])
    assert result.converged
    assert float(v2[0][11, 15]) < -1.0 and float(v2[0][11, 9]) > 1.0


def test_boundary_push_with_box_obstacles_matches_jax():
    """Particles pushed out of a box and a cuboid, then back into the
    domain: the JAX package's positions within 1e-6."""
    from phiflow_tpu.math import channel, instance, wrap
    rng = np.random.default_rng(4)
    pos = rng.uniform(-1, 17, (3000, 3)).astype(np.float32)
    box, jbox = Box((3., 4., 5.), (7., 9., 8.)), JBox(_vec((3., 4., 5.)), _vec((7., 9., 8.)))
    cub, jcub = Cuboid((12., 11., 4.), (2., 1.5, 3.)), JCuboid(_vec((12., 11., 4.)), _vec((2., 1.5, 3.)))
    domain = JBox(x=16., y=16., z=16.)
    jpos = wrap(pos, instance('points'), channel(vector='x,y,z'))
    from phiflow_tpu.field import PointCloud
    ref = jax_fluid.boundary_push(PointCloud(jpos), [jbox, jax_fluid.Obstacle(jcub), ~domain], separation=0.5)
    ref = np.asarray(ref.geometry.center.native(('points', 'vector')))
    got = fluid.boundary_push_native(torch.from_numpy(pos), (16., 16., 16.), 0.5, obstacles=[box, Obstacle(cub)]).numpy()
    assert float(np.abs(got - ref).max()) <= 1e-6
    inside = box.lies_inside(tuple(torch.from_numpy(got).unbind(1))) | cub.lies_inside(tuple(torch.from_numpy(got).unbind(1)))
    assert int(inside.sum()) == 0 and float(np.abs(got - pos).max()) > 0.5
    # a sphere: no exact push; both packages push along the finite-difference normal of its signed distance
    from phiflow_tpu.geom import Sphere as JSphere
    ref = jax_fluid.boundary_push(PointCloud(jpos), [JSphere(_vec((8., 8., 8.)), 2.), ~domain], separation=0.5)
    ref = np.asarray(ref.geometry.center.native(('points', 'vector')))
    got = fluid.boundary_push_native(torch.from_numpy(pos), (16., 16., 16.), obstacles=[Sphere((8., 8., 8.), 2.)]).numpy()
    assert float(np.abs(got - ref).max()) <= 1e-3  # the normal divides float32 distance differences by 2e-3


# --- analogues of the JAX suite's masked-preconditioner tests ----------------

@pytest.fixture(scope='module')
def cavity_state():
    """The lid-driven cavity with its obstacle after two steps, advected and
    diffused once more: the velocity a projection starts from."""
    model = LidDrivenCavity(48, obstacle=True, device='cpu')
    v, p = model.initial_state_native()
    for _ in range(2):
        v, p = model.step_native(v, p)
    v = advect.semi_lagrangian_native(v, v, model.dt, 1.0, model.boundary, velocity_extrap=model.boundary)
    return model, diffuse.explicit_native(v, model.viscosity, model.dt, 1.0, model.boundary), p


def _project_cavity(model, v, p, mode, monkeypatch, tol=1e-6):
    monkeypatch.setattr(fluid, 'MASKED_PRECONDITIONER', mode)
    _, p2, result = fluid.make_incompressible_native(v, p, 1.0, rel_tol=tol, abs_tol=0., max_iterations=3000,
                                              obstacles=model.obstacles)
    return p2.numpy(), result.iterations


def test_chebyshev_matches_unpreconditioned(cavity_state, monkeypatch):
    model, v, p = cavity_state
    p_none, it_none = _project_cavity(model, v, p, None, monkeypatch)
    p_cheb, it_cheb = _project_cavity(model, v, p, 'chebyshev', monkeypatch)
    scale = np.sqrt(np.mean(p_none ** 2)) + 1e-30
    assert np.sqrt(np.mean((p_cheb - p_none) ** 2)) / scale < 1e-3
    assert it_cheb * 2 < it_none, (it_cheb, it_none)


def test_default_is_preconditioned(cavity_state, monkeypatch):
    model, v, p = cavity_state
    assert fluid.MASKED_PRECONDITIONER == 'chebyshev'
    _, it_default = _project_cavity(model, v, p, fluid.MASKED_PRECONDITIONER, monkeypatch)
    _, it_none = _project_cavity(model, v, p, None, monkeypatch)
    assert it_default < it_none

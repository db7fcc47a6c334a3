"""The port's Poisson stencil (K1 `poisson_apply`, K2 `poisson_smooth`, K3
`residual_restrict`) against the JAX package's Pallas kernels run in
interpret mode (or its XLA route, at shapes its gates refuse). The port runs
on the CPU, where its wrappers take the plain PyTorch twins; inputs are made
with numpy from a seed and fed to both. The kernels' launch plans
(`smooth_plan`, `stencil_plan`, `restrict_plan`) are pure Python and are
checked here too."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phiflow_tpu.ops import poisson as JP
from phiflow_tpu_torch.ops import poisson as TP

BCS = [(('neumann', 'neumann'),) * 3,
       (('periodic', 'periodic'),) * 3,
       (('neumann', 'ghost0'), ('periodic', 'periodic'), ('ghost0', 'neumann'))]
BC_IDS = ['neumann', 'periodic', 'mixed']
INV = (1.0, 0.7, 1.3)
SHAPE = (16, 24, 128)
W = 0.9 / (-2.0 * sum(INV))  # the V-cycle's (negative) Jacobi weight


def _fields(seed, shape=SHAPE, n=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _max_err(got: torch.Tensor, ref) -> float:
    return float(np.abs(got.float().numpy() - np.asarray(ref, np.float32)).max())


def _bf16_within_one_ulp(got: torch.Tensor, ref, atol=2e-5) -> bool:
    """Both sides round a float32 result to bfloat16 once; their float32 sums
    run in different orders, so they may land one bf16 ulp apart — plus the
    float32 tolerance, which is larger than that ulp where a result cancels
    towards zero."""
    r = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    _, e = torch.frexp(r.abs())
    return bool(((got.float() - r).abs() <= torch.ldexp(torch.ones_like(r), e - 8) + atol).all())


@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
@pytest.mark.parametrize('mode', ['matvec', 'residual', 'jacobi'])
def test_poisson_apply_matches_pallas(bcs, mode):
    p, b = _fields(0)
    ref = JP._apply_pallas_3d(jnp.asarray(p), INV, bcs, None, None, None,
                              jnp.asarray(b) if mode != 'matvec' else None, mode, 0.15, interpret=True)
    got = TP.poisson_apply(torch.from_numpy(p), INV, bcs, b=torch.from_numpy(b), mode=mode,
                           omega_over_diag=0.15)
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
    assert _max_err(got, ref) < 2e-5


@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
def test_poisson_apply_with_dot_matches_pallas(bcs):
    (p,) = _fields(1, n=1)
    ref, ref_dot = JP._apply_pallas_3d(jnp.asarray(p), INV, bcs, None, None, None, None, 'matvec', None,
                                       interpret=True, with_dot=True)
    got, dot = TP.poisson_apply(torch.from_numpy(p), INV, bcs, with_dot=True)
    assert _max_err(got, ref) < 2e-5
    assert abs(float(dot) - float(ref_dot)) / max(abs(float(ref_dot)), 1.0) < 1e-5


def test_poisson_apply_masked_twin_matches_xla():
    """The masked operator on the CPU: the twin against JAX's XLA route, with
    JAX's own staged masks."""
    X, Y, Z = 8, 8, 16
    rng = np.random.default_rng(2)
    p = rng.standard_normal((X, Y, Z)).astype(np.float32)
    act = (rng.uniform(size=(X, Y, Z)) > 0.3).astype(np.float32)
    bcs = BCS[2]
    masks = []
    for d in range(3):
        shape = [X, Y, Z]
        if bcs[d] != ('periodic', 'periodic'):
            shape[d] += 1
        masks.append((rng.uniform(size=shape) > 0.2).astype(np.float32))
    mA, c0 = JP.stage_masks([jnp.asarray(m) for m in masks], bcs, INV)
    ref = JP._apply_xla(jnp.asarray(p), INV, bcs, mA, c0, jnp.asarray(act), None, 'matvec', None)
    got = TP.poisson_apply(torch.from_numpy(p), INV, bcs,
                           mA_list=[torch.from_numpy(np.array(m)) for m in mA],
                           c0=torch.from_numpy(np.array(c0)), active=torch.from_numpy(act))
    assert _max_err(got, ref) < 2e-5


@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
def test_poisson_smooth_zero_init_matches_pallas(bcs):
    (b,) = _fields(3, n=1)
    ref = JP._jacobi2_pallas_3d(None, jnp.asarray(b), INV, bcs, W, True, interpret=True)
    got = TP.poisson_smooth(None, torch.from_numpy(b), INV, bcs, W, 3, zero_init=True)
    assert _max_err(got, ref) < 2e-5


@pytest.mark.parametrize('sweeps', [2, 3])
@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
def test_poisson_smooth_sweeps_match_pallas(bcs, sweeps):
    u, b = _fields(4)
    ref = JP._jacobi2_pallas_3d(jnp.asarray(u), jnp.asarray(b), INV, bcs, W, False, sweeps=sweeps,
                                interpret=True)
    got = TP.poisson_smooth(torch.from_numpy(u), torch.from_numpy(b), INV, bcs, W, sweeps)
    assert _max_err(got, ref) < 2e-5


@pytest.mark.parametrize('sweeps', [1, 2, 3, 4])
@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
def test_poisson_smooth_zero_init_sweep_counts_match_jax(bcs, sweeps):
    """Zero-init smooths of 1-4 sweeps (u0 = w·b, then 0-3 more) against JAX's
    `poisson_smooth` in interpret mode: u0 alone, u0 and one Pallas Jacobi
    sweep, the fused triple (`_jacobi2_pallas_3d`), the triple and one more."""
    (b,) = _fields(7, n=1)
    ref = JP.poisson_smooth(None, jnp.asarray(b), INV, bcs, W, sweeps, zero_init=True, use_pallas=True,
                            interpret=True)
    got = TP.poisson_smooth(None, torch.from_numpy(b), INV, bcs, W, sweeps, zero_init=True)
    assert _max_err(got, ref) < 2e-5


@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
def test_poisson_smooth_one_sweep_matches_pallas(bcs):
    """One warm sweep against the Pallas stencil's Jacobi epilogue, which is
    what JAX's `poisson_smooth` runs for a sweep it does not fuse."""
    u, b = _fields(8)
    ref = JP.poisson_smooth(jnp.asarray(u), jnp.asarray(b), INV, bcs, W, 1, use_pallas=True, interpret=True)
    got = TP.poisson_smooth(torch.from_numpy(u), torch.from_numpy(b), INV, bcs, W, 1)
    assert _max_err(got, ref) < 2e-5


def test_poisson_smooth_emit_dot_matches_pallas():
    u, b = _fields(5)
    bcs = BCS[0]
    ref, ref_dot = JP._jacobi2_pallas_3d(jnp.asarray(u), jnp.asarray(b), INV, bcs, W, False, sweeps=3,
                                         interpret=True, emit_dot=True)
    got, dot = TP.poisson_smooth(torch.from_numpy(u), torch.from_numpy(b), INV, bcs, W, 3, emit_dot=True)
    assert _max_err(got, ref) < 2e-5
    assert abs(float(dot) - float(ref_dot)) / max(abs(float(ref_dot)), 1.0) < 1e-5


def test_poisson_smooth_bf16_out_matches_pallas():
    u, b = _fields(6)
    bcs = BCS[2]
    ref = JP._jacobi2_pallas_3d(jnp.asarray(u), jnp.asarray(b), INV, bcs, W, False, sweeps=3,
                                interpret=True, out_dtype=jnp.bfloat16)
    got = TP.poisson_smooth(torch.from_numpy(u), torch.from_numpy(b), INV, bcs, W, 3,
                            out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _bf16_within_one_ulp(got, ref)


# a 256³ V-cycle's levels, and chip_smoke.py's small shapes with z ≥ 64 and z < 64 (the 16 × 16 tile)
V_CYCLE_SHAPES = [(n,) * 3 for n in (256, 128, 64, 32, 16, 8)] + [(24, 40, 72), (24, 40, 24)]


@pytest.mark.parametrize('zero_init', [True, False], ids=['zero-init', 'warm'])
@pytest.mark.parametrize('sweeps', [1, 2, 3, 4, 24])
@pytest.mark.parametrize('shape', V_CYCLE_SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_smooth_plan(shape, sweeps, zero_init):
    """K2's launch plan: one launch a smooth of up to 3 sweeps (the zero-init
    u₀ = w·b one of them, alone at sweeps=1), a chain of ⌈ν/3⌉ beyond; float32
    between launches and `out_dtype` at the end; shared memory within a
    block's limit, and within half of it for one launch, so two blocks share
    an SM; a grid that covers every output."""
    f32, bf16 = torch.float32, torch.bfloat16
    plan = TP.smooth_plan(shape, sweeps, zero_init, (None if zero_init else bf16, f32, bf16))
    launches = plan['launches']
    assert len(launches) == -(-sweeps // 3)
    assert [l['sweeps'] for l in launches] == [3] * (sweeps // 3) + [sweeps % 3] * (sweeps % 3 > 0)
    assert [l['zero_init'] for l in launches] == [zero_init] + [False] * (len(launches) - 1)
    for i, l in enumerate(launches):
        S = l['sweeps'] - l['zero_init']
        assert l['stencil_sweeps'] == S
        # three float32 planes a level (u₀ and the S − 1 intermediate sweeps) and S + 1 of b, over the tile grown by S,
        # rows padded to whole quads of cells
        ty, tz = plan['tile']
        assert l['smem'] == 4 * (4 * S + 1) * (ty + 2 * S) * (-(-(tz + 2 * S) // 4) * 4) <= TP.SMEM_LIMIT
        assert l['u_dtype'] == (None if l['zero_init'] else bf16 if i == 0 else f32)
        assert l['out_dtype'] == (bf16 if i == len(launches) - 1 else f32)
    if sweeps <= 3:
        assert plan['smem'] <= TP.SMEM_LIMIT // 2
    if zero_init and sweeps == 1:
        assert launches[0]['stencil_sweeps'] == 0  # u₀ = w·b alone, in one launch
    assert plan['smem'] == max(l['smem'] for l in launches)
    assert plan['tile'] == ((16, 64) if shape[2] >= 64 else (16, 16))
    for n, t, g in zip(shape[::-1], (tz, ty, plan['chunk']), plan['grid']):
        assert g * t >= n > (g - 1) * t
    assert plan['blocks'] == plan['grid'][0] * plan['grid'][1] * plan['grid'][2]


@pytest.mark.parametrize('chunk', [1, 3, 64, 300])
def test_smooth_plan_fixed_chunk(chunk):
    """A fixed x-chunk replaces the cost model's pick and only it: the grid's
    x count follows it, the tile, launches and shared memory do not move."""
    shape, dtypes = (256, 128, 64), (torch.bfloat16, torch.float32, torch.float32)
    picked = TP.smooth_plan(shape, 3, False, dtypes)
    plan = TP.smooth_plan(shape, 3, False, dtypes, chunk=chunk)
    assert plan['chunk'] == chunk
    assert plan['grid'] == picked['grid'][:2] + (-(-shape[0] // chunk),)
    assert plan['blocks'] == plan['grid'][0] * plan['grid'][1] * plan['grid'][2]
    assert {k: plan[k] for k in ('tile', 'smem', 'launches')} == {k: picked[k] for k in ('tile', 'smem', 'launches')}
    with pytest.raises(ValueError):
        TP.smooth_plan(shape, 3, False, dtypes, chunk=0)


@pytest.mark.parametrize('bcs', [BCS[0], BCS[1], (('neumann', 'ghost0'), ('periodic', 'periodic'),
                                                  ('neumann', 'neumann'))], ids=BC_IDS)
def test_residual_restrict_matches_pallas(bcs):
    u, b = _fields(7, (4, 16, 256))
    inv = (1.0, 0.5, 2.0)
    ref = JP._residual_restrict_pallas_3d(jnp.asarray(u), jnp.asarray(b), inv, bcs, interpret=True)
    got = TP.residual_restrict(torch.from_numpy(u), torch.from_numpy(b), inv, bcs)
    assert tuple(got.shape) == (2, 8, 128)
    assert _max_err(got, ref) < 1e-5


# ---------------------------------------------------------------------------
# K1 (unmasked) and K3: the march kernels' launch plans, and parity at ragged z
# ---------------------------------------------------------------------------

# the level shapes of the 256³ and 48³ V-cycles (fine shapes, as K3 takes them), and chip_smoke.py's small shapes:
# SMALL, SMALL_NARROW (z narrower than a warp's runs) and RAGGED (rows that are no whole number of 16-byte groups)
MARCH_SHAPES = ([(n,) * 3 for n in (256, 128, 64, 32, 16, 8)] + [(n,) * 3 for n in (48, 24, 12, 6)]
                + [(24, 40, 72), (24, 40, 24), (24, 40, 70)])
MARCH_IDS = ['x'.join(map(str, s)) for s in MARCH_SHAPES]
DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16}


def _covers_once(n, blocks, per_block, per_thread):
    """Block g's thread t owns indices (g·per_block + t)·per_thread + e, e < per_thread: those below n cover
    [0, n) exactly once, and the last block owns at least one of them."""
    owned = [(g * per_block + t) * per_thread + e
             for g in range(blocks) for t in range(per_block) for e in range(per_thread)]
    return sorted(i for i in owned if i < n) == list(range(n)) and (blocks - 1) * per_block * per_thread < n


def _check_march_block(plan):
    bx, by = plan['block']
    assert 1 <= bx <= 32 and bx & (bx - 1) == 0  # a warp holds whole rows
    assert (bx * by) % 32 == 0 and bx * by <= TP.MARCH_THREADS
    assert plan['blocks'] == plan['grid'][0] * plan['grid'][1] * plan['grid'][2]


def _aligned_rows(Z, *dtypes):
    return all(Z * dt.itemsize % 16 == 0 for dt in dtypes if dt is not None)


@pytest.mark.parametrize('b_dtype', [None, 'f32', 'bf16'], ids=['matvec', 'b-f32', 'b-bf16'])
@pytest.mark.parametrize('p_dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('shape', MARCH_SHAPES, ids=MARCH_IDS)
def test_stencil_plan(shape, p_dtype, b_dtype):
    """K1's plan: runs of 16 bytes of p, a grid that covers every cell exactly
    once (z runs × y rows × x chunks), one partial a block, and the vector
    route exactly where every row of p and b starts on a 16-byte boundary."""
    X, Y, Z = shape
    pdt, bdt = DTYPES[p_dtype], DTYPES.get(b_dtype)
    plan = TP.stencil_plan(shape, pdt, bdt)
    _check_march_block(plan)
    bx, by = plan['block']
    assert plan['run'] * pdt.itemsize == 16
    assert _covers_once(Z, plan['grid'][0], bx, plan['run'])
    assert _covers_once(Y, plan['grid'][1], by, 1)
    assert _covers_once(X, plan['grid'][2], 1, plan['chunk'])
    assert plan['partials'] == plan['blocks']
    assert plan['route'] == ('vector' if _aligned_rows(Z, pdt, bdt) else 'scalar')
    assert TP.stencil_plan(shape, pdt, bdt, aligned=False)['route'] == 'scalar'


@pytest.mark.parametrize('b_dtype', ['f32', 'bf16'], ids=['b-f32', 'b-bf16'])
@pytest.mark.parametrize('u_dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('shape', MARCH_SHAPES, ids=MARCH_IDS)
def test_restrict_plan(shape, u_dtype, b_dtype):
    """K3's plan: runs of coarse cells under 16 bytes of a fine row of u, a
    grid that covers every coarse cell exactly once (z runs × coarse y rows ×
    coarse x chunks), and the vector route exactly where every fine row of u
    and of b starts on a 16-byte boundary."""
    X, Y, Z = shape
    udt, bdt = DTYPES[u_dtype], DTYPES[b_dtype]
    plan = TP.restrict_plan(shape, udt, bdt)
    _check_march_block(plan)
    bx, by = plan['block']
    assert 2 * plan['run'] * udt.itemsize == 16
    assert _covers_once(Z // 2, plan['grid'][0], bx, plan['run'])
    assert _covers_once(Y // 2, plan['grid'][1], by, 1)
    assert _covers_once(X // 2, plan['grid'][2], 1, plan['chunk'])
    assert plan['route'] == ('vector' if _aligned_rows(Z, udt, bdt) else 'scalar')
    assert TP.restrict_plan(shape, udt, bdt, aligned=False)['route'] == 'scalar'


@pytest.mark.parametrize('chunk', [1, 3, 64, 300])
def test_march_plans_fixed_chunk(chunk):
    """A fixed x-chunk replaces the cost model's pick and only it."""
    shape, f32, bf16 = (256, 128, 64), torch.float32, torch.bfloat16
    for plan_of in (lambda **kw: TP.stencil_plan(shape, f32, f32, **kw),
                    lambda **kw: TP.restrict_plan(shape, bf16, f32, **kw)):
        picked, plan = plan_of(), plan_of(chunk=chunk)
        planes = shape[0] if 'partials' in plan else shape[0] // 2
        assert plan['chunk'] == chunk
        assert plan['grid'] == picked['grid'][:2] + (-(-planes // chunk),)
        assert {k: plan[k] for k in ('route', 'run', 'block')} == {k: picked[k] for k in ('route', 'run', 'block')}
        with pytest.raises(ValueError):
            plan_of(chunk=0)


def test_restrict_plan_refuses_odd_sizes():
    with pytest.raises(ValueError, match='even'):
        TP.restrict_plan((8, 8, 7), torch.float32, torch.float32)


# z 70 and z 6: rows that are no whole number of 16-byte groups (the kernels' scalar route); JAX's gates refuse these
# shapes, so it computes through XLA, as its own suite runs it
RAGGED_SHAPES = [(4, 6, 70), (6, 6, 6)]


@pytest.mark.parametrize('mode', ['matvec', 'residual', 'jacobi'])
@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
@pytest.mark.parametrize('shape', RAGGED_SHAPES, ids=['z70', 'z6'])
def test_poisson_apply_with_dot_ragged_matches_jax(shape, bcs, mode):
    p, b = _fields(12, shape)
    ref = np.asarray(JP.poisson_apply(jnp.asarray(p), INV, bcs, b=jnp.asarray(b), mode=mode, omega_over_diag=0.15))
    ref_dot = float(np.sum(p.astype(np.float64) * ref))
    got, dot = TP.poisson_apply(torch.from_numpy(p), INV, bcs, b=torch.from_numpy(b), mode=mode,
                                omega_over_diag=0.15, with_dot=True)
    assert tuple(got.shape) == shape
    assert _max_err(got, ref) < 2e-5
    assert abs(float(dot) - ref_dot) / max(abs(ref_dot), 1.0) < 1e-5


@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
@pytest.mark.parametrize('shape', RAGGED_SHAPES, ids=['z70', 'z6'])
def test_residual_restrict_ragged_matches_jax(shape, bcs):
    u, b = _fields(13, shape)
    inv = (1.0, 0.5, 2.0)
    ref = JP.residual_restrict(jnp.asarray(u), jnp.asarray(b), inv, bcs)
    got = TP.residual_restrict(torch.from_numpy(u), torch.from_numpy(b), inv, bcs)
    assert tuple(got.shape) == tuple(n // 2 for n in shape)
    assert _max_err(got, ref) < 1e-5


# ---------------------------------------------------------------------------
# K1m: the masked form — coefficient arrays from stage_masks, active cells, both
# ---------------------------------------------------------------------------

FORMS = ['mA+c0', 'active', 'mA+c0+active']


def _face_masks(rng, shape, bcs):
    """Random 0/1 masks of every face per axis (N+1 along the own axis, N
    where periodic), first and last planes non-zero before staging."""
    masks = []
    for d in range(3):
        fshape = list(shape)
        if bcs[d] != ('periodic', 'periodic'):
            fshape[d] += 1
        m = (rng.uniform(size=fshape) > 0.2).astype(np.float32)
        index = [slice(None)] * 3
        for plane in (0, -1):
            index[d] = plane
            m[tuple(index)] = 1.0
        masks.append(m)
    return masks


def _masked_inputs(seed, shape, bcs, form):
    """(p, b, JAX kwargs, port kwargs) of one masked form; each side stages
    the same face masks with its own stage_masks."""
    rng = np.random.default_rng(seed)
    p, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    masks = _face_masks(rng, shape, bcs)
    act = (rng.uniform(size=shape) > 0.3).astype(np.float32)
    jkw = dict(mA_list=None, c0=None, active=None)
    tkw = {}
    if 'mA' in form:
        jkw['mA_list'], jkw['c0'] = JP.stage_masks([jnp.asarray(m) for m in masks], bcs, INV)
        tkw['mA_list'], tkw['c0'] = TP.stage_masks([torch.from_numpy(m) for m in masks], bcs, INV)
    if 'active' in form:
        jkw['active'] = jnp.asarray(act)
        tkw['active'] = torch.from_numpy(act)
    return p, b, jkw, tkw


@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
def test_stage_masks_matches_jax_exactly(bcs):
    rng = np.random.default_rng(8)
    masks = _face_masks(rng, (6, 8, 10), bcs)
    masks = [m * rng.uniform(0.5, 1.5, size=m.shape).astype(np.float32) for m in masks]  # not only 0/1
    ref_mA, ref_c0 = JP.stage_masks([jnp.asarray(m) for m in masks], bcs, INV)
    mA, c0 = TP.stage_masks([torch.from_numpy(m) for m in masks], bcs, INV)
    for got, ref in zip(mA, ref_mA):
        assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(c0.numpy(), np.asarray(ref_c0))
    for d, (lo, _) in enumerate(bcs):
        if lo != 'periodic':  # plane 0 of a⁻ is zeroed: the last plane's a⁺ = roll(mA, −1) is 0
            assert float(mA[d].select(d, 0).abs().max()) == 0.0


@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
@pytest.mark.parametrize('form', FORMS)
@pytest.mark.parametrize('mode', ['matvec', 'residual', 'jacobi'])
def test_masked_twin_matches_pallas(bcs, form, mode):
    """At a shape the Pallas gate admits (8 × 8 × 128): within 2e-5 of the
    kernel in interpret mode, the tolerance of the unmasked checks."""
    shape = (8, 8, 128)
    p, b, jkw, tkw = _masked_inputs(9, shape, bcs, form)
    ref = JP._apply_pallas_3d(jnp.asarray(p), INV, bcs, jkw['mA_list'], jkw['c0'], jkw['active'],
                              jnp.asarray(b) if mode != 'matvec' else None, mode, 0.15, interpret=True)
    got = TP.poisson_apply(torch.from_numpy(p), INV, bcs, b=torch.from_numpy(b), mode=mode, omega_over_diag=0.15,
                           **tkw)
    assert _max_err(got, ref) < 2e-5


@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
@pytest.mark.parametrize('form', FORMS)
def test_masked_twin_with_dot_matches_pallas(bcs, form):
    """The dot is ⟨p, out⟩ after the active select: inactive cells add p²."""
    shape = (8, 8, 128)
    p, _, jkw, tkw = _masked_inputs(10, shape, bcs, form)
    ref, ref_dot = JP._apply_pallas_3d(jnp.asarray(p), INV, bcs, jkw['mA_list'], jkw['c0'], jkw['active'], None,
                                       'matvec', None, interpret=True, with_dot=True)
    got, dot = TP.poisson_apply(torch.from_numpy(p), INV, bcs, with_dot=True, **tkw)
    assert _max_err(got, ref) < 2e-5
    assert abs(float(dot) - float(ref_dot)) / max(abs(float(ref_dot)), 1.0) < 1e-5


@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
@pytest.mark.parametrize('form', FORMS)
@pytest.mark.parametrize('mode', ['matvec', 'residual', 'jacobi'])
def test_masked_twin_matches_xla_off_gate(bcs, form, mode):
    """At a shape the Pallas gate refuses (10 × 12 × 20): within 1e-5 of
    JAX's XLA route, which is what the JAX package runs there."""
    shape = (10, 12, 20)
    p, b, jkw, tkw = _masked_inputs(11, shape, bcs, form)
    ref = JP._apply_xla(jnp.asarray(p), INV, bcs, jkw['mA_list'], jkw['c0'], jkw['active'], jnp.asarray(b), mode,
                        0.15)
    got = TP.poisson_apply(torch.from_numpy(p), INV, bcs, b=torch.from_numpy(b), mode=mode, omega_over_diag=0.15,
                           **tkw)
    assert _max_err(got, ref) < 1e-5


def test_masked_arguments_come_together():
    p = torch.zeros(4, 4, 4)
    with pytest.raises(ValueError, match='together'):
        TP.poisson_apply(p, INV, BCS[0], c0=p)


# ---------------------------------------------------------------------------
# K1m's march: its launch plan, and a numpy model of its indexing
# ---------------------------------------------------------------------------

# the shapes K1m runs at on a path (obstacles 256³ and 48³, FLIP 128³, 64³, 32³ and 24³) and chip_smoke.py's small
# shapes: SMALL, SMALL_NARROW (idle lanes) and RAGGED (rows that are no whole number of runs: the scalar route)
MASKED_SHAPES = [(n,) * 3 for n in (256, 48, 128, 64, 32, 24)] + [(24, 40, 72), (24, 40, 24), (24, 40, 70)]


@pytest.mark.parametrize('form', ['active', 'coeffs'])
@pytest.mark.parametrize('b_dtype', [None, 'f32', 'bf16'], ids=['matvec', 'b-f32', 'b-bf16'])
@pytest.mark.parametrize('p_dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('shape', MASKED_SHAPES, ids=['x'.join(map(str, s)) for s in MASKED_SHAPES])
def test_masked_stencil_plan(shape, p_dtype, b_dtype, form):
    """K1m's plan in both its forms: runs of `MASKED_RUN` cells (16 bytes of
    each float32 mask) in either dtype of p, a grid that covers every cell
    exactly once, one partial a block, and the vector route exactly where
    every row is a whole number of runs."""
    X, Y, Z = shape
    pdt, bdt = DTYPES[p_dtype], DTYPES.get(b_dtype)
    plan = TP.stencil_plan(shape, pdt, bdt, form=form)
    _check_march_block(plan)
    bx, by = plan['block']
    assert plan['run'] == TP.MASKED_RUN == 4
    assert _covers_once(Z, plan['grid'][0], bx, plan['run'])
    assert _covers_once(Y, plan['grid'][1], by, 1)
    assert _covers_once(X, plan['grid'][2], 1, plan['chunk'])
    assert plan['partials'] == plan['blocks']
    assert plan['route'] == ('vector' if Z % 4 == 0 else 'scalar')
    assert TP.stencil_plan(shape, pdt, bdt, aligned=False, form=form)['route'] == 'scalar'


def test_masked_stencil_plan_fixed_chunk():
    """A fixed x-chunk replaces the cost model's pick and only it; the masked
    plan's run does not follow p's dtype, the unmasked one's does; an
    unknown form is refused."""
    shape, f32, bf16 = (256, 128, 64), torch.float32, torch.bfloat16
    picked = TP.stencil_plan(shape, f32, form='coeffs')
    for chunk in (1, 3, 64, 300):
        plan = TP.stencil_plan(shape, f32, form='coeffs', chunk=chunk)
        assert plan['chunk'] == chunk and plan['grid'] == picked['grid'][:2] + (-(-shape[0] // chunk),)
        assert {k: plan[k] for k in ('route', 'run', 'block')} == {k: picked[k] for k in ('route', 'run', 'block')}
    assert TP.stencil_plan(shape, bf16, form='active')['run'] == 4
    assert TP.stencil_plan(shape, bf16)['run'] == 8
    with pytest.raises(ValueError):
        TP.stencil_plan(shape, f32, form='coeffs', chunk=0)
    with pytest.raises(ValueError, match='form'):
        TP.stencil_plan(shape, f32, form='masked')


def test_march_plan_counts_whole_waves():
    """The chunk's cost counts whole waves of blocks: a last wave that is
    partly empty costs a full one. At the obstacle path's 256³ the
    coefficient form (3 blocks of 256 threads an SM) takes chunk 16 (1024
    blocks, 2.6 waves of 396) over 32 (512 blocks, 1.3 waves), which the
    fractional count would pick."""
    f32 = torch.float32
    plan = TP.stencil_plan((256, 256, 256), f32, form='coeffs')
    slots = TP._SMS * (TP._STENCIL_THREADS_PER_SM['coeffs'] // (plan['block'][0] * plan['block'][1]))
    assert slots == 396 and plan['chunk'] == 16 and plan['blocks'] == 1024
    waves = -(-plan['blocks'] // slots)
    half = TP.stencil_plan((256, 256, 256), f32, form='coeffs', chunk=32)
    assert waves * (16 + 2) < -(-half['blocks'] // slots) * (32 + 2)


def _offset_or_none(i, n, lo, hi, stride):
    """csrc/poisson.cu::march::offset_or_none: plane or row i (at most one past either end), -1 past a
    non-periodic side."""
    if 0 <= i < n:
        return i * stride
    if i < 0:
        return (n - 1) * stride if lo == 'periodic' else -1
    return 0 if hi == 'periodic' else -1


def _masked_march_model(p, b, inv, bcs, mA, c0, act, mode, w, plan):
    """K1m as `march::stencil_kernel` indexes it, thread by thread: a run of
    `plan['run']` cells of a row marching along x over its chunk, pm / ax
    loaded at the chunk's start, a⁺_x the next plane's run of mA_x (0 past a
    non-periodic last plane, plane 0 past a periodic one), a⁺_y the next row's
    run of mA_y, a⁺_z the next cell (past the run: the next lane's first, or
    the row's first where periodic). A lane's shuffled neighbour is the run
    beside it in the same row, so its value is the one at that offset; the
    scalar route fills a run past the row's end with the row's first cell
    (periodic) or 0. Returns out and the dot, summed from per-block partials."""
    X, Y, Z = p.shape
    YZ = Y * Z
    V, (bx, by), cx, vec = plan['run'], plan['block'], plan['chunk'], plan['route'] == 'vector'
    f = [a.reshape(-1) if a is not None else None for a in (p, b, *(mA or (None,) * 3), c0, act)]
    pf, bf, mx, my, mz, c0f, af = f
    (xlo, xhi), (ylo, yhi), (zlo, zhi) = bcs
    wrap_z = zhi == 'periodic'
    f32 = np.float32

    def load(a, row, k0, wrap):
        if row < 0:
            return np.zeros(V, f32)
        if vec:
            return a[row + k0:row + k0 + V].astype(f32)
        return np.array([a[row + k] if k < Z else a[row] if (k == Z and wrap) else 0.0
                         for k in range(k0, k0 + V)], f32)

    def at(a, pl, q):
        return f32(a[pl + q]) if q >= 0 else f32(0.0)

    def centre(i, n, lo, hi):
        c = -2.0
        if i == 0 and lo != 'periodic':
            c = -2.0 if lo == 'ghost0' else -1.0
        if i == n - 1 and hi != 'periodic':
            c = -2.0 if hi == 'ghost0' else -1.0
        return f32(c)

    out = np.full(X * Y * Z, np.nan, f32)
    partials = []
    inv = [f32(x) for x in inv]
    for gz in range(plan['grid'][2]):
        for gy in range(plan['grid'][1]):
            for gx in range(plan['grid'][0]):
                contrib = 0.0
                for ty in range(by):
                    for tx in range(bx):
                        k0, j = (gx * bx + tx) * V, gy * by + ty
                        if not (j < Y and k0 < Z):
                            continue  # an idle thread stores nothing and adds 0
                        row = j * Z
                        rym = _offset_or_none(j - 1, Y, ylo, yhi, Z)
                        ryp = _offset_or_none(j + 1, Y, ylo, yhi, Z)
                        ql = row + k0 - 1 if k0 > 0 else (row + Z - 1 if zlo == 'periodic' else -1)
                        qr = row + k0 + V if k0 + V < Z else (row if (k0 + V == Z and wrap_z) else -1)
                        x0 = gz * cx
                        plm = _offset_or_none(x0 - 1, X, xlo, xhi, YZ)
                        pm = load(pf, plm + row if plm >= 0 else -1, k0, wrap_z)
                        pc = load(pf, x0 * YZ + row, k0, wrap_z)
                        ax = load(mx, x0 * YZ + row, k0, False) if mA else None
                        for i in range(x0, min(x0 + cx, X)):
                            pl, pln = i * YZ, _offset_or_none(i + 1, X, xlo, xhi, YZ)
                            pn = load(pf, pln + row if pln >= 0 else -1, k0, wrap_z)
                            ym = load(pf, pl + rym if rym >= 0 else -1, k0, wrap_z)
                            yp = load(pf, pl + ryp if ryp >= 0 else -1, k0, wrap_z)
                            bv = load(bf, pl + row, k0, False) if mode != 'matvec' else None
                            zl, zr = at(pf, pl, ql), at(pf, pl, qr)
                            if mA:
                                axn = load(mx, pln + row if pln >= 0 else -1, k0, False)
                                ay = load(my, pl + row, k0, False)
                                ayp = load(my, pl + ryp if ryp >= 0 else -1, k0, False)
                                az = load(mz, pl + row, k0, wrap_z)
                                cc = load(c0f, pl + row, k0, False)
                                azr = at(mz, pl, qr)
                            ac = load(af, pl + row, k0, False) if act is not None else None
                            for e in range(V):
                                if k0 + e >= Z:
                                    break
                                lo = zl if e == 0 else pc[e - 1]
                                hi = zr if e == V - 1 else pc[e + 1]
                                if mA:
                                    lap = (inv[0] * (ax[e] * pm[e] + axn[e] * pn[e])
                                           + inv[1] * (ay[e] * ym[e] + ayp[e] * yp[e])
                                           + inv[2] * (az[e] * lo + (azr if e == V - 1 else az[e + 1]) * hi)
                                           + cc[e] * pc[e])
                                else:
                                    cen = (inv[0] * centre(i, X, xlo, xhi) + inv[1] * centre(j, Y, ylo, yhi)
                                           + inv[2] * centre(k0 + e, Z, zlo, zhi))
                                    lap = (inv[0] * (pm[e] + pn[e]) + inv[1] * (ym[e] + yp[e])
                                           + inv[2] * (lo + hi) + cen * pc[e])
                                o = lap if mode == 'matvec' else bv[e] - lap if mode == 'residual' else \
                                    pc[e] + f32(w) * (bv[e] - lap)
                                if ac is not None and ac[e] == 0.0:
                                    o = pc[e]
                                out[pl + row + k0 + e] = o
                                contrib += float(pc[e]) * float(o)
                            pm, pc = pc, pn
                            if mA:
                                ax = axn
                partials.append(contrib)
    return out.reshape(X, Y, Z), sum(partials)


@pytest.mark.parametrize('mode', ['matvec', 'residual', 'jacobi'])
@pytest.mark.parametrize('form', FORMS)
@pytest.mark.parametrize('bcs', BCS, ids=BC_IDS)
@pytest.mark.parametrize('shape', [(5, 6, 12), (5, 6, 10)], ids=['vector', 'scalar'])
def test_masked_march_model_matches_twin_and_jax(shape, bcs, form, mode):
    """The model of K1m's indexing (`_masked_march_model`, two-plane chunks:
    every chunk start; idle lanes and rows) against the twin and JAX's XLA
    route: every cell written once, values within 2e-5, the dot within 1e-5
    relative."""
    p, b, jkw, tkw = _masked_inputs(14, shape, bcs, form)
    plan = TP.stencil_plan(shape, torch.float32, None if mode == 'matvec' else torch.float32, chunk=2,
                           form='active' if form == 'active' else 'coeffs')
    assert plan['route'] == ('vector' if shape[2] % 4 == 0 else 'scalar')
    mA = [m.numpy() for m in tkw['mA_list']] if 'mA_list' in tkw else None
    c0 = tkw['c0'].numpy() if 'c0' in tkw else None
    act = tkw['active'].numpy() if 'active' in tkw else None
    got, dot = _masked_march_model(p, b, INV, bcs, mA, c0, act, mode, 0.15, plan)
    assert not np.isnan(got).any()
    ref, ref_dot = TP.poisson_apply(torch.from_numpy(p), INV, bcs, b=torch.from_numpy(b), mode=mode,
                                    omega_over_diag=0.15, with_dot=True, **tkw)
    assert float(np.abs(got - ref.numpy()).max()) < 2e-5
    assert abs(dot - float(ref_dot)) / max(abs(float(ref_dot)), 1.0) < 1e-5
    jref = JP._apply_xla(jnp.asarray(p), INV, bcs, jkw['mA_list'], jkw['c0'], jkw['active'], jnp.asarray(b), mode,
                         0.15)
    assert _max_err(torch.from_numpy(got), jref) < 2e-5

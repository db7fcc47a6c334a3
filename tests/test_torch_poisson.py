"""The port's Poisson stencil (K1 `poisson_apply`, K2 `poisson_smooth`, K3
`residual_restrict`) against the JAX package's Pallas kernels run in
interpret mode. The port runs on the CPU, where its wrappers take the plain
PyTorch twins; inputs are made with numpy from a seed and fed to both."""
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

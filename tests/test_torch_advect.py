"""The port's `semi_lagrangian`, `mac_cormack` and `max_displacement_cells`
(`phiflow_tpu_torch/physics/advect.py`) against `phiflow_tpu.physics.advect`
on the same numpy fields: a centred and a staggered field, 2D and 3D, closed
and periodic box. Both sides run their window sum on the CPU (JAX its
`fori_loop` route, the port its plain twin); tolerance 1e-5 abs on values of
order 1 — the two differ only in float32 summation order."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phiflow_tpu.physics import advect as jadvect
from phiflow_tpu_torch.math import BOUNDARY, PERIODIC
from phiflow_tpu_torch.physics import advect

TOL = 1e-5
DT = 0.5
DX = 1.5


def _smooth(shape, N, rng, amp):
    """Low-mode sinusoids scaled to max |·| = amp."""
    grids = np.meshgrid(*[np.arange(n) / N for n in shape], indexing='ij')
    out = np.zeros(shape)
    for _ in range(3):
        k = rng.integers(1, 3, len(shape))
        ph = rng.uniform(0, 2 * np.pi, len(shape))
        out += np.prod([np.sin(2 * np.pi * k[a] * grids[a] + ph[a]) for a in range(len(shape))], axis=0)
    return (amp * out / np.abs(out).max()).astype(np.float32)


def _case(dims, periodic, cfl, seed):
    """(numpy velocity components, numpy smoke, JAX velocity, JAX smoke)."""
    from phiflow_tpu.math import Tensor, dual, stack
    from phiflow_tpu.models import SmokePlume as JaxSmoke
    N = 12 if dims == 3 else 20
    names = tuple('xyz'[:dims])
    rng = np.random.default_rng(seed)
    shapes = [tuple(N - (0 if periodic or a != d else 1) for a in range(dims)) for d in range(dims)]
    vel = [_smooth(s, N, rng, cfl * DX / DT) for s in shapes]
    smoke = (0.5 + _smooth((N,) * dims, N, rng, 0.5)).astype(np.float32)
    model = JaxSmoke(resolution=N, dims=dims, size=DX * N, periodic=periodic)
    v0, s0, _ = model.initial_state()
    comps = [Tensor(jnp.asarray(a), v0.vector[d].values.shape.only(names, reorder=True))
             for d, a in zip(names, vel)]
    jv = v0.with_values(stack(comps, dual(vector=list(names))))
    js = s0.with_values(Tensor(jnp.asarray(smoke), s0.values.shape.only(names, reorder=True)))
    return vel, smoke, jv, js


def _assert_close(got, ref_field, names, staggered):
    if staggered:
        for d, dim in enumerate(names):
            ref = np.asarray(ref_field.vector[dim].values.native(tuple(names)))
            assert got[d].shape == ref.shape
            assert float(np.abs(got[d].numpy() - ref).max()) < TOL, dim
    else:
        ref = np.asarray(ref_field.values.native(tuple(names)))
        assert float(np.abs(got.numpy() - ref).max()) < TOL


@pytest.mark.parametrize('max_cells,substeps,cfl', [(1, 1, 0.8), (2, 1, 1.7), (1, 2, 0.8),
                                                    (1, 1, 2.5), (2, 2, 5.5)],
                         ids=['K1', 'K2', 'K1-sub2', 'K1-clamped', 'K2-sub2-clamped'])
@pytest.mark.parametrize('periodic', [False, True], ids=['closed', 'periodic'])
@pytest.mark.parametrize('dims', [2, 3])
def test_advection_matches_jax(dims, periodic, max_cells, substeps, cfl):
    import warnings
    names = tuple('xyz'[:dims])
    vel, smoke, jv, js = _case(dims, periodic, cfl, seed=dims * 10 + periodic)
    tv = tuple(torch.from_numpy(a) for a in vel)
    ts = torch.from_numpy(smoke)
    s_ext = PERIODIC if periodic else BOUNDARY
    v_ext = PERIODIC if periodic else 0.0
    kw = dict(max_cells=max_cells, substeps=substeps)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)  # JAX warns where the window clamps
        for jfn, tfn in ((jadvect.semi_lagrangian, advect.semi_lagrangian_native),
                         (jadvect.mac_cormack, advect.mac_cormack_native)):
            _assert_close(tfn(ts, tv, DT, DX, s_ext, periodic, **kw), jfn(js, jv, DT, **kw), names, False)
            _assert_close(tfn(tv, tv, DT, DX, v_ext, periodic, **kw), jfn(jv, jv, DT, **kw), names, True)


@pytest.mark.parametrize('periodic', [False, True], ids=['closed', 'periodic'])
@pytest.mark.parametrize('dims', [2, 3])
def test_max_displacement_cells_matches_jax(dims, periodic):
    vel, smoke, jv, js = _case(dims, periodic, 1.3, seed=50 + dims)
    tv = tuple(torch.from_numpy(a) for a in vel)
    for tfield, jfield in ((torch.from_numpy(smoke), js), (tv, jv)):
        ref = float(jadvect.max_displacement_cells(jfield, jv, DT))
        got = float(advect.max_displacement_cells_native(tfield, tv, DT, DX, periodic))
        assert abs(got - ref) < TOL
        assert 0.5 < got <= 1.3 + TOL


def test_refused_options():
    v = (torch.zeros(7, 8), torch.zeros(8, 7))
    s = torch.zeros(8, 8)
    with pytest.raises(NotImplementedError, match='slice'):
        advect.semi_lagrangian_native(s, v, DT, 1.0, BOUNDARY, max_cells=None)
    with pytest.raises(NotImplementedError, match='slice'):
        advect.mac_cormack_native(s, v, DT, 1.0, BOUNDARY, substeps='auto')
    # a leading batch axis is no longer refused: each entry advects as on its own
    batched = torch.rand(2, 8, 8, generator=torch.Generator().manual_seed(0))
    out = advect.semi_lagrangian_native(batched, v, DT, 1.0, BOUNDARY)
    assert all(torch.equal(out[e], advect.semi_lagrangian_native(batched[e], v, DT, 1.0, BOUNDARY)) for e in range(2))

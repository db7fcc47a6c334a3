"""The port's multigrid transfers (K4 `prolong_add` / `prolong_pc`,
`restrict_mean`) and fused advection (K5, at model level) against the JAX
package, whose Pallas kernels run in interpret mode. The port runs on the
CPU, where its wrappers take the plain PyTorch twins."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phiflow_tpu.ops import transfer as JT
from phiflow_tpu_torch.ops import transfer as TT

ORDER = ('x', 'y', 'z')


def test_prolong_add_matches_pallas():
    rng = np.random.default_rng(6)
    c = rng.standard_normal((8, 8, 128)).astype(np.float32)
    u = rng.standard_normal((16, 16, 256)).astype(np.float32)
    ref = JT._prolong_add_pallas_3d(jnp.asarray(c), jnp.asarray(u), interpret=True)
    got = TT.prolong_add(torch.from_numpy(c), torch.from_numpy(u))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_prolong_pc_matches_pallas():
    rng = np.random.default_rng(7)
    c = rng.standard_normal((8, 8, 128)).astype(np.float32)
    ref = JT._prolong_add_pallas_3d(jnp.asarray(c), None, interpret=True)
    got = TT.prolong_pc(torch.from_numpy(c))
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_restrict_mean_matches_reduce_window():
    rng = np.random.default_rng(8)
    r = rng.standard_normal((2, 16, 8, 6)).astype(np.float32)
    ref = JT.restrict_mean(jnp.asarray(r), 3)
    got = TT.restrict_mean(torch.from_numpy(r), 3)
    assert tuple(got.shape) == (2, 8, 4, 3)
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 1e-6


def _jax_state(model, vx, vy, vz, smoke):
    """JAX Fields holding the given raw arrays (JAX's own layout)."""
    from phiflow_tpu.math import Tensor, dual, stack
    v0, s0, _ = model.initial_state()
    comps = [Tensor(jnp.asarray(a), v0.vector[d].values.shape.only(ORDER, reorder=True))
             for d, a in zip(ORDER, (vx, vy, vz))]
    v = v0.with_values(stack(comps, dual(vector=list(ORDER))))
    s = s0.with_values(Tensor(jnp.asarray(smoke), s0.values.shape.only(ORDER, reorder=True)))
    return v, s


def test_fused_advect_matches_pallas_model():
    """Both advection phases (three fused calls: MacCormack forward with
    extrema, backward + combine + clip + inflow + lift, staggered velocity +
    buoyancy) on a random state with |u|·dt/dx < 1, against JAX's
    `SmokePlume._fused_advect` in interpret mode."""
    from phiflow_tpu.models import SmokePlume as JaxSmoke
    from phiflow_tpu_torch.models import SmokePlume
    N = 64
    rng = np.random.default_rng(11)
    vel = [rng.uniform(-1.9, 1.9, s).astype(np.float32)
           for s in ((N - 1, N, N), (N, N - 1, N), (N, N, N - 1))]
    smoke = rng.uniform(0., 1., (N, N, N)).astype(np.float32)
    # in one torch thread: in a process that has imported JAX, torch.sqrt (the inflow ball) came out up to
    # 3e-4 relative off in some runs when PyTorch's worker threads shared the work (ROADMAP §3)
    model = SmokePlume(resolution=N, dims=3, device='cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tv, ts = model._fused_advect_native(tuple(torch.from_numpy(a) for a in vel), torch.from_numpy(smoke))
    finally:
        torch.set_num_threads(threads)
    jax_model = JaxSmoke(resolution=N, dims=3)
    v, s = _jax_state(jax_model, *vel, smoke)
    jv, js = jax_model._fused_advect(v, s, interpret=True)
    assert float(np.abs(ts.numpy() - np.asarray(js.values.native(ORDER))).max()) < 2e-5
    for d, dim in enumerate(ORDER):
        ref = np.asarray(jv.vector[dim].values.native(ORDER))
        assert tv[d].shape == ref.shape
        assert float(np.abs(tv[d].numpy() - ref).max()) < 2e-5, dim


@pytest.mark.parametrize('periodic', [False, True], ids=['closed', 'periodic'])
@pytest.mark.parametrize('K', [2, 3])
def test_fused_advect_wide_window_matches_pallas_model(K, periodic):
    """The three fused calls at max_cells K = 2, 3, in the closed and the
    periodic box: call 2's combine + inflow ball + lift plane and call 3's
    three staggered outputs from one call, displacements up to 0.95·K cells,
    against JAX's `SmokePlume._fused_advect` in interpret mode."""
    from phiflow_tpu.models import SmokePlume as JaxSmoke
    from phiflow_tpu_torch.models import SmokePlume
    N = 16  # `_fused_advect` is called directly, past the models' N ≥ 64 gate for `step`
    rng = np.random.default_rng(13)
    shapes = [tuple(N - (0 if periodic else a == d) for a in range(3)) for d in range(3)]
    vel = [rng.uniform(-1.9 * K, 1.9 * K, s).astype(np.float32) for s in shapes]
    smoke = rng.uniform(0., 1., (N, N, N)).astype(np.float32)
    model = SmokePlume(resolution=N, dims=3, max_cells=K, periodic=periodic, device='cpu')
    tv, ts = model._fused_advect_native(tuple(torch.from_numpy(a) for a in vel), torch.from_numpy(smoke))
    jax_model = JaxSmoke(resolution=N, dims=3, max_cells=K, periodic=periodic)
    v, s = _jax_state(jax_model, *vel, smoke)
    jv, js = jax_model._fused_advect(v, s, interpret=True)
    assert float(np.abs(ts.numpy() - np.asarray(js.values.native(ORDER))).max()) < 2e-5
    for d, dim in enumerate(ORDER):
        ref = np.asarray(jv.vector[dim].values.native(ORDER))
        assert tv[d].shape == ref.shape
        assert float(np.abs(tv[d].numpy() - ref).max()) < 2e-5, dim


PATH_CALLS = {  # (output shapes, number of sources, the slabs) of a 256³ closed-box step's three fused calls
    'call 1': ([(256,) * 3], 4, [3]),
    'call 2': ([(256,) * 3], 4, [3]),
    'call 3': ([(255, 256, 256), (256, 255, 256), (256, 256, 255)], 3, [0, 1, 2]),
    'small, four outputs': ([(24, 40, 72), (24, 39, 72), (23, 40, 72), (24, 40, 71)], 5, [4, 0, 2, 3]),
}


@pytest.mark.parametrize('K', range(1, 8))
@pytest.mark.parametrize('call', PATH_CALLS)
def test_advect_plan(call, K):
    """K5's launch plan: the staged arrays and their index tables fit a
    block's shared memory (two blocks a SM at K ≤ 2 on the path), each slab
    is staged over the corner window of a displacement clipped to ±K, each
    velocity array over the tile and one more, and the grid covers every
    output."""
    from phiflow_tpu_torch.ops.advect3d import SMEM_LIMIT, advect_plan
    shapes, n_sources, slabs = PATH_CALLS[call]
    plan = advect_plan(shapes, K, n_sources, slabs)
    T = plan['tile']
    assert plan['smem'] <= SMEM_LIMIT
    if K <= 2:
        assert plan['smem'] <= SMEM_LIMIT // 2
    assert set(plan['staged']) == set(range(3)) | set(slabs)
    floats = ints = 0
    for i, (off, tab, lo, e) in plan['staged'].items():
        assert off == floats and tab == ints  # packed in order
        below, above = (K, K + 2) if i in slabs else (0, 1)
        assert lo[:2] == (below, below) and e[:2] == (T[0] + below + above, T[1] + below + above)
        # z: whole groups of 4 floats (16-byte copies) on the path, covering the same range
        group = 4 if (lo[2] % 4, e[2] % 4, off % 4) == (0, 0, 0) else 1
        assert group == 4 or call.startswith('small') and K == 7
        assert below <= lo[2] < below + group and e[2] - lo[2] - T[2] - above in range(group)
        floats += e[0] * e[1] * e[2]
        ints += sum(e)
    assert plan['smem'] == 4 * (floats + ints)
    for a, ax in ((0, 2), (1, 1), (2, 0)):
        assert plan['grid'][a] * T[ax] >= max(s[ax] for s in shapes) > (plan['grid'][a] - 1) * T[ax]


def test_fused_advect_periodic_sources_match_pallas():
    """Periodic ('wrap') sources — the periodic box's layout, faces 0..N−1 on
    the own axis — against JAX's periodic slab staging, for the MacCormack
    forward call (with extrema) and the staggered self-advection call."""
    from phiflow_tpu.ops import advect3d as JA
    from phiflow_tpu_torch.ops.advect3d import OutSpec, Source, fused_advect_3d
    N, K = (16, 16, 16), 1
    rng = np.random.default_rng(12)
    vel = [rng.uniform(-2.4, 2.4, N).astype(np.float32) for _ in range(3)]  # clips at ±1 cell
    smoke = rng.uniform(0., 1., N).astype(np.float32)
    scales = (-0.5,) * 3
    slabs = [JA.stage_slab_periodic(jnp.asarray(vel[d]), d, N, K) for d in range(3)]
    smoke_slab = JA.stage_slab_periodic(jnp.asarray(smoke), None, N, K)
    srcs = [Source(torch.from_numpy(vel[d]), own_axis=d, mode='wrap') for d in range(3)]

    def crop(a):
        return np.asarray(a)[:N[0], :N[1], :N[2]]

    [ref] = JA.fused_advect_3d(slabs + [smoke_slab], N, K, [JA.OutSpec(slab=3, extrema=True)], scales,
                               interpret=True)
    [got] = fused_advect_3d(srcs + [Source(torch.from_numpy(smoke), mode='wrap')], N, K,
                            [OutSpec(slab=3, extrema=True)], scales)
    for g, r in zip(got, ref):
        assert float(np.abs(g.numpy() - crop(r)).max()) < 2e-5
    refs = JA.fused_advect_3d(slabs, N, K, [JA.OutSpec(slab=d, d_own=d) for d in range(3)], scales,
                              interpret=True)
    gots = fused_advect_3d(srcs, N, K, [OutSpec(slab=d, d_own=d) for d in range(3)], scales)
    for g, r in zip(gots, refs):
        assert tuple(g.shape) == N
        assert float(np.abs(g.numpy() - crop(r)).max()) < 2e-5

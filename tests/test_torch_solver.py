"""The port's pressure solve — the multigrid V-cycle (K2–K4 with the coarse
pseudo-inverse) and the projection `SmokePlume.project` (CG on K1) — against
the JAX package on the CPU (its XLA paths, float32 levels). Inputs are made
with numpy from a seed and fed to both."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

ORDER = ('x', 'y', 'z')
BCS = [(('neumann', 'neumann'),) * 3,
       (('periodic', 'periodic'),) * 3,
       (('neumann', 'ghost0'), ('periodic', 'periodic'), ('ghost0', 'neumann'))]


@pytest.mark.parametrize('bcs', BCS, ids=['neumann', 'periodic', 'mixed'])
def test_vcycle_matches_jax(bcs):
    from phiflow_tpu.math._multigrid import make_poisson_vcycle as jax_vcycle
    from phiflow_tpu_torch.math import make_poisson_vcycle
    N = (32, 32, 32)
    rng = np.random.default_rng(21)
    b = rng.standard_normal(N).astype(np.float32)
    b -= b.mean()
    ref = np.asarray(jax_vcycle(N, (1.0,) * 3, bcs)(jnp.asarray(b)[None]))[0]
    vcycle = make_poisson_vcycle(N, (1.0,) * 3, bcs, 'cpu')
    got, dot = vcycle(torch.from_numpy(b), emit_dot=True)
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - ref).max()) < 1e-5
    # the finest level's ⟨u, b⟩ from the last post-smooth
    want = float(np.sum(got.numpy().astype(np.float64) * b))
    assert abs(float(dot) - want) / max(abs(want), 1.0) < 1e-5


def test_vcycle_level_dtype_rule():
    """Levels are bfloat16 only on CUDA for 3D grids with max(res) ≥ 64; on
    the CPU they stay float32 and the result has b's dtype."""
    from phiflow_tpu_torch.math import make_poisson_vcycle
    b = torch.from_numpy(np.random.default_rng(22).standard_normal((64, 64, 64)).astype(np.float32))
    u, dot = make_poisson_vcycle((64,) * 3, (1.0,) * 3, BCS[0], 'cpu')(b)
    assert u.dtype == torch.float32 and dot is None


def _smooth(rng, shape, N, amp):
    grids = np.meshgrid(*[np.arange(n) / N for n in shape], indexing='ij')
    out = np.zeros(shape)
    for _ in range(3):
        k = rng.integers(1, 4, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        out += np.prod([np.sin(2 * np.pi * k[a] * grids[a] + ph[a]) for a in range(3)], axis=0)
    return (amp * out / np.abs(out).max()).astype(np.float32)


def test_project_matches_jax():
    """make_incompressible at 32³, cg_tol 1e-5, from x0 = 0: velocity and
    pressure within 1e-4 of JAX's, and the same number of CG iterations."""
    from phiflow_tpu.math import SolveTape, Tensor, dual, stack
    from phiflow_tpu.models import SmokePlume as JaxSmoke
    from phiflow_tpu_torch.field import divergence_native
    from phiflow_tpu_torch.models import SmokePlume
    N = 32
    rng = np.random.default_rng(23)
    vel = [_smooth(rng, s, N, 1.0) + 0.1 * rng.standard_normal(s).astype(np.float32)
           for s in ((N - 1, N, N), (N, N - 1, N), (N, N, N - 1))]
    jax_model = JaxSmoke(resolution=N, dims=3, cg_tol=1e-5)
    v0, _, p0 = jax_model.initial_state()
    comps = [Tensor(jnp.asarray(a), v0.vector[d].values.shape.only(ORDER, reorder=True))
             for d, a in zip(ORDER, vel)]
    v = v0.with_values(stack(comps, dual(vector=list(ORDER))))
    with SolveTape(record_runtime=True) as tape:
        jv, jp = jax_model.project(v, p0)
    jax_iterations = tape.solve_infos[-1].runtime_stats['iterations']

    model = SmokePlume(resolution=N, dims=3, cg_tol=1e-5, device='cpu')
    tv, tp = model.project_native(tuple(torch.from_numpy(a) for a in vel), torch.zeros((N,) * 3))
    assert model.last_solve.iterations == jax_iterations
    assert model.last_solve.converged
    assert float(np.abs(tp.numpy() - np.asarray(jp.values.native(ORDER))).max()) < 1e-4
    for d, dim in enumerate(ORDER):
        ref = np.asarray(jv.vector[dim].values.native(ORDER))
        assert float(np.abs(tv[d].numpy() - ref).max()) < 1e-4, dim
    assert float(divergence_native(tv, 1.0).abs().max()) < 1e-3


def test_project_periodic_matches_jax():
    """The periodic box's projection (periodic divergence, gradient and
    stencil modes) against JAX's periodic `SmokePlume.project`."""
    from phiflow_tpu.math import SolveTape, Tensor, dual, stack
    from phiflow_tpu.models import SmokePlume as JaxSmoke
    from phiflow_tpu_torch.field import face_layout
    from phiflow_tpu_torch.physics.fluid import make_incompressible_native
    N = 32
    rng = np.random.default_rng(24)
    vel = [_smooth(rng, (N, N, N), N, 1.0) for _ in range(3)]
    jax_model = JaxSmoke(resolution=N, dims=3, cg_tol=1e-5, periodic=True)
    v0, _, p0 = jax_model.initial_state()
    comps = [Tensor(jnp.asarray(a), v0.vector[d].values.shape.only(ORDER, reorder=True))
             for d, a in zip(ORDER, vel)]
    v = v0.with_values(stack(comps, dual(vector=list(ORDER))))
    with SolveTape(record_runtime=True) as tape:
        jv, jp = jax_model.project(v, p0)
    tv, tp, result = make_incompressible_native(tuple(torch.from_numpy(a) for a in vel), None, 1.0,
                                         rel_tol=1e-5, abs_tol=0., faces=face_layout(True, len(vel)))
    assert result.iterations == tape.solve_infos[-1].runtime_stats['iterations']
    assert float(np.abs(tp.numpy() - np.asarray(jp.values.native(ORDER))).max()) < 1e-4
    for d, dim in enumerate(ORDER):
        ref = np.asarray(jv.vector[dim].values.native(ORDER))
        assert float(np.abs(tv[d].numpy() - ref).max()) < 1e-4, dim

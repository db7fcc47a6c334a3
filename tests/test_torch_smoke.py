"""The port's slice end to end: `SmokePlume.step` in 3D against the JAX
package's step on the CPU, plus the model's state helpers, its device rule and
the configurations it refuses."""
import numpy as np
import pytest
import torch

from phiflow_tpu_torch.models import SmokePlume, state_from_numpy, state_to_numpy

ORDER = ('x', 'y', 'z')


def test_three_steps_match_jax():
    """3 steps at 32³ from rest, cg_tol 1e-5: smoke and every velocity
    component within 2e-4 of JAX's step (32³ is below the fused kernel's
    sizes, so both sides take their per-phase path)."""
    from phiflow_tpu.models import SmokePlume as JaxSmoke
    N = 32
    jax_model = JaxSmoke(resolution=N, dims=3, cg_tol=1e-5, max_iterations=200)
    jv, js, jp = jax_model.initial_state()
    model = SmokePlume(resolution=N, dims=3, cg_tol=1e-5, max_iterations=200, device='cpu')
    v, s, p = model.initial_state_native()
    for _ in range(3):
        jv, js, jp = jax_model.step(jv, js, jp)
        v, s, p = model.step_native(v, s, p)
    assert float(np.abs(s.numpy() - np.asarray(js.values.native(ORDER))).max()) < 2e-4
    for d, dim in enumerate(ORDER):
        ref = np.asarray(jv.vector[dim].values.native(ORDER))
        assert v[d].shape == ref.shape
        assert float(np.abs(v[d].numpy() - ref).max()) < 2e-4, dim
    assert float(s.max()) > 0.5  # the inflow has filled in
    assert all(bool(torch.isfinite(t).all()) for t in (*v, s, p))


def test_state_numpy_round_trip():
    N = 8
    rng = np.random.default_rng(31)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((N - 1, N, N), (N, N - 1, N), (N, N, N - 1), (N, N, N), (N, N, N))]
    state = state_from_numpy(*arrays, device='cpu')
    (vx, vy, vz), smoke, pressure = state
    assert all(t.dtype == torch.float32 and t.device.type == 'cpu' for t in (vx, vy, vz, smoke, pressure))
    back = state_to_numpy(state)
    assert all(np.array_equal(a, b) for a, b in zip(arrays, back))


def test_initial_state_layout():
    N = 8
    (vx, vy, vz), smoke, pressure = SmokePlume(resolution=N, dims=3, device='cpu').initial_state_native()
    assert [tuple(t.shape) for t in (vx, vy, vz)] == [(N - 1, N, N), (N, N - 1, N), (N, N, N - 1)]
    assert tuple(smoke.shape) == tuple(pressure.shape) == (N, N, N)


def test_default_device_raises_without_cuda(monkeypatch):
    """Entry points run on CUDA unless the caller asks for the CPU; with no
    card they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        SmokePlume(resolution=8, dims=3)
    with pytest.raises(RuntimeError, match='CUDA'):
        state_from_numpy(*(np.zeros((2, 2, 2), np.float32),) * 5)


def _batched_obstacle_projection():
    """A batch of masked systems: the projection of a batched velocity around an obstacle."""
    from phiflow_tpu_torch import math
    from phiflow_tpu_torch.field import StaggeredGrid
    from phiflow_tpu_torch.geom import Sphere
    from phiflow_tpu_torch.physics import fluid
    values = math.wrap(torch.zeros(2, 2, 16, 16), math.batch('b'), math.channel(vector='x,y'), math.spatial('x,y'))
    with math.default_device('cpu'):
        v = StaggeredGrid(values, math.extrapolation.ZERO, x=16, y=16)
        fluid.make_incompressible(v, [Sphere(x=8, y=8, radius=3)])


@pytest.mark.parametrize('make', [_batched_obstacle_projection,
                                  lambda: SmokePlume(resolution=16, dims=3, max_cells=None, device='cpu')],
                         ids=['batched', 'adaptive-window'])
def test_refused_configurations(make):
    """What the port still refuses, naming the slice that brings it: a batch
    of masked systems (batched smoke itself runs since the batched-smoke
    slice) and the unbounded gather lookup."""
    with pytest.raises(NotImplementedError, match='slice'):
        make()

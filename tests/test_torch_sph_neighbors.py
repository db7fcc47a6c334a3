"""The port's cell-list neighbour search (`phiflow_tpu_torch/math/_neighbors.py`)
against the JAX package's `cell_list_neighbors` on the same numpy positions,
on the CPU: `indices` and `mask` exactly equal, `deltas` within 1e-6 — in 2D
and 3D, closed and periodic, with particles on cell faces, with a capacity
forced to overflow, and on the default dam break's initial packing, whose
top row of cells drops 3688 particles from its buckets in both packages."""
import functools

import jax
import numpy as np
import pytest
import torch

from phiflow_tpu.math._neighbors import cell_list_neighbors as jax_cell_list

import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.math._neighbors import cell_list_neighbors
from phiflow_tpu_torch.models import SphDamBreak


@functools.lru_cache(maxsize=None)
def _jax_search(cutoff, lower, upper, periodic=False, capacity=None):
    return jax.jit(lambda pos: jax_cell_list(pos, cutoff, lower, upper, periodic=periodic, capacity=capacity))


def _compare(pos, cutoff, lower, upper, **kw):
    ref = [np.asarray(a) for a in _jax_search(cutoff, tuple(lower), tuple(upper), **kw)(pos)]
    got = [a.numpy() for a in cell_list_neighbors(torch.from_numpy(pos), cutoff, lower, upper, **kw)]
    assert got[0].dtype == np.int32 and got[2].dtype == np.bool_
    assert got[0].shape == ref[0].shape
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-6)
    return got


def _dropped(indices):
    """Particles in no bucket: a particle's own cell is always a candidate cell."""
    return int((~(indices == np.arange(indices.shape[0])[:, None]).any(1)).sum())


@pytest.mark.parametrize('d', [2, 3])
@pytest.mark.parametrize('periodic', [False, True], ids=['closed', 'periodic'])
def test_random_cloud(d, periodic):
    rng = np.random.default_rng(10 + d)
    n = 600 if d == 2 else 900
    lower, upper = [0.1] * d, [0.9, 1.3, 1.0][:d]
    pos = rng.uniform(lower, upper, (n, d)).astype(np.float32)
    pos[:20] = np.round(pos[:20] / 0.1) * 0.1  # on cell faces
    pos[20:25] = rng.uniform(-0.2, 1.5, (5, d))  # outside the domain: clamped into the border cells
    _compare(pos, 0.1 if d == 2 else 0.15, lower, upper, periodic=periodic)


@pytest.mark.parametrize('d', [2, 3])
def test_overflow_small_capacity(d):
    """Clustered particles and a capacity of 3: the stable sort decides which stay."""
    rng = np.random.default_rng(20 + d)
    pos = rng.normal(0.5, 0.05, (400, d)).astype(np.float32)
    got = _compare(pos, 0.05, [0.] * d, [1.] * d, capacity=3)
    assert _dropped(got[0]) > 100


def test_default_dam_break_packing():
    """The default dam break's initial lattice (10,000 particles, 53 × 53
    cells, capacity 21): 3688 particles dropped, the same in both packages."""
    with tm.default_device('cpu'):
        model = SphDamBreak(device='cpu')
    pos = model.particles0.geometry.center.numpy(('points', 'vector'))
    got = _compare(pos, model.support, [0., 0.], [1., 1.])
    assert got[0].shape == (10_000, 189)
    assert _dropped(got[0]) == 3688


def test_cell_list_matches_dense():
    """`tests/physics/test_sph.py::test_cell_list_matches_dense` on the port."""
    rng = np.random.default_rng(3)
    N = 500
    pos = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    cutoff = 0.08
    idx, deltas, mask = (a.numpy() for a in cell_list_neighbors(torch.from_numpy(pos), cutoff, [0., 0.], [1., 1.]))
    d2 = ((pos[None, :, :] - pos[:, None, :]) ** 2).sum(-1)
    dense_sets = [set(np.nonzero((d2[i] < cutoff ** 2) & (np.arange(N) != i))[0].tolist()) for i in range(N)]
    assert [set(idx[i][mask[i]].tolist()) for i in range(N)] == dense_sets


def test_cell_list_periodic():
    """`tests/physics/test_sph.py::test_cell_list_periodic` on the port: neighbours across the wrap, min-image deltas."""
    pos = torch.tensor([[0.05, 0.5], [0.95, 0.5]])
    idx, deltas, mask = cell_list_neighbors(pos, 0.2, [0., 0.], [1., 1.], periodic=True)
    assert [set(idx[i][mask[i]].tolist()) for i in range(2)] == [{1}, {0}]
    assert abs(float(deltas[0][mask[0]][0, 0]) + 0.1) < 1e-6

"""The port's P2G mean scatter (K8 `p2g_mean_3d`) against the JAX package's
`ops/p2g.py`: its plain scatter `_p2g_xla` and its Pallas kernel in interpret
mode. The port runs on the CPU, where the wrapper takes the plain twin; inputs
are made with numpy from a seed and fed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiflow_tpu.ops import p2g as JG
from phiflow_tpu_torch.ops import p2g as TG

# (resolution, lower corner, cell size): a cube of unit cells, and a grid that
# is not cubic with a corner off the origin and cells of three sizes
GRIDS = [((16, 16, 16), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
         ((7, 12, 20), (0.5, -1.0, 0.25), (0.5, 1.0, 0.25))]
GRID_IDS = ['cube', 'non-cubic']
N = 5000  # not a multiple of the Pallas kernel's 512-particle chunk


def _particles(seed, res, lower, dx, n=N):
    """Positions over the grid: most inside, 5% up to two cells outside on any
    side, one coordinate in 32 exactly on a cell border; and values."""
    rng = np.random.default_rng(seed)
    cells = rng.uniform(0, 1, (n, 3)) * np.asarray(res)
    outside = rng.uniform(size=(n, 1)) < 0.05
    cells = np.where(outside, rng.uniform(-2, 2, (n, 3)) + np.where(rng.uniform(size=(n, 3)) < 0.5, 0, res), cells)
    cells = np.where(rng.uniform(size=(n, 3)) < 1 / 32, np.round(cells), cells)
    pos = (cells * np.asarray(dx) + np.asarray(lower)).astype(np.float32)
    return pos, rng.standard_normal(n).astype(np.float32)


def _inv(dx):
    return tuple(1.0 / h for h in dx)


@pytest.mark.parametrize('clamp', [False, True], ids=['discard', 'clamp'])
@pytest.mark.parametrize('grid', GRIDS, ids=GRID_IDS)
def test_cell_ids_match_jax_exactly(grid, clamp):
    """Borders and outside particles included: the same cell and the same
    validity for every particle."""
    res, lower, dx = grid
    pos, _ = _particles(0, res, lower, dx)
    ref_ids, ref_valid = JG._cell_ids(jnp.asarray(pos), res, lower, _inv(dx), clamp)
    ids, valid = TG._cell_ids(torch.from_numpy(pos), res, lower, _inv(dx), clamp)
    assert np.array_equal(ids.numpy(), np.asarray(ref_ids))
    assert np.array_equal(valid.numpy(), np.asarray(ref_valid) > 0)
    assert (not clamp and not valid.all()) or (clamp and valid.all())  # some particles do lie outside


@pytest.mark.parametrize('clamp', [False, True], ids=['discard', 'clamp'])
@pytest.mark.parametrize('grid', GRIDS, ids=GRID_IDS)
def test_sums_counts_match_xla(grid, clamp):
    """Counts exactly; sums within 1e-6 of the largest sum (the two scatters
    add a cell's few addends in their own order)."""
    res, lower, dx = grid
    pos, vals = _particles(1, res, lower, dx)
    ref_s, ref_c = JG._p2g_xla(jnp.asarray(pos), jnp.asarray(vals), res, lower, _inv(dx), clamp)
    sums, counts = TG.p2g_sums_counts(torch.from_numpy(pos), torch.from_numpy(vals), res, lower, _inv(dx), clamp)
    assert tuple(sums.shape) == tuple(counts.shape) == res
    assert np.array_equal(counts.numpy(), np.asarray(ref_c))
    scale = max(1.0, float(np.abs(np.asarray(ref_s)).max()))
    assert float(np.abs(sums.numpy() - np.asarray(ref_s)).max()) <= 1e-6 * scale


@pytest.mark.parametrize('clamp', [False, True], ids=['discard', 'clamp'])
@pytest.mark.parametrize('grid', GRIDS, ids=GRID_IDS)
def test_sums_counts_match_pallas(grid, clamp):
    """Against the one-hot kernel in interpret mode, at its own tolerance:
    1e-5 relative (its bf16 hi/lo split of the values)."""
    res, lower, dx = grid
    pos, vals = _particles(2, res, lower, dx)
    ref_s, ref_c = JG._p2g_pallas(jnp.asarray(pos), jnp.asarray(vals), res, lower, _inv(dx), clamp, interpret=True)
    sums, counts = TG.p2g_sums_counts(torch.from_numpy(pos), torch.from_numpy(vals), res, lower, _inv(dx), clamp)
    assert np.array_equal(counts.numpy(), np.asarray(ref_c))
    scale = max(1.0, float(np.abs(np.asarray(ref_s)).max()))
    assert float(np.abs(sums.numpy() - np.asarray(ref_s)).max()) <= 1e-5 * scale


@pytest.mark.parametrize('base', [0.0, float('nan')], ids=['base0', 'baseNaN'])
@pytest.mark.parametrize('clamp', [False, True], ids=['discard', 'clamp'])
@pytest.mark.parametrize('grid', GRIDS, ids=GRID_IDS)
def test_mean_matches_jax(grid, clamp, base):
    """`p2g_mean_3d` of both packages: `base` in exactly the same (empty)
    cells, the means within 1e-6."""
    res, lower, dx = grid
    pos, vals = _particles(3, res, lower, dx, n=1500)  # sparse: many empty cells
    ref = np.asarray(JG.p2g_mean_3d(jnp.asarray(pos), jnp.asarray(vals), res, lower, _inv(dx), clamp, base))
    got = TG.p2g_mean_3d(torch.from_numpy(pos), torch.from_numpy(vals), res, lower, _inv(dx), clamp, base).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(ref).any() == bool(np.isnan(base))
    assert float(np.nanmax(np.abs(got - ref))) <= 1e-6


@pytest.mark.parametrize('clamp', [False, True], ids=['discard', 'clamp'])
def test_gradient_matches_jax(clamp):
    """The autograd.Function's backward against jax.grad of `p2g_mean_3d`:
    g / count gathered back to the particles, 0 for dropped ones."""
    res, lower, dx = GRIDS[1]
    pos, vals = _particles(4, res, lower, dx, n=800)
    weight = np.random.default_rng(5).standard_normal(res).astype(np.float32)

    def loss(v):
        return jnp.sum(JG.p2g_mean_3d(jnp.asarray(pos), v, res, lower, _inv(dx), clamp, 0.0) * weight)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(vals)))
    v = torch.from_numpy(vals).requires_grad_(True)
    p = torch.from_numpy(pos).requires_grad_(True)
    out = TG.p2g_mean_3d(p, v, res, lower, _inv(dx), clamp, 0.0)
    (out * torch.from_numpy(weight)).sum().backward()
    assert float(np.abs(v.grad.numpy() - ref).max()) <= 1e-6
    assert p.grad is None  # positions select cells: no gradient
    if not clamp:
        assert (ref == 0).any()  # the dropped particles


def test_mean_2d_matches_numpy():
    """Two spatial axes run the twin on any device (the kernel is 3D)."""
    rng = np.random.default_rng(6)
    res, lower, dx = (9, 14), (0.0, 0.5), (1.0, 1.0)
    pos = (rng.uniform(-1, 1, (3000, 2)) + rng.uniform(0, 1, (3000, 2)) * np.asarray(res)).astype(np.float32)
    vals = rng.standard_normal(3000).astype(np.float32)
    got = TG.p2g_mean(torch.from_numpy(pos), torch.from_numpy(vals), res, lower, _inv(dx), False, float('nan')).numpy()
    cell = np.floor((pos - np.asarray(lower, np.float32)) * np.float32(1.0)).astype(np.int64)
    inside = ((cell >= 0) & (cell < np.asarray(res))).all(axis=1)
    flat = cell[inside, 0] * res[1] + cell[inside, 1]
    counts = np.bincount(flat, minlength=res[0] * res[1])
    sums = np.bincount(flat, weights=vals[inside].astype(np.float64), minlength=res[0] * res[1])
    ref = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan).reshape(res)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert float(np.nanmax(np.abs(got - ref))) <= 1e-6


def test_arguments_are_checked():
    pos, vals = torch.zeros(4, 3), torch.zeros(4)
    res, lower, inv = (4, 4, 4), (0.0,) * 3, (1.0,) * 3
    with pytest.raises(ValueError, match='expected pos'):
        TG.p2g_sums_counts(pos[:, :2], vals, res, lower, inv, True)
    with pytest.raises(TypeError, match='float32'):
        TG.p2g_sums_counts(pos.double(), vals, res, lower, inv, True)
    with pytest.raises(ValueError, match='3D grid'):
        TG.p2g_mean_3d(pos[:, :2], vals, (4, 4), (0.0, 0.0), (1.0, 1.0), True, 0.0)

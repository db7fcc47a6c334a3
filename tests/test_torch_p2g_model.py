"""A numpy model of the CUDA kernel K8 (`phiflow_tpu_torch/csrc/p2g.cu`)
against the JAX package's P2G (`phiflow_tpu/ops/p2g.py`), on the CPU where the
kernel cannot run.

The model computes what the kernel computes, in its order: the particles in
blocks of 256 threads, warps of 32 lanes; lanes past the last particle and
dropped particles carry the cell -1; the lanes of a warp with the same cell
form a group (`__match_any_sync`, grouping by equality), whose count is its
size and whose sum is taken lane by lane in increasing lane order; each group
but the sentinel's adds one sum and one count to its cell. The mean is the
epilogue's formula. Inputs are made with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiflow_tpu.ops import p2g as JG
from phiflow_tpu_torch.field import distribute_points_native
from phiflow_tpu_torch.field._resample import face_grid
from phiflow_tpu_torch.ops import p2g as TG

WARP, BLOCK = 32, 256  # csrc/p2g.cu: lanes a warp, P2G_THREADS
f32 = np.float32


def _cells(pos, res, lower, inv_dx, clamp):
    """The kernel's cell per particle (-1 where it is dropped), in float32
    without contraction: floor((p - lower) * inv_dx), clamped to the grid."""
    cell = np.zeros(pos.shape[0], np.int64)
    inside = np.ones(pos.shape[0], bool)
    with np.errstate(invalid='ignore'):
        for a, r in enumerate(res):
            c = np.floor((pos[:, a] - f32(lower[a])) * f32(inv_dx[a]))
            inside &= (c >= 0) & (c < r)
            c = np.clip(np.nan_to_num(c, nan=0.0), 0, r - 1)  # fminf(fmaxf(c, 0), r - 1): NaN goes to 0
            cell = cell * r + c.astype(np.int64)
    return np.where(inside | clamp, cell, -1)


def _scatter_model(pos, vals, res, lower, inv_dx, clamp):
    """(sums, counts, atomic pairs issued, the largest group) as K8 forms them."""
    n, n_cells = pos.shape[0], int(np.prod(res))
    n_lanes = -(-max(n, 1) // BLOCK) * BLOCK  # whole blocks of whole warps
    cell = np.full(n_lanes, -1, np.int64)
    cell[:n] = _cells(pos, res, lower, inv_dx, clamp)
    v = np.zeros(n_lanes, f32)
    v[:n] = np.where(cell[:n] >= 0, vals, f32(0))  # a select: a dropped particle's value is never read
    # groups: (warp, cell), lanes in increasing order within each
    key = np.arange(n_lanes) // WARP * (n_cells + 1) + (cell + 1)
    order = np.argsort(key, kind='stable')
    first = np.flatnonzero(np.r_[True, key[order][1:] != key[order][:-1]])
    size = np.diff(np.r_[first, n_lanes])
    group_cell = cell[order[first]]
    kept = group_cell >= 0
    # the shuffle loop: lane by lane in increasing lane order, float32 adds from 0
    group_sum = np.zeros(first.size, f32)
    for j in range(WARP):
        m = size > j
        group_sum[m] = group_sum[m] + v[order[first[m] + j]]
    # one atomic pair a group, the sentinel's excepted
    sums = np.zeros(n_cells, f32)
    counts = np.zeros(n_cells, f32)
    np.add.at(sums, group_cell[kept], group_sum[kept])
    np.add.at(counts, group_cell[kept], size[kept].astype(f32))
    return sums.reshape(res), counts.reshape(res), int(kept.sum()), int(size[kept].max(initial=0))


def _epilogue_model(sums, counts, base):
    """The mean kernel's formula: counts > 0 ? sums / max(counts, 1) : base."""
    with np.errstate(invalid='ignore', divide='ignore'):
        return np.where(counts > 0, sums / np.maximum(counts, f32(1)), f32(base)).astype(f32)


def _xla(pos, vals, res, lower, inv_dx, clamp):
    s, c = JG._p2g_xla(jnp.asarray(pos), jnp.asarray(vals), res, lower, inv_dx, clamp)
    return np.asarray(s), np.asarray(c)


def _assert_matches_xla(pos, vals, res, lower, inv_dx, clamp, exact=False):
    """Counts exactly; sums within 1e-6 of the largest sum (the kernel adds a
    cell's addends in its own order), or exactly. Returns the model's atomic
    pairs and largest group."""
    sums, counts, pairs, largest = _scatter_model(pos, vals, res, lower, inv_dx, clamp)
    ref_s, ref_c = _xla(pos, vals, res, lower, inv_dx, clamp)
    assert np.array_equal(counts, ref_c)
    if exact:
        assert np.array_equal(sums, ref_s, equal_nan=True)
    else:
        assert np.array_equal(np.isnan(sums), np.isnan(ref_s))
        scale = max(1.0, float(np.nanmax(np.abs(ref_s))))
        assert float(np.nanmax(np.abs(sums - ref_s))) <= 1e-6 * scale
    return pairs, largest


FLIP_N = 24
# FLIP's target grids: the cells (discard, base 0) and the three face grids (clamp, base NaN)
TARGETS = [None, 0, 1, 2]
TARGET_IDS = ['cells', 'x-faces', 'y-faces', 'z-faces']


def _flip_particles(seed=0):
    """FlipLiquid's particles at 24³ in the path's order (cell by cell, 8 a
    cell), the block moved to the corner and stretched past two walls so that
    some lie outside every target grid; random values."""
    pos = distribute_points_native((0.15 * FLIP_N, 0.15 * FLIP_N, 0.45 * FLIP_N), (0.55 * FLIP_N, 0.55 * FLIP_N, 0.85 * FLIP_N),
                            (FLIP_N,) * 3, points_per_cell=8, seed=seed)
    pos = ((pos - f32(0.15 * FLIP_N)) * f32(1.2) - f32(1.0)).astype(f32)
    return pos, np.random.default_rng(seed + 1).standard_normal(pos.shape[0]).astype(f32)


def _target(axis):
    res, lower, _ = face_grid((FLIP_N,) * 3, (1.0,) * 3, axis)
    return res, tuple(float(x) for x in lower), (1.0,) * 3, axis is not None


@pytest.mark.parametrize('axis', TARGETS, ids=TARGET_IDS)
def test_model_matches_xla_in_flip_order(axis):
    """(a) FLIP's order: a warp's lanes fall into a few cells, so the kernel
    issues far fewer atomic pairs than there are particles."""
    pos, vals = _flip_particles()
    res, lower, inv_dx, clamp = _target(axis)
    pairs, largest = _assert_matches_xla(pos, vals, res, lower, inv_dx, clamp)
    assert pairs <= pos.shape[0] // 2 and largest >= 4


@pytest.mark.parametrize('axis', TARGETS, ids=TARGET_IDS)
def test_model_matches_xla_shuffled(axis):
    """(b) A shuffled order, the worst case for grouping: nearly one atomic
    pair a particle."""
    pos, vals = _flip_particles()
    perm = np.random.default_rng(7).permutation(pos.shape[0])
    pos, vals = pos[perm], vals[perm]
    res, lower, inv_dx, clamp = _target(axis)
    pairs, _ = _assert_matches_xla(pos, vals, res, lower, inv_dx, clamp)
    kept = int((_cells(pos, res, lower, inv_dx, clamp) >= 0).sum())
    assert pairs >= 0.9 * kept


@pytest.mark.parametrize('clamp', [False, True], ids=['discard', 'clamp'])
def test_model_one_cell_integer_values_exact(clamp):
    """(c) Every particle in one cell, integer values: every warp is one group
    of 32 and the sums are exact in any order, so they compare exactly."""
    rng = np.random.default_rng(3)
    res, lower, dx = (7, 12, 20), (0.5, -1.0, 0.25), (0.5, 1.0, 0.25)
    n = 4133
    pos = ((np.array([3, 5, 7]) + rng.uniform(0.01, 0.99, (n, 3))) * dx + lower).astype(f32)
    vals = rng.integers(-8, 9, n).astype(f32)
    pairs, largest = _assert_matches_xla(pos, vals, res, lower, tuple(1 / h for h in dx), clamp, exact=True)
    assert pairs == -(-n // WARP) and largest == WARP


def _sparse_particles(seed, n, res=(7, 12, 20), lower=(0.5, -1.0, 0.25), dx=(0.5, 1.0, 0.25)):
    """Positions over the grid, a third of them up to two cells outside, so
    that warps mix kept and dropped particles; random values."""
    rng = np.random.default_rng(seed)
    cells = rng.uniform(0, 1, (n, 3)) * res
    outside = rng.uniform(size=(n, 1)) < 1 / 3
    cells = np.where(outside, rng.uniform(-2, 2, (n, 3)) + np.where(rng.uniform(size=(n, 3)) < 0.5, 0, res), cells)
    pos = (cells * np.asarray(dx) + np.asarray(lower)).astype(f32)
    return pos, rng.standard_normal(n).astype(f32), res, lower, tuple(1 / h for h in dx)


def test_model_drops_nan_and_inf_values():
    """(d) Dropped particles valued NaN, +inf and -inf in the warps of finite
    ones add nothing. The JAX package's scatter adds `value · 0` for them,
    which is NaN (ROADMAP §3, P2G (c)), so it is given those values as 0."""
    pos, vals, res, lower, inv_dx = _sparse_particles(4, 3000)
    dropped = _cells(pos, res, lower, inv_dx, False) < 0
    assert 0 < dropped.sum() < pos.shape[0]
    poison = np.where(dropped, np.array([np.nan, np.inf, -np.inf], f32)[np.arange(pos.shape[0]) % 3], vals)
    sums, counts, _, _ = _scatter_model(pos, poison, res, lower, inv_dx, False)
    ref_s, ref_c = _xla(pos, np.where(dropped, f32(0), vals), res, lower, inv_dx, False)
    assert np.isfinite(sums).all()
    assert np.array_equal(counts, ref_c)
    assert float(np.abs(sums - ref_s).max()) <= 1e-6 * max(1.0, float(np.abs(ref_s).max()))
    assert not np.isfinite(_xla(pos, poison, res, lower, inv_dx, False)[0]).all()  # the JAX package's own rule


@pytest.mark.parametrize('clamp', [False, True], ids=['discard', 'clamp'])
def test_model_kept_nan_value_reaches_only_its_cell(clamp):
    """(d) A NaN value of a kept particle makes its own cell's sum NaN and no
    other, as in the JAX package."""
    pos, vals, res, lower, inv_dx = _sparse_particles(5, 3000)
    cells = _cells(pos, res, lower, inv_dx, clamp)
    vals = np.where((np.arange(pos.shape[0]) % 97 == 5) & (cells >= 0), f32(np.nan), vals)
    _assert_matches_xla(pos, vals, res, lower, inv_dx, clamp)
    sums = _scatter_model(pos, vals, res, lower, inv_dx, clamp)[0].reshape(-1)
    nan_cells = np.unique(cells[np.isnan(vals)])
    assert nan_cells.size and np.array_equal(np.flatnonzero(np.isnan(sums)), nan_cells)


@pytest.mark.parametrize('n', [1, 31, 45, 289, 4133])
@pytest.mark.parametrize('clamp', [False, True], ids=['discard', 'clamp'])
def test_model_ragged_particle_counts(n, clamp):
    """(e) Counts that are no multiple of a warp or a block: the tail lanes
    carry the sentinel and add nothing."""
    pos, vals, res, lower, inv_dx = _sparse_particles(6, n)
    _assert_matches_xla(pos, vals, res, lower, inv_dx, clamp)


@pytest.mark.parametrize('clamp', [False, True], ids=['discard', 'clamp'])
def test_model_nan_position_goes_to_cell_zero(clamp):
    """A NaN position goes to cell 0: counted under clamp, dropped under
    discard, as in the port's twin."""
    pos, vals, res, lower, inv_dx = _sparse_particles(8, 700)
    pos[::50, 1] = np.nan
    sums, counts, _, _ = _scatter_model(pos, vals, res, lower, inv_dx, clamp)
    ref_s, ref_c = TG._p2g_plain(torch.from_numpy(pos), torch.from_numpy(vals), res, lower, inv_dx, clamp)
    assert np.array_equal(counts, ref_c.numpy())
    assert float(np.abs(sums - ref_s.numpy()).max()) <= 1e-6 * max(1.0, float(ref_s.abs().max()))
    n_nan = pos[::50].shape[0]
    assert (counts.reshape(-1)[0] >= n_nan) == clamp


@pytest.mark.parametrize('base', [0.0, float('nan')], ids=['base0', 'baseNaN'])
@pytest.mark.parametrize('clamp', [False, True], ids=['discard', 'clamp'])
def test_epilogue_formula_bit_equal_to_jax(clamp, base):
    """The mean kernel's formula on the JAX package's sums and counts equals
    its `p2g_mean_3d` bit for bit (base in the same empty cells), and so does
    the port's twin `_mean_or_base`."""
    pos, vals, res, lower, inv_dx = _sparse_particles(9, 1500)
    sums, counts = (np.array(a) for a in _xla(pos, vals, res, lower, inv_dx, clamp))
    ref = np.asarray(JG.p2g_mean_3d(jnp.asarray(pos), jnp.asarray(vals), res, lower, inv_dx, clamp, base))
    got = _epilogue_model(sums, counts, base)
    assert (counts == 0).any() and (counts > 1).any()
    assert np.array_equal(got, ref, equal_nan=True)
    twin = TG._mean_or_base(torch.from_numpy(sums), torch.from_numpy(counts), base).numpy()
    assert np.array_equal(twin, ref, equal_nan=True)

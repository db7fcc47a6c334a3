"""Cell-list neighbour search on raw torch tensors — port of
`phiflow_tpu/math/_neighbors.py` (`cell_list_neighbors`, `:25`), the scalable
backend of `pairwise_differences` and of SPH's compact graphs.

The same function, bit for bit in `indices` and `mask`: the domain is binned
into a static grid of cells (edge ≥ cutoff), the particles sorted by cell
(stable, as `jnp.argsort` is: the order decides which particles overflow a
full bucket), scattered into buckets of a fixed capacity, and each particle
gathers the 3^d surrounding buckets as a fixed-width candidate list.

Nothing here reads a device value back to the host: the capacity is a host
number computed from N, counts come from `index_add_` (not `bincount`, which
reads the maximum back), overflowing slots go to one spare slot past the end
that is sliced off (JAX's `mode='drop'`), and every host constant enters as a
Python number, one axis at a time, so no host array is copied to the device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ['cell_list_neighbors']


def cell_list_neighbors(positions: torch.Tensor, cutoff: float, lower: Sequence[float], upper: Sequence[float],
                        periodic: bool = False, capacity: Optional[int] = None, capacity_factor: float = 2.0):
    """Fixed-width neighbour candidates for each particle.

    positions: (N, d) float tensor; cutoff: interaction radius (a host
    number); lower / upper: the domain's bounds; capacity: the most particles
    a cell holds (default: capacity_factor × a Poisson-tail bound of the mean
    occupancy, at least 4). Particles past a full bucket are dropped from it.

    Returns (indices, deltas, mask) on the positions' device:
      indices: (N, M) int32 — candidate particle ids, −1 in empty slots (M = 3^d · capacity)
      deltas:  (N, M, d)   — positions[j] − positions[i] (min-image if periodic)
      mask:    (N, M) bool — a candidate AND distance < cutoff AND j ≠ i
    """
    N, d = positions.shape
    dev = positions.device
    lower = np.asarray(lower, np.float32).reshape(d)
    upper = np.asarray(upper, np.float32).reshape(d)
    size = upper - lower
    nc = np.maximum(1, np.floor(size / cutoff).astype(int))  # static cells per axis
    # float32, as the JAX package divides float32 positions by it: a float64 cell size would move
    # particles that lie on cell faces (the initial lattice of a dam break) into the next cell
    cell_size = (size / nc).astype(np.float32)
    n_cells = int(np.prod(nc))
    if capacity is None:
        mean_occ = N / n_cells
        capacity = max(4, int(np.ceil(capacity_factor * 0.5 * (mean_occ + 5 * np.sqrt(mean_occ) + 8))))
    strides = [int(s) for s in np.concatenate([np.cumprod(nc[::-1])[::-1][1:], [1]])]
    nc = [int(n) for n in nc]

    # --- bin particles ---
    coords = []
    for a in range(d):
        rel = (positions[:, a] - float(lower[a])) / float(cell_size[a])
        coords.append(torch.clamp(torch.floor(rel).to(torch.int32), 0, nc[a] - 1))
    cell_id = sum(c * s for c, s in zip(coords, strides)).to(torch.int64)

    # --- fixed-capacity buckets via a stable sort + rank-in-cell scatter ---
    order = torch.argsort(cell_id, stable=True)
    sorted_cells = cell_id[order]
    counts = torch.zeros(n_cells, dtype=torch.int64, device=dev).index_add_(
        0, cell_id, torch.ones(N, dtype=torch.int64, device=dev))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N, device=dev) - starts[sorted_cells]
    spare = n_cells * capacity  # overflowing particles land here and are sliced off
    slot = torch.where(rank < capacity, sorted_cells * capacity + rank, spare)
    buckets = torch.full((spare + 1,), -1, dtype=torch.int32, device=dev)
    buckets.scatter_(0, slot, order.to(torch.int32))
    buckets = buckets[:spare].reshape(n_cells, capacity)

    # --- candidate gather: the 3^d surrounding cells, in one gather ---
    # offset k of axis a is (k // 3^(d-1-a)) % 3 − 1: itertools.product's order, made on the device
    k = torch.arange(3 ** d, device=dev)
    nb_id, in_range = 0, None
    for a in range(d):
        nb = coords[a][:, None] + ((k // 3 ** (d - 1 - a)) % 3 - 1)[None, :]  # (N, 3^d)
        if periodic:
            nb = torch.remainder(nb, nc[a])
        else:
            inside = (nb >= 0) & (nb < nc[a])
            in_range = inside if in_range is None else in_range & inside
            nb = torch.clamp(nb, 0, nc[a] - 1)
        nb_id = nb_id + nb * strides[a]
    cand = buckets[nb_id]  # (N, 3^d, capacity)
    if in_range is not None:
        cand = torch.where(in_range[..., None], cand, -1)
    indices = cand.reshape(N, -1)  # (N, 3^d · capacity)

    # --- deltas + mask ---
    safe_idx = torch.clamp(indices, min=0).to(torch.int64)
    deltas = positions[safe_idx] - positions[:, None, :]
    if periodic:
        comps = []
        for a in range(d):
            s = float(size[a])
            comps.append(torch.remainder(deltas[..., a] + s / 2, s) - s / 2)
        deltas = torch.stack(comps, dim=-1)
    dist2 = deltas[..., 0] ** 2
    for a in range(1, d):
        dist2 = dist2 + deltas[..., a] ** 2
    own = indices == torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    mask = (indices >= 0) & ~own & (dist2 < float(np.float32(cutoff) ** 2))
    return indices, deltas, mask

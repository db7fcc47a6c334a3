"""The cells of a regular grid — port of the part of
`phiflow_tpu/geom/_grid.py::UniformGrid` that sampling a geometry needs: the
cell centres, the cells' bounding radius and `stagger`, the grid of the faces
along one axis.

Bounds and cell sizes are float32 on the host, computed in JAX's order, so the
centres (and with them which cells a surface through a centre includes) are
the same numbers in both packages.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device

__all__ = ['UniformGrid']


@functools.lru_cache(maxsize=256)
def _axis_centers(n: int, lower: float, upper: float, device: str) -> torch.Tensor:
    """The n cell centres dividing [lower, upper], on `device`. Cached: a
    simulation asks for the same few grids every step."""
    f32 = np.float32
    local = (np.arange(n).astype(f32) + f32(0.5)) / f32(n)
    return torch.from_numpy(local * (f32(upper) - f32(lower)) + f32(lower)).to(device)


class UniformGrid:
    """`resolution` cells dividing the box [lower, upper]. Its coordinate
    arrays live on `device`: the card unless the caller passes 'cpu'."""

    def __init__(self, resolution: Sequence[int], lower, upper, device=None):
        self.resolution = tuple(int(n) for n in resolution)
        self.lower = np.asarray(lower, np.float32).reshape(len(self.resolution))
        self.upper = np.asarray(upper, np.float32).reshape(len(self.resolution))
        self.device = resolve_device(device)

    @property
    def spatial_rank(self) -> int:
        return len(self.resolution)

    @property
    def dx(self) -> np.ndarray:
        return (self.upper - self.lower) / np.asarray(self.resolution, np.float32)

    @property
    def center(self) -> Tuple[torch.Tensor, ...]:
        """The cell centres as a location: per axis a coordinate array shaped
        to broadcast along that axis."""
        d = self.spatial_rank
        return tuple(_axis_centers(n, float(lo), float(up), str(self.device)).reshape([n if j == a else 1 for j in range(d)])
                     for a, (n, lo, up) in enumerate(zip(self.resolution, self.lower, self.upper)))

    def bounding_radius(self) -> float:
        """Half a cell's diagonal."""
        half = self.dx * np.float32(0.5)
        return float(np.sqrt(np.sum(half ** 2, dtype=np.float32)))

    def stagger(self, axis: int, lower: bool, upper: bool) -> 'UniformGrid':
        """The grid whose cells are centred on this grid's faces along `axis`;
        `lower` / `upper` say whether the outermost face on that side is
        included."""
        unit = np.zeros(self.spatial_rank, np.float32)
        unit[axis] = self.dx[axis]
        res = list(self.resolution)
        res[axis] += int(lower) + int(upper) - 1
        return UniformGrid(res, self.lower + unit * np.float32(-0.5 if lower else 0.5),
                           self.upper + unit * np.float32(0.5 if upper else -0.5), self.device)

    def __repr__(self):
        return f"UniformGrid({self.resolution}, {self.lower.tolist()}..{self.upper.tolist()})"

"""The cells of a regular grid — port of `phiflow_tpu/geom/_grid.py::UniformGrid`.

`UniformGrid` is the Field layer's grid, with JAX's signature: a spatial
`Shape` resolution and a `Box` of bounds, its cell size `dx` and cell centres
`center` as Tensors, and `stagger`, the grid of the faces along one axis.

`UniformGrid_native` is the array layer's: sizes, float32 corners and coordinate
arrays on a device — what sampling a geometry needs (the cell centres as one
coordinate array per axis, the cells' bounding radius, `stagger` by axis
index). `UniformGrid.native` gives the one for the other.

Bounds and cell sizes are host numbers computed in JAX's order, so the
centres (and with them which cells a surface through a centre includes) are
the same numbers in both packages.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..math import (
    EMPTY_SHAPE, Tensor, channel, default_float, get_default_device, meshgrid, spatial, to_float, wrap,
)
from ._box import Box, Cuboid
from ._geom import Geometry

__all__ = ['UniformGrid', 'UniformGrid_native', 'enclosing_grid']


@functools.lru_cache(maxsize=256)
def _axis_centers(n: int, lower: float, upper: float, device: str) -> torch.Tensor:
    """The n cell centres dividing [lower, upper], on `device`. Cached: a
    simulation asks for the same few grids every step."""
    f32 = np.float32
    local = (np.arange(n).astype(f32) + f32(0.5)) / f32(n)
    return torch.from_numpy(local * (f32(upper) - f32(lower)) + f32(lower)).to(device)


class UniformGrid_native:
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

    def stagger(self, axis: int, lower: bool, upper: bool) -> 'UniformGrid_native':
        """The grid whose cells are centred on this grid's faces along `axis`;
        `lower` / `upper` say whether the outermost face on that side is
        included."""
        unit = np.zeros(self.spatial_rank, np.float32)
        unit[axis] = self.dx[axis]
        res = list(self.resolution)
        res[axis] += int(lower) + int(upper) - 1
        return UniformGrid_native(res, self.lower + unit * np.float32(-0.5 if lower else 0.5),
                                  self.upper + unit * np.float32(0.5 if upper else -0.5), self.device)

    def __repr__(self):
        return f"UniformGrid_native({self.resolution}, {self.lower.tolist()}..{self.upper.tolist()})"


def _get_bounds(bounds, resolution) -> Box:
    names = resolution.names
    if bounds is None:
        return Box._of(np.zeros(len(names), default_float()),
                       np.asarray([float(s) for s in resolution.sizes], default_float()), names)
    if isinstance(bounds, (int, float)):
        return Box._of(np.zeros(len(names), default_float()), np.full(len(names), float(bounds), default_float()),
                       names)
    if isinstance(bounds, Box):
        return bounds
    if isinstance(bounds, Cuboid):
        return Box._of(bounds._center - bounds._half_size, bounds._center + bounds._half_size, bounds.names)
    raise ValueError(f"bounds must be a Box, a number or None, got {type(bounds)}")


class UniformGrid(Geometry):
    """All cells of a regular grid: a spatial `resolution` and `bounds` (a
    Box whose vector labels are the resolution's dim names)."""

    def __init__(self, resolution=None, bounds=None, **resolution_):
        resolution = (resolution or EMPTY_SHAPE).spatial & spatial(**resolution_)
        bounds = _get_bounds(bounds, resolution)
        if bounds.names:
            resolution = resolution.only(bounds.names, reorder=True)
        else:
            bounds = Box._of(bounds._lower, bounds._upper, resolution.names)
        self.resolution = resolution
        self._bounds = bounds
        self._derived = {}  # dx and face grids, computed once: a grid is immutable

    @property
    def bounds(self) -> Box:
        return self._bounds

    @property
    def names(self):
        return self.resolution.names

    @property
    def _center(self) -> np.ndarray:
        return self._bounds._center

    @property
    def spatial_rank(self) -> int:
        return self.resolution.rank

    @property
    def shape(self):
        return self.resolution & channel(vector=self.resolution.names)

    def _sizes(self):
        return wrap([float(s) for s in self.resolution.sizes], channel(vector=self.resolution.names))

    @property
    def dx(self):
        """The cell size, a host Tensor with a `vector` dim."""
        if 'dx' not in self._derived:
            self._derived['dx'] = self._bounds.size / self._sizes()
        return self._derived['dx']

    @property
    def center(self):
        """The cell centres: a host Tensor of the resolution's dims and `vector`."""
        local = meshgrid(**{d.name: d.size for d in self.resolution.dims})
        local = (to_float(local) + 0.5) / self._sizes()
        return local * self._bounds.size + self._bounds.lower

    size = dx

    @property
    def grid_size(self):
        return self._bounds.size

    @property
    def half_size(self):
        return self.dx * 0.5

    @property
    def lower(self):
        """Each cell's lower corner."""
        return self.center - self.half_size

    @property
    def upper(self):
        return self.center + self.half_size

    @property
    def volume(self) -> Tensor:
        from ..math._ops import prod
        return prod(self.dx, 'vector')

    def position_of(self, voxel_index: Tensor) -> Tensor:
        return self._bounds.lower + (to_float(voxel_index) + 0.5) * self.dx

    def voxel_at(self, location: Tensor, clamp=True) -> Tensor:
        from ..math._ops import floor, maximum, minimum, to_int32
        index = to_int32(floor((location - self._bounds.lower) / self.dx))
        if clamp:
            upper = wrap([s - 1 for s in self.resolution.sizes], channel(vector=self.resolution.names))
            index = minimum(maximum(index, 0), upper)
        return index

    def padded(self, widths: dict) -> 'UniformGrid':
        """The grid grown by (lower, upper) cells along each dim of `widths`."""
        from ..math._ops import dim_mask
        resolution, bounds = self.resolution, self._bounds
        for dim, (lower, upper) in widths.items():
            masked_dx = self.dx * dim_mask(self.resolution, dim)
            resolution = resolution.with_dim_size(dim, resolution.get_size(dim) + lower + upper)
            bounds = Box(bounds.lower - masked_dx * lower, bounds.upper + masked_dx * upper)
        return UniformGrid(resolution, bounds)

    def with_scaled_resolution(self, scale) -> 'UniformGrid':
        return UniformGrid(self.resolution.with_sizes([int(s * scale) for s in self.resolution.sizes]), self._bounds)

    def lies_inside(self, location):
        return self._bounds.lies_inside(location)

    def approximate_signed_distance(self, location):
        return self._bounds.approximate_signed_distance(location)

    def bounding_radius(self) -> Tensor:
        from ..math._ops import vec_length
        return vec_length(self.half_size)

    def bounding_half_extent(self) -> Tensor:
        return self.half_size

    def bounding_box(self) -> Box:
        return self._bounds

    def at(self, center) -> Geometry:
        return UniformGrid(self.resolution, self._bounds.at(center))

    def shifted(self, delta) -> Geometry:
        return UniformGrid(self.resolution, self._bounds.shifted(delta))

    def rotated(self, angle) -> Geometry:
        raise NotImplementedError("a grid cannot be rotated; rotate its center_representation()")

    def scaled(self, factor) -> 'UniformGrid':
        return UniformGrid(self.resolution, self._bounds.scaled(factor))

    def stagger(self, dim: str, lower: bool, upper: bool) -> 'UniformGrid':
        """The grid of the faces along `dim`; `lower` / `upper`: whether the
        outermost face on that side is included."""
        key = ('stagger', dim, lower, upper)
        if key in self._derived:
            return self._derived[key]
        mask = np.array([1. if d == dim else 0. for d in self.resolution.names])
        unit = self.dx * wrap(mask, channel(vector=self.resolution.names))
        bounds = Box(self._bounds.lower + unit * (-0.5 if lower else 0.5),
                     self._bounds.upper + unit * (0.5 if upper else -0.5))
        sizes = [s + (int(lower) + int(upper) - 1 if d == dim else 0)
                 for d, s in zip(self.resolution.names, self.resolution.sizes)]
        self._derived[key] = UniformGrid(self.resolution.with_sizes(sizes), bounds)
        return self._derived[key]

    def __getitem__(self, item):
        """The cells of slices along grid dims (JAX's `UniformGrid.__getitem__`,
        `:210-245`): the bounds cut by whole cells, in JAX's float order."""
        from ..math._magic import slicing_dict
        item = slicing_dict(self, item)
        resolution, lower, upper = self.resolution, self._bounds._lower, self._bounds._upper
        dx = (upper - lower) / np.asarray(self.resolution.sizes, lower.dtype)
        for dim, sel in item.items():
            if dim not in resolution:
                continue
            if not isinstance(sel, slice) or sel.step not in (None, 1):
                raise ValueError(f"grid dims can only be sliced with slices of step 1, got {dim}: {sel}")
            size = self.resolution.get_size(dim)
            start = sel.start or 0
            stop = sel.stop if sel.stop is not None else size
            start, stop = start + size if start < 0 else start, stop + size if stop < 0 else stop
            mask = np.asarray([1. if n == dim else 0. for n in self.resolution.names], lower.dtype)
            lower = lower + lower.dtype.type(start) * mask * dx
            upper = upper + lower.dtype.type(stop - size) * mask * dx
            resolution = resolution.with_dim_size(dim, stop - start)
        return UniformGrid(resolution, Box._of(lower, upper, self._bounds.names))

    def native(self, device=None) -> UniformGrid_native:
        """The array layer's grid of the same cells, its coordinates on `device`
        (the default device when None)."""
        return UniformGrid_native(self.resolution.sizes, self._bounds._lower, self._bounds._upper,
                                  get_default_device() if device is None else device)

    def __eq__(self, other):
        return isinstance(other, UniformGrid) and self.resolution == other.resolution and self._bounds == other._bounds

    def __hash__(self):
        return hash(self.resolution)

    def __repr__(self):
        return f"{self.resolution}, bounds={self._bounds}"


def enclosing_grid(*geometries: Geometry, voxel_count: int, rel_margin=0., abs_margin=0.) -> UniformGrid:
    """The uniform grid of about `voxel_count` cubic cells over the bounding
    box of `geometries`, widened by `rel_margin` of its half size plus `abs_margin`."""
    from ..math._ops import max_, min_, stack, instance
    boxes = [g.bounding_box() for g in geometries]
    lower = min_(stack([b.lower for b in boxes], instance('_g'), expand_values=True), '_g')
    upper = max_(stack([b.upper for b in boxes], instance('_g'), expand_values=True), '_g')
    center, half = (lower + upper) / 2, (upper - lower) / 2
    half = half * (1 + rel_margin) + abs_margin
    bounds = Box(center - half, center + half)
    size = np.asarray(bounds.size.numpy('vector'), np.float64)
    cell_size = (float(np.prod(size)) / voxel_count) ** (1 / len(size))
    names = bounds.size.shape.get_labels('vector')
    return UniformGrid(spatial(**{n: max(1, int(round(float(s) / cell_size))) for n, s in zip(names, size)}), bounds)

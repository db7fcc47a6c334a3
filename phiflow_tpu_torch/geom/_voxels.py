"""Voxel geometries — port of `phiflow_tpu/geom/_voxels.py`: the cells of a
`UniformGrid` that a mask marks, as one geometry."""
from __future__ import annotations

from ..math import Tensor, Shape, channel, instance
from ..math import _ops as ops
from ..math._magic import slicing_dict
from ._geom import TensorGeometry
from ._box import Box
from ._grid import UniformGrid

__all__ = ['Voxels']


class Voxels(TensorGeometry):
    """Filled cells of a uniform grid, stored as an int index list (instance dim)."""

    def __init__(self, grid: UniformGrid, indices: Tensor):
        """indices: int tensor (instance 'voxels', channel vector=dims)."""
        self._grid = grid
        self._indices = indices

    @property
    def grid(self) -> UniformGrid:
        return self._grid

    @property
    def indices(self) -> Tensor:
        return self._indices

    @property
    def center(self) -> Tensor:
        return self._grid.position_of(self._indices)

    @property
    def shape(self) -> Shape:
        return self._indices.shape.instance & self._grid.shape.only('vector')

    @property
    def volume(self) -> Tensor:
        return self._grid.volume

    @property
    def voxel_count(self) -> int:
        return self._indices.shape.instance.volume

    def _lies_inside(self, location: Tensor) -> Tensor:
        idx = self._grid.voxel_at(location, clamp=False)
        match = ops.all_(idx == self._indices, 'vector')  # broadcast over voxels instance dim
        reduce = self._indices.shape.instance
        return ops.any_(match, reduce)

    def _signed_distance(self, location: Tensor) -> Tensor:
        centers = self.center
        diffs = location - centers
        dist = ops.vec_length(diffs)
        result = ops.min_(dist, self._indices.shape.instance) - ops.min_(self._grid.dx) * 0.5
        return result

    def bounding_radius(self) -> Tensor:
        return self._grid.bounds.bounding_radius()

    def bounding_half_extent(self) -> Tensor:
        lo = ops.min_(self.center, self._indices.shape.instance)
        up = ops.max_(self.center, self._indices.shape.instance)
        return (up - lo) * 0.5 + self._grid.half_size

    def bounding_box(self):
        lo = ops.min_(self.center, self._indices.shape.instance) - self._grid.half_size
        up = ops.max_(self.center, self._indices.shape.instance) + self._grid.half_size
        return Box(lo, up)

    def at(self, center: Tensor):
        delta = center - self.bounding_box().center
        return Voxels(UniformGrid(self._grid.resolution, self._grid.bounds.shifted(delta)), self._indices)

    @staticmethod
    def from_mask(mask_grid) -> 'Voxels':
        """Create from a boolean/float grid Field or tensor of filled cells."""
        from ..field import Field
        if isinstance(mask_grid, Field):
            grid = mask_grid.geometry
            values = mask_grid.values
        else:
            raise ValueError("Voxels.from_mask requires a grid Field")
        idx = ops.nonzero(values, list_dim=instance('voxels'))
        idx = ops.rename_dims(idx, 'vector', channel(vector=grid.resolution.names))
        return Voxels(grid, idx)

    def __getitem__(self, item):
        item = slicing_dict(self, item)
        return Voxels(self._grid, self._indices[{k: v for k, v in item.items() if k in self._indices.shape}])

    def __eq__(self, other):
        return isinstance(other, Voxels) and self._grid == other._grid and ops.equal(self._indices, other._indices)

    def __hash__(self):
        return hash('Voxels')

    def __repr__(self):
        return f"Voxels[{self.voxel_count} cells of {self._grid.resolution}]"

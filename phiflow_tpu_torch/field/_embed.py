"""FieldEmbedding — port of `phiflow_tpu/field/_embed.py`: an extrapolation
whose ghost cells are sampled from another Field, the boundary of a nested
domain (a fine grid inside a coarse one) and of its pressure.

`pad_values` samples the embedded Field at the ghost cells' centres, which
it locates from the padded values' `bounds` (as JAX does; without bounds it
replicates the edge, as JAX's fallback does). `ghost_cells` gives the array
layer the samples of a pad of one cell on both sides of an axis as one torch
plane a side (`field/_field_math.py::_native_sides`), where JAX's `pad` puts
them: it pads the lower side first and locates the upper ghost cells on the
widened values, a grid of n + 1 cells over the same bounds, so the upper
layer sits n / (n + 1) of a cell beyond the edge cell's centre, not one
cell."""
from __future__ import annotations

from ..math import Tensor, channel, wrap
from ..math import extrapolation as extrapolation_mod
from ..math.extrapolation import Extrapolation

__all__ = ['FieldEmbedding']


class FieldEmbedding(Extrapolation):

    def __init__(self, field):
        super().__init__(pad_rank=1)
        self.field = field

    def to_dict(self) -> dict:
        return {'type': 'field-embedding'}

    def valid_outer_faces(self, dim):
        return True, True

    def determines_boundary_values(self, key) -> bool:
        return False

    @property
    def is_flexible(self) -> bool:
        return True

    def spatial_gradient(self) -> Extrapolation:
        return extrapolation_mod.BOUNDARY

    def _sample_at(self, points: Tensor) -> Tensor:
        from ._resample import sample_field_at_points
        return sample_field_at_points(self.field, points)

    def _ghost_points(self, grid, dim: str, width: int, upper: bool) -> Tensor:
        """The centres of `width` ghost cells of `grid` beyond its lower or upper side of `dim`."""
        from ..math import concat
        names = grid.resolution.names
        n = grid.resolution.get_size(dim)
        edge = grid.center[{dim: slice(n - 1, n) if upper else slice(0, 1)}]
        unit = wrap([1. if d == dim else 0. for d in names], channel(vector=names)) * grid.dx.vector[dim]
        steps = range(1, width + 1) if upper else range(width, 0, -1)
        return concat([edge + unit * (k if upper else -k) for k in steps], edge.shape[dim])

    def pad_values(self, value: Tensor, width: int, dim: str, upper_edge: bool, bounds=None, already_padded=None,
                   **kwargs) -> Tensor:
        """The embedded Field at the ghost cells' centres."""
        from ..geom._grid import UniformGrid
        if bounds is None:  # the ghost cells cannot be located: replicate the edge, as the JAX package does
            return extrapolation_mod.BOUNDARY.pad_values(value, width, dim, upper_edge)
        grid = UniformGrid(value.shape.spatial, bounds)
        return self._sample_at(self._ghost_points(grid, dim, width, upper_edge))

    def ghost_cells(self, grid, dim: str, upper: bool):
        """The ghost cells of `grid` beyond one side of `dim` in a pad of one
        cell on both sides, as a torch array of the grid's dims in order, 1
        along `dim`: the upper ones located on the lower-padded grid, as
        JAX's `pad` locates them."""
        from ..geom._grid import UniformGrid
        names = grid.resolution.names
        if upper:
            grid = UniformGrid(grid.resolution.with_dim_size(dim, grid.resolution.get_size(dim) + 1), grid.bounds)
        return self._sample_at(self._ghost_points(grid, dim, 1, upper)).torch(names)

    def __getitem__(self, item):
        if isinstance(item, dict):
            return FieldEmbedding(self.field[{k: v for k, v in item.items() if k in self.field.shape}])
        return self

    def __eq__(self, other):
        return isinstance(other, FieldEmbedding) and other.field is self.field

    def __hash__(self):
        return hash('field-embedding')

    def __repr__(self):
        return f"FieldEmbedding({self.field})"

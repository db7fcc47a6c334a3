"""Sampled signed distances — port of `phiflow_tpu/geom/_sdf_grid.py`: `SDFGrid`
holds a signed distance on a grid over its bounds and reads it linearly;
`sample_sdf` builds one from any geometry."""
from __future__ import annotations

from ..math import Tensor, Shape, wrap, channel, spatial
from ..math import _ops as ops
from ..math import extrapolation as extrapolation_mod
from ..math._magic import slicing_dict
from ._geom import Geometry, TensorGeometry
from ._box import Box, BaseBox
from ._grid import UniformGrid

__all__ = ['SDFGrid', 'sample_sdf']


class SDFGrid(TensorGeometry):
    """Signed distance sampled on a uniform grid; queries interpolate linearly."""

    def __init__(self, sdf: Tensor, bounds: BaseBox, approximate_outside=True,
                 gradient: Tensor = None, center: Tensor = None, volume: Tensor = None):
        self._sdf = sdf
        self._bounds = bounds
        self._approximate_outside = approximate_outside
        self._gradient = gradient
        self._center = center if center is not None else bounds.center
        self._volume = volume

    @property
    def values(self) -> Tensor:
        return self._sdf

    @property
    def bounds(self) -> BaseBox:
        return self._bounds

    @property
    def resolution(self) -> Shape:
        return self._sdf.shape.spatial

    @property
    def dx(self) -> Tensor:
        return self._bounds.size / wrap([float(s) for s in self.resolution.sizes],
                                        channel(vector=self.resolution.names))

    @property
    def center(self) -> Tensor:
        return self._center

    @property
    def shape(self) -> Shape:
        return self._sdf.shape & self._bounds.shape

    @property
    def volume(self) -> Tensor:
        if self._volume is not None:
            return self._volume
        cell_vol = ops.prod(self.dx, 'vector')
        inside = ops.to_float(self._sdf <= 0)
        return ops.sum_(inside, self.resolution) * cell_vol

    def _interp(self, location: Tensor) -> Tensor:
        local = self._bounds.global_to_local(location)
        coords = local * wrap([float(s) for s in self.resolution.sizes],
                              channel(vector=self.resolution.names)) - 0.5
        return ops.grid_sample(self._sdf, coords, extrapolation_mod.BOUNDARY)

    def _lies_inside(self, location: Tensor) -> Tensor:
        return self._interp(location) <= 0

    def _signed_distance(self, location: Tensor) -> Tensor:
        dist = self._interp(location)
        if self._approximate_outside:
            out_dist = self._bounds.approximate_signed_distance(location)
            return ops.where(out_dist > 0, out_dist + ops.maximum(dist, 0.), dist)
        return dist

    def approximate_closest_surface(self, location: Tensor):
        from ._geom import sdf_normal as _sdf_normal
        dist = self.approximate_signed_distance(location)
        normal = _sdf_normal(self.approximate_signed_distance, location,
                             eps=float(ops.min_(self.dx)) * 0.5)
        delta = -dist * normal
        return dist, delta, normal, None, None

    def bounding_radius(self) -> Tensor:
        return self._bounds.bounding_radius()

    def bounding_half_extent(self) -> Tensor:
        return self._bounds.bounding_half_extent()

    def bounding_box(self):
        return self._bounds.bounding_box()

    def at(self, center: Tensor) -> 'SDFGrid':
        delta = center - self._center
        return SDFGrid(self._sdf, self._bounds.shifted(delta), self._approximate_outside,
                       self._gradient, center, self._volume)

    def rebuild_sdf(self) -> 'SDFGrid':
        """Reinitialize to a proper distance function by sweeping.
        Round-1: fast-marching approximation via repeated min-propagation."""
        sdf = self._sdf
        dx = float(ops.min_(self.dx))
        sign = ops.sign(sdf)
        d = abs(sdf)
        for _ in range(max(self.resolution.sizes)):
            neighbors = []
            for dim in self.resolution.names:
                lo, up = ops.shift(d, (-1, 1), dim, extrapolation_mod.BOUNDARY, stack_dim=None)
                neighbors.extend([lo + dx, up + dx])
            best = d
            for nb in neighbors:
                best = ops.minimum(best, nb)
            if bool(ops.close(best, d, rel_tolerance=0, abs_tolerance=1e-6)):
                break
            d = best
        return SDFGrid(sign * d, self._bounds, self._approximate_outside, None, self._center, self._volume)

    def __getitem__(self, item):
        item = slicing_dict(self, item)
        return SDFGrid(self._sdf[{k: v for k, v in item.items() if k in self._sdf.shape}],
                       self._bounds, self._approximate_outside, None, None, None)

    def __eq__(self, other):
        return isinstance(other, SDFGrid) and ops.equal(self._sdf, other._sdf)

    def __hash__(self):
        return hash('SDFGrid')

    def __repr__(self):
        return f"SDFGrid[{self.resolution}, {self._bounds}]"


def sample_sdf(geometry: Geometry, bounds: BaseBox = None, resolution: Shape = None,
               approximate_outside=False, rebuild=None, valid_dist=None, rel_margin=0.1,
               abs_margin=0., cache_surface=False, **resolution_) -> SDFGrid:
    """Sample any geometry's SDF onto a grid."""
    if bounds is None:
        bounds = geometry.bounding_box()
        half = bounds.half_size * (1 + 2 * rel_margin) + abs_margin
        bounds = Box(bounds.center - half, bounds.center + half)
    if isinstance(bounds, UniformGrid):
        resolution = bounds.resolution
        bounds = bounds.bounds
    resolution = (resolution or spatial()) & spatial(**{k: int(v) for k, v in resolution_.items()})
    grid = UniformGrid(resolution, bounds)
    sdf_values = geometry.approximate_signed_distance(grid.center)
    result = SDFGrid(sdf_values, bounds, approximate_outside, center=geometry.center)
    if rebuild == 'auto-flatten' or rebuild is True:
        result = result.rebuild_sdf()
    return result

"""Terrain — port of `phiflow_tpu/geom/_heightmap.py`: the region below (or
above) a height function sampled on a grid over the other axes, the height
read with a zero-gradient (BOUNDARY) linear lookup and the distance
corrected by the slope, 1 / √(1 + |∇h|²) (`:98-111`); a FLIP terrain
obstacle. Its queries take Tensors of points or per-axis locations."""
from __future__ import annotations

from ..math import Tensor, Shape, wrap, channel
from ..math import _ops as ops
from ..math import extrapolation as extrapolation_mod
from ..math._magic import slicing_dict
from ._geom import TensorGeometry
from ._box import BaseBox

__all__ = ['Heightmap']


class Heightmap(TensorGeometry):
    """Terrain: the region below (or above) a height function sampled on a grid.

    `height`: (spatial grid over the non-up dims) tensor of surface heights.
    `bounds`: full domain box including the up axis. `max_dist`: narrow band for
    accurate distance queries beyond which distances are approximate.
    """

    def __init__(self, height: Tensor, bounds: BaseBox, max_dist=None, fill_below=True, up_dim: str = None):
        self._height = height
        self._bounds = bounds
        self._fill_below = fill_below
        labels = bounds.shape.get_labels('vector')
        self.up_dim = up_dim or [n for n in labels if n not in height.shape.spatial][0]
        self._max_dist = max_dist

    @property
    def height(self) -> Tensor:
        return self._height

    @property
    def bounds(self) -> BaseBox:
        return self._bounds

    @property
    def shape(self) -> Shape:
        return self._bounds.shape

    @property
    def center(self) -> Tensor:
        return self._bounds.center

    @property
    def volume(self) -> Tensor:
        base_dims = self._height.shape.spatial
        lo = self._bounds.lower.vector[self.up_dim]
        up = self._bounds.upper.vector[self.up_dim]
        depth = ops.mean(self._height, base_dims) - lo if self._fill_below else up - ops.mean(self._height, base_dims)
        base_labels = [n for n in self._bounds.shape.get_labels('vector') if n != self.up_dim]
        base_area = ops.prod(ops.stack({n: self._bounds.size.vector[n] for n in base_labels}, channel('_b')), '_b')
        return base_area * depth

    def _surface_height_at(self, location: Tensor) -> Tensor:
        base_labels = [n for n in location.shape.get_labels('vector') if n != self.up_dim]
        base_lower = ops.stack({n: self._bounds.lower.vector[n] for n in base_labels}, channel(vector=base_labels))
        base_size = ops.stack({n: self._bounds.size.vector[n] for n in base_labels}, channel(vector=base_labels))
        base_loc = ops.stack({n: location.vector[n] for n in base_labels}, channel(vector=base_labels))
        res = self._height.shape.spatial
        local = (base_loc - base_lower) / base_size
        coords = local * wrap([float(s) for s in res.sizes], channel(vector=res.names)) - 0.5
        return ops.grid_sample(self._height, coords, extrapolation_mod.BOUNDARY)

    def _lies_inside(self, location: Tensor) -> Tensor:
        h = self._surface_height_at(location)
        z = location.vector[self.up_dim]
        return (z <= h) if self._fill_below else (z >= h)

    def _surface_gradient_at(self, location: Tensor):
        """∂h/∂(base dims) at the location's footprint — central differences of
        the height grid sampled like the height itself. Returns a dict
        base_dim → slope tensor."""
        base_dims = self._height.shape.spatial
        base_labels = list(base_dims.names)
        grads = {}
        for i, dim in enumerate(base_labels):
            dx = float(self._bounds.size.vector[dim]) / base_dims.get_size(dim)
            padded = extrapolation_mod.BOUNDARY.pad(self._height, {dim: (1, 1)})
            n = base_dims.get_size(dim)
            g = (padded[{dim: slice(2, n + 2)}] - padded[{dim: slice(0, n)}]) / (2 * dx)
            base_lower = ops.stack({m: self._bounds.lower.vector[m] for m in base_labels},
                                   channel(vector=base_labels))
            base_size = ops.stack({m: self._bounds.size.vector[m] for m in base_labels},
                                  channel(vector=base_labels))
            base_loc = ops.stack({m: location.vector[m] for m in base_labels},
                                 channel(vector=base_labels))
            local = (base_loc - base_lower) / base_size
            coords = local * wrap([float(s) for s in base_dims.sizes], channel(vector=base_labels)) - 0.5
            grads[dim] = ops.grid_sample(g, coords, extrapolation_mod.BOUNDARY)
        return grads

    def _signed_distance(self, location: Tensor) -> Tensor:
        """Slope-corrected distance to the surface: the vertical distance
        divided by √(1+|∇h|²), first-order accurate near the surface."""
        h = self._surface_height_at(location)
        z = location.vector[self.up_dim]
        vertical = (z - h) if self._fill_below else (h - z)
        grads = self._surface_gradient_at(location)
        slope_sq = None
        for g in grads.values():
            slope_sq = g ** 2 if slope_sq is None else slope_sq + g ** 2
        return vertical / ops.sqrt(1.0 + slope_sq)

    def approximate_closest_surface(self, location: Tensor):
        """(signed_distance, delta, normal, None, None) with the outward normal
        (−∇h, 1)/√(1+|∇h|²) of the terrain surface z = h(x)."""
        h = self._surface_height_at(location)
        z = location.vector[self.up_dim]
        vertical = (z - h) if self._fill_below else (h - z)
        grads = self._surface_gradient_at(location)
        slope_sq = None
        for g in grads.values():
            slope_sq = g ** 2 if slope_sq is None else slope_sq + g ** 2
        inv_norm = 1.0 / ops.sqrt(1.0 + slope_sq)
        sgn_dist = vertical * inv_norm
        labels = self._bounds.shape.get_labels('vector')
        sign = 1.0 if self._fill_below else -1.0
        comps = {}
        for dim in labels:
            if dim == self.up_dim:
                comps[dim] = sign * inv_norm
            else:
                comps[dim] = -sign * grads[dim] * inv_norm
        normal = ops.stack(comps, channel(vector=list(labels)))
        delta = -sgn_dist * normal
        return sgn_dist, delta, normal, None, None

    def bounding_radius(self) -> Tensor:
        return self._bounds.bounding_radius()

    def bounding_half_extent(self) -> Tensor:
        return self._bounds.bounding_half_extent()

    def bounding_box(self):
        return self._bounds.bounding_box()

    def at(self, center: Tensor) -> 'Heightmap':
        delta = center - self.center
        dz = delta.vector[self.up_dim]
        return Heightmap(self._height + dz, self._bounds.shifted(delta), self._max_dist,
                         self._fill_below, self.up_dim)

    def __getitem__(self, item):
        item = slicing_dict(self, item)
        return Heightmap(self._height[{k: v for k, v in item.items() if k in self._height.shape}],
                         self._bounds, self._max_dist, self._fill_below, self.up_dim)

    def __eq__(self, other):
        return isinstance(other, Heightmap) and ops.equal(self._height, other._height)

    def __hash__(self):
        return hash(('Heightmap', self.up_dim))

    def __repr__(self):
        return f"Heightmap[{self._height.shape}, up={self.up_dim}]"

"""Geometry mask initializers — port of `phiflow_tpu/field/_mask.py`: a
geometry sampled on a grid, 1 inside and 0 outside by cell centre
(`HardGeometryMask`, also `GeometryMask`) or the fraction of each cell inside
(`SoftGeometryMask`). A grid built from one samples the geometry as
`resample(geometry, grid, soft=...)` does (`_resample.py::_geometry_mask`),
at the faces a staggered grid stores too."""
from __future__ import annotations

from ..math import Tensor
from ..geom import Geometry
from ._field import FieldInitializer
from ._resample import _geometry_mask, _sample_at_faces

__all__ = ['HardGeometryMask', 'SoftGeometryMask', 'GeometryMask']


class HardGeometryMask(FieldInitializer):
    """1 inside the geometry, 0 outside, by cell centre."""

    soft, balance = False, 0.5

    def __init__(self, geometry: Geometry):
        self.geometry = geometry

    def _sample(self, geometry, at: str, boundaries, **kwargs) -> Tensor:
        def on(grid):
            return _geometry_mask(self.geometry, grid, self.soft, self.balance)
        return _sample_at_faces(on, geometry, boundaries) if at == 'face' else on(geometry)


class SoftGeometryMask(HardGeometryMask):
    """The fraction of each cell inside the geometry."""

    soft = True

    def __init__(self, geometry: Geometry, balance=0.5):
        super().__init__(geometry)
        self.balance = balance


GeometryMask = HardGeometryMask

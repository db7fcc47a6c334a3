"""The legacy Domain API — port of `phiflow_tpu/physics/_boundaries.py`,
which touches no array: `Domain` bundles a resolution, bounds and the
boundary of each kind of grid (`OPEN`, `CLOSED`, `PERIODIC_DOMAIN`, `STICKY`,
`SLIPPERY`) and builds the grids. Deprecated (a DeprecationWarning) in
favour of passing resolution and bounds to the grid constructors.
"""
from __future__ import annotations

import warnings
from typing import Union

from ..math import Shape, spatial, extrapolation
from ..math.extrapolation import Extrapolation
from ..geom import Box, UniformGrid
from ..field import CenteredGrid, StaggeredGrid

__all__ = ['Domain', 'OPEN', 'CLOSED', 'PERIODIC_DOMAIN', 'STICKY', 'SLIPPERY']

# boundary-condition presets: per grid role 
OPEN = {
    'scalar': extrapolation.ZERO_GRADIENT,
    'vector': extrapolation.ZERO_GRADIENT,
    'active': extrapolation.ZERO,
    'accessible': extrapolation.ONE,
}
CLOSED = STICKY = SLIPPERY = {
    'scalar': extrapolation.ZERO_GRADIENT,
    'vector': extrapolation.ZERO,
    'active': extrapolation.ZERO,
    'accessible': extrapolation.ZERO,
}
PERIODIC_DOMAIN = {
    'scalar': extrapolation.PERIODIC,
    'vector': extrapolation.PERIODIC,
    'active': extrapolation.PERIODIC,
    'accessible': extrapolation.PERIODIC,
}


def _as_boundary_dict(boundaries) -> dict:
    if isinstance(boundaries, dict) and 'scalar' in boundaries:
        return boundaries
    if isinstance(boundaries, Extrapolation):
        return {k: boundaries for k in ('scalar', 'vector', 'active', 'accessible')}
    raise ValueError(f"boundaries must be OPEN/CLOSED/PERIODIC_DOMAIN or an Extrapolation, got {boundaries}")


class Domain:
    """Grid resolution + physical bounds + boundary conditions, with grid factories."""

    def __init__(self, resolution: Union[Shape, tuple, list] = None, boundaries=OPEN,
                 bounds: Box = None, **resolution_):
        warnings.warn("Domain is deprecated; pass resolution/bounds directly to CenteredGrid/StaggeredGrid",
                      DeprecationWarning, stacklevel=2)
        res = spatial(**resolution_) if resolution is None else \
            (resolution if isinstance(resolution, Shape) else spatial(**dict(zip('xyz', resolution))))
        if resolution_ and resolution is not None:
            res = res & spatial(**resolution_)
        assert res.rank > 0, "Domain requires at least one spatial dimension"
        self.resolution: Shape = res
        self.boundaries: dict = _as_boundary_dict(boundaries)
        self.bounds: Box = bounds if bounds is not None else \
            Box(**{n: float(s) for n, s in zip(res.names, res.sizes)})

    @property
    def shape(self) -> Shape:
        return self.resolution

    @property
    def rank(self) -> int:
        return self.resolution.rank

    @property
    def dx(self):
        return self.bounds.size / self.resolution.sizes[0] if self.resolution.rank == 1 \
            else self.cells.dx

    @property
    def cells(self) -> UniformGrid:
        return UniformGrid(self.resolution, self.bounds)

    def center_points(self):
        return self.cells.center

    # --- grid factories ---

    def grid(self, value=0., extrapolation_=None):
        """Centered scalar grid with this domain's 'scalar' boundary."""
        ext = extrapolation_ if extrapolation_ is not None else self.boundaries['scalar']
        return CenteredGrid(value, ext, bounds=self.bounds, resolution=self.resolution)

    scalar_grid = grid

    def vector_grid(self, value=0., extrapolation_=None):
        """Centered vector grid with this domain's 'vector' boundary."""
        ext = extrapolation_ if extrapolation_ is not None else self.boundaries['vector']
        g = CenteredGrid(value, ext, bounds=self.bounds, resolution=self.resolution)
        if not g.shape.channel:
            from ..math import wrap, channel
            import numpy as np
            vec = wrap(np.zeros(self.rank, np.float32), channel(vector=self.resolution.names))
            g = g.with_values(g.values + vec)
        return g

    def vgrid(self, value=0., extrapolation_=None):
        return self.vector_grid(value, extrapolation_)

    def staggered_grid(self, value=0., extrapolation_=None):
        """Staggered vector grid with this domain's 'vector' boundary."""
        ext = extrapolation_ if extrapolation_ is not None else self.boundaries['vector']
        return StaggeredGrid(value, ext, bounds=self.bounds, resolution=self.resolution)

    sgrid = staggered_grid

    def accessible_mask(self, not_accessible=(), type=CenteredGrid):
        """1 where flow is possible, 0 inside obstacles."""
        from ..geom import union
        from ..field import resample
        if not not_accessible:
            mask_geo = None
        else:
            mask_geo = union(list(not_accessible))
        base = self.grid(1., self.boundaries['accessible'])
        if mask_geo is None:
            return base
        inside = resample(mask_geo, to=base, soft=False)
        return base.with_values(base.values * (1 - inside.values))

    def __repr__(self):
        return f"Domain({self.resolution}, bounds={self.bounds})"

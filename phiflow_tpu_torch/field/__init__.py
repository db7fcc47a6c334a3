"""Staggered-grid operators and particle ⇄ grid transfers on raw tensors (mirrors `phiflow_tpu/field`)."""
from ._field_math import divergence, spatial_gradient, finite_fill
from ._point_cloud import distribute_points
from ._resample import sample_grid_at_centers, sample_grid_at_points, scatter_to_grid

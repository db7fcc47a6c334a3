"""Staggered-grid operators, particle ⇄ grid transfers and geometry masks on raw tensors (mirrors `phiflow_tpu/field`)."""
from ._angular_velocity import angular_velocity, angular_velocity_at_faces
from ._field_math import divergence, spatial_gradient, finite_fill, stagger, safe_mul, laplace
from ._point_cloud import distribute_points
from ._resample import (sample_grid_at_centers, sample_grid_at_points, scatter_to_grid, cell_grid, staggered_cells,
                        geometry_mask)

"""Staggered-grid operators on raw component tensors (mirrors `phiflow_tpu/field`)."""
from ._field_math import divergence, spatial_gradient
from ._resample import sample_grid_at_centers

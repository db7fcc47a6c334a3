"""Staggered-grid operators on raw component tensors (mirrors `phiflow_tpu/field`)."""
from ._field_math import divergence, spatial_gradient

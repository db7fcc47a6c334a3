"""Geometry on raw tensors (mirrors `phiflow_tpu/geom`)."""
from ._box import box_push

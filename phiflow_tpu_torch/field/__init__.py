"""Fields on grids, and below them the array layer's staggered-grid operators,
particle ⇄ grid transfers and geometry masks on raw tensors (mirrors
`phiflow_tpu/field`).

Every name the JAX package's `phiflow_tpu.field` exports and this package
exports too takes the JAX package's signature; the array-level functions on
raw `torch.Tensor`s carry the suffix `_native` where a name is shared.
"""
from ._field import Field, FieldInitializer, as_boundary, is_staggered
from ._grid import CenteredGrid, StaggeredGrid, Grid, unstack_staggered_tensor, expand_staggered
from ._resample import resample, sample
from ._field_math import (
    laplace, spatial_gradient, divergence, stagger, fourier_laplace, fourier_poisson, where, maximum, minimum, clip,
    is_finite, safe_mul,
    finite_fill, mean, mask, native_call,
    divergence_native, spatial_gradient_native, finite_fill_native, stagger_native, safe_mul_native, laplace_native,
)
from ._noise import Noise
from ._angular_velocity import angular_velocity, angular_velocity_at_faces
from ._point_cloud import PointCloud, distribute_points, distribute_points_native
from ._resample import (sample_grid_at_centers, sample_grid_at_points, scatter_to_grid, cell_grid, staggered_cells,
                        geometry_mask)

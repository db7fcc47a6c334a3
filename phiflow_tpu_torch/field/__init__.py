"""Fields on grids, and below them the array layer's staggered-grid operators,
particle ⇄ grid transfers and geometry masks on raw tensors (mirrors
`phiflow_tpu/field`).

Every name the JAX package's `phiflow_tpu.field` exports and this package
exports too takes the JAX package's signature; the array-level functions on
raw `torch.Tensor`s carry the suffix `_native` where a name is shared.
"""
from ._field import Field, FieldInitializer, as_boundary, is_staggered
from ._grid import CenteredGrid, StaggeredGrid, Grid, unstack_staggered_tensor, expand_staggered
from ._resample import resample, sample, reduce_sample, grid_scatter
from ._field_math import (
    laplace, spatial_gradient, divergence, curl, stagger, fourier_laplace, fourier_poisson, where, maximum, minimum,
    clip, abs_ as abs, sign, round_ as round, ceil, floor, sqrt, exp, sin, cos, is_finite, real, imag, sigmoid, mean,
    normalize, center_of_mass, vec_length, vec_abs, vec_squared, finite_fill, discretize, integrate, pack_dims,
    support, mask, native_call, safe_mul, bake_extrapolation, assert_close, data_bounds, pad_field as pad,
    downsample2x, upsample2x, concat_fields as concat, stack_fields as stack, stop_gradient, l2_loss, l1_loss,
    frequency_loss,
    divergence_native, spatial_gradient_native, finite_fill_native, stagger_native, safe_mul_native, laplace_native,
    face_layout,
)
from ._field_math import is_finite as isfinite
from ._noise import Noise
from ._embed import FieldEmbedding
from ._field_io import write, read
from ._scene import Scene, SceneBatch
from ._mask import GeometryMask, HardGeometryMask, SoftGeometryMask
from ._angular_velocity import AngularVelocity, angular_velocity, angular_velocity_at_faces
from ._point_cloud import PointCloud, nonzero, distribute_points, distribute_points_native
from ._resample import (sample_grid_at_centers, sample_grid_at_points, scatter_to_grid, cell_grid, staggered_cells,
                        geometry_mask)
from ..math import (
    to_float, to_int32, to_int64, cast, unstack, shift, jit_compile, jit_compile_linear, gradient, functional_gradient,
    jacobian, solve_linear, solve_nonlinear, minimize,
)

SampledField = Field  # the name of PhiFlow 2


def convert(field, backend=None, use_dlpack=True):
    """`field` itself: the port has one backend, PyTorch."""
    return field

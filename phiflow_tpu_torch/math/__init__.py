"""Named-dim tensors, extrapolations and solves, and below them the array
layer's solver pieces and window interpolation (mirrors `phiflow_tpu/math`).

Every name the JAX package's `phiflow_tpu.math` exports and this package
exports too takes the JAX package's signature; the array-level functions on
raw `torch.Tensor`s carry the suffix `_native` where a name is shared.
"""
import numpy as _np

from ._shape import (
    Shape, Dim, EMPTY_SHAPE, batch, spatial, channel, instance, dual,
    shape_of as shape, merge_shapes, concat_shapes, parse_dim_order,
    non_batch, non_spatial, non_channel, non_instance, non_dual, primal,
    BATCH, SPATIAL, CHANNEL, INSTANCE, DUAL, DimFilter,
)
from ._magic import IncompatibleShapes, ConvergenceException, Diverged, NotConverged, BoundDim, slicing_dict
from ._tensor import (
    Tensor, TensorStack, wrap, tensor, NUMPY, precision, set_global_precision, get_precision, backend_dtype,
    default_float, set_default_device, get_default_device, default_device,
)
from ._ops import (
    zeros, ones, zeros_like, ones_like, seed, random_normal, random_uniform, linspace, arange, range_tensor, meshgrid,
    stack, unstack, concat, expand, rename_dims, pack_dims, unpack_dim, transpose, squeeze, flatten,
    abs_ as abs, sign, sqrt, exp, log, log2, log10, sin, cos, tan, arcsin, arccos, arctan, arctan2,
    sinh, cosh, tanh, floor, ceil, round_ as round, is_finite, is_nan, is_inf, real, imag, conjugate,
    sigmoid, erf, factorial, degrees_to_radians, radians_to_degrees,
    to_float, to_int32, to_int64, to_bool, cast, maximum, minimum, clip, where, safe_div, nan_to_0,
    sum_ as sum, mean, prod, max_ as max, min_ as min, std, any_ as any, all_ as all,
    finite_mean, finite_sum, finite_max, finite_min, at_max, argmax, argmin, cumulative_sum, dot,
    close, always_close, assert_close, equal,
    pad, shift, grid_sample, closest_grid_values, neighbor_mean, sample_subgrid, histogram, fft, ifft, fftfreq,
    vec, vec_length, vec_squared, vec_normalize, norm, length, squared_norm, normalize, cross, cross_product,
    dim_mask, gather, scatter, boolean_mask, nonzero, convolve, reshaped_native, reshaped_tensor,
    quantile, median, pairwise_differences, find_closest, assert_finite, stop_gradient, native_call,
    print_ as print, map_ as map,
)
from . import _extrapolation as extrapolation
from ._extrapolation import Extrapolation, as_extrapolation
from ._functional import (
    jit_compile, jit_compile_linear, LinearFunction, gradient, functional_gradient, jacobian, custom_gradient,
    iterate, map_s2b, map_d2c, map_c2d, broadcast, get_function_parameters, trace_check, when_available,
    perf_counter,
)
from ._solve import (Solve, SolveInfo, SolveTape, solve_linear, copy_solve, SolveResult, cg, cg_adaptive, bicgstab,
                     bicgstab2)
from ._layout import Layout, layout
from ._sparse import (SparseCooTensor, sparse_tensor, is_sparse, dense, to_format, stored_indices, stored_values,
                      matrix_from_function)
from ._optimize import minimize, solve_nonlinear
from ._multigrid import make_poisson_vcycle
from ._nd import (BOUNDARY, PERIODIC, PerSide, masked_fill, masked_fill_native, shift_window_interp, fourier_laplace,
                  fourier_poisson, spatial_gradient_t as spatial_gradient, laplace_t as laplace, downsample2x,
                  upsample2x)

PI = _np.pi
INF = _np.inf
NAN = _np.nan


def copy_with(obj, **updates):
    """`obj` with some attributes replaced: a Solve through `copy_solve`, a
    dataclass through `dataclasses.replace`, anything else as a shallow copy."""
    if isinstance(obj, Solve):
        return copy_solve(obj, **updates)
    if hasattr(obj, '__with_attrs__'):
        return obj.__with_attrs__(**updates)
    import dataclasses
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **updates)
    import copy as _copy
    new = _copy.copy(obj)
    for k, v in updates.items():
        setattr(new, k, v)
    return new


def const_vec(value, dims) -> Tensor:
    """A vector with the same `value` for each dim of `dims` (the spatial
    dims of a Shape, or dim names)."""
    if isinstance(dims, Shape):
        names = dims.spatial.names if dims.spatial else dims.names
    else:
        names = parse_dim_order(dims)
    return stack({n: wrap(value) for n in names}, channel('vector'))


def masked(value):
    """`value` itself: the JAX package's placeholder for masked tensors."""
    return value


def l2_loss(x, reduce=None) -> Tensor:
    """½·Σ x² over all non-batch dims (a TensorStack: the sum over its
    components; a Field: of its values)."""
    from . import _ops
    if hasattr(x, 'values') and hasattr(x, 'geometry'):
        x = x.values
    if isinstance(x, TensorStack):
        return _ops.sum_([l2_loss(c) for c in x.components])
    x = wrap(x)
    return _ops.sum_(x ** 2, reduce if reduce is not None else x.shape.non_batch) * 0.5


def l1_loss(x, reduce=None) -> Tensor:
    """Σ |x| over all non-batch dims (a TensorStack: the sum over its
    components; a Field: of its values)."""
    from . import _ops
    if hasattr(x, 'values') and hasattr(x, 'geometry'):
        x = x.values
    if isinstance(x, TensorStack):
        return _ops.sum_([l1_loss(c) for c in x.components])
    x = wrap(x)
    return _ops.sum_(_ops.abs_(x), reduce if reduce is not None else x.shape.non_batch)

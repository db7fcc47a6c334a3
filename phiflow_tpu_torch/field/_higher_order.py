"""Higher-order (4th / 6th) finite differences of centred grids — port of
`phiflow_tpu/field/_higher_order.py`.

Each 1-D derivative along an axis — with the boundary-aware one-sided rows
and the compact (implicit) scheme's left-hand side — is the dense operator
matrix of `_stencil1d.derivative_matrix`, built on the host, and applied to
the Field's values along that axis by `apply_axis_matrix` (one contraction;
the values' other dims, such as `vector` or `_gradient`, ride along). This
covers periodic, Dirichlet and zero-gradient boundaries.
"""
from __future__ import annotations

from ..math import Tensor
from ..math import _ops as ops
from ..math._tensor import to_torch
from ._field import Field
from ._stencil1d import derivative_matrix, apply_axis_matrix, classify_side

__all__ = ['higher_order_laplace', 'higher_order_gradient']


def _axis_bc(field: Field, dim: str):
    """(bc_lo, bc_hi) specs for `derivative_matrix`, or None if the boundary
    cannot be classified."""
    lo = classify_side(field.boundary, dim, False)
    hi = classify_side(field.boundary, dim, True)
    if lo is None or hi is None:
        return None
    if ('periodic' in (lo, hi)) and lo != hi:
        return None
    return lo, hi


def _apply_derivative(values: Tensor, field: Field, dim: str, deriv: int, order: int,
                      implicit_order: int, staggered_out=False,
                      out_lo_valid=True, out_hi_valid=True) -> Tensor:
    bc = _axis_bc(field, dim)
    if bc is None:
        raise NotImplementedError(f"order-{order} derivatives require periodic / constant / zero-gradient "
                                  f"boundaries along {dim}, got {field.boundary}")
    n = field.resolution.get_size(dim)
    h = float(field.dx.vector[dim])
    M, affine = derivative_matrix(n, deriv, order, h, bc[0], bc[1],
                                  staggered_out=staggered_out,
                                  out_lo_valid=out_lo_valid, out_hi_valid=out_hi_valid,
                                  implicit_order=implicit_order)
    axis = values.shape.names.index(dim)
    native = apply_axis_matrix(to_torch(values.native()), axis, M, affine)
    return Tensor(native, values.shape.with_dim_size(dim, native.shape[axis]))


def _implicitness(order: int, implicit) -> int:
    """Order 6 takes the compact (tridiagonal) scheme; its left-hand side is
    folded into the operator matrix, so an `implicit` Solve is taken and not
    needed."""
    return 2 if (order >= 6 or implicit is not None) else 0


def higher_order_gradient(field: Field, grad_ext, at: str, dims, stack_dim, order: int, implicit) -> Field:
    """Order-4/6 (compact) gradient with boundary-aware one-sided rows, at
    the cell centres (stacked along `stack_dim`) or at the faces."""
    dims = dims or field.resolution.names
    impl = _implicitness(order, implicit)
    if at == 'face':
        comps = []
        for dim in dims:
            lo_v, up_v = grad_ext.valid_outer_faces(dim)
            comps.append(_apply_derivative(field.values, field, dim, 1, order, impl,
                                           staggered_out=True, out_lo_valid=lo_v, out_hi_valid=up_v))
        from ..math import dual
        return Field(field.geometry, ops.stack(comps, dual(vector=list(dims))), grad_ext)
    comps = {dim: _apply_derivative(field.values, field, dim, 1, order, impl) for dim in dims}
    return Field(field.geometry, ops.stack(comps, stack_dim), grad_ext)


def higher_order_laplace(field: Field, order: int = 6, implicit=None) -> Field:
    """Order-4/6 (compact) Laplacian with boundary-aware one-sided rows."""
    impl = _implicitness(order, implicit)
    result = None
    for dim in field.resolution.names:
        term = _apply_derivative(field.values, field, dim, 2, order, impl)
        result = term if result is None else result + term
    return Field(field.geometry, result, field.boundary.spatial_gradient())

"""The public extrapolation module — port of `phiflow_tpu/math/extrapolation.py`."""
from ._extrapolation import *  # noqa: F401,F403
from ._extrapolation import (  # noqa: F401
    Extrapolation, ConstantExtrapolation, ZERO, ONE, PERIODIC, BOUNDARY, ZERO_GRADIENT,
    SYMMETRIC, REFLECT, ANTIREFLECT, ANTISYMMETRIC, SYMMETRIC_GRADIENT, NONE, Undefined,
    combine_sides, combine_by_direction, as_extrapolation, map, where, remove_constant_offset,
    get_normal, get_tangential, domain_slice, from_dict, to_native,
)

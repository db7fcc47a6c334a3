"""Geometry queries — port of `phiflow_tpu/geom/_geom_functions.py`: lengths,
normalisation, a sphere-marched `line_trace` through any geometry's signed
distance, and farthest-point sampling."""
from __future__ import annotations

from typing import Optional, Tuple


from ..math import Tensor, wrap
from ..math import _ops as ops
from ._geom import Geometry

__all__ = ['length', 'squared_length', 'normalize', 'line_trace']


def length(obj, epsilon=None) -> Tensor:
    """Vector length / cylinder length."""
    from ._cylinder import Cylinder
    if isinstance(obj, Cylinder):
        return obj.depth
    return ops.vec_length(obj, eps=epsilon)


def squared_length(obj) -> Tensor:
    from ._cylinder import Cylinder
    if isinstance(obj, Cylinder):
        return obj.depth ** 2
    return ops.vec_squared(obj)


def normalize(obj: Tensor, epsilon=1e-15, allow_infinite=False, allow_zero=True) -> Tensor:
    return ops.vec_normalize(obj, epsilon=epsilon)


def line_trace(geo: Geometry, origin: Tensor, direction: Tensor, side='both', tolerance=None,
               max_iter: int = 64, step_size=0.9, max_line_length=None) -> Tuple[Tensor, Tensor, Tensor, Tensor, Optional[Tensor]]:
    """Sphere-march a ray against any geometry via its SDF.

    Returns (hit: bool, distance, position, normal, hit_index=None).
    """
    direction = ops.vec_normalize(direction)
    if tolerance is None:
        tolerance = 1e-4 * float(ops.max_(geo.bounding_radius())) if geo.bounding_radius().available else 1e-4
    max_len = max_line_length if max_line_length is not None else 4 * float(ops.max_(geo.bounding_radius())) + 1e3

    def sdf_at(t):
        return geo.approximate_signed_distance(origin + t * direction)

    t = ops.zeros_like(sdf_at(wrap(0.)))
    hit = t < -1  # all False

    for _ in range(max_iter):
        d = sdf_at(t)
        if side == 'both':
            d = abs(d)
        hit = hit | (d < tolerance)
        advance = ops.where(hit, ops.zeros_like(d), d * step_size)
        t = ops.minimum(t + advance, max_len)
    position = origin + t * direction
    from ._geom import sdf_normal as _sdf_normal
    normal = _sdf_normal(geo.approximate_signed_distance, position)
    final_hit = abs(sdf_at(t)) < tolerance * 10
    return final_hit, t, position, normal, None


def farthest_points(points, count: int, batch_dims=None):
    """Greedy farthest-point sampling: indices of `count` spread-out points."""
    import numpy as np
    from ..math import instance, channel, wrap as _wrap
    inst = points.shape.instance
    pts = np.asarray(points.numpy(inst.names + ('vector',)))
    n = pts.shape[0]
    count = min(count, n)
    chosen = [0]
    dists = np.linalg.norm(pts - pts[0], axis=-1)
    for _ in range(count - 1):
        idx = int(np.argmax(dists))
        chosen.append(idx)
        dists = np.minimum(dists, np.linalg.norm(pts - pts[idx], axis=-1))
    return _wrap(np.asarray(chosen, np.int32), instance(**{inst.name: count}))

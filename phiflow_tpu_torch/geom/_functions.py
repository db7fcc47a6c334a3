"""Vector, plane and triangle functions — port of `phiflow_tpu/geom/_functions.py`,
on the port's Tensors."""
from __future__ import annotations

import numpy as np

from ..math import Tensor, wrap, channel, stack
from ..math import _ops as ops
from ..math._ops import cross, cross_product  # re-export

__all__ = ['cross', 'cross_product', 'clip_length', 'normal_from_slope', 'plane_sgn_dist',
           'closest_on_triangle', 'closest_points_on_lines', 'distance_line_point', 'orthogonal_vector',
           'closest_on_plane', 'closest_on_line', 'closest_normal_vector', 'solve2x2', 'farthest_points']


def clip_length(vec: Tensor, min_len=0., max_len=1., vec_dim='vector', eps=1e-5) -> Tensor:
    """Scale vectors so their length lies in [min_len, max_len]."""
    length = ops.vec_length(vec, vec_dim, eps=eps)
    clipped = ops.clip(length, min_len, max_len)
    return ops.safe_div(vec, length) * clipped


def orthogonal_vector(v: Tensor) -> Tensor:
    """Any vector orthogonal to the 2D vector v (90° rotation)."""
    labels = v.shape.get_labels('vector')
    assert len(labels) == 2
    return stack({labels[0]: -v.vector[labels[1]], labels[1]: v.vector[labels[0]]},
                 channel(vector=labels))


def normal_from_slope(slope: Tensor, space) -> Tensor:
    """Unit normal of a surface given by its slope components. `space` names the full vector dims; the
    up-axis is the one missing from `slope`."""
    from ..math import parse_dim_order
    space_names = parse_dim_order(space) if not isinstance(space, (tuple, list)) else tuple(space)
    slope_labels = slope.shape.get_labels('vector') or ()
    up = [n for n in space_names if n not in slope_labels]
    assert len(up) == 1, f"space {space_names} minus slope dims {slope_labels} must leave one up-axis"
    comps = {n: -slope.vector[n] for n in slope_labels}
    comps[up[0]] = wrap(1.)
    n = stack(comps, channel(vector=space_names), expand_values=True)
    return ops.vec_normalize(n)


def plane_sgn_dist(plane_offset: Tensor, plane_normal: Tensor, point: Tensor) -> Tensor:
    """Signed distance of point from the plane n·x = n·offset."""
    return ops.sum_((point - plane_offset) * plane_normal, 'vector')


def distance_line_point(line_offset: Tensor, line_direction: Tensor, point: Tensor, is_direction_normalized=False) -> Tensor:
    """Distance of a point from an infinite line."""
    to_p = point - line_offset
    d = line_direction if is_direction_normalized else ops.vec_normalize(line_direction)
    along = ops.sum_(to_p * d, 'vector')
    closest = line_offset + along * d
    return ops.vec_length(point - closest)


def closest_on_triangle(A: Tensor, B: Tensor, C: Tensor, query: Tensor, exact_edges=True) -> Tensor:
    """Closest point on triangle ABC to `query`.
    Standard region-partition algorithm (Ericson), fully vectorized."""
    ab = B - A
    ac = C - A
    ap = query - A

    def dot(u, v):
        return ops.sum_(u * v, 'vector')

    d1 = dot(ab, ap)
    d2 = dot(ac, ap)
    bp = query - B
    d3 = dot(ab, bp)
    d4 = dot(ac, bp)
    cp = query - C
    d5 = dot(ab, cp)
    d6 = dot(ac, cp)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    # interior barycentric
    denom = ops.maximum(va + vb + vc, 1e-30)
    v = vb / denom
    w = vc / denom
    interior = A + v * ab + w * ac
    # edge/vertex regions
    result = interior
    # edge AB
    t_ab = ops.clip(ops.safe_div(d1, d1 - d3), 0, 1)
    on_ab = A + t_ab * ab
    cond_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    result = ops.where(cond_ab, on_ab, result)
    # edge AC
    t_ac = ops.clip(ops.safe_div(d2, d2 - d6), 0, 1)
    on_ac = A + t_ac * ac
    cond_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    result = ops.where(cond_ac, on_ac, result)
    # edge BC
    t_bc = ops.clip(ops.safe_div(d4 - d3, (d4 - d3) + (d5 - d6)), 0, 1)
    on_bc = B + t_bc * (C - B)
    cond_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    result = ops.where(cond_bc, on_bc, result)
    # vertices
    result = ops.where((d1 <= 0) & (d2 <= 0), A, result)
    result = ops.where((d3 >= 0) & (d4 <= d3), B, result)
    result = ops.where((d6 >= 0) & (d5 <= d6), C, result)
    return result


def closest_points_on_lines(p1: Tensor, d1: Tensor, p2: Tensor, d2: Tensor, eps=1e-10, can_be_parallel=True):
    """Closest points between two infinite lines.
    Returns (point_on_line1, point_on_line2)."""
    def dot(u, v):
        return ops.sum_(u * v, 'vector')

    r = p1 - p2
    a = dot(d1, d1)
    b = dot(d1, d2)
    c = dot(d2, d2)
    e = dot(d1, r)
    f = dot(d2, r)
    denom = a * c - b * b
    t1 = ops.safe_div(b * f - c * e, ops.where(abs(denom) < eps, ops.ones_like(denom), denom))
    t2 = ops.safe_div(a * f - b * e, ops.where(abs(denom) < eps, ops.ones_like(denom), denom))
    if can_be_parallel:
        parallel = abs(denom) < eps
        t1 = ops.where(parallel, ops.zeros_like(t1), t1)
        t2 = ops.where(parallel, ops.safe_div(f, c), t2)
    return p1 + t1 * d1, p2 + t2 * d2


def closest_on_plane(plane_offset: Tensor, plane_normal: Tensor, point: Tensor) -> Tensor:
    """Orthogonal projection of `point` onto the plane n·x = offset."""
    d = plane_sgn_dist(plane_offset, plane_normal, point)
    n = ops.vec_normalize(plane_normal)
    return point - d * n


def closest_on_line(A: Tensor, B: Tensor, query: Tensor) -> Tensor:
    """Closest point on the SEGMENT A→B to `query`."""
    ab = B - A
    t = ops.safe_div(ops.sum_((query - A) * ab, 'vector'), ops.sum_(ab * ab, 'vector'))
    t = ops.clip(t, 0.0, 1.0)
    return A + t * ab


def closest_normal_vector(target: Tensor, normal: Tensor, is_normalized=False, eps=1e-10) -> Tensor:
    """Unit vector orthogonal to `normal` closest in direction to `target`."""
    n = normal if is_normalized else ops.vec_normalize(normal)
    tangential = target - ops.sum_(target * n, 'vector') * n
    return ops.vec_normalize(tangential, eps=eps)


def solve2x2(a, b, c, d, y1, y2):
    """Closed-form solve of [[a, b], [c, d]]·x = (y1, y2)."""
    det = a * d - b * c
    x1 = ops.safe_div(d * y1 - b * y2, det)
    x2 = ops.safe_div(a * y2 - c * y1, det)
    return x1, x2


def farthest_points(points: Tensor, count: int, list_dim_name: str = None):
    """Greedy farthest-point subsampling: the indices of `count` points, each
    the farthest from those chosen before it, starting at the first."""
    import torch
    inst = points.shape.instance
    list_dim = list_dim_name or inst.names[0]
    pts = torch.as_tensor(points.native((list_dim, 'vector')))
    chosen = [0]
    dist = torch.sum((pts - pts[0]) ** 2, -1)
    for _ in range(count - 1):
        nxt = int(torch.argmax(dist))
        chosen.append(nxt)
        dist = torch.minimum(dist, torch.sum((pts - pts[nxt]) ** 2, -1))
    from ..math import instance as instance_dim
    return wrap(np.asarray(chosen, np.int32), instance_dim(selection=len(chosen)))

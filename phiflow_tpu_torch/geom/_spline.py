"""B-spline bases — port of `phiflow_tpu/geom/_spline.py`: the clamped knot
vector (`b_spline_knots`, numpy), the Cox–de Boor bases of every control
point with the last non-empty knot interval closed so that u = 1 is covered
(`eval_nurbs_bases`) and a curve's points (`spline_eval`). The bases are
Tensor operations on the query parameters, on their device."""
from __future__ import annotations

import numpy as np

from ..math import Tensor, wrap, channel, stack
from ..math import _ops as ops

__all__ = ['b_spline_knots', 'eval_nurbs_bases', 'spline_eval']


def b_spline_knots(control_count: int, degree: int = 2, clamped=True) -> np.ndarray:
    """The open-uniform knot vector of `control_count` control points."""
    n_knots = control_count + degree + 1
    if clamped:
        interior = n_knots - 2 * (degree + 1)
        middle = np.linspace(0, 1, interior + 2)
        return np.concatenate([np.zeros(degree), middle, np.ones(degree)])
    return np.linspace(0, 1, n_knots)


def eval_nurbs_bases(u, knots: np.ndarray, degree: int = 2, control_count: int = None) -> Tensor:
    """The Cox–de Boor bases N_{i,p}(u) of all control points, along a
    channel dim 'basis'. A term whose knot span is empty is the number 0;
    where both terms of a basis are, the basis is zeros like its neighbour."""
    u_t = wrap(u) if not isinstance(u, Tensor) else u
    knots = np.asarray(knots, np.float32)
    n_basis = control_count if control_count is not None else len(knots) - degree - 1
    nonempty = [i for i in range(len(knots) - 1) if knots[i + 1] > knots[i]]
    last_nonempty = nonempty[-1] if nonempty else len(knots) - 2
    bases = []
    for i in range(len(knots) - 1):
        lo, hi = float(knots[i]), float(knots[i + 1])
        if i == last_nonempty:
            inside = (u_t >= lo) & (u_t <= hi)
        else:
            inside = (u_t >= lo) & (u_t < hi)
        bases.append(ops.to_float(inside))
    for p in range(1, degree + 1):
        new_bases = []
        for i in range(len(bases) - 1):
            denom1 = float(knots[i + p] - knots[i])
            denom2 = float(knots[i + p + 1] - knots[i + 1])
            term1 = ((u_t - float(knots[i])) / denom1) * bases[i] if denom1 > 0 else 0
            term2 = ((float(knots[i + p + 1]) - u_t) / denom2) * bases[i + 1] if denom2 > 0 else 0
            new_bases.append(term1 + term2 if not isinstance(term1, int) or not isinstance(term2, int)
                             else ops.zeros_like(bases[i]))
        bases = new_bases
    return stack({f"b{i}": b for i, b in enumerate(bases[:n_basis])}, channel('basis'))


def spline_eval(control_points: Tensor, u, degree: int = 2) -> Tensor:
    """A clamped B-spline curve at parameters u ∈ [0, 1]; `control_points`
    has an instance dim (the points) and a channel 'vector'."""
    n = control_points.shape.instance.volume
    knots = b_spline_knots(n, degree)
    bases = eval_nurbs_bases(u, knots, degree, n)
    comps = {}
    for lbl in control_points.shape.get_labels('vector'):
        coords = control_points.vector[lbl]
        total = None
        for i in range(n):
            term = bases[{'basis': i}] * coords[{control_points.shape.instance.name: i}]
            total = term if total is None else total + term
        comps[lbl] = total
    return stack(comps, channel(vector=control_points.shape.get_labels('vector')))

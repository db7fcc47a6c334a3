"""Thickened spline sheets — port of `phiflow_tpu/geom/_spline_solid.py`.

A `SplineSolid` is a spline sheet (control net `points` with two spatial
dims (u, v) and a channel 'vector') extruded symmetrically by a per-vertex
`thickness` along the sheet normal, its edges rounded by per-edge `fillet`
values (1: a full cylinder cap, 0: a sharp edge). Parameters (u, v) run in
index units [0, n − 1].

Its queries are Tensor operations on the query points, on their device: the
closest sheet parameter (`closest_param`) is a nearest-control-point seed
(`_argmin_2d`, the first index on ties, as `jnp.argmin`) refined by 12
damped Gauss-Newton steps, each of five sheet evaluations (`_eval_sheet`:
`grid_sample` for order-1 nets, the clamped B-spline bases otherwise). The
signed distance is that of the sphere rolled along the skeleton
(`approximate_closest_surface`, the JAX package's simplified corner
handling: the smaller fillet of the edges overrun), computed here from the
sphere's per-point centre and radius without building a `Sphere`. Surface
meshing is host-side numpy.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from ..math import Tensor, Shape, wrap, channel, spatial, dual, stack
from ..math import _ops as ops
from ._geom import TensorGeometry, Geometry
from ._sphere import Sphere
from ._mesh_builder import MeshBuilder

__all__ = ['SplineSolid', 'to_spline', 'apply_spline_bounds', 'transform_with_spline', 'closest_param',
           'spline_eval_surface']


def _uv_names(points: Tensor) -> Tuple[str, str]:
    names = points.shape.spatial.names
    assert len(names) == 2, f"SplineSolid points need exactly 2 spatial dims, got {names}"
    return names


def _np_net(points: Tensor) -> np.ndarray:
    u, v = _uv_names(points)
    return np.asarray(points.numpy((u, v, 'vector')))


class SplineSolid(TensorGeometry):
    """Spline sheet with thickness and rounded edges."""

    def __init__(self, points: Tensor, thickness: Union[Tensor, float],
                 fillet: Dict[str, Union[Tensor, float]] = None,
                 order: Dict[str, int] = None):
        assert 'vector' in points.shape, "points needs a channel 'vector' dim"
        u, v = _uv_names(points)
        self.points = points
        self.thickness = ops.expand(wrap(thickness), points.shape.spatial)
        order = dict(order) if order else {u: 1, v: 1}
        for dim, o in order.items():
            assert dim in (u, v) and o < points.shape.get_size(dim), \
                f"order {o} for {dim} needs more than {o} control points"
        self.order = order
        fillet = dict(fillet) if fillet else {}
        full = {}
        for dim, other in ((u, v), (v, u)):
            for side in '-+':
                f = wrap(fillet.get(dim + side, 0.))
                full[dim + side] = ops.expand(f, points.shape.only(other))
        self.fillet = full

    # --- shape / bulk properties ---

    @property
    def shape(self) -> Shape:
        return self.points.shape

    @property
    def resolution(self) -> Shape:
        return self.points.shape.spatial

    @property
    def center(self) -> Tensor:
        return ops.neighbor_mean(self.points, spatial)

    @property
    def radius(self) -> Tensor:
        return 0.5 * self.thickness

    @property
    def volume(self) -> Tensor:
        """Per-cell volume: the |du × dv| area element times the cell's mean thickness."""
        u, v = _uv_names(self.points)
        du = self.points[{u: slice(1, None)}] - self.points[{u: slice(0, -1)}]
        dv = self.points[{v: slice(1, None)}] - self.points[{v: slice(0, -1)}]
        du_c = ops.neighbor_mean(du, v)
        dv_c = ops.neighbor_mean(dv, u)
        area = ops.vec_length(ops.cross(du_c, dv_c))
        t_c = ops.neighbor_mean(self.thickness, spatial)
        return area * t_c

    @property
    def corner_shape(self) -> Shape:
        return dual(side='lo,up') + (self.resolution - 1)

    @property
    def corners(self) -> Tensor:
        """The lower and upper corner point of each sheet cell, stacked on a dual 'side' dim."""
        u, v = _uv_names(self.points)
        return stack({'lo': self.points[{u: slice(0, -1), v: slice(0, -1)}],
                      'up': self.points[{u: slice(1, None), v: slice(1, None)}]}, dual('side'))

    @property
    def corner_radii(self) -> Tensor:
        u, v = _uv_names(self.points)
        return stack({'lo': self.radius[{u: slice(0, -1), v: slice(0, -1)}],
                      'up': self.radius[{u: slice(1, None), v: slice(1, None)}]}, dual('side'))

    # --- tangents & normals ---

    @property
    def vertex_tangents(self) -> Tensor:
        """Per-control-point tangents dS/du, dS/dv (central differences, one-sided
        at the boundary), stacked on dual '~tangents'."""
        u, v = _uv_names(self.points)
        comps = {}
        for d in (u, v):
            p = self.points
            fwd = p[{d: slice(1, None)}] - p[{d: slice(0, -1)}]  # n-1 midpoint diffs
            # average back to vertices: one-sided at ends, central inside
            first = fwd[{d: slice(0, 1)}]
            last = fwd[{d: slice(-1, None)}]
            inner = ops.neighbor_mean(fwd, d) if fwd.shape.get_size(d) > 1 else None
            parts = [first] + ([inner] if inner is not None else []) + [last]
            comps[d] = ops.concat(parts, d)
        return stack(comps, dual('tangents'))

    @property
    def vertex_normals(self) -> Tensor:
        """Unit sheet normal at every control point."""
        t = self.vertex_tangents
        u, v = _uv_names(self.points)
        return ops.vec_normalize(ops.cross(t[{'~tangents': u}], t[{'~tangents': v}]))

    @property
    def surface_points(self) -> Tensor:
        """Front/back offset surface points ± radius·normal, stacked on a dual 'side' dim."""
        fb = wrap([-1., 1.], dual(side='front,back'))
        return self.points + fb * self.radius * self.vertex_normals

    # --- parameter-space evaluation ---

    def center_at(self, uv: Tensor) -> Tensor:
        """Sheet skeleton point at (u, v) index coordinates."""
        return _eval_sheet(self.points, uv, self.order)

    def thickness_at(self, uv: Tensor) -> Tensor:
        """Interpolated thickness at (u, v) (`grid_sample`, zero-gradient beyond the net)."""
        if not spatial(self.thickness):
            return self.thickness
        return ops.grid_sample(self.thickness, uv, 'boundary')

    def fillet_at(self, key: str, uv: Tensor) -> Tensor:
        """Interpolated fillet of boundary `key` ('u-',…) at the edge coordinate."""
        f = self.fillet[key]
        if not spatial(f):
            return f
        other = f.shape.spatial.name
        coord = uv[{'vector': other}]
        coord = ops.rename_dims(ops.expand(coord, channel(vector=[other])), 'vector', channel(vector=[other]))
        return ops.grid_sample(f, coord, 'boundary')

    # --- queries ---

    def _lies_inside(self, location: Tensor) -> Tensor:
        return self._signed_distance(location) <= 0

    def _signed_distance(self, location: Tensor) -> Tensor:
        return self.approximate_closest_surface(location)[0]

    def approximate_closest_surface(self, location: Tensor):
        """SDF via a sphere rolled along the skeleton: the closest surface point
        lies on a sphere whose center is the closest skeleton point offset along
        the sheet normal (clamped so the sphere stays inside the slab) and whose
        radius shrinks with the local edge fillet (corner handling simplified
        to the min-fillet sphere — exact for equal u/v fillets). Returns
        (signed distance, delta to the surface, outward normal, None, face
        index) at a Tensor of points."""
        u, v = _uv_names(self.points)
        on_skel, uv, unbounded_uv, tangents = closest_param(self.order, self.points, location)
        delta = location - on_skel
        normal_c = ops.vec_normalize(ops.cross(tangents[{'~tangents': u}], tangents[{'~tangents': v}]))
        radius = 0.5 * self.thickness_at(uv)
        h = ops.sum_(normal_c * delta, 'vector')
        # effective fillet: 1 inside the valid uv range, boundary fillet when the
        # unbounded parameter overran that edge
        eps = 1e-6
        fillet_eff = None
        for d in (u, v):
            lo_over = unbounded_uv[{'vector': d}] < uv[{'vector': d}] - eps
            hi_over = unbounded_uv[{'vector': d}] > uv[{'vector': d}] + eps
            f_lo = ops.where(lo_over, self.fillet_at(d + '-', uv), 1.)
            f_hi = ops.where(hi_over, self.fillet_at(d + '+', uv), 1.)
            f_d = ops.minimum(f_lo, f_hi)
            fillet_eff = f_d if fillet_eff is None else ops.minimum(fillet_eff, f_d)
        fillet_eff = ops.clip(fillet_eff, 1e-5, 1.)
        sphere_rad = radius * fillet_eff
        h_lim = radius - sphere_rad
        sphere_center = on_skel + normal_c * ops.clip(h, -h_lim, h_lim)
        # the sphere's closest surface (Sphere.approximate_closest_surface) at its per-point centre and radius
        delta_c = location - sphere_center
        dist = ops.vec_length(delta_c, eps=1e-12)
        sgn_dist = dist - sphere_rad
        s_normal = delta_c / ops.maximum(dist, 1e-12)
        s_delta = -sgn_dist * s_normal
        offset = None
        face_index = None
        try:
            idx_u = ops.to_int32(ops.clip(unbounded_uv[{'vector': u}] + 1, 0, self.resolution.get_size(u)))
            idx_v = ops.to_int32(ops.clip(unbounded_uv[{'vector': v}] + 1, 0, self.resolution.get_size(v)))
            side = ops.to_int32(h <= 0)
            face_index = stack({u: idx_u, v: idx_v, 'side': side}, channel('index'))
        except Exception:
            pass
        return sgn_dist, s_delta, s_normal, offset, face_index

    # --- bounding ---

    def bounding_radius(self) -> Tensor:
        c = ops.mean(self.points, spatial)
        d = ops.vec_length(self.points - c) + self.radius
        return ops.max_(d, spatial)

    def bounding_half_extent(self) -> Tensor:
        lo = ops.min_(self.points, spatial)
        hi = ops.max_(self.points, spatial)
        return 0.5 * (hi - lo) + ops.max_(self.radius, spatial)

    # --- face interface (areas only) ---

    @property
    def face_shape(self) -> Shape:
        return dual(side='front,back') + (self.resolution + 1)

    @property
    def face_areas(self) -> Tensor:
        """Approximate area per face patch: inner spline cells as two triangles,
        edge strips as (1−f)+f·π/2 flattened cylinder slices, corners as blended
        sphere/cylinder caps."""
        u, v = _uv_names(self.points)
        c = self.corners
        v1 = c[{'~side': 'lo'}]
        v4 = c[{'~side': 'up'}]
        v2 = self.points[{u: slice(0, -1), v: slice(1, None)}]
        v3 = self.points[{u: slice(1, None), v: slice(0, -1)}]
        tri1 = 0.5 * ops.vec_length(ops.cross(v2 - v1, v3 - v1))
        tri2 = 0.5 * ops.vec_length(ops.cross(v4 - v1, v3 - v1))
        inner = tri1 + tri2  # (nu-1, nv-1)
        rows = {0: [], 1: [inner], 2: []}
        pi_2 = np.pi / 2
        for key, fillet in self.fillet.items():
            edge, is_upper = key[:-1], key[-1] == '+'
            other = v if edge == u else u
            sel = {edge: slice(-1, None) if is_upper else slice(0, 1)}
            ep = self.points[sel]
            lengths = ops.vec_length(ep[{other: slice(1, None)}] - ep[{other: slice(0, -1)}])
            et = self.thickness[sel]
            mean_rad = 0.25 * (et[{other: slice(1, None)}] + et[{other: slice(0, -1)}])
            f_c = ops.neighbor_mean(fillet, other) if spatial(fillet) else fillet
            area = (1 - f_c) * mean_rad * lengths + f_c * mean_rad * pi_2 * lengths
            if edge == u:
                rows[2 if is_upper else 0].append(area)
            else:
                rows[1].insert(2 if is_upper else 0, area)
        for i, j, idx, f1, f2 in ((0, 0, {u: 0, v: 0}, u + '-', v + '-'),
                                  (0, 2, {u: 0, v: -1}, u + '-', v + '+'),
                                  (2, 0, {u: -1, v: 0}, u + '+', v + '-'),
                                  (2, 2, {u: -1, v: -1}, u + '+', v + '+')):
            rad = self.radius[idx]
            fa = self.fillet[f1][{v if f1[0] == u else u: idx[v if f1[0] == u else u]}]
            fb = self.fillet[f2][{v if f2[0] == u else u: idx[v if f2[0] == u else u]}]
            min_f = ops.minimum(fa, fb)
            max_f = ops.maximum(fa, fb)
            curved = (min_f * rad) ** 2 * pi_2 + (1 - min_f) * rad * (np.pi / 4) * min_f * rad
            large_flat = (max_f * rad) ** 2 * (np.pi / 4) + (1 - max_f) * max_f * rad ** 2
            small_flat = (min_f * rad) ** 2 * (np.pi / 4) + (1 - min_f) * min_f * rad ** 2
            corner = curved + large_flat - small_flat
            rows[i].insert(j, ops.expand(corner, spatial(**{u: 1, v: 1})))
        def expand_strip(a, i):
            # edge strips need the edge dim of size 1; inner already 2D
            want = {u: 1} if i != 1 else {}
            for d in (u, v):
                if d not in a.shape:
                    a = ops.expand(a, spatial(**{d: 1}))
            return a
        bands = []
        for i in (0, 1, 2):
            parts = [expand_strip(a, i) for a in rows[i]]
            bands.append(ops.concat(parts, v))
        result = ops.concat(bands, u)
        return ops.expand(result, dual(side='front,back'))

    @property
    def boundary_faces(self) -> Dict[str, Dict[str, slice]]:
        u, v = _uv_names(self.points)
        return {u + '-': {u: slice(0, 1)}, u + '+': {u: slice(-1, None)},
                v + '-': {v: slice(0, 1)}, v + '+': {v: slice(-1, None)}}

    # --- transforms / arithmetic ---

    def at(self, center: Tensor) -> 'SplineSolid':
        assert self.resolution in center.shape, "SplineSolid.at() needs new control points"
        return SplineSolid(center, self.thickness, self.fillet, self.order)

    def shifted(self, delta: Tensor) -> 'SplineSolid':
        return SplineSolid(self.points + delta, self.thickness, self.fillet, self.order)

    def rotated(self, angle) -> 'SplineSolid':
        from ._transform import rotate_vector
        return SplineSolid(rotate_vector(self.points, angle), self.thickness, self.fillet, self.order)

    def scaled(self, factor) -> 'SplineSolid':
        return SplineSolid(self.points * factor, self.thickness * factor, self.fillet, self.order)

    def __mul__(self, other):
        if isinstance(other, (int, float, Tensor)):
            return SplineSolid(self.points * other, self.thickness * other,
                               {k: f * other for k, f in self.fillet.items()}, self.order)
        return NotImplemented

    __rmul__ = __mul__

    def __add__(self, other):
        if isinstance(other, SplineSolid):
            return SplineSolid(self.points + other.points, self.thickness + other.thickness,
                               {k: f + other.fillet[k] for k, f in self.fillet.items()}, self.order)
        return NotImplemented

    def __eq__(self, other):
        return isinstance(other, SplineSolid) and self.order == other.order \
            and ops.always_close(self.points, other.points) and ops.always_close(self.thickness, other.thickness) \
            and all(ops.always_close(self.fillet[k], other.fillet[k]) for k in self.fillet)

    def __hash__(self):
        return hash(('SplineSolid', tuple(self.order.items())))

    def __repr__(self):
        return f"SplineSolid({self.resolution}, order={self.order})"

    # --- surface meshing (host-side) ---

    def surface_mesh(self, min_cyl_segments: int = 5, min_corner_segments: int = 2):
        """Closed triangle/quad surface mesh: two offset spline surfaces + rounded
        edge strips + corner caps, the arcs connected with simple fans (host numpy,
        `MeshBuilder`)."""
        u, v = _uv_names(self.points)
        pts = _np_net(self.points)                      # (nu, nv, 3)
        nrm = _np_net(self.vertex_normals) if True else None
        rad = np.asarray(self.radius.numpy((u, v)))
        nu, nv, _ = pts.shape
        mb = MeshBuilder(2)
        front = pts + rad[..., None] * nrm
        back = pts - rad[..., None] * nrm

        def add_grid_quads(surf, flip=False):
            for i in range(nu - 1):
                for j in range(nv - 1):
                    q = [tuple(surf[i, j]), tuple(surf[i + 1, j]), tuple(surf[i + 1, j + 1]), tuple(surf[i, j + 1])]
                    mb.add_polygon(*(q[::-1] if flip else q))
        add_grid_quads(front)
        add_grid_quads(back, flip=True)

        def fillet_np(key):
            f = self.fillet[key]
            other = v if key[0] == u else u
            if spatial(f):
                return np.asarray(f.numpy(other))
            return np.full(nv if key[0] == u else nu, float(f))

        n_seg = max(2, min_cyl_segments)
        # rounded edges: arc from front to back around the outward in-plane direction
        edges = [(u + '-', pts[0], nrm[0], pts[0] - pts[1]),
                 (u + '+', pts[-1], nrm[-1], pts[-1] - pts[-2]),
                 (v + '-', pts[:, 0], nrm[:, 0], pts[:, 0] - pts[:, 1]),
                 (v + '+', pts[:, -1], nrm[:, -1], pts[:, -1] - pts[:, -2])]
        arc_cache = {}
        for key, ep, en, eo in edges:
            f = np.clip(fillet_np(key), 1e-5, 1.)
            er = rad[0] if key == u + '-' else rad[-1] if key == u + '+' else rad[:, 0] if key == v + '-' else rad[:, -1]
            # outward in-plane unit direction (orthogonalized against the normal)
            o = eo - (eo * en).sum(-1, keepdims=True) * en
            o = o / (np.linalg.norm(o, axis=-1, keepdims=True) + 1e-12)
            thetas = np.linspace(0, np.pi, 2 * n_seg + 1)  # front (θ=0) → back (θ=π)
            arc = np.empty((len(thetas),) + ep.shape)
            for ti, th in enumerate(thetas):
                hn = np.cos(th)                       # +1 front → −1 back
                ho = np.sin(th)
                # flat slab part (1−f)·r along ±normal + fillet circle f·r
                cen = ep + np.clip(hn, -1, 1) * ((1 - f) * er)[..., None] * en
                arc[ti] = cen + (f * er)[..., None] * (hn * en + ho * o)
            arc_cache[key] = arc
            for ti in range(len(thetas) - 1):
                for s in range(arc.shape[1] - 1):
                    q = [tuple(arc[ti, s]), tuple(arc[ti, s + 1]), tuple(arc[ti + 1, s + 1]), tuple(arc[ti + 1, s])]
                    if key in (u + '-', v + '+'):
                        q = q[::-1]
                    mb.add_polygon(*q)
        # corner caps: fan between the u-edge arc end and v-edge arc end
        n_cseg = max(2, min_corner_segments)
        for uk, ui in ((u + '-', 0), (u + '+', -1)):
            for vk, vi in ((v + '-', 0), (v + '+', -1)):
                arc_u = arc_cache[uk][:, vi]          # (T, 3) u-edge arc at this corner
                arc_v = arc_cache[vk][:, ui]          # (T, 3)
                for ti in range(arc_u.shape[0] - 1):
                    phis = np.linspace(0, 1, n_cseg + 1)
                    ring0 = np.stack([(1 - p) * arc_u[ti] + p * arc_v[ti] for p in phis])
                    ring1 = np.stack([(1 - p) * arc_u[ti + 1] + p * arc_v[ti + 1] for p in phis])
                    # project blend rings back onto the corner sphere for roundness
                    c_pt = pts[ui, vi]
                    r_here = rad[ui, vi]
                    f_u = np.clip(fillet_np(uk)[vi], 1e-5, 1.)
                    f_v = np.clip(fillet_np(vk)[ui], 1e-5, 1.)
                    roundness = f_u * f_v
                    for ring in (ring0, ring1):
                        d = ring - c_pt
                        L = np.linalg.norm(d, axis=-1, keepdims=True)
                        tgt = np.where(L > 1e-9, c_pt + d / L * np.minimum(L, r_here), ring)
                        ring[:] = (1 - roundness) * ring + roundness * tgt
                    for s in range(n_cseg):
                        q = [tuple(ring0[s]), tuple(ring0[s + 1]), tuple(ring1[s + 1]), tuple(ring1[s])]
                        if (ui == 0) ^ (vi == 0):
                            q = q[::-1]
                        mb.add_polygon(*q)
        return mb.build()


# ---------------------------------------------------------------------------
# parameter-space helpers
# ---------------------------------------------------------------------------

def _eval_sheet(points: Tensor, uv: Tensor, order: Dict[str, int]) -> Tensor:
    """Evaluate the sheet at (u, v) index coordinates. Order-1 nets are exactly
    multilinear (grid_sample); higher orders use the clamped B-spline bases."""
    u, v = _uv_names(points)
    if all(order.get(d, 1) == 1 for d in (u, v)):
        return ops.grid_sample(points, uv, 'boundary')
    from ._spline import b_spline_knots, eval_nurbs_bases
    total = None
    weights = None
    for d in (u, v):
        n = points.shape.get_size(d)
        t = ops.clip(uv[{'vector': d}] / max(n - 1, 1), 0., 1.)
        knots = b_spline_knots(n, order.get(d, 1))
        bases = eval_nurbs_bases(t, knots, order.get(d, 1), n)  # channel 'basis'
        bn = ops.rename_dims(bases, 'basis', channel(**{f'_basis_{d}': n}))
        weights = bn if weights is None else weights * bn
    comps = {}
    for lbl in points.shape.get_labels('vector'):
        coeff = ops.rename_dims(points[{'vector': lbl}], [u, v],
                                channel(**{f'_basis_{u}': points.shape.get_size(u),
                                           f'_basis_{v}': points.shape.get_size(v)}))
        comps[lbl] = ops.sum_(weights * coeff, [f'_basis_{u}', f'_basis_{v}'])
    return stack(comps, channel(vector=points.shape.get_labels('vector')))


def spline_eval_surface(order: Dict[str, int], points: Tensor, uv: Tensor, outputs=('position',)):
    """Evaluate position / tangents / normal of a spline sheet at `uv`."""
    u, v = _uv_names(points)
    eps = 1e-3
    pos = _eval_sheet(points, uv, order)
    result = {}
    if 'position' in outputs:
        result['position'] = pos
    if 'tangents' in outputs or 'normal' in outputs:
        tangents = {}
        for d in (u, v):
            e = stack({u: wrap(eps if d == u else 0.), v: wrap(eps if d == v else 0.)}, channel('vector'))
            hi = _eval_sheet(points, uv + e, order)
            lo = _eval_sheet(points, uv - e, order)
            tangents[d] = (hi - lo) / (2 * eps)
        t = stack(tangents, dual('tangents'))
        if 'tangents' in outputs:
            result['tangents'] = t
        if 'normal' in outputs:
            result['normal'] = ops.vec_normalize(ops.cross(tangents[u], tangents[v]))
    return tuple(result[k] for k in outputs)


def closest_param(order: Dict[str, int], points: Tensor, location: Tensor,
                  iterations: int = 12, uv_gradient: bool = False):
    """Closest sheet parameter to `location`: coarse control-net argmin seed +
    Gauss-Newton refinement on |S(uv) − x|². Returns (on_skeleton, uv, unbounded_uv, tangents);
    `unbounded_uv` extrapolates past the clamped edge along the local tangent so
    callers can detect edge/corner overrun."""
    u, v = _uv_names(points)
    nu, nv = points.shape.get_size(u), points.shape.get_size(v)
    # --- seed: nearest control point ---
    d2 = ops.sum_((location - points) ** 2, 'vector')
    iu, iv = _argmin_2d(d2, u, v)
    uv = stack({u: ops.to_float(iu), v: ops.to_float(iv)}, channel('vector'))
    eps = 1e-3

    def jacobian(uv):
        """dS/d(u,v) via centered differences; the center is nudged inside the
        valid range so boundary clamping cannot halve the derivative (which
        would make Gauss-Newton overshoot x2 and ping-pong between edges)."""
        uv_c = stack({u: ops.clip(uv[{'vector': u}], eps, float(nu - 1) - eps),
                      v: ops.clip(uv[{'vector': v}], eps, float(nv - 1) - eps)}, channel('vector'))
        js = {}
        for d in (u, v):
            e = stack({u: wrap(eps if d == u else 0.), v: wrap(eps if d == v else 0.)}, channel('vector'))
            js[d] = (_eval_sheet(points, uv_c + e, order) - _eval_sheet(points, uv_c - e, order)) / (2 * eps)
        return js

    last_step = None
    for _ in range(iterations):
        s = _eval_sheet(points, uv, order)
        r = location - s
        js = jacobian(uv)
        a = ops.sum_(js[u] * js[u], 'vector')
        b_ = ops.sum_(js[u] * js[v], 'vector')
        c = ops.sum_(js[v] * js[v], 'vector')
        y1 = ops.sum_(js[u] * r, 'vector')
        y2 = ops.sum_(js[v] * r, 'vector')
        det = a * c - b_ * b_
        det = ops.where(abs(det) < 1e-12, 1e-12, det)
        du = (c * y1 - b_ * y2) / det
        dv = (a * y2 - b_ * y1) / det
        du = ops.clip(du, -1., 1.)  # damped for stability far from the sheet
        dv = ops.clip(dv, -1., 1.)
        last_step = stack({u: du, v: dv}, channel('vector'))
        uv_unclamped = uv + last_step
        uv = stack({u: ops.clip(uv_unclamped[{'vector': u}], 0., float(nu - 1)),
                    v: ops.clip(uv_unclamped[{'vector': v}], 0., float(nv - 1))}, channel('vector'))
    unbounded = uv + last_step if last_step is not None else uv
    on_skeleton = _eval_sheet(points, uv, order)
    tangents = stack(jacobian(uv), dual('tangents'))
    return on_skeleton, uv, unbounded, tangents


def _argmin_2d(d2: Tensor, u: str, v: str):
    """Integer (iu, iv) minimizing d2 over the (u, v) spatial dims."""
    nu, nv = d2.shape.get_size(u), d2.shape.get_size(v)
    rest = d2.shape.without([u, v])
    arr = d2.native(rest.names + (u, v)).reshape(tuple(rest.sizes) + (nu * nv,))
    # the first index of the smallest value, or of the first NaN, as jnp.argmin
    flat_idx = np.argmin(arr, axis=-1) if isinstance(arr, np.ndarray) else torch.argmin(arr, dim=-1)
    iu = Tensor(flat_idx // nv, rest)
    iv = Tensor(flat_idx % nv, rest)
    return iu, iv


# ---------------------------------------------------------------------------
# conversion / fitting
# ---------------------------------------------------------------------------

def to_spline(geo: Geometry, per_vertex_thickness: bool = True, rel_separation: float = 1e-5) -> SplineSolid:
    """Fit a SplineSolid to a primitive: Cylinder → 2-point sheet with round
    (fillet 1) caps, Box → flat sheet spanning the two largest axes with sharp
    edges, Sphere → degenerate sheet with all-round edges."""
    from ._box import BaseBox
    from ._cylinder import Cylinder
    assert geo.spatial_rank == 3, f"to_spline needs 3D geometry, got {geo}"
    labels = geo.shape.get_labels('vector')
    if isinstance(geo, Cylinder):
        c = np.asarray(geo.center.numpy('vector'))
        axis_np = np.asarray(ops.vec_normalize(geo.up).numpy('vector'))
        half = 0.5 * float(geo.depth)
        r = float(geo.radius)
        tip0, tip1 = c - half * axis_np, c + half * axis_np
        right = np.asarray(_orthogonal_np(axis_np))
        sep = float(geo.depth) * rel_separation
        pts = np.stack([[tip0 - sep * right, tip0 + sep * right],
                        [tip1 - sep * right, tip1 + sep * right]])  # (u=2, v=2, 3)
        points = Tensor(pts.astype(np.float32), spatial(u=2, v=2) & channel(vector=labels))
        return SplineSolid(points, thickness=2 * r,
                           fillet={'u-': 0., 'u+': 0., 'v-': 1., 'v+': 1.}, order={'u': 1, 'v': 1})
    if isinstance(geo, BaseBox):
        size = np.asarray(geo.size.numpy('vector'))
        center = np.asarray(geo.center.numpy('vector'))
        th_idx = int(np.argmin(size))
        u_idx, v_idx = (th_idx + 1) % 3, (th_idx + 2) % 3
        axes = np.eye(3)
        try:
            rot = np.asarray(geo.rotation_matrix.numpy(('vector', '~vector')))
            axes = rot
        except Exception:
            pass
        du = axes[:, u_idx] if axes.ndim == 2 else axes[u_idx]
        dv = axes[:, v_idx] if axes.ndim == 2 else axes[v_idx]
        su, sv = size[u_idx], size[v_idx]
        pts = np.stack([[center - .5 * su * du - .5 * sv * dv, center - .5 * su * du + .5 * sv * dv],
                        [center + .5 * su * du - .5 * sv * dv, center + .5 * su * du + .5 * sv * dv]])
        points = Tensor(pts.astype(np.float32), spatial(u=2, v=2) & channel(vector=labels))
        return SplineSolid(points, thickness=float(size[th_idx]),
                           fillet={'u-': 0., 'u+': 0., 'v-': 0., 'v+': 0.}, order={'u': 1, 'v': 1})
    if isinstance(geo, Sphere):
        c = np.asarray(geo.center.numpy('vector'))
        r = float(geo.radius)
        sep = rel_separation * 2 * r
        pts = np.stack([[c + [0, 0, 0], c + [0, sep, 0]],
                        [c + [sep, 0, 0], c + [sep, sep, 0]]])
        points = Tensor(pts.astype(np.float32), spatial(u=2, v=2) & channel(vector=labels))
        return SplineSolid(points, thickness=2 * r,
                           fillet={'u-': 1., 'u+': 1., 'v-': 1., 'v+': 1.}, order={'u': 1, 'v': 1})
    raise NotImplementedError(f"to_spline for {type(geo)}")


def _orthogonal_np(v: np.ndarray) -> np.ndarray:
    o = np.cross(v, [1., 0., 0.])
    if np.linalg.norm(o) < 1e-6:
        o = np.cross(v, [0., 1., 0.])
    return o / np.linalg.norm(o)


def apply_spline_bounds(spline: SplineSolid, min_thickness: float = 1e-5) -> SplineSolid:
    """Rectify a 2×2 spline solid: orthogonalize the u edge against the v edge,
    clamp fillets to [0,1] and thickness to ≥ min_thickness."""
    u, v = _uv_names(spline.points)
    p0 = spline.points[{u: 0, v: 0}]
    dv = spline.points[{u: 0, v: 1}] - p0
    du_raw = spline.points[{u: 1, v: 0}] - p0
    # remove the dv component from du, keep du's length
    dv_n = ops.vec_normalize(dv)
    du = du_raw - ops.sum_(du_raw * dv_n, 'vector') * dv_n
    du = du * (ops.vec_length(du_raw) / ops.vec_length(du, eps=1e-12))
    rows = stack({'0': stack({'0': p0, '1': p0 + dv}, spatial(v=2)),
                  '1': stack({'0': p0 + du, '1': p0 + du + dv}, spatial(v=2))}, spatial(u=2))
    points = ops.rename_dims(rows, ['u', 'v'], spatial(**{u: 2, v: 2}))
    fillet = {k: ops.clip(f, 0., 1.) for k, f in spline.fillet.items()}
    return SplineSolid(points, ops.maximum(wrap(min_thickness), spline.thickness), fillet, spline.order)


def transform_with_spline(points: Tensor, source: SplineSolid, target: SplineSolid) -> Tensor:
    """Carry points along with a deforming spline solid: decompose each point
    into (normal, tangent, ortho) components of the closest `source` skeleton
    frame, then rebuild at the same (u, v) on `target`."""
    u, v = _uv_names(source.points)
    on_skel, uv, unbounded, tangents = closest_param(source.order, source.points, points)
    n_src = ops.vec_normalize(ops.cross(tangents[{'~tangents': u}], tangents[{'~tangents': v}]))
    t_src = ops.vec_normalize(tangents[{'~tangents': u}])
    o_src = ops.cross(n_src, t_src)
    delta = points - on_skel
    comp_n = ops.sum_(n_src * delta, 'vector')
    comp_t = ops.sum_(t_src * delta, 'vector')
    comp_o = ops.sum_(o_src * delta, 'vector')
    tgt_pos, tgt_tangents, tgt_normal = spline_eval_surface(target.order, target.points, uv,
                                                            ('position', 'tangents', 'normal'))
    t_tgt = ops.vec_normalize(tgt_tangents[{'~tangents': u}])
    o_tgt = ops.cross(tgt_normal, t_tgt)
    d_thick = 0.5 * (target.thickness_at(uv) - source.thickness_at(uv))
    comp_n = comp_n + d_thick * ops.sign(comp_n)
    return tgt_pos + comp_n * tgt_normal + comp_t * t_tgt + comp_o * o_tgt

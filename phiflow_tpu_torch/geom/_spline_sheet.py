"""Tensor-product B-spline sheets and volumes — port of
`phiflow_tpu/geom/_spline_sheet.py`: `BSplineSheet` (a surface from a
(nu, nv, d) control net: points, normals, area, a quad mesh),
`SplineVolume` (a solid from a (nu, nv, nw, d) net: points, volume, its six
boundary sheets), `to_spline_volume` (a box, sphere or cylinder as such a
net) and `double_cover`. The control nets are numpy arrays on the host; an
evaluation is a contraction of the parameters' bases with the net, Tensor
operations on the parameters' device. Areas, volumes and meshes are host
numpy, as in the JAX package."""
from __future__ import annotations

import numpy as np

from ..math import Tensor, wrap, spatial, channel, stack
from ..math import _ops as ops
from ._spline import b_spline_knots, eval_nurbs_bases

__all__ = ['BSplineSheet', 'SplineVolume', 'to_spline_volume', 'double_cover']


def _tensor_eval(control: np.ndarray, params, degrees):
    """A tensor-product B-spline at params = (u, v[, w]) ∈ [0, 1]^k;
    `control` is the (n1, …, nk, d) numpy net. Returns a Tensor (…, vector)."""
    k = control.ndim - 1
    weights = None
    for axis in range(k):
        n = control.shape[axis]
        knots = b_spline_knots(n, degrees[axis])
        bases = eval_nurbs_bases(params[axis], knots, degrees[axis], n)
        bn = ops.rename_dims(bases, 'basis', channel(**{f'basis{axis}': n}))
        weights = bn if weights is None else weights * bn
    labels = tuple('xyz'[:control.shape[-1]])
    comps = {}
    flat = control.reshape(-1, control.shape[-1])
    basis_dims = [f'basis{a}' for a in range(k)]
    for ci, lbl in enumerate(labels):
        coeff = wrap(np.ascontiguousarray(flat[:, ci]).reshape(control.shape[:-1]),
                     channel(**{bd: control.shape[a] for a, bd in enumerate(basis_dims)}))
        comps[lbl] = ops.sum_(weights * coeff, basis_dims)
    return stack(comps, channel(vector=labels))


class BSplineSheet:
    """Tensor-product B-spline surface from a (nu, nv, d) control net."""

    def __init__(self, control_points, degrees=(2, 2)):
        self.control = np.asarray(control_points, np.float32)
        assert self.control.ndim == 3, "control_points must be (nu, nv, d)"
        self.degrees = tuple(degrees)

    @property
    def spatial_rank(self) -> int:
        return self.control.shape[-1]

    def eval(self, u, v) -> Tensor:
        """The surface point S(u, v); u, v Tensors or numbers in [0, 1]."""
        return _tensor_eval(self.control, (wrap(u), wrap(v)), self.degrees)

    def normal(self, u, v, eps=1e-4) -> Tensor:
        """The unit normal at numbers (u, v), from central-difference partials (3D sheets)."""
        su1 = self.eval(wrap(float(u) + eps), v)
        su0 = self.eval(wrap(float(u) - eps), v)
        sv1 = self.eval(u, wrap(float(v) + eps))
        sv0 = self.eval(u, wrap(float(v) - eps))
        du = (su1 - su0).numpy('vector')
        dv = (sv1 - sv0).numpy('vector')
        n = np.cross(du, dv)
        n = n / (np.linalg.norm(n) + 1e-12)
        return wrap(n.astype(np.float32), channel(vector=tuple('xyz'[:3])))

    def sample_grid(self, nu: int, nv: int) -> Tensor:
        """The surface on a regular (nu, nv) parameter grid: a (u, v, vector) Tensor."""
        us = wrap(np.linspace(0, 1, nu, dtype=np.float32), spatial(u=nu))
        vs = wrap(np.linspace(0, 1, nv, dtype=np.float32), spatial(v=nv))
        return _tensor_eval(self.control, (us, vs), self.degrees)

    def area(self, samples: int = 32) -> float:
        """The area of a triangulation of a samples × samples parameter grid."""
        pts = np.asarray(self.sample_grid(samples, samples).numpy(('u', 'v', 'vector')))
        a = pts[1:, :-1] - pts[:-1, :-1]
        b = pts[:-1, 1:] - pts[:-1, :-1]
        c = pts[1:, 1:] - pts[:-1, :-1]
        t1 = 0.5 * np.linalg.norm(np.cross(a, b), axis=-1)
        t2 = 0.5 * np.linalg.norm(np.cross(c - a, c - b), axis=-1)
        return float(t1.sum() + t2.sum())

    def to_mesh(self, nu: int = 16, nv: int = 16):
        """A quad surface mesh (points (nu·nv, d), faces (…, 4) int32)."""
        pts = np.asarray(self.sample_grid(nu, nv).numpy(('u', 'v', 'vector'))).reshape(nu * nv, -1)
        faces = []
        for i in range(nu - 1):
            for j in range(nv - 1):
                faces.append((i * nv + j, (i + 1) * nv + j, (i + 1) * nv + j + 1, i * nv + j + 1))
        return pts, np.asarray(faces, np.int32)

    def __repr__(self):
        return f"BSplineSheet(control={self.control.shape[:-1]}, degrees={self.degrees})"


class SplineVolume:
    """Trivariate B-spline volume from a (nu, nv, nw, d) control net: a solid
    parameterised by a full 3D lattice instead of a sheet and a thickness
    (`SplineSolid`)."""

    def __init__(self, control_points, degrees=(2, 2, 2)):
        self.control = np.asarray(control_points, np.float32)
        assert self.control.ndim == 4, "control_points must be (nu, nv, nw, d)"
        self.degrees = tuple(degrees)

    def eval(self, u, v, w) -> Tensor:
        return _tensor_eval(self.control, (wrap(u), wrap(v), wrap(w)), self.degrees)

    def sample_grid(self, nu: int, nv: int, nw: int) -> Tensor:
        us = wrap(np.linspace(0, 1, nu, dtype=np.float32), spatial(u=nu))
        vs = wrap(np.linspace(0, 1, nv, dtype=np.float32), spatial(v=nv))
        ws = wrap(np.linspace(0, 1, nw, dtype=np.float32), spatial(w=nw))
        return _tensor_eval(self.control, (us, vs, ws), self.degrees)

    def volume(self, samples: int = 16) -> float:
        """The sum of the Jacobian determinants on a samples³ parameter grid."""
        n = samples
        pts = np.asarray(self.sample_grid(n, n, n).numpy(('u', 'v', 'w', 'vector')))
        du = np.diff(pts, axis=0)[:, :-1, :-1]
        dv = np.diff(pts, axis=1)[:-1, :, :-1]
        dw = np.diff(pts, axis=2)[:-1, :-1, :]
        det = np.einsum('...i,...i->...', du, np.cross(dv, dw))
        return float(np.abs(det).sum())

    def to_sheets(self):
        """The six boundary BSplineSheets of the solid."""
        c = self.control
        d = self.degrees
        return [
            BSplineSheet(c[0], (d[1], d[2])), BSplineSheet(c[-1], (d[1], d[2])),
            BSplineSheet(c[:, 0], (d[0], d[2])), BSplineSheet(c[:, -1], (d[0], d[2])),
            BSplineSheet(c[:, :, 0], (d[0], d[1])), BSplineSheet(c[:, :, -1], (d[0], d[1])),
        ]

    def __repr__(self):
        return f"SplineVolume(control={self.control.shape[:-1]}, degrees={self.degrees})"


def to_spline_volume(geo, control_resolution=(4, 4, 4)) -> 'SplineVolume':
    """A SplineVolume of a 3D primitive: a Box as the exact trilinear net, a
    Sphere and a Cylinder as nets on spherical / cylindrical shells
    (accurate to the control resolution)."""
    from ._box import BaseBox
    from ._sphere import Sphere
    from ._cylinder import Cylinder
    nu, nv, nw = control_resolution
    if isinstance(geo, BaseBox):
        lower = np.asarray(geo.lower.numpy()).reshape(-1)
        upper = np.asarray(geo.upper.numpy()).reshape(-1)
        assert len(lower) == 3, "to_spline requires 3D geometry"
        us = np.linspace(0, 1, nu)
        vs = np.linspace(0, 1, nv)
        ws = np.linspace(0, 1, nw)
        U, V, W = np.meshgrid(us, vs, ws, indexing='ij')
        pts = lower + np.stack([U, V, W], -1) * (upper - lower)
        return SplineVolume(pts.astype(np.float32), degrees=(1, 1, 1))
    if isinstance(geo, Sphere):
        center = np.asarray(geo.center.numpy()).reshape(-1)
        radius = float(geo.radius)
        assert len(center) == 3, "to_spline requires 3D geometry"
        r = np.linspace(0, 1, nu)[:, None, None]
        theta = np.linspace(1e-3, np.pi - 1e-3, nv)[None, :, None]
        phi = np.linspace(0, 2 * np.pi, nw)[None, None, :]
        x = r * radius * np.sin(theta) * np.cos(phi)
        y = r * radius * np.sin(theta) * np.sin(phi)
        z = r * radius * np.cos(theta) * np.ones_like(phi)
        pts = center + np.stack(np.broadcast_arrays(x, y, z), -1)
        return SplineVolume(pts.astype(np.float32), degrees=(1, 2, 2))
    if isinstance(geo, Cylinder):
        center = np.asarray(geo.center.numpy()).reshape(-1)
        radius = float(geo.radius)
        depth = float(geo.depth)
        r = np.linspace(0, 1, nu)[:, None, None]
        phi = np.linspace(0, 2 * np.pi, nv)[None, :, None]
        z = np.linspace(-depth / 2, depth / 2, nw)[None, None, :]
        x = r * radius * np.cos(phi) * np.ones_like(z)
        y = r * radius * np.sin(phi) * np.ones_like(z)
        zz = np.ones_like(x) * z
        pts = center + np.stack(np.broadcast_arrays(x, y, zz), -1)
        return SplineVolume(pts.astype(np.float32), degrees=(1, 2, 1))
    raise NotImplementedError(f"to_spline for {type(geo)}")


def double_cover(sheet: 'BSplineSheet') -> 'BSplineSheet':
    """The closed double cover of an open sheet: the net forward then
    backward along u, so that a sheet can be treated as a (degenerate)
    watertight surface."""
    c = sheet.control
    doubled = np.concatenate([c, c[::-1]], axis=0)
    return BSplineSheet(doubled, sheet.degrees)

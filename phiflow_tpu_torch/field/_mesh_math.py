"""Finite-volume operators on unstructured meshes — port of
`phiflow_tpu/field/_mesh_math.py`, the whole module: face values
(`centroid_to_faces`, linear and upwind), the Green-Gauss and least-squares
gradients, the divergence, the Laplacian (two-point flux, with and without
the non-orthogonal correction) and its diagonal, the conservative advection
term and the sampling of a mesh Field at points.

Every operator is a dense slot-table computation on the mesh's device, in
the JAX package's order of operations (`geom/_mesh.py`): gather the
neighbours' values, form a per-face expression, sum over the face slots.
The masks of the mesh's boundary groups are made once per Mesh
(`Mesh.boundary_mask`); the Dirichlet tables of a Field's boundary are
summed from them on every call, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

from ..math import Tensor, channel
from ..math import _ops as ops
from ..math._extrapolation import Extrapolation, ConstantExtrapolation, _MixedExtrapolation
from ..geom._mesh import Mesh
from ._field import Field

__all__ = ['centroid_to_faces', 'green_gauss_gradient', 'least_squares_gradient', 'mesh_divergence', 'mesh_laplace',
           'mesh_laplace_diagonal', 'mesh_advection_differential', 'sample_mesh_field']


def _group_extrapolation(boundary: Extrapolation, name: str) -> Extrapolation:
    """Extrapolation for a named boundary group from a (possibly mixed) boundary."""
    if isinstance(boundary, _MixedExtrapolation):
        if name in boundary.ext:
            return boundary.ext[name][0]
        if name.endswith('-') or name.endswith('+'):
            base, upper = name[:-1], name.endswith('+')
            if base in boundary.ext:
                return boundary.ext[base][int(upper)]
    return boundary


def _component(value: Tensor, ext: Extrapolation, component: Optional[str]):
    if component is None:
        return ext
    return ext[{'vector': component}]


def _face_value_tables(field: Field, component: Optional[str] = None):
    """Returns (v_center, v_neighbor, dirichlet_value, is_interior, is_dirichlet, valid).

    Per (cells, ~faces): neighbor values for interior faces, Dirichlet values for
    constant-BC boundary faces; zero-gradient boundary faces replicate the center.
    """
    mesh: Mesh = field.geometry
    values = field.values if component is None else field.values[{'vector': component}]
    v_n = mesh.gather_neighbor(values)
    interior = mesh.interior_mask
    valid = mesh.valid_face_mask
    dirichlet_mask = ops.zeros_like(interior)
    dirichlet_value = ops.zeros_like(v_n)
    for name, bid in mesh.boundaries.items():
        ext = _group_extrapolation(field.boundary, name)
        if component is not None:
            ext = _component(values, ext, component)
        bmask = mesh.boundary_mask(name)
        if isinstance(ext, ConstantExtrapolation):
            bval = ext.value
            if component is not None and 'vector' in bval.shape:
                bval = bval[{'vector': component}]
            dirichlet_mask = dirichlet_mask + bmask
            dirichlet_value = dirichlet_value + bmask * bval
        # zero-gradient / other: neighbor value := center value (handled below)
    return values, v_n, dirichlet_value, interior, dirichlet_mask, valid


def centroid_to_faces(field: Field, scheme: str = 'linear', velocity_flux: Tensor = None,
                      component: Optional[str] = None) -> Tensor:
    """Interpolate cell values to faces (reference: phi/field/_resample.py:367).

    scheme='linear': distance-weighted average (0.5 for uniform meshes).
    scheme='upwind': take the upstream cell by sign of `velocity_flux` (u·n per face).
    Boundary faces: Dirichlet value or center value (zero-gradient).
    """
    mesh: Mesh = field.geometry
    v_c, v_n, v_dir, interior, dirichlet, valid = _face_value_tables(field, component)
    if scheme == 'upwind' and velocity_flux is not None:
        upstream_is_center = ops.to_float(velocity_flux >= 0)
        face_interior = upstream_is_center * v_c + (1 - upstream_is_center) * v_n
    else:
        face_interior = 0.5 * (v_c + v_n)
    boundary_face = dirichlet * v_dir + (valid - interior - dirichlet) * v_c
    return interior * face_interior + boundary_face


def green_gauss_gradient(field: Field, stack_dim=channel('vector'), boundary=None, scheme='linear') -> Field:
    """∇v via Green-Gauss: (1/V) Σ_f v_f n_f A_f (reference: phi/field/_field_math.py:490)."""
    mesh: Mesh = field.geometry
    assert not field.shape.channel, "green_gauss_gradient expects a scalar field (map components)"
    v_face = centroid_to_faces(field, scheme='linear')
    contrib = v_face * mesh.face_normals * mesh.face_areas  # (cells, ~faces, vector)
    grad = ops.sum_(contrib, '~faces') / mesh.volume
    labels = mesh.shape.get_labels('vector')
    grad = ops.rename_dims(grad, 'vector', stack_dim.with_size(len(labels), labels)) \
        if stack_dim.dims[0].name != 'vector' else grad
    out_ext = boundary if boundary is not None else field.boundary.spatial_gradient()
    return Field(mesh, grad, out_ext)


def least_squares_gradient(field: Field, stack_dim=channel('vector'), boundary=None) -> Field:
    """∇v by weighted least squares over neighbor-center deltas — exact for
    linear fields at ALL cells, including boundary cells where Green-Gauss
    degrades (reference declares this scheme but leaves it NotImplemented:
    phi/field/_field_math.py:499).

    Per cell, minimize Σ_f w_f (Δv_f − g·d_f)² with d_f the center-to-neighbor
    delta (center-to-face for Dirichlet boundary faces), w_f = 1/|d_f|².
    The per-cell normal equations (d×d symmetric) are solved in closed form via
    the adjugate — dense elementwise math over the fixed-degree face table, no
    per-cell control flow."""
    mesh: Mesh = field.geometry
    assert not field.values.shape.channel, "least_squares_gradient expects a scalar field"
    v_c, v_n, v_dir, interior, dirichlet, valid = _face_value_tables(field)
    d = interior * (mesh.gather_neighbor(mesh.center) - mesh.center) \
        + dirichlet * (mesh.face_centers - mesh.center)
    dv = interior * (v_n - v_c) + dirichlet * (v_dir - v_c)
    w = (interior + dirichlet) / (ops.sum_(d ** 2, 'vector') + 1e-30)
    labels = mesh.shape.get_labels('vector')
    c = {l: d[{'vector': l}] for l in labels}
    r = {l: ops.sum_(w * c[l] * dv, '~faces') for l in labels}
    M = {}
    for i, l1 in enumerate(labels):
        for l2 in labels[i:]:
            M[l1 + l2] = ops.sum_(w * c[l1] * c[l2], '~faces')
    if len(labels) == 2:
        x, y = labels
        det = M[x + x] * M[y + y] - M[x + y] ** 2
        det = det + 1e-12 * (M[x + x] + M[y + y]) + 1e-30
        g = {x: (M[y + y] * r[x] - M[x + y] * r[y]) / det,
             y: (M[x + x] * r[y] - M[x + y] * r[x]) / det}
    elif len(labels) == 3:
        x, y, z = labels
        a, b, cc = M[x + x], M[x + y], M[x + z]
        dd, e, f = M[y + y], M[y + z], M[z + z]
        A11 = dd * f - e * e
        A12 = cc * e - b * f
        A13 = b * e - cc * dd
        A22 = a * f - cc * cc
        A23 = b * cc - a * e
        A33 = a * dd - b * b
        det = a * A11 + b * A12 + cc * A13
        det = det + 1e-12 * (a + dd + f) + 1e-30
        g = {x: (A11 * r[x] + A12 * r[y] + A13 * r[z]) / det,
             y: (A12 * r[x] + A22 * r[y] + A23 * r[z]) / det,
             z: (A13 * r[x] + A23 * r[y] + A33 * r[z]) / det}
    else:
        raise NotImplementedError(f"least_squares_gradient: {len(labels)}D")
    grad = ops.stack(g, stack_dim if stack_dim.dims[0].name != 'vector'
                     else channel(vector=','.join(labels)))
    out_ext = boundary if boundary is not None else field.boundary.spatial_gradient()
    return Field(mesh, grad, out_ext)


def mesh_divergence(field: Field, order=2, upwind=None) -> Field:
    """∇·v = (1/V) Σ_f (v_f · n_f) A_f (reference: FVM divergence via integrate_flux)."""
    mesh: Mesh = field.geometry
    labels = mesh.shape.get_labels('vector')
    flux = None
    for d in labels:
        v_face = centroid_to_faces(Field(mesh, field.values[{'vector': d}], field.boundary[{'vector': d}]),
                                   scheme='linear')
        n_d = mesh.face_normals[{'vector': d}]
        term = v_face * n_d
        flux = term if flux is None else flux + term
    div = ops.sum_(flux * mesh.face_areas, '~faces') / mesh.volume
    return Field(mesh, div, field.boundary.spatial_gradient())


def mesh_laplace(field: Field, gradient=None, order=2, upwind=None, correct_skew=False) -> Field:
    """Δv via two-point flux: (1/V) Σ_f (v_n − v_c)/d_f A_f
    (reference: phi/field/_field_math.py:93-117 with skew correction).

    correct_skew=True adds the over-relaxed non-orthogonal correction: the
    orthogonal part is scaled by 1/(n̂·ê) (ê = unit center-to-center direction)
    and the remaining tangential gradient (n̂ − ê/(n̂·ê)) · ∇v_f is evaluated
    from the face-averaged Green-Gauss gradient — exact on skewed meshes up to
    the gradient reconstruction order."""
    mesh: Mesh = field.geometry
    if field.shape.channel:
        comps = {}
        for d in field.shape.get_labels('vector') or field.shape.channel.labels[0]:
            comp = Field(mesh, field.values[{'vector': d}], field.boundary[{'vector': d}])
            comps[d] = mesh_laplace(comp, gradient, order, upwind, correct_skew).values
        return Field(mesh, ops.stack(comps, channel('vector')), field.boundary.spatial_gradient())
    v_c, v_n, v_dir, interior, dirichlet, valid = _face_value_tables(field)
    dist = mesh.neighbor_distances
    if correct_skew:
        labels = mesh.shape.get_labels('vector')
        grad_c = (gradient if gradient is not None else green_gauss_gradient(field)).values
        # unit center→neighbor direction ê and face-averaged gradient per face
        orth_scale = None   # n̂·ê
        tang = None         # Σ_d ∇v_f,d (n̂_d − ê_d/(n̂·ê)) assembled in two passes
        e_comp = {}
        gf_comp = {}
        for d in labels:
            c_d = mesh.center[{'vector': d}]
            e_d = (mesh.gather_neighbor(c_d) - c_d) / dist
            e_comp[d] = e_d
            g_d = grad_c[{'vector': d}]
            gf_comp[d] = 0.5 * (g_d + mesh.gather_neighbor(g_d))
            nd = mesh.face_normals[{'vector': d}]
            term = nd * e_d
            orth_scale = term if orth_scale is None else orth_scale + term
        alpha = orth_scale / ops.maximum(orth_scale * orth_scale, 1e-12)  # sign-preserving 1/(n̂·ê)
        for d in labels:
            nd = mesh.face_normals[{'vector': d}]
            t = gf_comp[d] * (nd - alpha * e_comp[d])
            tang = t if tang is None else tang + t
        interior_flux = interior * (alpha * (v_n - v_c) / dist + tang)
    else:
        # interior: (v_n − v_c)/dist (orthogonal two-point flux)
        interior_flux = interior * (v_n - v_c) / dist
    dirichlet_flux = dirichlet * (v_dir - v_c) / (dist * 0.5)
    total = ops.sum_((interior_flux + dirichlet_flux) * mesh.face_areas, '~faces')
    return Field(mesh, total / mesh.volume, field.boundary.spatial_gradient())


def mesh_laplace_diagonal(field: Field, correct_skew: bool = True) -> Tensor:
    """Diagonal of the `mesh_laplace` operator, per cell (analytic).

    ∂(Δv)_i/∂v_i = −(1/V_i) Σ_f A_f [ interior_f·α_f/d_f + 2·dirichlet_f/d_f ]
    with α = 1/(n̂·ê) the over-relaxed non-orthogonal scale when `correct_skew`
    (the tangential correction's dependence on v_i through the reconstructed
    gradient is dropped — preconditioner-grade accuracy). Zero-gradient faces
    contribute nothing. Used to build Jacobi/Chebyshev preconditioners for FVM
    pressure systems (reference uses scipy splu / phiml ILU at this spot,
    phi/physics/fluid.py:193-194 — sequential triangular solves do not map to
    TPU; diagonal-scaled Chebyshev does)."""
    mesh: Mesh = field.geometry
    _, _, _, interior, dirichlet, _ = _face_value_tables(field)
    dist = mesh.neighbor_distances
    if correct_skew:
        labels = mesh.shape.get_labels('vector')
        orth_scale = None
        for d in labels:
            c_d = mesh.center[{'vector': d}]
            e_d = (mesh.gather_neighbor(c_d) - c_d) / dist
            term = mesh.face_normals[{'vector': d}] * e_d
            orth_scale = term if orth_scale is None else orth_scale + term
        alpha = orth_scale / ops.maximum(orth_scale * orth_scale, 1e-12)
        interior_coeff = interior * alpha / dist
    else:
        interior_coeff = interior / dist
    dirichlet_coeff = dirichlet * 2. / dist
    diag = -ops.sum_((interior_coeff + dirichlet_coeff) * mesh.face_areas, '~faces') / mesh.volume
    return diag


def mesh_advection_differential(u: Field, velocity: Field, density: float = 1., order=1, upwind=True) -> Field:
    """Conservative advection term −∇·(v ⊗ u) with (linear-)upwind face values
    (reference: phi/physics/advect.py:78 FVM path; SURVEY.md §3.5)."""
    mesh: Mesh = u.geometry
    labels = mesh.shape.get_labels('vector')
    # face-normal velocity flux u·n per face
    flux_n = None
    for d in labels:
        vel_face = centroid_to_faces(Field(mesh, velocity.values[{'vector': d}], velocity.boundary[{'vector': d}]),
                                     scheme='linear')
        term = vel_face * mesh.face_normals[{'vector': d}]
        flux_n = term if flux_n is None else flux_n + term
    comps = {}
    target_labels = u.shape.get_labels('vector') or ()
    if target_labels:
        for d in target_labels:
            comp = Field(mesh, u.values[{'vector': d}], u.boundary[{'vector': d}])
            face_v = centroid_to_faces(comp, scheme='upwind' if upwind else 'linear', velocity_flux=flux_n)
            div = ops.sum_(face_v * flux_n * mesh.face_areas, '~faces') / mesh.volume
            comps[d] = -density * div
        values = ops.stack(comps, channel('vector'))
    else:
        face_v = centroid_to_faces(u, scheme='upwind' if upwind else 'linear', velocity_flux=flux_n)
        values = -density * ops.sum_(face_v * flux_n * mesh.face_areas, '~faces') / mesh.volume
    return Field(mesh, values, u.boundary)


def sample_mesh_field(value: Field, geometry, at: str, boundary, dot_face_normal) -> Tensor:
    """Sample a mesh field at arbitrary points: nearest-cell lookup plus linear
    Green-Gauss gradient reconstruction, v(p) = v(c) + ∇v·(p − x_c)
    (reference: sample_mesh cell-walk + gradient, phi/field/_resample.py:407-426;
    the iterative cell walk is replaced by a dense `find_closest` over cell
    centroids — one gather instead of a data-dependent loop)."""
    mesh: Mesh = value.geometry
    points = geometry.center if hasattr(geometry, 'center') else geometry
    idx = ops.find_closest(mesh.center, points)
    base = ops.gather(value.values, idx, dims='cells')
    if not value.values.shape.channel:  # scalar: first-order correction inside the cell
        grad = green_gauss_gradient(value).values
        offset = points - ops.gather(mesh.center, idx, dims='cells')
        return base + ops.sum_(ops.gather(grad, idx, dims='cells') * offset, 'vector')
    return base

"""Unstructured meshes for finite volumes — port of
`phiflow_tpu/geom/_mesh.py` (`Mesh`, `mesh_from_numpy` of 2D polygons
through the C++ face matcher and of 3D volume elements, `mesh`,
`build_mesh`, the loaders `load_su2`, `load_gmsh`, `load_stl`).

Connectivity is stored as padded dense per-cell face tables, as in the JAX
package: for every cell a fixed number of face slots holding the neighbour
cell's index (−1 an unused slot, −(2+b) a face of boundary group b), the
face's area, outward normal and centre, and the distance between the cells'
centres. Every FVM operator (`field/_mesh_math.py`) is a neighbour gather, a
per-face expression and a masked sum over the slots.

The 2D tables are built on the host by the C++ face matcher (`native/_lib.py`,
the JAX package's `meshbuild.cpp`), bit for bit as there; the 3D tables by
numpy over all faces at once (`_face_tables_3d`: faces matched by their
sorted vertex sets, JAX's slot order, neighbours and boundary ids exactly,
the geometry within float32 rounding of JAX's cell-by-cell loop). Both are put once on
the default device (`math.set_default_device`) as named-dim Tensors over
`instance('cells')`, `dual(faces=…)` and `channel(vector=…)`; `Mesh.to`
moves them. The neighbour index the gathers take, the interior, valid and
group masks are made once per Mesh and device, on first use.

Slicing a mesh beyond the identity raises, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..math import Tensor, Shape, wrap, channel, instance, dual, concat_shapes, get_default_device, get_precision
from ..math import _ops as ops
from ..math._magic import slicing_dict
from ..math._tensor import to_torch
from ._box import Box
from ._geom import Geometry

__all__ = ['Mesh', 'mesh_from_numpy', 'mesh', 'build_mesh', 'load_su2', 'load_gmsh', 'load_stl']


def _resolved(device) -> torch.device:
    """`device` with its index: 'cuda' is the current card."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def _on(tensor: Tensor, device: torch.device) -> Tensor:
    native = tensor.native()
    if isinstance(native, torch.Tensor) and native.device == device:
        return tensor
    return Tensor(to_torch(native, device).to(device), tensor.shape)


class Mesh(Geometry):
    """Unstructured FVM mesh. All per-cell and per-face data are dense padded
    Tensors on one device:

    * cell_centers (cells, vector), cell_volumes (cells)
    * neighbors (cells, ~faces): neighbour cell index, −1 = unused slot,
      −(2+b) = boundary face of group b
    * face_areas / face_centers / face_normals (cells, ~faces[, vector]), outward

    `element_lists` is the host array (cells, max_verts) of each cell's
    vertex indices, padded with −1."""

    def __init__(self, vertices: Tensor, element_lists, boundaries: Dict[str, int],
                 cell_centers: Tensor, cell_volumes: Tensor,
                 neighbors: Tensor, face_areas_t: Tensor, face_centers_t: Tensor,
                 face_normals_t: Tensor, neighbor_distances: Tensor, element_rank: int):
        self._vertices = vertices
        self._element_lists = element_lists
        self._boundaries = boundaries  # name -> boundary id
        self._cell_centers = cell_centers
        self._cell_volumes = cell_volumes
        self._neighbors = neighbors
        self._face_areas = face_areas_t
        self._face_centers = face_centers_t
        self._face_normals = face_normals_t
        self._neighbor_distances = neighbor_distances
        self.element_rank = element_rank
        self._derived = {}

    # --- basic geometry interface ---
    @property
    def vertices(self) -> Tensor:
        return self._vertices

    @property
    def boundaries(self) -> Dict[str, int]:
        return self._boundaries

    @property
    def boundary_names(self) -> Tuple[str, ...]:
        return tuple(self._boundaries)

    @property
    def center(self) -> Tensor:
        return self._cell_centers

    @property
    def names(self):
        return self._cell_centers.shape.get_labels('vector')

    @property
    def shape(self) -> Shape:
        return self._cell_centers.shape

    @property
    def volume(self) -> Tensor:
        return self._cell_volumes

    @property
    def spatial_rank(self) -> int:
        return self._cell_centers.shape.get_size('vector')

    @property
    def cell_count(self) -> int:
        return self.shape.get_size('cells')

    @property
    def max_faces(self) -> int:
        return self._neighbors.shape.get_size('~faces')

    @property
    def device(self) -> torch.device:
        return self._neighbors.native().device

    def to(self, device) -> 'Mesh':
        """The mesh with its tables on `device`: itself where they are there."""
        device = _resolved(device)
        if self.device == device:
            return self
        return Mesh(_on(self._vertices, device), self._element_lists, self._boundaries,
                    *(_on(t, device) for t in (self._cell_centers, self._cell_volumes, self._neighbors,
                                               self._face_areas, self._face_centers, self._face_normals,
                                               self._neighbor_distances)),
                    self.element_rank)

    # --- dense face tables ---
    @property
    def neighbors(self) -> Tensor:
        """Neighbour cell index per (cells, ~faces); −1 unused, −(2+b) boundary group b."""
        return self._neighbors

    @property
    def face_areas(self) -> Tensor:
        return self._face_areas

    @property
    def face_centers(self) -> Tensor:
        return self._face_centers

    @property
    def face_normals(self) -> Tensor:
        return self._face_normals

    @property
    def neighbor_distances(self) -> Tensor:
        """Distance between cell centres across each face (boundary: centre-to-face ×2)."""
        return self._neighbor_distances

    @property
    def face_shape(self) -> Shape:
        return self._neighbors.shape

    def _cached(self, key, make):
        key = (key, get_precision())
        if key not in self._derived:
            self._derived[key] = make()
        return self._derived[key]

    @property
    def interior_mask(self) -> Tensor:
        return self._cached('interior', lambda: ops.to_float(self._neighbors >= 0))

    @property
    def valid_face_mask(self) -> Tensor:
        return self._cached('valid', lambda: ops.to_float(self._neighbors != -1))

    def boundary_mask(self, name: str) -> Tensor:
        bid = self._boundaries[name]
        return self._cached(('boundary', name), lambda: ops.to_float(self._neighbors == -(2 + bid)))

    def _gather_index(self) -> torch.Tensor:
        """The neighbour index per slot, clamped to 0 for boundary and unused
        slots, as an int64 array (cells, faces)."""
        return self._cached('index', lambda: torch.clamp(self._neighbors.native(), min=0).to(torch.int64))

    def gather_neighbor(self, cell_values: Tensor) -> Tensor:
        """Value of the neighbour cell per face slot (cells, ~faces, …); clamped
        for invalid and boundary slots (mask separately)."""
        cell_values = wrap(cell_values)
        rest = cell_values.shape.without('cells')
        native = to_torch(cell_values.native(('cells',) + rest.names), self.device)
        return Tensor(native[self._gather_index()], concat_shapes(self._neighbors.shape, rest))

    # --- queries ---
    def lies_inside(self, location: Tensor) -> Tensor:
        closest = ops.find_closest(self._cell_centers, location)
        d = ops.gather(self._cell_volumes, closest, dims='cells') ** (1 / self.spatial_rank)
        dist = ops.vec_length(location - ops.gather(self._cell_centers, closest, dims='cells'))
        return dist < d

    def approximate_signed_distance(self, location: Tensor) -> Tensor:
        closest = ops.find_closest(self._cell_centers, location)
        return ops.vec_length(location - ops.gather(self._cell_centers, closest, dims='cells'))

    def bounding_radius(self) -> Tensor:
        return (self._cell_volumes ** (1 / self.spatial_rank)) * 0.5

    def bounding_half_extent(self) -> Tensor:
        return ops.expand(self.bounding_radius(), self.shape.only('vector'))

    @property
    def bounds(self) -> Box:
        lo = ops.min_(self._vertices, 'vertices')
        up = ops.max_(self._vertices, 'vertices')
        return Box(lo, up)

    def at(self, center: Tensor) -> 'Mesh':
        delta = center - self.center
        return self.shifted(delta)

    def shifted(self, delta: Tensor) -> 'Mesh':
        return Mesh(self._vertices + delta, self._element_lists, self._boundaries,
                    self._cell_centers + delta, self._cell_volumes, self._neighbors,
                    self._face_areas, self._face_centers + delta, self._face_normals,
                    self._neighbor_distances, self.element_rank)

    def __getitem__(self, item):
        item = slicing_dict(self, item)
        if not item:
            return self
        raise NotImplementedError("Mesh slicing beyond identity not yet supported")

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, Mesh) or self._element_lists is not other._element_lists:
            return False
        return self._vertices is other._vertices or ops.equal(self._vertices, other._vertices)

    def __hash__(self):
        return hash(('Mesh', len(self._element_lists)))

    def __repr__(self):
        return f"Mesh[{self.cell_count} cells, {self.shape.get_size('vector')}D, boundaries={list(self._boundaries)}]"


# ---------------------------------------------------------------------------
# construction (host side, then one copy of each table to the device)
# ---------------------------------------------------------------------------

def _padded(polygons) -> np.ndarray:
    """Polygons as an int32 array (cells, max_verts) padded with −1."""
    if isinstance(polygons, np.ndarray) and polygons.ndim == 2:
        return np.ascontiguousarray(polygons, np.int32)
    polygons = [tuple(int(v) for v in poly) for poly in polygons]
    max_verts = max(len(p) for p in polygons)
    polys = np.full((len(polygons), max_verts), -1, np.int32)
    for i, p in enumerate(polygons):
        polys[i, :len(p)] = p
    return polys


def _native_face_tables(points: np.ndarray, polys: np.ndarray, boundaries: Dict[str, Sequence[Tuple[int, int]]]):
    """The C++ face matcher's tables and the boundary ids: JAX's groups in
    their order, then 'boundary' where unlisted boundary faces exist."""
    from ..native._lib import build_face_tables_2d
    boundary_ids = {name: i for i, name in enumerate(boundaries)}
    default_id = len(boundary_ids)
    rows = [np.zeros((0, 3), np.int32)]
    for name, edges in boundaries.items():
        edges = np.asarray(edges, np.int32).reshape(-1, 2)
        rows.append(np.stack([edges.min(1), edges.max(1), np.full(len(edges), boundary_ids[name], np.int32)], 1))
    centers, volumes, neighbors, areas, f_centers, normals, distances = \
        build_face_tables_2d(points, polys, np.concatenate(rows).astype(np.int32), default_id)
    if np.any(neighbors == -(2 + default_id)):
        boundary_ids['boundary'] = default_id
    return boundary_ids, centers, volumes, neighbors, areas, f_centers, normals, distances


# the faces of a volume element by its vertex count, in the JAX package's order and orientation (SU2 / VTK
# vertex order): tetrahedron, pyramid, wedge / prism, hexahedron
_FACES_3D = {
    4: [(0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2)],
    5: [(0, 3, 2, 1), (0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4)],
    6: [(0, 2, 1), (3, 4, 5), (0, 1, 4, 3), (1, 2, 5, 4), (2, 0, 3, 5)],
    8: [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7)],
}


def _face_geometry(pts: np.ndarray):
    """Area, centroid and unit normal of planar polygons (F, nv, 3) by the
    fan around their vertex mean, as the JAX package's `_poly_face_geometry`
    computes them one polygon at a time."""
    m = pts.mean(1)
    area = np.zeros(len(pts))
    centroid = np.zeros((len(pts), 3))
    normal = np.zeros((len(pts), 3))
    nv = pts.shape[1]
    for i in range(nv):
        a, b = pts[:, i], pts[:, (i + 1) % nv]
        cr = np.cross(a - m, b - m)
        tri = 0.5 * np.linalg.norm(cr, axis=1)
        area += tri
        centroid += tri[:, None] * (m + a + b) / 3
        normal += 0.5 * cr
    centroid = np.where(area[:, None] > 0, centroid / np.where(area > 0, area, 1.0)[:, None], centroid)
    length = np.linalg.norm(normal, axis=1)
    normal = np.where(length[:, None] > 0, normal / np.where(length > 0, length, 1.0)[:, None], normal)
    return area, centroid, normal


def _face_tables_3d(points: np.ndarray, polys: np.ndarray, boundaries: Dict[str, Sequence]):
    """The face tables of volume elements (tetrahedra, pyramids, wedges,
    hexahedra by their vertex count) as the JAX package's
    `_mesh_from_numpy_3d` builds them cell by cell, here vectorised over the
    faces: the same slots (`_FACES_3D`), neighbours and boundary ids; the
    geometry in float64, stored as float32. A face that exactly two cells
    share is interior; any other belongs to the group listing its vertex set
    (the last that does), else to 'boundary'. A cell's volume and centroid
    sum the tetrahedra from its vertex mean over each outward-turned face's
    fan."""
    n_cells = polys.shape[0]
    counts = (polys >= 0).sum(1)
    unsupported = sorted(set(counts.tolist()) - set(_FACES_3D))
    if unsupported:
        raise ValueError(f"unsupported 3D element with {unsupported[0]} vertices (tet/pyr/wedge/hex)")
    kinds = sorted(set(counts.tolist()))
    max_faces = max(len(_FACES_3D[n]) for n in kinds)
    pts = points.astype(np.float64)
    # every face slot: its cell, its slot and its vertices (-1 padded to 4)
    cell_of, slot_of, verts = [], [], []
    for n in kinds:
        cells = np.nonzero(counts == n)[0]
        for k, tpl in enumerate(_FACES_3D[n]):
            v = np.full((len(cells), 4), -1, np.int64)
            v[:, :len(tpl)] = polys[cells][:, list(tpl)]
            cell_of.append(cells)
            slot_of.append(np.full(len(cells), k))
            verts.append(v)
    cell_of, slot_of, verts = np.concatenate(cell_of), np.concatenate(slot_of), np.concatenate(verts)
    n_verts = (verts >= 0).sum(1)
    area, f_cent, f_norm = np.zeros(len(verts)), np.zeros((len(verts), 3)), np.zeros((len(verts), 3))
    for n in (3, 4):
        sel = n_verts == n
        area[sel], f_cent[sel], f_norm[sel] = _face_geometry(pts[verts[sel, :n]])
    # volumes and centroids
    valid = polys >= 0
    vm = (pts[np.maximum(polys, 0)] * valid[..., None]).sum(1) / counts[:, None]
    vol = np.zeros(n_cells)
    cent = np.zeros((n_cells, 3))
    for n in (3, 4):
        sel = np.nonzero(n_verts == n)[0]
        c = cell_of[sel]
        fp = pts[verts[sel, :n]]
        sign = np.where(np.einsum('ij,ij->i', f_norm[sel], f_cent[sel] - vm[c]) < 0, -1.0, 1.0)
        fm = fp.mean(1)
        for i in range(n):
            a, b = fp[:, i], fp[:, (i + 1) % n]
            tet = sign * np.einsum('ij,ij->i', fm - vm[c], np.cross(a - vm[c], b - vm[c])) / 6.0
            vol += np.bincount(c, tet, n_cells)
            moment = tet[:, None] * (vm[c] + fm + a + b) / 4.0
            cent += np.stack([np.bincount(c, moment[:, e], n_cells) for e in range(3)], 1)
    volumes = np.abs(vol).astype(np.float32)
    centers = np.where(vol[:, None] != 0, cent / np.where(vol != 0, vol, 1.0)[:, None], vm).astype(np.float32)
    # matching: a face's key is its sorted vertex set
    keys = np.sort(verts, axis=1)
    uniq, inverse, users = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(inverse, kind='stable')
    start = np.concatenate([[0], np.cumsum(users)[:-1]])
    pair = start[users == 2]
    a_slot, b_slot = order[pair], order[pair + 1]
    other = np.full(len(verts), -1, np.int64)
    other[a_slot], other[b_slot] = cell_of[b_slot], cell_of[a_slot]
    boundary_ids = {name: i for i, name in enumerate(boundaries)}
    group = np.full(len(uniq), -1, np.int64)  # a unique face's listed group
    if boundaries:
        index = {k: i for i, k in enumerate(map(tuple, uniq.tolist()))}
        for name, faces in boundaries.items():
            for f in faces:
                f = sorted(int(v) for v in f)
                i = index.get(tuple([-1] * (4 - len(f)) + f))
                if i is not None:
                    group[i] = boundary_ids[name]
    interior = users[inverse] == 2
    bid = group[inverse]
    if np.any(~interior & (bid < 0)):
        bid = np.where(bid < 0, boundary_ids.setdefault('boundary', len(boundary_ids)), bid)
    flip = np.einsum('ij,ij->i', f_norm, f_cent - centers[cell_of]) < 0
    normal = np.where(flip[:, None], -f_norm, f_norm)
    # the distances from the float32 centres, in float32, as there
    dist = np.where(interior, np.linalg.norm(centers[np.maximum(other, 0)] - centers[cell_of], axis=1),
                    2 * np.linalg.norm(f_cent.astype(np.float32) - centers[cell_of], axis=1))
    neighbors = np.full((n_cells, max_faces), -1, np.int32)
    areas = np.zeros((n_cells, max_faces), np.float32)
    f_centers = np.zeros((n_cells, max_faces, 3), np.float32)
    normals = np.zeros((n_cells, max_faces, 3), np.float32)
    distances = np.ones((n_cells, max_faces), np.float32)
    neighbors[cell_of, slot_of] = np.where(interior, other, -(2 + bid))
    areas[cell_of, slot_of] = area
    f_centers[cell_of, slot_of] = f_cent
    normals[cell_of, slot_of] = normal
    distances[cell_of, slot_of] = dist
    return boundary_ids, centers, volumes, neighbors, areas, f_centers, normals, distances


def mesh_from_numpy(points: Sequence, polygons: Sequence, boundaries: Dict[str, List[Tuple[int, int]]] = None,
                    element_rank: int = None, periodic=None, cell_dim=instance('cells'),
                    face_format: str = 'dense', axes=('x', 'y', 'z')) -> Mesh:
    """A 2D Mesh from vertex coordinates and polygon vertex lists (a sequence
    of index sequences, or an int array padded with −1) through the C++ face
    matcher. `boundaries` maps names to lists of boundary edges (vertex index
    pairs); unlisted boundary faces go to 'boundary'. The tables land on the
    default device."""
    points = np.asarray(points, np.float32)
    d = points.shape[1]
    labels = tuple(axes[:d])
    assert d in (2, 3), f"mesh_from_numpy supports 2D polygonal and 3D polyhedral meshes, got d={d}"
    polys = _padded(polygons)
    n_cells = polys.shape[0]
    tables = _face_tables_3d if d == 3 else _native_face_tables
    boundary_ids, centers, volumes, neighbors, areas, f_centers, normals, distances = \
        tables(points, polys, boundaries or {})
    cells = cell_dim.with_size(n_cells)
    faces_dim = dual(faces=neighbors.shape[1])
    vec = channel(vector=labels)
    device = get_default_device()

    def put(array, *dims):
        return Tensor(to_torch(array, device), concat_shapes(*dims))

    return Mesh(
        vertices=put(points, instance(vertices=points.shape[0]), vec),
        element_lists=polys,
        boundaries=boundary_ids,
        cell_centers=put(centers, cells, vec),
        cell_volumes=put(volumes, cells),
        neighbors=put(neighbors, cells, faces_dim),
        face_areas_t=put(areas, cells, faces_dim),
        face_centers_t=put(f_centers, cells, faces_dim, vec),
        face_normals_t=put(normals, cells, faces_dim, vec),
        neighbor_distances=put(distances, cells, faces_dim),
        element_rank=element_rank if element_rank is not None else d,
    )


def mesh(vertices, elements, boundaries=None, element_rank=None, periodic=None,
         face_format='dense', max_cell_walk=None) -> Mesh:
    """A mesh from Tensors or arrays of vertices and elements (−1 padded)."""
    if isinstance(vertices, Tensor):
        vertices = vertices.numpy()
    if isinstance(elements, Tensor):
        elements = elements.numpy()
    polygons = [tuple(int(v) for v in row if v >= 0) for row in np.asarray(elements)]
    return mesh_from_numpy(vertices, polygons, boundaries, element_rank, periodic)


def build_mesh(bounds: Box = None, resolution=None, obstacles=None,
               method='quad', cell_dim=instance('cells'), face_format='dense',
               max_squish=.5, **resolution_) -> Mesh:
    """A structured quad mesh covering `bounds` without the cells whose centre
    lies inside an obstacle. The side groups `x-`, `x+`, `y-`, `y+` hold the
    edges on each side, listed cell by cell and edge by edge as in the JAX
    package (numpy here, a Python loop there); the obstacle faces fall into
    'boundary'."""
    resolution = resolution or {}
    if isinstance(resolution, Shape):
        resolution = {n: s for n, s in zip(resolution.names, resolution.sizes)}
    resolution = {**resolution, **{k: int(v) for k, v in resolution_.items()}}
    names = list(resolution.keys())
    assert len(names) == 2, "build_mesh currently supports 2D"
    nx, ny = resolution[names[0]], resolution[names[1]]
    if bounds is None:
        bounds = Box(**{names[0]: float(nx), names[1]: float(ny)})
    lo = np.asarray(bounds.lower.native())
    up = np.asarray(bounds.upper.native())
    xs = np.linspace(lo[0], up[0], nx + 1)
    ys = np.linspace(lo[1], up[1], ny + 1)
    vid = np.arange((nx + 1) * (ny + 1)).reshape(nx + 1, ny + 1)
    pts = np.stack(np.meshgrid(xs, ys, indexing='ij'), axis=-1).reshape(-1, 2)
    cx = (xs[:-1] + xs[1:]) / 2
    cy = (ys[:-1] + ys[1:]) / 2
    keep = np.ones((nx, ny), bool)
    if obstacles:
        obstacles_list = obstacles if isinstance(obstacles, (list, tuple)) else [obstacles]
        if isinstance(obstacles, dict):
            obstacles_list = list(obstacles.values())
        centers2 = np.stack(np.meshgrid(cx, cy, indexing='ij'), axis=-1).reshape(-1, 2)
        pts_t = wrap(centers2.astype(np.float32), instance(c=centers2.shape[0]), channel(vector=names))
        for obs in obstacles_list:
            inside = np.asarray(obs.lies_inside(pts_t).numpy()).reshape(nx, ny)
            keep &= ~inside
    i, j = np.nonzero(keep)  # row-major: the order of JAX's nested loop over i, then j
    polys = np.stack([vid[i, j], vid[i + 1, j], vid[i + 1, j + 1], vid[i, j + 1]], 1)
    eps = 1e-6
    v0, v1 = polys, np.roll(polys, -1, axis=1)  # edge k of each cell: (poly[k], poly[(k + 1) % 4])

    def edges_on(axis, value):
        on = np.abs(pts[:, axis] - value) < eps
        hit = on[v0] & on[v1]  # (cells, 4): cell by cell, edge by edge
        return np.stack([v0[hit], v1[hit]], 1)

    boundaries = {names[0] + '-': edges_on(0, lo[0]), names[0] + '+': edges_on(0, up[0]),
                  names[1] + '-': edges_on(1, lo[1]), names[1] + '+': edges_on(1, up[1])}
    return mesh_from_numpy(pts, polys, boundaries, element_rank=2, cell_dim=cell_dim, axes=tuple(names))


# ---------------------------------------------------------------------------
# file loaders (self-contained parsers, as the JAX package's; no meshio)
# ---------------------------------------------------------------------------

# VTK element types (SU2 uses them): id → number of vertices
_VTK_NVERTS = {3: 2, 5: 3, 9: 4, 10: 4, 12: 8, 13: 6, 14: 5}
_VTK_VOLUME = {10, 12, 13, 14}  # tetra, hexahedron, prism/wedge, pyramid
_VTK_SURFACE_2D = {5, 9}        # triangle, quad — volume elements in 2D, boundary faces in 3D


def load_su2(file_or_mesh: str, cell_dim=instance('cells'), face_format='dense') -> Mesh:
    """Parse an SU2 ASCII mesh (the JAX package's `load_su2`).
    2D: triangle (VTK 5) / quad (VTK 9) volume elements, line boundary markers.
    3D: tetra (10) / hexahedron (12) / prism (13) / pyramid (14) volume elements,
    triangle/quad boundary markers."""
    with open(file_or_mesh) as f:
        lines = [l.strip() for l in f.readlines()]
    i = 0
    ndime = npoin = nelem = 0
    points = []
    elements = []
    boundaries = {}
    while i < len(lines):
        line = lines[i]
        if line.startswith('NDIME'):
            ndime = int(line.split('=')[1])
        elif line.startswith('NELEM'):
            nelem = int(line.split('=')[1])
            for k in range(nelem):
                i += 1
                parts = lines[i].split()
                vtk = int(parts[0])
                if vtk not in _VTK_NVERTS or (ndime == 2 and vtk not in _VTK_SURFACE_2D) \
                        or (ndime == 3 and vtk not in _VTK_VOLUME):
                    raise NotImplementedError(f"SU2 volume element type {vtk} in {ndime}D")
                nv = _VTK_NVERTS[vtk]
                elements.append(tuple(int(p) for p in parts[1:1 + nv]))
        elif line.startswith('NPOIN'):
            npoin = int(line.split('=')[1])
            for k in range(npoin):
                i += 1
                parts = lines[i].split()
                points.append([float(p) for p in parts[:ndime]] if ndime else [float(parts[0]), float(parts[1])])
        elif line.startswith('NMARK'):
            nmark = int(line.split('=')[1])
            for m in range(nmark):
                i += 1
                tag = lines[i].split('=')[1].strip()
                i += 1
                n_el = int(lines[i].split('=')[1])
                faces = []
                for k in range(n_el):
                    i += 1
                    parts = lines[i].split()
                    vtk = int(parts[0])
                    nv = _VTK_NVERTS.get(vtk)
                    if nv:  # line (2D boundary) or tri/quad (3D boundary)
                        faces.append(tuple(int(p) for p in parts[1:1 + nv]))
                boundaries[tag] = faces
        i += 1
    return mesh_from_numpy(points, elements, boundaries, element_rank=ndime, cell_dim=cell_dim)


def load_gmsh(file: str, boundary_names: Sequence[str] = None, cell_dim=instance('cells'),
              face_format='dense') -> Mesh:
    """Parse a Gmsh 2.2 ASCII .msh file (the JAX package's `load_gmsh`):
    triangles / quads in 2D with line boundaries, tetrahedra, hexahedra,
    prisms and pyramids in 3D with triangle / quad boundaries, grouped by
    physical tag (named by `boundary_names` in tag order, else
    'boundary<tag>')."""
    with open(file) as f:
        lines = [l.strip() for l in f.readlines()]
    raw_points = []
    raw_elements = []  # (etype, phys, verts)
    i = 0
    while i < len(lines):
        if lines[i] == '$Nodes':
            n = int(lines[i + 1])
            for k in range(n):
                parts = lines[i + 2 + k].split()
                raw_points.append([float(parts[1]), float(parts[2]), float(parts[3])])
            i += n + 2
        elif lines[i] == '$Elements':
            n = int(lines[i + 1])
            for k in range(n):
                parts = [int(p) for p in lines[i + 2 + k].split()]
                etype = parts[1]
                ntags = parts[2]
                tags = parts[3:3 + ntags]
                verts = tuple(v - 1 for v in parts[3 + ntags:])
                raw_elements.append((etype, tags[0] if tags else 0, verts))
            i += n + 2
        else:
            i += 1
    # gmsh types: 1=line 2=tri 3=quad 4=tet 5=hex 6=prism 7=pyramid
    is_3d = any(e[0] in (4, 5, 6, 7) for e in raw_elements)
    elements = []
    boundary_groups: Dict[int, list] = {}
    for etype, phys, verts in raw_elements:
        if is_3d:
            if etype in (4, 5, 6, 7):
                elements.append(verts)
            elif etype in (2, 3):  # surface → boundary face
                boundary_groups.setdefault(phys, []).append(verts)
        else:
            if etype in (2, 3):
                elements.append(verts)
            elif etype == 1:  # line → boundary edge
                boundary_groups.setdefault(phys, []).append(verts)
    points = [p[:3] if is_3d else p[:2] for p in raw_points]
    names = {}
    phys_ids = sorted(boundary_groups)
    for idx, phys in enumerate(phys_ids):
        name = boundary_names[idx] if boundary_names and idx < len(boundary_names) else f"boundary{phys}"
        names[name] = boundary_groups[phys]
    return mesh_from_numpy(points, elements, names, element_rank=3 if is_3d else 2, cell_dim=cell_dim)


def load_stl(file: str, face_dim=instance('faces')):
    """Parse an ASCII or binary STL file into vertices and triangle faces (the
    JAX package's `load_stl`): (points, triangles) numpy arrays, the vertices
    deduplicated after rounding to 6 decimals."""
    import struct
    with open(file, 'rb') as f:
        header = f.read(80)
        if header[:5] == b'solid':
            f.seek(0)
            text = f.read().decode('ascii', errors='ignore')
            tris = []
            current = []
            for line in text.splitlines():
                line = line.strip()
                if line.startswith('vertex'):
                    current.append([float(x) for x in line.split()[1:4]])
                    if len(current) == 3:
                        tris.append(current)
                        current = []
            tris = np.asarray(tris, np.float32)
        else:
            n, = struct.unpack('<I', f.read(4))
            data = np.frombuffer(f.read(n * 50), dtype=np.uint8).reshape(n, 50)
            tris = data[:, 12:48].copy().view('<f4').reshape(n, 3, 3)
    # deduplicate vertices
    flat = tris.reshape(-1, 3)
    verts, inverse = np.unique(flat.round(6), axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3)
    return verts.astype(np.float32), faces.astype(np.int32)

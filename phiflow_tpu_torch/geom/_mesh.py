"""Unstructured 2D meshes for finite volumes — port of the 2D part of
`phiflow_tpu/geom/_mesh.py` (`Mesh` `:33-188`, `mesh_from_numpy` `:235-268`
through the C++ face matcher, `mesh` `:459`, `build_mesh` `:470-530`).

Connectivity is stored as padded dense per-cell face tables, as in the JAX
package: for every cell a fixed number of face slots holding the neighbour
cell's index (−1 an unused slot, −(2+b) a face of boundary group b), the
face's area, outward normal and centre, and the distance between the cells'
centres. Every FVM operator (`field/_mesh_math.py`) is a neighbour gather, a
per-face expression and a masked sum over the slots.

The tables are built on the host by the C++ face matcher (`native/_lib.py`,
the JAX package's `meshbuild.cpp`), bit for bit as there, and put once on
the default device (`math.set_default_device`) as named-dim Tensors over
`instance('cells')`, `dual(faces=…)` and `channel(vector=…)`; `Mesh.to`
moves them. The neighbour index the gathers take, the interior, valid and
group masks are made once per Mesh and device, on first use.

A 3D input raises NotImplementedError: 3D meshes, the file loaders and
`_mesh_builder.py` come with a later slice of the port.
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

__all__ = ['Mesh', 'mesh_from_numpy', 'mesh', 'build_mesh']


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
    if d == 3:
        raise NotImplementedError("3D meshes (mesh_from_numpy of volume elements) come with a later slice of the port")
    assert d == 2, f"mesh_from_numpy supports 2D polygonal and 3D polyhedral meshes, got d={d}"
    polys = _padded(polygons)
    n_cells = polys.shape[0]
    boundary_ids, centers, volumes, neighbors, areas, f_centers, normals, distances = \
        _native_face_tables(points, polys, boundaries or {})
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

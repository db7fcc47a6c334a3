"""Incremental mesh assembly — port of `phiflow_tpu/geom/_mesh_builder.py`:
`MeshBuilder` (vertices deduplicated on a tolerance lattice, polygons or
volume elements, named boundary faces), `join_meshes`, and the
vertex-clustering `decimate_tri_mesh` of a triangle surface. Host-side."""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ._mesh import Mesh, mesh_from_numpy

__all__ = ['MeshBuilder', 'join_meshes', 'decimate_tri_mesh']


class MeshBuilder:
    """Accumulates vertices and polygons, a vertex within `tolerance` of one
    already added taking its index, then builds a Mesh (`mesh_from_numpy`,
    on the default device)."""

    def __init__(self, element_rank: int = 2, tolerance: float = 1e-6):
        self.element_rank = element_rank
        self.tolerance = tolerance
        self._vertices: List[Tuple[float, ...]] = []
        self._lookup: Dict[Tuple, int] = {}
        self._polygons: List[Tuple[int, ...]] = []
        self._boundaries: Dict[str, List[Tuple[int, int]]] = {}

    def vertex(self, *coords) -> int:
        key = tuple(round(float(c) / self.tolerance) for c in coords)
        if key in self._lookup:
            return self._lookup[key]
        idx = len(self._vertices)
        self._vertices.append(tuple(float(c) for c in coords))
        self._lookup[key] = idx
        return idx

    def add_polygon(self, *vertex_ids_or_coords) -> int:
        ids = []
        for v in vertex_ids_or_coords:
            if isinstance(v, int):
                ids.append(v)
            else:
                ids.append(self.vertex(*v))
        self._polygons.append(tuple(ids))
        return len(self._polygons) - 1

    def add_boundary_edge(self, name: str, v0: int, v1: int):
        self._boundaries.setdefault(name, []).append((v0, v1))

    def build(self) -> Mesh:
        return mesh_from_numpy(np.asarray(self._vertices, np.float32), self._polygons,
                               self._boundaries or None, element_rank=self.element_rank)


def join_meshes(*meshes: Mesh) -> Mesh:
    """The meshes' elements in one mesh, vertices they share merged, in the
    order given; their boundary groups are not carried over (unmatched faces
    fall into 'boundary')."""
    builder = MeshBuilder(meshes[0].element_rank)
    for m in meshes:
        verts = np.asarray(m.vertices.numpy(('vertices', 'vector')))
        for poly in m._element_lists:
            builder.add_polygon(*[tuple(verts[v]) for v in poly if v >= 0])
    return builder.build()


def decimate_tri_mesh(verts: np.ndarray, faces: np.ndarray, factor=0.5):
    """Vertex-clustering decimation of a triangle surface (verts (n, 3),
    faces (m, 3)): the vertices binned on a lattice of about
    ∛(n · factor) cells an axis over their bounding box, each bin's vertices
    replaced by their mean, faces that collapse dropped."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    bbox_min, bbox_max = verts.min(0), verts.max(0)
    target_cells = max(2, int(np.cbrt(len(verts) * factor)))
    cell = (bbox_max - bbox_min) / target_cells + 1e-9
    keys = np.floor((verts - bbox_min) / cell).astype(np.int64)
    _, inverse = np.unique(keys, axis=0, return_inverse=True)
    # new vertex = centroid per cluster
    n_clusters = inverse.max() + 1
    new_verts = np.zeros((n_clusters, verts.shape[1]), np.float64)
    counts = np.zeros(n_clusters, np.int64)
    np.add.at(new_verts, inverse, verts)
    np.add.at(counts, inverse, 1)
    new_verts /= counts[:, None]
    new_faces = inverse[faces]
    # drop degenerate faces
    keep = (new_faces[:, 0] != new_faces[:, 1]) & (new_faces[:, 1] != new_faces[:, 2]) \
        & (new_faces[:, 0] != new_faces[:, 2])
    return new_verts.astype(np.float32), new_faces[keep].astype(np.int32)

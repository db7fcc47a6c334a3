"""The C++ face matcher of `geom/_mesh.py` (`meshbuild.cpp`,
`build_face_tables_2d`): the JAX package's matcher, whose code this copy
keeps as it is, so that both packages build the same tables bit for bit.

It is compiled at first use by ``g++ -O3 -shared -fPIC -std=c++17`` into
`phiflow_tpu_torch/_build/libmeshbuild.so` (the directory, and the rule that
rebuilds a library older than its source, of `ops/_build.py`) and loaded
with `ctypes`. A failed build raises with the compiler's output: the port has
no other face matcher to fall back on."""
from __future__ import annotations

import os
import subprocess
import threading
import time

import numpy as np

from ..ops import _build

__all__ = ['SOURCE', 'library_path', 'build', 'get_lib', 'build_face_tables_2d']

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'meshbuild.cpp')
GXX_FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17')

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    return os.path.join(_build.BUILD_DIR, 'libmeshbuild.so')


def build(force: bool = False) -> float:
    """Compile `meshbuild.cpp` when its library is missing or older than it
    (always with `force`). Returns the wall seconds; raises RuntimeError with
    g++'s output when the compiler fails or is missing."""
    so = library_path()
    if not force and not _build.stale(so, [SOURCE]):
        return 0.0
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.tmp'
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(['g++', *GXX_FLAGS, SOURCE, '-o', tmp], capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the mesh face matcher (native/meshbuild.cpp) cannot be built") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building native/meshbuild.cpp failed (g++ exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)
    return time.perf_counter() - t0


def get_lib():
    """The loaded library, built first where needed."""
    global _lib
    with _lock:
        if _lib is None:
            import ctypes
            build()
            lib = ctypes.CDLL(library_path())
            lib.build_face_tables_2d.restype = ctypes.c_int
            lib.build_face_tables_2d.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,                   # points
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,   # polys
                ctypes.c_void_p, ctypes.c_int64,                   # boundary edges
                ctypes.c_int32,                                    # default boundary id
                ctypes.c_void_p, ctypes.c_void_p,                  # centers, volumes
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            _lib = lib
        return _lib


def build_face_tables_2d(points, polys_padded, boundary_edge_rows, default_boundary_id):
    """The face tables of a 2D polygon mesh, as numpy arrays: (centers,
    volumes, neighbors, areas, face centers, normals, distances).

    `points` (n, 2) float32, `polys_padded` (cells, max_verts) int32 padded
    with −1, `boundary_edge_rows` (edges, 3) int32 rows (v0, v1, group id)."""
    points = np.ascontiguousarray(points, np.float32)
    polys = np.ascontiguousarray(polys_padded, np.int32)
    if points.ndim != 2 or points.shape[1] != 2 or polys.ndim != 2:
        raise ValueError(f"points (n, 2) and polygons (cells, max_verts) expected, got {points.shape}, {polys.shape}")
    if polys.size and (polys.max() >= points.shape[0] or polys.min() < -1):
        raise ValueError(f"polygon vertex ids outside [-1, {points.shape[0]})")
    n_cells, max_verts = polys.shape
    bed = np.ascontiguousarray(boundary_edge_rows, np.int32).reshape(-1, 3)
    lib = get_lib()
    centers = np.zeros((n_cells, 2), np.float32)
    volumes = np.zeros((n_cells,), np.float32)
    neighbors = np.zeros((n_cells, max_verts), np.int32)
    areas = np.zeros((n_cells, max_verts), np.float32)
    f_centers = np.zeros((n_cells, max_verts, 2), np.float32)
    normals = np.zeros((n_cells, max_verts, 2), np.float32)
    distances = np.zeros((n_cells, max_verts), np.float32)
    rc = lib.build_face_tables_2d(
        points.ctypes.data, points.shape[0],
        polys.ctypes.data, n_cells, max_verts,
        bed.ctypes.data, bed.shape[0],
        np.int32(default_boundary_id),
        centers.ctypes.data, volumes.ctypes.data,
        neighbors.ctypes.data, areas.ctypes.data, f_centers.ctypes.data,
        normals.ctypes.data, distances.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"build_face_tables_2d returned {rc}")
    return centers, volumes, neighbors, areas, f_centers, normals, distances

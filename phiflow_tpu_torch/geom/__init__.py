"""Geometry on raw tensors (mirrors `phiflow_tpu/geom`)."""
from ._box import Box, Cuboid, box_push
from ._geom import Geometry, InvertedGeometry, Point, Union, union
from ._graph import Graph, graph
from ._grid import UniformGrid, UniformGrid_native
from ._sphere import Sphere
from ._transform import rotate_vector, rotation_matrix, rotation_matrix_native
from ._mesh import Mesh, mesh, mesh_from_numpy, build_mesh

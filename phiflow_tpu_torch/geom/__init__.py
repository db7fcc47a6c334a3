"""Geometry — port of `phiflow_tpu/geom`: its names but the splines."""
from ._geom import (Geometry, InvertedGeometry, Point, NoGeometry, GeometryException, assert_same_rank, invert, rotate,
                    scale, sample_function)
from ._box import Box, BaseBox, Cuboid, box_push, bounding_box, box_from_limits
from ._sphere import Sphere
from ._grid import UniformGrid, UniformGrid_native, enclosing_grid
from ._geom_ops import union, intersection, GeometryStack, Intersection, expel
from ._transform import (rotate_vector, rotation_matrix, rotation_matrix_native, rotation_angles,
                         rotation_matrix_from_axis_and_angle, rotation_matrix_from_directions)
from ._cylinder import Cylinder, cylinder
from ._sdf import SDF, numpy_sdf
from ._sdf_grid import SDFGrid, sample_sdf
from ._heightmap import Heightmap
from ._voxels import Voxels
from ._embed import embed, infinite_cylinder
from ._functions import (cross, clip_length, normal_from_slope, plane_sgn_dist, closest_on_triangle,
                         closest_points_on_lines, distance_line_point)
from ._geom_functions import line_trace, length, squared_length, normalize, farthest_points
from ._graph import Graph, graph
from ._mesh import Mesh, mesh, mesh_from_numpy, build_mesh, load_su2, load_gmsh, load_stl
from ._mesh_builder import MeshBuilder, join_meshes, decimate_tri_mesh
from ._convert import as_sdf, surface_mesh, marching_tetrahedra

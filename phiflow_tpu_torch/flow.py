"""The user namespace — port of `phiflow_tpu/flow.py`:

    from phiflow_tpu_torch.flow import *

the same names, from the port's packages, but the JAX package's parallel
names (`parallel`, `create_mesh`, `shard_field`, `shard_tensor`,
`simulation_mesh`): domain decomposition is not ported yet. It imports
without matplotlib and plotly (`vis` imports them at first use).
"""
# --- math ---
from . import math
from .math import (
    Tensor, Shape, EMPTY_SHAPE, batch, spatial, channel, instance, dual,
    wrap, tensor, vec, stack, unstack, concat, expand, rename_dims, pack_dims, unpack_dim,
    zeros, ones, random_uniform, random_normal, linspace, meshgrid, arange,
    Solve, SolveInfo, SolveTape, solve_linear, solve_nonlinear, minimize,
    jit_compile, jit_compile_linear, gradient, functional_gradient, jacobian, custom_gradient,
    iterate, assert_close, extrapolation, PI, INF, NAN, NUMPY,
    ConvergenceException, Diverged, NotConverged, copy_with, set_global_precision, precision,
    Layout, layout, neighbor_mean, sample_subgrid, quantile, median, histogram,
    pairwise_differences,
)
from .math.extrapolation import PERIODIC, ZERO_GRADIENT

# --- geom ---
from . import geom
from .geom import (
    Geometry, Point, Sphere, Box, Cuboid, UniformGrid, union, intersection, invert,
    rotate, scale, length, squared_length, normalize, cross,
    Cylinder, cylinder,
    Mesh, mesh, load_su2, load_gmsh, load_stl, mesh_from_numpy, build_mesh, Graph, graph,
    Heightmap, SDF, SDFGrid, Voxels, BSplineSheet, SplineSolid, to_spline, double_cover,
    SplineVolume, to_spline_volume, apply_spline_bounds, transform_with_spline,
)

# --- field ---
from . import field
from .field import (
    Field, Grid, CenteredGrid, StaggeredGrid, PointCloud, Noise,
    HardGeometryMask, SoftGeometryMask, GeometryMask, AngularVelocity,
    resample, sample, reduce_sample, spatial_gradient, divergence, curl, laplace,
    fourier_laplace, fourier_poisson, where, maximum, minimum, vec_length, vec_squared,
    finite_fill, distribute_points, l2_loss, mask, stagger,
)
from .field import Scene, SceneBatch, write as write_field, read as read_field

# --- physics ---
from . import physics
from .physics import advect, diffuse, fluid, integrate, sph
from .physics.fluid import Obstacle, make_incompressible, incompressible_rk4

# --- vis ---
from . import vis
from .vis import plot, show, show_hist, close as close_figures, control, action, write_image, load_scalars, overlay

import numpy
import numpy as np

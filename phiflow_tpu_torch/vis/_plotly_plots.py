"""Plotly recipes — port of `phiflow_tpu/vis/_plotly_plots.py`: 2D heatmaps
and quivers, 3D volumes, point clouds, cones, closed surfaces of spheres,
boxes and cylinders, graphs, spline sheets, meshes, SDF isosurfaces.

plotly is no hard dependency, and this module is imported only when a plot
asks for plotly (`vis._vis.plot(lib='plotly')`). Where plotly is missing the
module still imports, `PLOTLY` is None and `plotly_available()` False. The
tessellation helpers are numpy and need no plotly. The recipes hand plotly
host copies of the Fields' values (`Tensor.numpy`).
"""
from __future__ import annotations

import numpy as np

from ..field import Field
from ._vis_base import Recipe, PlottingLibrary

try:
    import plotly.graph_objects as go
    from plotly.subplots import make_subplots
    _PLOTLY_AVAILABLE = True
except ImportError:  # plotly is optional
    go = None
    make_subplots = None
    _PLOTLY_AVAILABLE = False

__all__ = ['PLOTLY', 'plotly_available']


def plotly_available() -> bool:
    return _PLOTLY_AVAILABLE


class _PlotlyRecipe(Recipe):
    pass


class LinePlotP(_PlotlyRecipe):
    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_grid and data.spatial_rank == 1

    def plot(self, data: Field, figure, subplot, space, **kwargs):
        dim = data.resolution.names[0]
        x = np.asarray(data.points.numpy(dim)) if not data.shape.channel else \
            np.asarray(data.points[{'vector': dim}].numpy(dim))
        y = np.asarray(data.values.numpy(dim))
        figure.add_trace(go.Scatter(x=x, y=y, mode='lines'), row=subplot[0] + 1, col=subplot[1] + 1)


class Heatmap2DP(_PlotlyRecipe):
    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_grid and data.spatial_rank == 2 \
            and not data.shape.channel and data.is_centered

    def plot(self, data: Field, figure, subplot, space, **kwargs):
        dims = data.resolution.names
        values = np.asarray(data.values.numpy(tuple(reversed(dims))))
        figure.add_trace(go.Heatmap(z=values, colorscale='Viridis'),
                         row=subplot[0] + 1, col=subplot[1] + 1)


class VectorField2DP(_PlotlyRecipe):
    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_grid and data.spatial_rank == 2 \
            and bool(data.shape.channel)

    def plot(self, data: Field, figure, subplot, space, **kwargs):
        at_c = data.at_centers() if data.is_staggered else data
        dims = at_c.resolution.names
        pts = at_c.points
        xs = np.asarray(pts[{'vector': dims[0]}].numpy(dims)).ravel()
        ys = np.asarray(pts[{'vector': dims[1]}].numpy(dims)).ravel()
        u = np.asarray(at_c.values[{'vector': dims[0]}].numpy(dims)).ravel()
        v = np.asarray(at_c.values[{'vector': dims[1]}].numpy(dims)).ravel()
        # plotly has no native quiver in graph_objects: draw line segments
        scale = 0.4 * float(np.median(np.abs(np.diff(np.unique(xs))))) / (np.abs(u).max() + 1e-12)
        lines_x, lines_y = [], []
        for x, y, du, dv in zip(xs, ys, u, v):
            lines_x += [x, x + du * scale, None]
            lines_y += [y, y + dv * scale, None]
        figure.add_trace(go.Scatter(x=lines_x, y=lines_y, mode='lines'),
                         row=subplot[0] + 1, col=subplot[1] + 1)


class Heatmap3DP(_PlotlyRecipe):
    """Volume rendering."""

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_grid and data.spatial_rank == 3 \
            and not data.shape.channel and data.is_centered

    def plot(self, data: Field, figure, subplot, space, **kwargs):
        dims = data.resolution.names
        values = np.asarray(data.values.numpy(dims))
        pts = data.points
        coords = [np.asarray(pts[{'vector': d}].numpy(dims)).ravel() for d in dims]
        figure.add_trace(go.Volume(
            x=coords[0], y=coords[1], z=coords[2], value=values.ravel(),
            opacity=0.1, surface_count=17), row=subplot[0] + 1, col=subplot[1] + 1)


class PointCloud2DP(_PlotlyRecipe):
    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_point_cloud and data.spatial_rank == 2

    def plot(self, data: Field, figure, subplot, space, **kwargs):
        pts = data.points
        labels = data.geometry.shape.get_labels('vector')
        xs = np.asarray(pts[{'vector': labels[0]}].numpy()).ravel()
        ys = np.asarray(pts[{'vector': labels[1]}].numpy()).ravel()
        figure.add_trace(go.Scatter(x=xs, y=ys, mode='markers', marker=dict(size=3)),
                         row=subplot[0] + 1, col=subplot[1] + 1)


class PointCloud3DP(_PlotlyRecipe):
    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_point_cloud and data.spatial_rank == 3

    def plot(self, data: Field, figure, subplot, space, **kwargs):
        pts = data.points
        labels = data.geometry.shape.get_labels('vector')
        xyz = [np.asarray(pts[{'vector': l}].numpy()).ravel() for l in labels]
        figure.add_trace(go.Scatter3d(x=xyz[0], y=xyz[1], z=xyz[2], mode='markers',
                                      marker=dict(size=2)), row=subplot[0] + 1, col=subplot[1] + 1)


class SurfaceMesh3DP(_PlotlyRecipe):
    """Triangle-surface plot of 3D meshes / mesh fields."""

    def can_plot(self, data, space) -> bool:
        from ..geom._mesh import Mesh
        if isinstance(data, Field) and data.is_mesh and data.spatial_rank == 3:
            return True
        return isinstance(data, Mesh) and data.spatial_rank == 3 and data.element_rank == 2

    def plot(self, data, figure, subplot, space, **kwargs):
        from ..geom._mesh import Mesh
        mesh = data.geometry if isinstance(data, Field) else data
        verts = np.asarray(mesh.vertices.center.numpy(('vertices', 'vector')))
        elems = np.asarray(mesh.elements).reshape(-1, 3)
        intensity = None
        if isinstance(data, Field):
            intensity = np.asarray(data.values.numpy()).ravel()
        figure.add_trace(go.Mesh3d(x=verts[:, 0], y=verts[:, 1], z=verts[:, 2],
                                   i=elems[:, 0], j=elems[:, 1], k=elems[:, 2],
                                   intensity=intensity, opacity=0.8),
                         row=subplot[0] + 1, col=subplot[1] + 1)


class SDF3DP(_PlotlyRecipe):
    """Isosurface of an SDF grid."""

    def can_plot(self, data, space) -> bool:
        from ..geom._sdf_grid import SDFGrid
        return isinstance(data, SDFGrid) and data.spatial_rank == 3

    def plot(self, data, figure, subplot, space, **kwargs):
        vals = np.asarray(data.values.numpy(data.values.shape.names))
        dims = data.values.shape.names
        grids = np.meshgrid(*[np.arange(s) for s in vals.shape], indexing='ij')
        figure.add_trace(go.Isosurface(
            x=grids[0].ravel(), y=grids[1].ravel(), z=grids[2].ravel(),
            value=vals.ravel(), isomin=0.0, isomax=0.0, surface_count=1),
            row=subplot[0] + 1, col=subplot[1] + 1)


# ---------------------------------------------------------------------------
# Geometry tessellation (pure numpy — unit-testable without plotly installed)
# ---------------------------------------------------------------------------

def sphere_surface(centers: np.ndarray, radii: np.ndarray, n: int = 12):
    """Merged triangle surfaces of spheres: centers (M,3), radii (M,) →
    (verts (V,3), faces (F,3) int). Lat-long tessellation with n latitude bands."""
    centers = np.atleast_2d(np.asarray(centers, np.float64))
    radii = np.broadcast_to(np.asarray(radii, np.float64).ravel(), (centers.shape[0],))
    thetas = np.linspace(0, np.pi, n + 1)
    phis = np.linspace(0, 2 * np.pi, 2 * n, endpoint=False)
    tt, pp = np.meshgrid(thetas, phis, indexing='ij')
    unit = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], -1)
    v_per = unit.reshape(-1, 3)
    rows, cols = n + 1, 2 * n
    faces = []
    for i in range(rows - 1):
        for j in range(cols):
            a, b = i * cols + j, i * cols + (j + 1) % cols
            c, d = (i + 1) * cols + j, (i + 1) * cols + (j + 1) % cols
            faces.append((a, b, c))
            faces.append((b, d, c))
    f_per = np.asarray(faces, np.int64)
    verts = np.concatenate([v_per * r + c for c, r in zip(centers, radii)])
    faces_all = np.concatenate([f_per + k * v_per.shape[0] for k in range(centers.shape[0])])
    return verts, faces_all


def cuboid_surface(lowers: np.ndarray, uppers: np.ndarray):
    """Merged triangle surfaces of axis-aligned boxes: lowers/uppers (M,3) →
    (verts (8M,3), faces (12M,3))."""
    lowers = np.atleast_2d(np.asarray(lowers, np.float64))
    uppers = np.atleast_2d(np.asarray(uppers, np.float64))
    corners = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)], np.float64)
    f_per = np.asarray([
        (0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),  # x- / x+
        (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),  # y- / y+
        (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3),  # z- / z+
    ], np.int64)
    verts, faces = [], []
    for k, (lo, up) in enumerate(zip(lowers, uppers)):
        verts.append(lo + corners * (up - lo))
        faces.append(f_per + 8 * k)
    return np.concatenate(verts), np.concatenate(faces)


def cylinder_surface(centers: np.ndarray, radii, depths, axis_index: int = 2, n: int = 24):
    """Merged triangle surfaces of axis-aligned cylinders: two cap fans + side
    band; centers (M,3) → (verts, faces)."""
    centers = np.atleast_2d(np.asarray(centers, np.float64))
    m = centers.shape[0]
    radii = np.broadcast_to(np.asarray(radii, np.float64).ravel(), (m,))
    depths = np.broadcast_to(np.asarray(depths, np.float64).ravel(), (m,))
    other = [i for i in range(3) if i != axis_index]
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    verts, faces = [], []
    offset = 0
    for c, r, d in zip(centers, radii, depths):
        ring = np.zeros((n, 3))
        ring[:, other[0]] = np.cos(ang) * r
        ring[:, other[1]] = np.sin(ang) * r
        lo_ring = ring.copy()
        lo_ring[:, axis_index] = -d / 2
        hi_ring = ring.copy()
        hi_ring[:, axis_index] = d / 2
        lo_c = np.zeros(3)
        lo_c[axis_index] = -d / 2
        hi_c = np.zeros(3)
        hi_c[axis_index] = d / 2
        v = np.concatenate([lo_ring, hi_ring, [lo_c], [hi_c]]) + c   # (2n+2, 3)
        f = []
        for j in range(n):
            j2 = (j + 1) % n
            f.append((j, j2, n + j))               # side
            f.append((j2, n + j2, n + j))
            f.append((2 * n, j2, j))               # bottom cap fan
            f.append((2 * n + 1, n + j, n + j2))   # top cap fan
        verts.append(v)
        faces.append(np.asarray(f, np.int64) + offset)
        offset += v.shape[0]
    return np.concatenate(verts), np.concatenate(faces)


def graph_edge_segments(graph) -> np.ndarray:
    """Edge endpoint pairs of a Graph geometry: (E, 2, d) float array."""
    from ..math._sparse import SparseCooTensor, SparseCompressedTensor
    inst = graph.shape.instance.names[0]
    centers = np.asarray(graph.center.numpy((inst, 'vector')))
    edges = graph.edges
    if graph.indices is not None:  # compact: (nodes, neighbor-index) int tensor
        idx = np.asarray(graph.indices.numpy())
        rows = np.repeat(np.arange(idx.shape[0]), idx.shape[-1])
        cols = idx.reshape(idx.shape[0], -1).ravel()
    elif isinstance(edges, SparseCooTensor):
        ij = np.asarray(edges._indices.numpy(('entries', 'sparse_idx')))
        rows, cols = ij[:, 0], ij[:, 1]
    elif isinstance(edges, SparseCompressedTensor):
        ptr = edges._pointers.detach().cpu().numpy()
        cols = edges._idx.detach().cpu().numpy()
        rows = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    else:
        dense = np.asarray(edges.numpy())
        rows, cols = np.nonzero(dense.reshape(centers.shape[0], -1))
    keep = (cols >= 0) & (cols < centers.shape[0])
    return np.stack([centers[rows[keep]], centers[cols[keep]]], axis=1)


class VectorCloud3DP(_PlotlyRecipe):
    """Cone glyphs for 3D vector data — grids and point clouds."""

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.spatial_rank == 3 and not data.is_mesh \
            and ('vector' in data.values.shape or data.is_staggered) \
            and (data.is_grid or data.is_point_cloud)

    def plot(self, data: Field, figure, subplot, space, **kwargs):
        at_c = data.at_centers() if data.is_staggered else data
        labels = at_c.geometry.shape.get_labels('vector')
        pts = at_c.points
        xyz = [np.asarray(pts[{'vector': l}].numpy()).ravel() for l in labels]
        uvw = [np.asarray(at_c.values[{'vector': l}].numpy()).ravel() for l in labels]
        figure.add_trace(go.Cone(x=xyz[0], y=xyz[1], z=xyz[2], u=uvw[0], v=uvw[1], w=uvw[2],
                                 sizemode='scaled', anchor='tail', colorscale='Blues'),
                         row=subplot[0] + 1, col=subplot[1] + 1)


class Object3DP(_PlotlyRecipe):
    """Sphere / box / cylinder point-cloud geometries rendered as closed
    triangle surfaces."""

    MAX_OBJECTS = 400

    def can_plot(self, data, space) -> bool:
        from ..geom import Sphere, Cylinder
        from ..geom._box import BaseBox
        from ..geom._grid import UniformGrid
        if not (isinstance(data, Field) and data.spatial_rank == 3):
            return False
        geo = data.geometry
        if isinstance(geo, UniformGrid) or not isinstance(geo, (Sphere, Cylinder, BaseBox)):
            return False
        return int(geo.shape.instance.volume or 1) <= self.MAX_OBJECTS

    def plot(self, data: Field, figure, subplot, space, **kwargs):
        verts, faces = self.tessellate(data.geometry)
        figure.add_trace(go.Mesh3d(x=verts[:, 0], y=verts[:, 1], z=verts[:, 2],
                                   i=faces[:, 0], j=faces[:, 1], k=faces[:, 2], opacity=0.7),
                         row=subplot[0] + 1, col=subplot[1] + 1)

    @staticmethod
    def tessellate(geo):
        from ..geom import Sphere, Cylinder
        from ..geom._box import BaseBox
        labels = geo.shape.get_labels('vector')
        inst = geo.shape.instance
        centers = np.asarray(geo.center.numpy()).reshape(-1, len(labels))
        if isinstance(geo, Sphere):
            radii = np.asarray(geo.radius.numpy()).ravel()
            return sphere_surface(centers, radii)
        if isinstance(geo, Cylinder):
            radii = np.asarray(geo.radius.numpy()).ravel()
            depths = np.asarray(geo.depth.numpy()).ravel()
            return cylinder_surface(centers, radii, depths, axis_index=labels.index(geo.axis))
        assert isinstance(geo, BaseBox)
        half = np.asarray(geo.half_size.numpy()).reshape(-1, len(labels)) \
            if hasattr(geo, 'half_size') else np.asarray(geo.size.numpy()).reshape(-1, len(labels)) / 2
        return cuboid_surface(centers - half, centers + half)


class Graph3DP(_PlotlyRecipe):
    """Graph edges as 3D line segments."""

    def can_plot(self, data, space) -> bool:
        from ..geom._graph import Graph
        if isinstance(data, Graph):
            return data.spatial_rank == 3
        return isinstance(data, Field) and data.is_graph and data.spatial_rank == 3

    def plot(self, data, figure, subplot, space, **kwargs):
        graph = data.geometry if isinstance(data, Field) else data
        seg = graph_edge_segments(graph)  # (E, 2, 3)
        nan = np.full((seg.shape[0], 1, 3), np.nan)
        strip = np.concatenate([seg, nan], axis=1).reshape(-1, 3)
        figure.add_trace(go.Scatter3d(x=strip[:, 0], y=strip[:, 1], z=strip[:, 2], mode='lines'),
                         row=subplot[0] + 1, col=subplot[1] + 1)


class SplineSheet3DP(_PlotlyRecipe):
    """B-spline sheet surfaces as a tessellated Mesh3d."""

    def can_plot(self, data, space) -> bool:
        from ..geom._spline_sheet import BSplineSheet
        if isinstance(data, BSplineSheet):
            return True
        return isinstance(data, Field) and isinstance(getattr(data, 'geometry', None), BSplineSheet)

    def plot(self, data, figure, subplot, space, **kwargs):
        sheet = data if not isinstance(data, Field) else data.geometry
        verts, quads = sheet.to_mesh(nu=24, nv=24)
        verts = np.asarray(verts, np.float64).reshape(-1, 3)
        quads = np.asarray(quads, np.int64).reshape(-1, 4)
        faces = np.concatenate([quads[:, (0, 1, 2)], quads[:, (0, 2, 3)]])  # quads → 2 tris
        figure.add_trace(go.Mesh3d(x=verts[:, 0], y=verts[:, 1], z=verts[:, 2],
                                   i=faces[:, 0], j=faces[:, 1], k=faces[:, 2], opacity=0.9),
                         row=subplot[0] + 1, col=subplot[1] + 1)


class PlotlyPlots(PlottingLibrary):
    def __init__(self):
        super().__init__('plotly', [
            Heatmap2DP(), VectorField2DP(), Heatmap3DP(), PointCloud2DP(), LinePlotP(),
            VectorCloud3DP(), Object3DP(), Graph3DP(), SplineSheet3DP(),
            PointCloud3DP(), SurfaceMesh3DP(), SDF3DP(),
        ])

    def create_figure(self, size, rows, cols, subplots=None, titles=None, log_dims=()):
        figure = make_subplots(rows=rows, cols=cols)
        figure.update_layout(width=size[0] * 90, height=size[1] * 90)
        return figure, {(r, c): (r, c) for r in range(rows) for c in range(cols)}

    def finalize(self, figure):
        pass

    def show(self, figure):
        fig = figure[0] if isinstance(figure, tuple) else figure
        fig.show()

    def save(self, figure, path, dpi=120, transparent=False):
        fig = figure[0] if isinstance(figure, tuple) else figure
        if path.endswith('.html'):
            fig.write_html(path)
        else:
            fig.write_image(path)  # requires kaleido


PLOTLY = PlotlyPlots() if _PLOTLY_AVAILABLE else None

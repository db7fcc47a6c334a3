"""Matplotlib recipes — port of `phiflow_tpu/vis/_matplotlib_plots.py`:
heatmaps (2D scalar grids), quivers and streamlines (2D vector grids, a
staggered one at its centres), point clouds, vector clouds, line plots (1D),
geometries, 3D isosurfaces, quivers and scatters, meshes, heightmaps, bars
and histograms. The recipes hand matplotlib host copies of the Fields'
values (`Tensor.numpy`), wherever the Fields lie.

matplotlib is imported at first use (`_pyplot`, the Agg backend as the JAX
package sets it), not with the module: the card's machine may have none, and
`phiflow_tpu_torch.vis` and `flow` import there. A recipe called without
matplotlib raises ImportError naming it.
"""
from __future__ import annotations

import functools

import numpy as np

from ..math import Tensor
from ..field import Field
from ..geom import Geometry, BaseBox, Sphere
from ._vis_base import Recipe, PlottingLibrary


@functools.lru_cache(maxsize=None)
def _pyplot():
    """matplotlib.pyplot, imported once with the Agg backend; ImportError naming matplotlib where it is missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plotting with the matplotlib recipes needs matplotlib, which is not installed") from e
    matplotlib.use('Agg')  # headless default; callers may switch
    import matplotlib.pyplot as plt
    return plt


class MatplotlibPlots(PlottingLibrary):

    def __init__(self):
        super().__init__('matplotlib', [
            Heatmap2D(), VectorField2D(), PointCloud2D(), LinePlot(), Geometry2D(),
            # 3D recipes
            Heatmap3D(), VectorField3D(), VectorCloud2D(), PointCloud3D(), Geometry3D(),
            # specialized 2D
            StreamPlot2D(), Mesh2D(), Heightmap3D(), BarChart(), Histogram(),
        ])

    def create_figure(self, size, rows, cols, subplots=None, titles=None, log_dims=()):
        """subplots: optional {(row, col): '3d'} to create 3D axes at positions."""
        figure = _pyplot().figure(figsize=size)
        axes = {}
        for r in range(rows):
            for c in range(cols):
                proj = (subplots or {}).get((r, c))
                axes[(r, c)] = figure.add_subplot(rows, cols, r * cols + c + 1,
                                                  projection=proj)
        return figure, axes

    def finalize(self, figure):
        figure[0].tight_layout() if isinstance(figure, tuple) else figure.tight_layout()

    def show(self, figure):
        fig = figure[0] if isinstance(figure, tuple) else figure
        fig.show()

    def save(self, figure, path, dpi=120, transparent=False):
        fig = figure[0] if isinstance(figure, tuple) else figure
        fig.savefig(path, dpi=dpi, transparent=transparent)
        _pyplot().close(fig)


class Heatmap2D(Recipe):

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_grid and data.spatial_rank == 2 \
            and not data.shape.channel and data.is_centered

    def plot(self, data: Field, figure, axis, space, **kwargs):
        dims = data.resolution.names
        values = np.asarray(data.values.numpy(tuple(reversed(dims))))
        lower = np.asarray(data.bounds.lower.numpy())
        upper = np.asarray(data.bounds.upper.numpy())
        im = axis.imshow(values, origin='lower', extent=(lower[0], upper[0], lower[1], upper[1]),
                         cmap=kwargs.get('cmap', 'viridis'), aspect='auto')
        figure_obj = figure[0] if isinstance(figure, tuple) else figure
        figure_obj.colorbar(im, ax=axis)
        axis.set_xlabel(dims[0])
        axis.set_ylabel(dims[1])
        return im


class VectorField2D(Recipe):

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_grid and data.spatial_rank == 2 \
            and (data.is_staggered or 'vector' in data.shape)

    def plot(self, data: Field, figure, axis, space, **kwargs):
        if data.is_staggered:
            data = data.at_centers()
        dims = data.resolution.names
        centers = data.center
        x = np.asarray(centers.vector[dims[0]].numpy(dims))
        y = np.asarray(centers.vector[dims[1]].numpy(dims))
        u = np.asarray(data.values[{'vector': dims[0]}].numpy(dims))
        v = np.asarray(data.values[{'vector': dims[1]}].numpy(dims))
        # subsample for readability
        res = max(x.shape)
        stride = max(1, res // 24)
        sl = (slice(None, None, stride),) * 2
        q = axis.quiver(x[sl], y[sl], u[sl], v[sl], angles='xy')
        axis.set_xlabel(dims[0])
        axis.set_ylabel(dims[1])
        return q


class PointCloud2D(Recipe):

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_point_cloud and data.spatial_rank == 2

    def plot(self, data: Field, figure, axis, space, **kwargs):
        pts = data.points
        labels = pts.shape.get_labels('vector')
        x = np.asarray(pts.vector[labels[0]].numpy()).flatten()
        y = np.asarray(pts.vector[labels[1]].numpy()).flatten()
        return axis.scatter(x, y, s=kwargs.get('s', 6))


class LinePlot(Recipe):

    def can_plot(self, data, space) -> bool:
        if isinstance(data, Field):
            return data.is_grid and data.spatial_rank == 1
        return isinstance(data, Tensor) and data.rank <= 2

    def plot(self, data, figure, axis, space, **kwargs):
        if isinstance(data, Field):
            dim = data.resolution.names[0]
            x = np.asarray(data.center.vector[dim].numpy(dim))
            y = np.asarray(data.values.numpy(dim))
            return axis.plot(x, y)
        t = data
        if t.rank == 1:
            return axis.plot(np.asarray(t.numpy()))
        dims = t.shape.names
        return axis.plot(np.asarray(t.numpy(tuple(dims))))


class Geometry2D(Recipe):

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Geometry) and data.spatial_rank == 2

    def plot(self, data: Geometry, figure, axis, space, **kwargs):
        _pyplot()
        import matplotlib.patches as patches
        if isinstance(data, Sphere):
            centers = np.atleast_2d(np.asarray(data.center.numpy()).reshape(-1, 2))
            radius = np.atleast_1d(np.asarray(data.radius.numpy()).flatten())
            for i, c in enumerate(centers):
                r = radius[i % len(radius)]
                axis.add_patch(patches.Circle(c, r, fill=kwargs.get('fill', True), alpha=0.7))
        elif isinstance(data, BaseBox):
            lower = np.atleast_2d(np.asarray(data.lower.numpy()).reshape(-1, 2))
            upper = np.atleast_2d(np.asarray(data.upper.numpy()).reshape(-1, 2))
            for lo, up in zip(lower, upper):
                axis.add_patch(patches.Rectangle(lo, *(up - lo), fill=kwargs.get('fill', True), alpha=0.7))
        else:
            c = np.atleast_2d(np.asarray(data.center.numpy()).reshape(-1, 2))
            axis.scatter(c[:, 0], c[:, 1])
        axis.autoscale_view()


# ---------------------------------------------------------------------------
# 3D recipes
# ---------------------------------------------------------------------------

def _is3d_axis(axis) -> bool:
    return hasattr(axis, 'zaxis')


class Heatmap3D(Recipe):
    """3D scalar grid → isosurface (marching cubes) at the mid-value, with
    translucent shading."""

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_grid and data.spatial_rank == 3 \
            and not data.shape.channel and data.is_centered

    def plot(self, data: Field, figure, axis, space, **kwargs):
        dims = data.resolution.names
        values = np.asarray(data.values.numpy(dims))
        lo = float(np.nanmin(values))
        hi = float(np.nanmax(values))
        level = kwargs.get('level', lo + 0.5 * (hi - lo))
        dx = np.asarray(data.dx.numpy(data.dx.shape.names)).reshape(-1)
        lower = np.asarray(data.bounds.lower.numpy()).reshape(-1)
        try:
            from skimage.measure import marching_cubes
            verts, faces, *_ = marching_cubes(values, level=level, spacing=tuple(dx))
            verts = verts + lower
            from mpl_toolkits.mplot3d.art3d import Poly3DCollection
            poly = Poly3DCollection(verts[faces], alpha=0.5)
            poly.set_facecolor('tab:blue')
            axis.add_collection3d(poly)
            axis.set_xlim(lower[0], lower[0] + dx[0] * values.shape[0])
            axis.set_ylim(lower[1], lower[1] + dx[1] * values.shape[1])
            axis.set_zlim(lower[2], lower[2] + dx[2] * values.shape[2])
            result = poly
        except Exception:  # flat field or no skimage: fall back to mid-slice scatter
            result = axis.scatter(*np.nonzero(values > level), s=1)
        axis.set_xlabel(dims[0]); axis.set_ylabel(dims[1]); axis.set_zlabel(dims[2])
        return result


class VectorField3D(Recipe):
    """3D vector grid → subsampled quiver3d."""

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_grid and data.spatial_rank == 3 \
            and (data.is_staggered or 'vector' in data.shape)

    def plot(self, data: Field, figure, axis, space, **kwargs):
        if data.is_staggered:
            data = data.at_centers()
        dims = data.resolution.names
        centers = data.center
        coords = [np.asarray(centers.vector[d].numpy(dims)) for d in dims]
        comps = [np.asarray(data.values[{'vector': d}].numpy(dims)) for d in dims]
        stride = max(1, max(coords[0].shape) // 8)
        sl = (slice(None, None, stride),) * 3
        q = axis.quiver(*(c[sl] for c in coords), *(u[sl] for u in comps),
                        length=kwargs.get('length', float(np.mean([c.max() - c.min() for c in coords])) / 10),
                        normalize=kwargs.get('normalize', True))
        axis.set_xlabel(dims[0]); axis.set_ylabel(dims[1]); axis.set_zlabel(dims[2])
        return q


class PointCloud3D(Recipe):
    """3D point cloud → scatter3d."""

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_point_cloud and data.spatial_rank == 3

    def plot(self, data: Field, figure, axis, space, **kwargs):
        pts = data.points
        labels = pts.shape.get_labels('vector')
        xyz = [np.asarray(pts.vector[l].numpy()).flatten() for l in labels]
        return axis.scatter(*xyz, s=kwargs.get('s', 4))


class VectorCloud2D(Recipe):
    """Vector values on a 2D point cloud → quiver at the points."""

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_point_cloud and data.spatial_rank == 2 \
            and 'vector' in data.values.shape

    def plot(self, data: Field, figure, axis, space, **kwargs):
        pts = data.points
        labels = pts.shape.get_labels('vector')
        x = np.asarray(pts.vector[labels[0]].numpy()).flatten()
        y = np.asarray(pts.vector[labels[1]].numpy()).flatten()
        u = np.asarray(data.values[{'vector': labels[0]}].numpy()).flatten()
        v = np.asarray(data.values[{'vector': labels[1]}].numpy()).flatten()
        return axis.quiver(x, y, u, v, angles='xy')


class Geometry3D(Recipe):
    """3D geometries → surface mesh (via geom.surface_mesh) or center scatter."""

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Geometry) and data.spatial_rank == 3

    def plot(self, data: Geometry, figure, axis, space, **kwargs):
        try:
            from ..geom._convert import surface_mesh
            verts, faces = surface_mesh(data, rel_dx=0.05)
            from mpl_toolkits.mplot3d.art3d import Poly3DCollection
            poly = Poly3DCollection(verts[faces], alpha=0.6)
            axis.add_collection3d(poly)
            return poly
        except Exception:
            c = np.atleast_2d(np.asarray(data.center.numpy()).reshape(-1, 3))
            return axis.scatter(c[:, 0], c[:, 1], c[:, 2])


# ---------------------------------------------------------------------------
# specialized 2D recipes
# ---------------------------------------------------------------------------

class StreamPlot2D(Recipe):
    """Streamlines of a 2D vector grid.
    Select with plot(..., plot_type='stream')."""

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_grid and data.spatial_rank == 2 \
            and (data.is_staggered or 'vector' in data.shape)

    def plot(self, data: Field, figure, axis, space, **kwargs):
        if data.is_staggered:
            data = data.at_centers()
        dims = data.resolution.names
        centers = data.center
        # streamplot needs strictly increasing 1D x/y (rows = y)
        x = np.asarray(centers.vector[dims[0]].numpy(dims))[:, 0]
        y = np.asarray(centers.vector[dims[1]].numpy(dims))[0, :]
        u = np.asarray(data.values[{'vector': dims[0]}].numpy(tuple(reversed(dims))))
        v = np.asarray(data.values[{'vector': dims[1]}].numpy(tuple(reversed(dims))))
        res = axis.streamplot(x, y, u, v, density=kwargs.get('density', 1.0))
        axis.set_xlabel(dims[0]); axis.set_ylabel(dims[1])
        return res


class Histogram(Recipe):
    """Histogram of tensor values.
    Select with plot_type='histogram' (LinePlot otherwise matches 1D data)."""

    def can_plot(self, data, space) -> bool:
        if isinstance(data, Field):
            data = data.values
        return isinstance(data, Tensor)

    def plot(self, data, figure, axis, space, **kwargs):
        if isinstance(data, Field):  # a value per point: a point cloud's default value is one number
            from ..math import _ops as ops
            data = ops.expand(data.values, data.geometry.shape.non_channel) if data.is_point_cloud else data.values
        vals = np.asarray(data.numpy()).flatten()
        vals = vals[np.isfinite(vals)]
        return axis.hist(vals, bins=kwargs.get('bins', 20))


class BarChart(Recipe):
    """Bar chart of a labeled 1D tensor."""

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Tensor) and data.rank == 1 and data.shape.channel \
            and data.shape.dims[0].labels is not None

    def plot(self, data: Tensor, figure, axis, space, **kwargs):
        labels = data.shape.dims[0].labels
        return axis.bar(list(labels), np.asarray(data.numpy()).flatten())


class Mesh2D(Recipe):
    """Scalar field on an unstructured 2D mesh → tripcolor over cell centers
    (the FVM visualization path)."""

    def can_plot(self, data, space) -> bool:
        return isinstance(data, Field) and data.is_mesh and data.spatial_rank == 2

    def plot(self, data: Field, figure, axis, space, **kwargs):
        centers = np.asarray(data.geometry.center.numpy(('cells', 'vector')))
        vals = data.values
        if 'vector' in vals.shape:  # magnitude for vector fields
            from ..math import _ops as ops
            vals = ops.vec_length(vals)
        v = np.asarray(vals.numpy()).reshape(-1)
        t = axis.tripcolor(centers[:, 0], centers[:, 1], v, cmap=kwargs.get('cmap', 'viridis'))
        figure_obj = figure[0] if isinstance(figure, tuple) else figure
        figure_obj.colorbar(t, ax=axis)
        return t


class Heightmap3D(Recipe):
    """Heightmap geometry → 3D surface plot."""

    def can_plot(self, data, space) -> bool:
        from ..geom._heightmap import Heightmap
        return isinstance(data, Heightmap)

    def plot(self, data, figure, axis, space, **kwargs):
        heights = np.asarray(data.height.numpy(data.height.shape.names))
        if heights.ndim == 1:  # 1D heightmap: line plot
            return axis.plot(heights)
        x = np.arange(heights.shape[0])
        y = np.arange(heights.shape[1])
        X, Y = np.meshgrid(x, y, indexing='ij')
        return axis.plot_surface(X, Y, heights, cmap=kwargs.get('cmap', 'terrain'))


MATPLOTLIB = MatplotlibPlots()

"""plot / show and the interactive helpers — port of `phiflow_tpu/vis/_vis.py`.
matplotlib is reached through `_matplotlib_plots._pyplot` at first use."""
from __future__ import annotations

import os
import numpy as np

from ..math import Tensor
from ..field import Field
from ..geom import Geometry
from ._vis_base import Control, Action, display_name
from ._matplotlib_plots import MATPLOTLIB, _pyplot

__all__ = ['plot', 'show', 'show_hist', 'close', 'control', 'action', 'overlay', 'write_image',
           'plot_scalars', 'smooth']

_CONTROLS: list = []
_ACTIONS: list = []


def plot(*fields, lib=None, row_dims=None, col_dims=None, animate=None, overlay=None,
         title=None, size=(12, 5), same_scale=True, show_color_bar=True, **kwargs):
    """Create a figure for Fields / Tensors / Geometries. Returns (figure, axes)."""
    if isinstance(lib, str):
        if lib == 'matplotlib':
            lib = MATPLOTLIB
        elif lib == 'plotly':
            from ._plotly_plots import PLOTLY
            assert PLOTLY is not None, "plotly is not installed in this environment"
            lib = PLOTLY
        else:
            raise ValueError(f"unknown plotting library {lib!r} (matplotlib, plotly)")
    lib = lib or MATPLOTLIB
    items = []
    for f in fields:
        if isinstance(f, dict):
            items.extend(f.items())
        elif isinstance(f, tuple) and len(f) == 2 and f[0] == '__overlay__':
            items.append((None, f))  # overlay marker: all fields share one axis
        elif isinstance(f, (tuple, list)):
            items.extend((None, x) for x in f)
        else:
            items.append((None, f))
    # row_dims/col_dims: lay out batch dims of a single field over subplots
    if (row_dims or col_dims) and len(items) == 1 and isinstance(items[0][1], (Field, Tensor)):
        name0, data0 = items[0]
        shp = data0.shape
        r_names = [d for d in ([row_dims] if isinstance(row_dims, str) else (row_dims or [])) if d in shp.names]
        c_names = [d for d in ([col_dims] if isinstance(col_dims, str) else (col_dims or [])) if d in shp.names]
        if r_names or c_names:
            import itertools as _it
            r_sizes = [shp.get_size(d) for d in r_names] or [1]
            c_sizes = [shp.get_size(d) for d in c_names] or [1]
            items = []
            for r_idx in _it.product(*[range(s) for s in r_sizes]):
                for c_idx in _it.product(*[range(s) for s in c_sizes]):
                    sel = {**dict(zip(r_names, r_idx)), **dict(zip(c_names, c_idx))}
                    label = ' '.join(f"{k}={v}" for k, v in sel.items())
                    items.append((label if not name0 else f"{name0} {label}", data0[sel]))
            cols = int(np.prod(c_sizes))
            rows = int(np.prod(r_sizes))
            projections = {(i // cols, i % cols): '3d' for i, (_, data) in enumerate(items)
                           if _needs_3d_axis(data)}
            figure, axes = lib.create_figure(size, rows, cols, subplots=projections or None)
            for i, (nm, data) in enumerate(items):
                axis = axes[(i // cols, i % cols)]
                lib.plot(data, figure, axis, None, **kwargs)
                if nm:
                    axis.set_title(display_name(nm))
            lib.finalize(figure)
            return figure
    n = len(items)
    cols = min(n, 3)
    rows = (n + cols - 1) // cols
    projections = {(i // cols, i % cols): '3d' for i, (_, data) in enumerate(items)
                   if _needs_3d_axis(data)}
    figure, axes = lib.create_figure(size, rows, cols, subplots=projections or None)
    if animate is not None:
        return _animate(lib, figure, axes, items, cols, animate, **kwargs)
    for i, (name, data) in enumerate(items):
        axis = axes[(i // cols, i % cols)]
        if isinstance(data, tuple) and len(data) == 2 and data[0] == '__overlay__':
            for layer in data[1]:
                lib.plot(layer, figure, axis, None, **kwargs)
        else:
            lib.plot(data, figure, axis, None, **kwargs)
        if name:
            axis.set_title(display_name(name))
        elif title:
            axis.set_title(title if isinstance(title, str) else str(title))
    lib.finalize(figure)
    return figure


def _needs_3d_axis(data) -> bool:
    from ..geom._heightmap import Heightmap
    if isinstance(data, tuple) and len(data) == 2 and data[0] == '__overlay__':
        return any(_needs_3d_axis(layer) for layer in data[1])
    if isinstance(data, Field):
        return data.spatial_rank == 3
    if isinstance(data, Heightmap):
        return True
    if isinstance(data, Geometry):
        return data.spatial_rank == 3
    return False


def _animate(lib, figure, axes, items, cols, animate_dim: str, fps=10, **kwargs):
    """Frame-by-frame animation over a batch dim."""
    _pyplot()
    import matplotlib.animation as animation
    frames = None
    for _, data in items:
        shp = data.shape if hasattr(data, 'shape') else None
        if shp is not None and animate_dim in getattr(shp, 'names', ()):
            frames = shp.get_size(animate_dim)
            break
    assert frames is not None, f"no item has the animation dim {animate_dim!r}"
    fig = figure[0] if isinstance(figure, tuple) else figure

    def draw(frame):
        for i, (name, data) in enumerate(items):
            axis = axes[(i // cols, i % cols)]
            axis.clear()
            sliced = data[{animate_dim: frame}] if hasattr(data, '__getitem__') else data
            lib.plot(sliced, figure, axis, None, **kwargs)
            if name:
                axis.set_title(display_name(name))
        return []

    anim = animation.FuncAnimation(fig, draw, frames=frames, interval=1000 / fps, blit=False)
    return anim


def show(*fields, **kwargs):
    """Plot and display."""
    if fields and not isinstance(fields[0], (Field, Tensor, Geometry, dict, tuple, list)):
        raise ValueError(f"show() cannot display {type(fields[0])}")
    figure = plot(*fields, **kwargs)
    MATPLOTLIB.show(figure)
    return figure


def show_hist(data, bins=20, **kwargs):
    """Plot and display a histogram of the given values."""
    figure = plot(data, plot_type='histogram', bins=bins, **kwargs)
    MATPLOTLIB.show(figure)
    return figure


def close(figure=None):
    _pyplot().close(figure[0] if isinstance(figure, tuple) else figure)


def write_image(path: str, figure=None, dpi=120., close_figure=False, transparent=True):
    """Save a figure to an image file."""
    if figure is None:
        figure = _pyplot().gcf()
    MATPLOTLIB.save(figure, os.path.expanduser(path), dpi=dpi, transparent=transparent)


def control(value, range_=None, description="", **kwargs):
    """Declare a UI-controllable value."""
    ctrl = Control(name=f"control{len(_CONTROLS)}", control_type=type(value), initial=value,
                   value_range=range_, description=description, kwargs=kwargs)
    _CONTROLS.append(ctrl)
    return value


def action(fn):
    """Register a UI-triggerable action."""
    act = Action(fn.__name__, fn, fn.__doc__ or "")
    _ACTIONS.append(act)
    return fn


def overlay(*fields):
    """Mark fields to be plotted into the same axis."""
    return ('__overlay__', fields)


def plot_scalars(curves: dict, size=(8, 4)):
    fig, ax = _pyplot().subplots(figsize=size)
    for name, values in curves.items():
        arr = np.asarray(values.numpy() if isinstance(values, Tensor) else values)
        if arr.ndim == 2:
            ax.plot(arr[:, 0], arr[:, 1], label=name)
        else:
            ax.plot(arr, label=name)
    ax.legend()
    return fig


def smooth(curve, n: int = 10):
    """Moving-average smoothing of a curve."""
    arr = np.asarray(curve.numpy() if isinstance(curve, Tensor) else curve, np.float64)
    if n <= 1:
        return curve
    kernel = np.ones(n) / n
    if arr.ndim == 2:
        sm = arr.copy()
        sm[:, 1] = np.convolve(arr[:, 1], kernel, mode='same')
        return sm
    return np.convolve(arr, kernel, mode='same')

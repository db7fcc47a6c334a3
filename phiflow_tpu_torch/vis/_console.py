"""ASCII console plots — port of `phiflow_tpu/vis/_console.py`: a 2D scalar
grid as shades, a 2D vector grid as arrows (host copies of the values)."""
from __future__ import annotations

import numpy as np

from ..field import Field

__all__ = ['heatmap', 'quiver']

_SHADES = ' .:-=+*#%@'


def heatmap(field: Field, cols: int = 64, rows: int = 24) -> str:
    """Render a 2D scalar grid as ASCII art."""
    assert field.is_grid and field.spatial_rank == 2
    dims = field.resolution.names
    values = np.asarray(field.values.numpy(tuple(reversed(dims))))
    ny, nx = values.shape
    yi = np.linspace(0, ny - 1, rows).astype(int)
    xi = np.linspace(0, nx - 1, cols).astype(int)
    sub = values[np.ix_(yi, xi)]
    lo, hi = np.nanmin(sub), np.nanmax(sub)
    rng = hi - lo if hi > lo else 1.0
    normalized = ((sub - lo) / rng * (len(_SHADES) - 1)).astype(int)
    lines = [''.join(_SHADES[v] for v in row) for row in normalized[::-1]]
    return '\n'.join(lines) + f"\n[{lo:.3g} … {hi:.3g}]"


def quiver(field: Field, cols: int = 32, rows: int = 16) -> str:
    """Render a 2D vector field as ASCII arrows."""
    arrows = "→↗↑↖←↙↓↘"
    if field.is_staggered:
        field = field.at_centers()
    dims = field.resolution.names
    u = np.asarray(field.values[{'vector': dims[0]}].numpy(tuple(reversed(dims))))
    v = np.asarray(field.values[{'vector': dims[1]}].numpy(tuple(reversed(dims))))
    ny, nx = u.shape
    yi = np.linspace(0, ny - 1, rows).astype(int)
    xi = np.linspace(0, nx - 1, cols).astype(int)
    mag = np.sqrt(u ** 2 + v ** 2)
    threshold = np.nanmax(mag) * 0.05 if np.nanmax(mag) > 0 else 1
    lines = []
    for y in yi[::-1]:
        line = []
        for x in xi:
            if mag[y, x] < threshold:
                line.append('·')
            else:
                angle = np.arctan2(v[y, x], u[y, x])
                idx = int(np.round(angle / (np.pi / 4))) % 8
                line.append(arrows[idx])
        lines.append(''.join(line))
    return '\n'.join(lines)

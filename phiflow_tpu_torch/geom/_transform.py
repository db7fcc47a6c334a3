"""Rotations — port of `phiflow_tpu/geom/_transform.py::rotation_matrix` and
`rotate_vector`: a scalar angle in 2D; in 3D a vector of Euler angles (the
rotation about x, then y, then z) or a scalar (about z).

The matrix is built on the host in float32, as the geometry's other numbers
are. `rotation_matrix(angle, labels)` has JAX's signature and returns it as a
host Tensor with dims (~vector, vector); `rotation_matrix_native(angle, ndim)`
returns the numpy array that `rotate_vector` and the obstacle masks use on
vectors given as sequences of per-axis tensors (`geom/_geom.py`).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..math import Tensor, channel, concat_shapes, dual

__all__ = ['rotation_matrix', 'rotation_matrix_native', 'rotate_vector']


def rotation_matrix(angle, labels=('x', 'y')) -> Tensor:
    """The rotation as a host Tensor R[~vector=row, vector=col] over the axes
    `labels`, with y_row = Σ_col R[row, col]·x_col."""
    labels = tuple(labels)
    m = rotation_matrix_native(angle.numpy() if isinstance(angle, Tensor) else angle, len(labels))
    return Tensor(m, concat_shapes(dual(vector=labels), channel(vector=labels)))


def rotation_matrix_native(angle, ndim: int) -> np.ndarray:
    """The (ndim, ndim) float32 matrix R with y_row = Σ_col R[row, col]·x_col."""
    f32 = np.float32
    angle = np.asarray(angle, f32)
    if ndim == 2:
        if angle.ndim != 0:
            raise ValueError(f"a 2D rotation is one angle, got shape {angle.shape}")
        c, s = np.cos(angle), np.sin(angle)
        return np.array([[c, -s], [s, c]], f32)
    if ndim == 3:
        if angle.ndim == 0:
            ax = ay = f32(0.)
            az = angle
        elif angle.shape == (3,):
            ax, ay, az = angle
        else:
            raise ValueError(f"a 3D rotation is one angle or three Euler angles, got shape {angle.shape}")
        cx, sx = np.cos(ax), np.sin(ax)
        cy, sy = np.cos(ay), np.sin(ay)
        cz, sz = np.cos(az), np.sin(az)
        # R = Rz @ Ry @ Rx
        return np.array([[cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
                         [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
                         [-sy, cy * sx, cy * cx]], f32)
    raise NotImplementedError(f"rotation in {ndim}D")


def rotate_vector(v: Sequence[torch.Tensor], angle, invert: bool = False) -> Tuple[torch.Tensor, ...]:
    """Rotate the vector field `v` (one tensor per axis) by `angle`; with
    ``invert`` by the inverse rotation R⁻¹ = Rᵀ."""
    if angle is None:
        return tuple(v)
    d = len(v)
    m = rotation_matrix_native(angle, d)
    if invert:
        m = m.T
    out = []
    for row in range(d):
        acc = None
        for col in range(d):
            term = float(m[row, col]) * v[col]
            acc = term if acc is None else acc + term
        out.append(acc)
    return tuple(out)

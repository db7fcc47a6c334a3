"""Rotations — port of `phiflow_tpu/geom/_transform.py`: `rotation_matrix`
and `rotate_vector` (a scalar angle in 2D; in 3D a vector of Euler angles, the
rotation about x, then y, then z, or a scalar, about z), `rotation_angles`,
`rotation_matrix_from_axis_and_angle` (Rodrigues) and
`rotation_matrix_from_directions`.

The matrix is built on the host in float32, as the geometry's other numbers
are. `rotation_matrix(angle, labels)` has JAX's signature and returns it as a
host Tensor with dims (~vector, vector); `rotation_matrix_native(angle, ndim)`
returns the numpy array that `rotate_vector` and the obstacle masks use on
vectors given as sequences of per-axis tensors (`geom/_geom.py`);
`rotate_vector` also takes a vector Tensor, as the JAX package's does.
The axis-angle and two-direction forms are built from Tensors, on their
device.
"""
from __future__ import annotations

import numpy as np

from ..math import Tensor, channel, concat_shapes, dual, rename_dims, stack, wrap

__all__ = ['rotation_matrix', 'rotation_matrix_native', 'rotate_vector', 'rotation_angles',
           'rotation_matrix_from_axis_and_angle', 'rotation_matrix_from_directions']


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


def rotate_vector(v, angle, invert: bool = False):
    """Rotate the vector field `v` (one tensor per axis, or a Tensor with a
    `vector` dim) by `angle` (or a rotation matrix Tensor); with ``invert``
    by the inverse rotation R⁻¹ = Rᵀ."""
    if isinstance(v, Tensor):
        from ..math._ops import sum_
        if angle is None:
            return v
        labels = v.shape.get_labels('vector')
        m = angle if isinstance(angle, Tensor) and '~vector' in angle.shape else rotation_matrix(angle, labels)
        if invert:
            return sum_(m * rename_dims(v, 'vector', dual(vector=labels)), '~vector')
        return rename_dims(sum_(m * v, 'vector'), '~vector', channel(vector=labels))
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


def rotation_angles(matrix: Tensor):
    """The angle of a 2D rotation matrix."""
    from ..math._ops import arctan2
    if len(matrix.shape.get_labels('vector')) == 2:
        return arctan2(matrix[{'vector': 1, '~vector': 0}], matrix[{'vector': 0, '~vector': 0}])
    raise NotImplementedError("3D rotation_angles")


def _matrix(m, labels) -> Tensor:
    rows = [stack({labels[c]: m[r][c] for c in range(len(labels))}, channel(vector=labels), expand_values=True)
            for r in range(len(labels))]
    return stack({labels[r]: rows[r] for r in range(len(labels))}, dual(vector=labels), expand_values=True)


def rotation_matrix_from_axis_and_angle(axis, angle, vec_dim='vector', is_axis_normalized=False,
                                        epsilon=1e-5) -> Tensor:
    """The 3D rotation by `angle` about `axis` (Rodrigues' formula)."""
    from ..math._ops import cos, sin, vec_normalize
    axis = axis if isinstance(axis, Tensor) else wrap(axis)
    labels = axis.shape.get_labels('vector')
    if len(labels) != 3:
        raise ValueError(f"an axis-angle rotation is 3D, got the axis {axis.shape}")
    if not is_axis_normalized:
        axis = vec_normalize(axis, epsilon=epsilon)
    angle = wrap(angle)
    c, s = cos(angle), sin(angle)
    t = 1 - c
    x, y, z = (axis.vector[n] for n in labels)
    return _matrix([[t * x * x + c, t * x * y - s * z, t * x * z + s * y],
                    [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
                    [t * x * z - s * y, t * y * z + s * x, t * z * z + c]], labels)


def rotation_matrix_from_directions(source_dir: Tensor, target_dir: Tensor, vec_dim='vector', epsilon=1e-5) -> Tensor:
    """The rotation taking the direction `source_dir` to `target_dir`."""
    from ..math._ops import arctan2, cross, safe_div, sum_, vec, vec_length, vec_normalize, where
    source_dir = vec_normalize(source_dir, epsilon=epsilon)
    target_dir = vec_normalize(target_dir, epsilon=epsilon)
    labels = source_dir.shape.get_labels('vector')
    if len(labels) == 2:
        a_s = arctan2(source_dir.vector[labels[1]], source_dir.vector[labels[0]])
        a_t = arctan2(target_dir.vector[labels[1]], target_dir.vector[labels[0]])
        return rotation_matrix(a_t - a_s, labels)
    axis = cross(source_dir, target_dir)
    sin_a = vec_length(axis, eps=1e-12)
    angle = arctan2(sin_a, sum_(source_dir * target_dir, 'vector'))
    safe_axis = where(sin_a > epsilon, safe_div(axis, sin_a), vec(**{labels[0]: 1., labels[1]: 0., labels[2]: 0.}))
    return rotation_matrix_from_axis_and_angle(safe_axis, angle, is_axis_normalized=True)

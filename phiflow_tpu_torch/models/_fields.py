"""The crossing between a model's array state and its Field state: raw
tensors wrapped as the values of the model's own Fields, and back, without a
copy — a staggered grid's face components stay the stored tensors, as a
`TensorStack` keeps them."""
from __future__ import annotations

from ..field._field import face_components, face_values
from ..math import Tensor

__all__ = ['staggered_values', 'staggered_natives', 'cell_values', 'cell_native']


def staggered_values(like, components):
    """The face `components` (raw tensors in the grid's dim order) as the
    values of the staggered Field `like`."""
    names = like.resolution.names
    return face_values([Tensor(c, t.shape.only(names, reorder=True))
                        for c, t in zip(components, face_components(like.values))], like.values)


def staggered_natives(field):
    """The raw face components of a staggered Field, in its grid's dim order."""
    names = field.resolution.names
    return tuple(c.native(names) for c in face_components(field.values))


def cell_values(like, array) -> Tensor:
    """A raw cell array as the values of the centred Field `like`."""
    return Tensor(array, like.resolution)


def cell_native(field):
    """The raw array of a centred Field, in its grid's dim order."""
    return field.values.native(field.resolution.names)

"""The crossing between a model's array state and its Field state: raw
tensors wrapped as the values of the model's own Fields, and back, without a
copy — a staggered grid's face components stay the stored tensors, as a
`TensorStack` keeps them. Batch dims are the arrays' leading axes."""
from __future__ import annotations

from ..field._field import face_components, face_values
from ..field._field_math import _batch_tensor
from ..math import EMPTY_SHAPE, Tensor

__all__ = ['staggered_values', 'staggered_natives', 'cell_values', 'cell_native']


def staggered_values(like, components, batch=EMPTY_SHAPE):
    """The face `components` (raw tensors in the grid's dim order, `batch`'s
    dims leading where a component has more axes than the grid) as the
    values of the staggered Field `like`."""
    names = like.resolution.names
    return face_values([_batch_tensor(c, batch if c.ndim > len(names) else EMPTY_SHAPE,
                                      t.shape.only(names, reorder=True))
                        for c, t in zip(components, face_components(like.values))], like.values)


def staggered_natives(field):
    """The raw face components of a staggered Field, in its grid's dim order
    after its batch dims (each component with the batch dims it has)."""
    names = field.resolution.names
    return tuple(c.native(c.shape.batch.names + names) for c in face_components(field.values))


def cell_values(like, array, batch=EMPTY_SHAPE) -> Tensor:
    """A raw cell array as the values of the centred Field `like`, `batch`'s
    dims leading where it has more axes than the grid."""
    return _batch_tensor(array, batch if array.ndim > like.resolution.rank else EMPTY_SHAPE, like.resolution)


def cell_native(field):
    """The raw array of a centred Field, in its grid's dim order after its batch dims."""
    return field.values.native(field.values.shape.batch.names + field.resolution.names)

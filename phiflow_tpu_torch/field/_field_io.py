"""Field ⇄ .npz files — port of `phiflow_tpu/field/_field_io.py` (`write`,
`read`), in the same schema, so that a file either package writes reads in
the other: one `.npz` a grid Field with its values (`data`; a staggered
grid's components padded to resolution + 1 and stacked along `vector`),
`dim_names`, `dim_types`, `dim_item_names` (labels joined by commas),
`field_type` ('CenteredGrid' or 'StaggeredGrid'), the bounds' `lower` and
`upper`, and the boundary as JSON (`extrapolation`). The JAX package
deflates its files (`np.savez_compressed`); the port stores them
(`np.savez`), since float data barely compresses and deflating is most of
a write's time; `np.load` reads either. A Tensor of file names writes and
reads one file an entry. A read Field's values land on the default device
(`math.set_default_device`), bit for bit as written.
"""
from __future__ import annotations

import json
import os
from typing import Union

import numpy as np

from ..math import Shape, Tensor, channel, get_default_device, spatial, wrap
from ..math import extrapolation as extrapolation_mod
from ..math._shape import Dim
from ..math._tensor import to_torch
from ..geom import Box
from ._field import Field
from ._grid import CenteredGrid, StaggeredGrid

__all__ = ['write', 'read']


def _names(file: Tensor):
    """(index, file name) of each entry of a Tensor of file names."""
    for idx in file.shape.meshgrid():
        yield idx, str(np.asarray(file[idx].numpy()))


def write(field: Field, file: Union[str, Tensor]):
    """Write a grid Field to `<file>.npz` (the suffix added where missing,
    the directory created). A Tensor of file names writes one file an entry,
    the Field sliced along the names' dims it has."""
    if isinstance(file, Tensor):
        for idx, name in _names(file):
            write(field[{k: v for k, v in idx.items() if k in field.shape}], name)
        return
    if not field.is_grid:
        raise ValueError(f"write() only supports grids, got {type(field.geometry).__name__}")
    data = field.staggered_tensor() if field.is_staggered else field.values
    if not file.endswith('.npz'):
        file += '.npz'
    os.makedirs(os.path.dirname(os.path.abspath(file)), exist_ok=True)
    shape = data.shape
    np.savez(file,
             data=np.asarray(data.numpy(shape.names)),
             dim_names=np.array(shape.names),
             dim_types=np.array(shape.types),
             dim_item_names=np.array([','.join(l) if l else '' for l in shape.labels]),
             field_type=np.array('StaggeredGrid' if field.is_staggered else 'CenteredGrid'),
             lower=np.asarray(field.bounds.lower.numpy()), upper=np.asarray(field.bounds.upper.numpy()),
             extrapolation=np.array(json.dumps(field.boundary.to_dict())))



def read(file: Union[str, Tensor], convert_to_backend=True) -> Field:
    """A Field written by `write` (by either package). A Tensor of file names
    reads one file an entry and stacks the Fields along the names' dims."""
    if isinstance(file, Tensor):
        from ._field_math import stack_fields
        result = [read(name) for _, name in _names(file)]
        for d in reversed(file.shape.dims):
            n = d.size
            result = [stack_fields(result[i:i + n], Shape((d,))) for i in range(0, len(result), n)]
        return result[0]
    if not file.endswith('.npz'):
        file += '.npz'
    with np.load(file, allow_pickle=False) as data:
        arr = data['data']
        dim_names = [str(n) for n in data['dim_names']]
        dim_types = [str(t) for t in data['dim_types']]
        dim_item_names = [str(i) for i in data['dim_item_names']]
        field_type = str(data['field_type'])
        lower, upper = data['lower'], data['upper']
        extrap = extrapolation_mod.from_dict(json.loads(str(data['extrapolation'])))
    shape = Shape(tuple(Dim(name, size, kind, tuple(items.split(',')) if items else None)
                        for name, size, kind, items in zip(dim_names, arr.shape, dim_types, dim_item_names)))
    values = Tensor(to_torch(arr, get_default_device()), shape)
    names = [d.name for d in shape.dims if d.dim_type == 'spatial']
    bounds = Box(wrap(lower.astype(np.float32), channel(vector=names)),
                 wrap(upper.astype(np.float32), channel(vector=names)))
    if field_type == 'StaggeredGrid':
        return StaggeredGrid(values, extrap, bounds=bounds,
                             resolution=spatial(**{n: shape.get_size(n) - 1 for n in names}))
    return CenteredGrid(values, extrap, bounds=bounds)

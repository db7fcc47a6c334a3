"""Layout — a copy of `phiflow_tpu/math/_layout.py`, which touches no
array: arbitrary python trees (lists/dicts/tuples) as named-dim tensors
(phiml's `Layout`; the visualisation organises heterogeneous plot data so).

A Layout does NOT copy or convert its content: it assigns named dims to the
nesting levels so tree data can be sliced/unstacked/iterated with the same
dim-name API as numeric tensors. Dict keys become labels on the layout dim.
"""
from __future__ import annotations

from typing import Any, Sequence

from ._shape import Shape, Dim, EMPTY_SHAPE, batch, channel, concat_shapes

__all__ = ['Layout', 'layout']


class Layout:
    """A python tree with named dims assigned to its nesting levels."""

    def __init__(self, obj: Any, shape: Shape):
        self._obj = obj
        self._shape = shape

    @property
    def shape(self) -> Shape:
        return self._shape

    @property
    def native(self):
        return self._obj

    @property
    def rank(self) -> int:
        return self._shape.rank

    @property
    def dtype(self):
        return object

    def __getitem__(self, item) -> Any:
        if not isinstance(item, dict):
            if self._shape.rank == 0:
                raise IndexError("cannot index a leaf Layout")
            item = {self._shape.names[0]: item}
        obj, shape = self._obj, self._shape
        for name, sel in item.items():
            if name not in shape.names:
                continue
            depth = shape.names.index(name)
            assert depth == 0, "slice outer layout dims first"
            dim = shape.dims[0]
            if isinstance(sel, str) and dim.labels:
                sel = dim.labels.index(sel)
            if isinstance(obj, dict):
                values = list(obj.values())
                keys = list(obj.keys())
            else:
                values = list(obj)
                keys = None
            if isinstance(sel, int):
                obj = values[sel]
                shape = shape[1:]
            elif isinstance(sel, slice):
                picked = values[sel]
                if keys is not None:
                    obj = dict(zip(keys[sel], picked))
                else:
                    obj = picked
                new_labels = dim.labels[sel] if dim.labels else None
                shape = concat_shapes(Shape((Dim(dim.name, len(picked), dim.dim_type, new_labels),)), shape[1:])
            else:
                raise TypeError(f"cannot index layout with {sel!r}")
        if isinstance(shape, Shape) and shape.rank and isinstance(obj, (dict, list, tuple)):
            return Layout(obj, shape)
        return obj

    def __iter__(self):
        if self._shape.rank == 0:
            yield self._obj
            return
        n = self._shape.sizes[0]
        for i in range(n):
            yield self[{self._shape.names[0]: i}]

    def __len__(self):
        return self._shape.sizes[0] if self._shape.rank else 1

    def unstack(self, dim: str = None):
        dim = dim or self._shape.names[0]
        return tuple(self[{dim: i}] for i in range(self._shape.get_size(dim)))

    def __repr__(self):
        return f"Layout[{self._shape}]"


def layout(obj: Any, *dims: Shape) -> Layout:
    """Assign named dims to the nesting levels of a python tree
    (reference API: phiml `math.layout`). With no dims, one batch dim per
    nesting level is inferred (dict keys become labels)."""
    if dims:
        shape = dims[0]
        for d in dims[1:]:
            shape = concat_shapes(shape, d)
        # fill dict labels where missing
        new_dims = []
        level_obj = obj
        for d in shape.dims:
            if isinstance(level_obj, dict):
                labels = tuple(str(k) for k in level_obj.keys())
                new_dims.append(Dim(d.name, len(labels), d.dim_type, d.labels or labels))
                level_obj = next(iter(level_obj.values())) if level_obj else None
            else:
                size = len(level_obj) if isinstance(level_obj, (list, tuple)) else d.size
                new_dims.append(Dim(d.name, size, d.dim_type, d.labels))
                level_obj = level_obj[0] if isinstance(level_obj, (list, tuple)) and level_obj else None
        return Layout(obj, Shape(tuple(new_dims)))
    # infer: one batch dim per nesting level
    dims_list = []
    level_obj = obj
    level = 0
    while isinstance(level_obj, (dict, list, tuple)):
        if isinstance(level_obj, dict):
            labels = tuple(str(k) for k in level_obj.keys())
            dims_list.append(Dim(f'layout{level}', len(labels), 'batch', labels))
            level_obj = next(iter(level_obj.values())) if level_obj else None
        else:
            dims_list.append(Dim(f'layout{level}', len(level_obj), 'batch', None))
            level_obj = level_obj[0] if level_obj else None
        level += 1
    return Layout(obj, Shape(tuple(dims_list)))

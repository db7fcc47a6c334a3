"""Slicing helpers, `BoundDim` attribute access and the solve exceptions —
port of `phiflow_tpu/math/_magic.py`."""
from __future__ import annotations


class IncompatibleShapes(Exception):
    def __init__(self, message, *shapes):
        super().__init__(message)
        self.shapes = shapes


class ConvergenceException(Exception):
    """Raised when a linear/nonlinear solve does not meet its tolerances."""
    def __init__(self, result):
        super().__init__(getattr(result, 'msg', 'solve did not converge'))
        self.result = result


class Diverged(ConvergenceException):
    pass


class NotConverged(ConvergenceException):
    pass


class BoundDim:
    """Attribute-as-dim access: ``tensor.x[0]``, ``field.vector['x']``, ``t.x.size``.

    """
    __slots__ = ('obj', 'name')

    def __init__(self, obj, name: str):
        self.obj = obj
        self.name = name

    @property
    def exists(self):
        return self.name in self.obj.shape

    @property
    def size(self):
        return self.obj.shape.get_size(self.name)

    @property
    def labels(self):
        return self.obj.shape.get_labels(self.name)

    item_names = labels

    @property
    def dim_type(self):
        return self.obj.shape.get_dim_type(self.name)

    def __getitem__(self, item):
        return self.obj[{self.name: item}]

    def __iter__(self):
        for i in range(self.size):
            yield self.obj[{self.name: i}]

    def unstack(self):
        return tuple(self)

    def __repr__(self):
        return f"{type(self.obj).__name__}.{self.name}"


def slicing_dict(obj, item) -> dict:
    """Normalize `obj[item]` arguments to a dict of dim-name → selection."""
    if isinstance(item, dict):
        result = {}
        for k, v in item.items():
            if isinstance(k, str) and ',' in k:
                for k_ in k.split(','):
                    result[k_.strip()] = v
            else:
                from ._shape import Shape
                result[k.name if isinstance(k, Shape) else k] = v
        return result
    if isinstance(item, tuple) and len(item) and all(isinstance(i, dict) for i in item):
        merged = {}
        for i in item:
            merged.update(i)
        return slicing_dict(obj, merged)
    shape = obj.shape
    if isinstance(item, (int, slice)):
        if shape.channel.rank == 1:
            return {shape.channel.name: item}
        if shape.rank == 1:
            return {shape.name: item}
        raise ValueError(f"cannot infer dim for {type(obj).__name__}[{item!r}] with shape {shape}")
    if isinstance(item, str):
        # label-based selection on the (single) labeled dim
        for d in shape.dims:
            if d.labels and all(i.strip() in d.labels for i in item.split(',')):
                return {d.name: item}
        raise ValueError(f"no dim with labels matching {item!r} in {shape}")
    raise ValueError(f"invalid slicing: {item!r}")

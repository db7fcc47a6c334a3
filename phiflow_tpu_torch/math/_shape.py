"""Named, typed dimensions — port of `phiflow_tpu/math/_shape.py`.

Every named-dim object of the port carries a `Shape`: an immutable, hashable
tuple of `Dim` records, each of one of five types:

  * ``batch``    — independent simulations side by side;
  * ``spatial``  — grid axes (x, y, z);
  * ``channel``  — components of one sample point (e.g. ``vector='x,y'``),
                   with item names ("labels");
  * ``instance`` — unordered collections (particles);
  * ``dual``     — face dims, spelled ``~name``: the components of a
                   staggered grid.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple, Union

__all__ = [
    'Dim', 'Shape', 'EMPTY_SHAPE',
    'BATCH', 'SPATIAL', 'CHANNEL', 'INSTANCE', 'DUAL',
    'batch', 'spatial', 'channel', 'instance', 'dual',
    'shape_of', 'merge_shapes', 'concat_shapes', 'parse_dim_order',
    'DimFilter', 'non_batch', 'non_spatial', 'non_channel', 'non_instance', 'non_dual', 'primal',
]

# Dim type constants (ordered: canonical display order is batch, dual, instance, spatial, channel)
BATCH = 'batch'
DUAL = 'dual'
INSTANCE = 'instance'
SPATIAL = 'spatial'
CHANNEL = 'channel'

_TYPE_ORDER = {BATCH: 0, DUAL: 1, INSTANCE: 2, SPATIAL: 3, CHANNEL: 4}
_TYPE_ABBREV = {BATCH: 'ᵇ', DUAL: 'ᵈ', INSTANCE: 'ⁱ', SPATIAL: 'ˢ', CHANNEL: 'ᶜ'}


class Dim:
    """One named dimension: (name, size, type, labels).

    ``labels`` (phiml: "item names") are per-index names along the dim,
    e.g. ``('x', 'y')`` for a 2D ``vector`` channel dim. ``size`` may be
    ``None`` for undefined-size dims (used in dim-filter expressions) and in a
    non-uniform stack the stack owner tracks per-component sizes.
    """
    __slots__ = ('name', 'size', 'dim_type', 'labels')

    def __init__(self, name: str, size: Optional[int], dim_type: str, labels: Optional[Tuple[str, ...]] = None):
        assert dim_type in _TYPE_ORDER, f"invalid dim type {dim_type!r}"
        if dim_type == DUAL and not name.startswith('~'):
            name = '~' + name
        assert isinstance(name, str) and name, f"invalid dim name {name!r}"
        if labels is not None:
            labels = tuple(labels)
            if size is None:
                size = len(labels)
            assert len(labels) == size, f"labels {labels} do not match size {size} for dim '{name}'"
        self.name = name
        self.size = None if size is None else int(size)
        self.dim_type = dim_type
        self.labels = labels

    def with_size(self, size, labels=None) -> 'Dim':
        if isinstance(size, str):
            labels = tuple(s.strip() for s in size.split(','))
            size = len(labels)
        elif isinstance(size, (tuple, list)) and size and all(isinstance(s, str) for s in size):
            labels = tuple(size)
            size = len(labels)
        if labels is None and self.labels is not None and self.size == size:
            labels = self.labels
        return Dim(self.name, size, self.dim_type, labels)

    def as_type(self, dim_type: str) -> 'Dim':
        name = self.name
        if self.dim_type == DUAL and dim_type != DUAL:
            name = name.lstrip('~')
        return Dim(name, self.size, dim_type, self.labels)

    @property
    def is_batch(self): return self.dim_type == BATCH
    @property
    def is_spatial(self): return self.dim_type == SPATIAL
    @property
    def is_channel(self): return self.dim_type == CHANNEL
    @property
    def is_instance(self): return self.dim_type == INSTANCE
    @property
    def is_dual(self): return self.dim_type == DUAL

    def __eq__(self, other):
        if not isinstance(other, Dim):
            return NotImplemented
        return (self.name == other.name and self.size == other.size
                and self.dim_type == other.dim_type and self.labels == other.labels)

    def __hash__(self):
        return hash((self.name, self.size, self.dim_type, self.labels))

    def __repr__(self):
        lbl = ':' + ','.join(self.labels) if self.labels else ''
        return f"{self.name}={self.size}{_TYPE_ABBREV[self.dim_type]}{lbl}"


class Shape:
    """Immutable ordered collection of `Dim`s. Hashable."""
    __slots__ = ('dims', '_by_name', '_names', '_derived')

    def __init__(self, dims: Sequence[Dim] = ()):
        dims = tuple(dims)
        self.dims = dims
        self._by_name = {d.name: i for i, d in enumerate(dims)}
        assert len(self._by_name) == len(dims), f"duplicate dim names in {dims}"
        self._names = tuple(d.name for d in dims)
        self._derived = {}  # filtered shapes, computed once: a Shape is immutable

    # --- basic accessors ---
    @property
    def names(self) -> Tuple[str, ...]:
        return self._names

    @property
    def sizes(self) -> Tuple[Optional[int], ...]:
        return tuple(d.size for d in self.dims)

    @property
    def types(self) -> Tuple[str, ...]:
        return tuple(d.dim_type for d in self.dims)

    @property
    def rank(self) -> int:
        return len(self.dims)

    @property
    def volume(self) -> int:
        v = 1
        for d in self.dims:
            assert d.size is not None, f"volume of undefined shape {self}"
            v *= d.size
        return v

    @property
    def is_empty(self) -> bool:
        return not self.dims

    @property
    def well_defined(self) -> bool:
        return all(d.size is not None for d in self.dims)

    @property
    def name(self) -> str:
        assert len(self.dims) == 1, f".name requires a single dim, got {self}"
        return self.dims[0].name

    @property
    def size(self) -> int:
        assert len(self.dims) == 1, f".size requires a single dim, got {self}"
        return self.dims[0].size

    @property
    def dim_type(self) -> str:
        assert len(self.dims) == 1, f".dim_type requires a single dim, got {self}"
        return self.dims[0].dim_type

    @property
    def labels(self):
        """Tuple of per-dim label tuples (phiml: item_names)."""
        return tuple(d.labels for d in self.dims)

    @property
    def item_names(self):
        return self.labels

    def get_labels(self, dim: Union[str, 'Shape', Dim]):
        return self.get_dim(_dim_name(dim)).labels

    def get_size(self, dim: Union[str, 'Shape', Dim]) -> int:
        return self.get_dim(_dim_name(dim)).size

    def get_dim_type(self, dim) -> str:
        return self.get_dim(_dim_name(dim)).dim_type

    def get_dim(self, name: str) -> Dim:
        if name not in self._by_name:
            raise KeyError(f"dim '{name}' not in {self}")
        return self.dims[self._by_name[name]]

    def index(self, dim: Union[str, 'Shape', Dim]) -> int:
        """Axis position of `dim` in the native array."""
        return self._by_name[_dim_name(dim)]

    def indices(self, dims) -> Tuple[int, ...]:
        return tuple(self._by_name[n] for n in parse_dim_order(dims))

    def __contains__(self, item) -> bool:
        if isinstance(item, Dim):
            return item.name in self._by_name
        if isinstance(item, Shape):
            return all(n in self._by_name for n in item.names)
        if isinstance(item, str):
            return all(n.strip() in self._by_name for n in item.split(',')) if ',' in item else item in self._by_name
        if isinstance(item, (tuple, list)):
            return all(n in self for n in item)
        return NotImplemented

    def __len__(self):
        return len(self.dims)

    def __iter__(self):
        for d in self.dims:
            yield Shape((d,))

    def __bool__(self):
        return bool(self.dims)

    # --- filtering ---
    def _filtered(self, pred) -> 'Shape':
        return Shape(tuple(d for d in self.dims if pred(d)))

    def _of_type(self, dim_type: str, keep: bool) -> 'Shape':
        key = (dim_type, keep)
        if key not in self._derived:
            self._derived[key] = Shape(tuple(d for d in self.dims if (d.dim_type == dim_type) == keep))
        return self._derived[key]

    @property
    def batch(self): return self._of_type(BATCH, True)
    @property
    def spatial(self): return self._of_type(SPATIAL, True)
    @property
    def channel(self): return self._of_type(CHANNEL, True)
    @property
    def instance(self): return self._of_type(INSTANCE, True)
    @property
    def dual(self): return self._of_type(DUAL, True)
    @property
    def non_batch(self): return self._of_type(BATCH, False)
    @property
    def non_spatial(self): return self._of_type(SPATIAL, False)
    @property
    def non_channel(self): return self._of_type(CHANNEL, False)
    @property
    def non_instance(self): return self._of_type(INSTANCE, False)
    @property
    def non_dual(self): return self._filtered(lambda d: not d.is_dual)
    @property
    def primal(self): return self._filtered(lambda d: not d.is_dual and not d.is_batch)

    def only(self, dims: 'DimFilter', reorder=False) -> 'Shape':
        names = _resolve_filter(dims, self)
        if reorder:
            return Shape(tuple(self.get_dim(n) for n in names if n in self._by_name))
        return self._filtered(lambda d: d.name in names)

    def without(self, dims: 'DimFilter') -> 'Shape':
        names = _resolve_filter(dims, self)
        return self._filtered(lambda d: d.name not in names)

    def __sub__(self, other):
        return self.without(other)

    def __and__(self, other: 'Shape') -> 'Shape':
        return merge_shapes(self, other)

    def __add__(self, other):
        """Add to all sizes (phiml: shape arithmetic, e.g. ``spatial(x=64)+1``)."""
        if isinstance(other, int):
            return Shape(tuple(Dim(d.name, d.size + other, d.dim_type) for d in self.dims))
        return NotImplemented

    # --- modification (returns new Shape) ---
    def with_size(self, size, labels=None) -> 'Shape':
        assert len(self.dims) == 1
        return Shape((self.dims[0].with_size(size, labels),))

    def with_sizes(self, sizes) -> 'Shape':
        if isinstance(sizes, Shape):
            new = []
            for d in self.dims:
                if d.name in sizes:
                    sd = sizes.get_dim(d.name)
                    new.append(Dim(d.name, sd.size, d.dim_type, sd.labels or d.labels))
                else:
                    new.append(d)
            return Shape(tuple(new))
        sizes = tuple(sizes)
        assert len(sizes) == len(self.dims)
        return Shape(tuple(d.with_size(s) for d, s in zip(self.dims, sizes)))

    def with_dim_size(self, dim, size, labels=None) -> 'Shape':
        name = _dim_name(dim)
        return Shape(tuple(d.with_size(size, labels) if d.name == name else d for d in self.dims))

    def replace(self, old, new: 'Shape') -> 'Shape':
        """Replace dim(s) `old` with the dims of `new` (in place of the first)."""
        old_names = parse_dim_order(old)
        dims = []
        inserted = False
        for d in self.dims:
            if d.name in old_names:
                if not inserted:
                    dims.extend(new.dims)
                    inserted = True
            else:
                dims.append(d)
        return Shape(tuple(dims))

    def as_batch(self): return Shape(tuple(d.as_type(BATCH) for d in self.dims))
    def as_spatial(self): return Shape(tuple(d.as_type(SPATIAL) for d in self.dims))
    def as_channel(self): return Shape(tuple(d.as_type(CHANNEL) for d in self.dims))
    def as_instance(self): return Shape(tuple(d.as_type(INSTANCE) for d in self.dims))
    def as_dual(self): return Shape(tuple(d.as_type(DUAL) for d in self.dims))

    @property
    def reversed(self) -> 'Shape':
        return Shape(tuple(reversed(self.dims)))

    def transposed_to(self, order) -> 'Shape':
        names = parse_dim_order(order)
        assert set(names) == set(self.names)
        return Shape(tuple(self.get_dim(n) for n in names))

    # --- comparison / display ---
    def __eq__(self, other):
        if not isinstance(other, Shape):
            return NotImplemented
        return self.dims == other.dims

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return '(' + ', '.join(repr(d) for d in self.dims) + ')'

    def __getitem__(self, item):
        if isinstance(item, int):
            return Shape((self.dims[item],))
        if isinstance(item, slice):
            return Shape(self.dims[item])
        if isinstance(item, str):
            return self.only(item, reorder=True)
        if isinstance(item, (tuple, list)):
            return Shape(tuple(self.dims[i] if isinstance(i, int) else self.get_dim(i) for i in item))
        raise TypeError(item)

    def __getattr__(self, name):
        # allow shape.x → Shape of dim 'x' (single-dim access)
        if name.startswith('_'):
            raise AttributeError(name)
        try:
            return Shape((self.get_dim(name),))
        except KeyError:
            raise AttributeError(f"shape {self} has no dim '{name}'")

    def is_uniform(self):
        return True

    def meshgrid(self):
        """Iterate over all index combinations as dicts name→index."""
        import itertools
        ranges = [range(d.size) for d in self.dims]
        for combo in itertools.product(*ranges):
            yield dict(zip(self.names, combo))


EMPTY_SHAPE = Shape(())


def _dim_name(dim) -> str:
    if isinstance(dim, str):
        return dim.strip()
    if isinstance(dim, Shape):
        return dim.name
    if isinstance(dim, Dim):
        return dim.name
    raise TypeError(f"expected dim name, got {dim!r}")


def parse_dim_order(dims) -> Tuple[str, ...]:
    if dims is None:
        return ()
    if type(dims) is tuple and all(type(d) is str and d and ',' not in d and d == d.strip() for d in dims):
        return dims
    if isinstance(dims, str):
        return tuple(s.strip() for s in dims.split(',') if s.strip())
    if isinstance(dims, Shape):
        return dims.names
    if isinstance(dims, Dim):
        return (dims.name,)
    if isinstance(dims, (tuple, list)):
        result = []
        for d in dims:
            result.extend(parse_dim_order(d))
        return tuple(result)
    raise TypeError(f"cannot parse dim order from {dims!r}")


DimFilter = Union[str, tuple, list, Shape, callable, None]


def _resolve_filter(dims: DimFilter, against: Shape) -> Tuple[str, ...]:
    """Resolve a dim filter (string, Shape, callable like `spatial`, tuple) to dim names."""
    if dims is None:
        return ()
    if callable(dims) and not isinstance(dims, Shape):
        return dims(against).names
    if isinstance(dims, (tuple, list)):
        result = []
        for d in dims:
            result.extend(_resolve_filter(d, against))
        return tuple(result)
    return parse_dim_order(dims)


def _make_dims(dim_type: str, *args, **dims) -> Shape:
    """Shared constructor logic for batch()/spatial()/channel()/instance()/dual()."""
    result = []
    for arg in args:
        if isinstance(arg, str):
            for part in arg.split(','):
                part = part.strip()
                if not part:
                    continue
                if '=' in part:
                    name, size = part.split('=')
                    result.append(Dim(name.strip(), int(size), dim_type))
                else:
                    result.append(Dim(part, None, dim_type))
        elif isinstance(arg, Shape):
            result.extend(d.as_type(dim_type) for d in arg.dims)
        elif hasattr(arg, 'shape'):  # Tensor, Field, Geometry, ...
            s = arg.shape
            result.extend(d for d in s.dims if d.dim_type == dim_type)
        elif arg is None:
            continue
        else:
            raise TypeError(f"cannot construct dims from {arg!r}")
    for name, size in dims.items():
        labels = None
        if isinstance(size, str):
            labels = tuple(s.strip() for s in size.split(','))
            size = len(labels)
        elif isinstance(size, (tuple, list)):
            if all(isinstance(s, str) for s in size) and len(size) > 0:
                labels = tuple(size)
                size = len(labels)
            else:
                raise TypeError(f"invalid size {size!r} for dim '{name}'")
        elif isinstance(size, Shape):
            labels = size.names
            size = len(labels)
        result.append(Dim(name, size, dim_type, labels))
    return Shape(tuple(result))


def batch(*args, **dims) -> Shape:
    """Create batch dims or filter batch dims of an object: ``batch(b=10)``, ``batch(tensor)``."""
    if not dims and len(args) == 1 and not isinstance(args[0], str):
        return shape_of(args[0]).batch
    return _make_dims(BATCH, *args, **dims)


def spatial(*args, **dims) -> Shape:
    if not dims and len(args) == 1 and not isinstance(args[0], str):
        return shape_of(args[0]).spatial
    return _make_dims(SPATIAL, *args, **dims)


def channel(*args, **dims) -> Shape:
    if not dims and len(args) == 1 and not isinstance(args[0], str):
        return shape_of(args[0]).channel
    return _make_dims(CHANNEL, *args, **dims)


def instance(*args, **dims) -> Shape:
    if not dims and len(args) == 1 and not isinstance(args[0], str):
        return shape_of(args[0]).instance
    return _make_dims(INSTANCE, *args, **dims)


def dual(*args, **dims) -> Shape:
    if not dims and len(args) == 1 and not isinstance(args[0], str):
        return shape_of(args[0]).dual
    return _make_dims(DUAL, *args, **dims)


def non_batch(obj) -> Shape: return shape_of(obj).non_batch
def non_spatial(obj) -> Shape: return shape_of(obj).non_spatial
def non_channel(obj) -> Shape: return shape_of(obj).non_channel
def non_instance(obj) -> Shape: return shape_of(obj).non_instance
def non_dual(obj) -> Shape: return shape_of(obj).non_dual
def primal(obj) -> Shape: return shape_of(obj).primal


def shape_of(obj) -> Shape:
    if isinstance(obj, Shape):
        return obj
    if hasattr(obj, 'shape') and isinstance(obj.shape, Shape):
        return obj.shape
    if isinstance(obj, (int, float, complex, bool)) or obj is None:
        return EMPTY_SHAPE
    import numpy as np
    if isinstance(obj, np.ndarray) and obj.ndim == 0:
        return EMPTY_SHAPE
    import torch
    if isinstance(obj, torch.Tensor) and obj.ndim == 0:
        return EMPTY_SHAPE
    if isinstance(obj, (tuple, list)):
        return channel(vector=len(obj))
    raise TypeError(f"cannot determine shape of {type(obj)}")


def merge_shapes(*shapes: Shape, allow_varying_sizes=False) -> Shape:
    """Merge shapes: union of dims ordered by (type-priority, first-appearance). Sizes must match."""
    merged: dict = {}
    for s in shapes:
        if s is None:
            continue
        if not isinstance(s, Shape):
            s = shape_of(s)
        for d in s.dims:
            if d.name in merged:
                old = merged[d.name]
                if old.size is None:
                    merged[d.name] = d
                elif d.size is not None and old.size != d.size:
                    if allow_varying_sizes:
                        merged[d.name] = Dim(d.name, None, d.dim_type, None)
                    else:
                        from ._magic import IncompatibleShapes
                        raise IncompatibleShapes(f"cannot merge {shapes}: dim '{d.name}' has sizes {old.size} and {d.size}", *shapes)
                elif old.labels is None and d.labels is not None:
                    merged[d.name] = d
            else:
                merged[d.name] = d
    dims = sorted(merged.values(), key=lambda d: _TYPE_ORDER[d.dim_type])
    # stable sort keeps first-appearance order within each type group
    return Shape(tuple(dims))


def concat_shapes(*shapes: Shape) -> Shape:
    """Concatenate shapes in order (no reordering, names must be unique)."""
    dims = []
    for s in shapes:
        if s is not None:
            dims.extend(s.dims)
    return Shape(tuple(dims))


def after_gather(shape: Shape, selection: dict) -> Shape:
    """Shape after indexing with dict of name→(int | slice | list)."""
    dims = []
    for d in shape.dims:
        if d.name in selection:
            sel = selection[d.name]
            if isinstance(sel, int):
                continue  # dim removed
            if isinstance(sel, str) and d.labels:
                if ',' in sel:
                    names = tuple(s.strip() for s in sel.split(','))
                    dims.append(Dim(d.name, len(names), d.dim_type, names))
                else:
                    continue  # single label → dim removed
            elif isinstance(sel, slice):
                start, stop, step = sel.indices(d.size)
                n = max(0, (stop - start + (step - (1 if step > 0 else -1))) // step)
                labels = d.labels[sel] if d.labels else None
                dims.append(Dim(d.name, n, d.dim_type, labels))
            elif isinstance(sel, (tuple, list)):
                labels = tuple(d.labels[i] for i in sel) if d.labels else None
                dims.append(Dim(d.name, len(sel), d.dim_type, labels))
            else:
                dims.append(d)  # tensor-valued index keeps dim
        else:
            dims.append(d)
    return Shape(tuple(dims))

"""Named-dim Tensor over `torch.Tensor` — port of `phiflow_tpu/math/_tensor.py`.

A `Tensor` pairs one native array, whose axes follow its `Shape`'s dim order,
with that `Shape`. The native is a `torch.Tensor` on the card or the CPU, or a
numpy array for constants on the host: numbers, geometry coordinates,
extrapolation values and cell sizes stay numpy, as the JAX package keeps them
(its `_keep_host`), so comparisons of such constants never touch the device
and host arithmetic rounds exactly as it does there. A host constant moves to
the device of the torch tensor it meets (a 0-dim one as a CPU scalar, which
torch takes into a CUDA kernel without a copy), or to the default device
(`set_default_device`) where the array layer needs a torch tensor.

`TensorStack` holds one uniform Tensor per entry of its stack dim: the faces of
a staggered grid (N−1 entries on a closed axis) stay the separate component
tensors they are, and reach the kernels without a copy.
"""
from __future__ import annotations

import operator
from typing import Sequence, Tuple

import numpy as np
import torch

from ._shape import (
    Shape, Dim, EMPTY_SHAPE, channel, merge_shapes, concat_shapes, parse_dim_order,
)
from ._magic import BoundDim, slicing_dict, IncompatibleShapes

__all__ = ['Tensor', 'TensorStack', 'wrap', 'tensor', 'precision', 'set_global_precision', 'get_precision',
           'default_float', 'backend_dtype', 'set_default_device', 'get_default_device', 'default_device',
           'NUMPY']

# --- precision ---
_PRECISION = [32]


def set_global_precision(bits: int):
    assert bits in (16, 32, 64)
    _PRECISION[0] = bits


def get_precision() -> int:
    return _PRECISION[0]


class precision:
    """``with math.precision(64): ...`` — the float width of new values."""

    def __init__(self, bits: int):
        assert bits in (16, 32, 64)
        self.bits = bits

    def __enter__(self):
        self.old = _PRECISION[0]
        _PRECISION[0] = self.bits

    def __exit__(self, *args):
        _PRECISION[0] = self.old


def default_float():
    """The numpy float type of the current precision."""
    return {16: np.float16, 32: np.float32, 64: np.float64}[_PRECISION[0]]


def backend_dtype(kind='float'):
    if kind == 'float':
        return default_float()
    if kind == 'int':
        return np.int32
    if kind == 'complex':
        return np.complex64 if _PRECISION[0] <= 32 else np.complex128
    if kind == 'bool':
        return np.bool_
    raise ValueError(kind)


class _NumpyContext:
    """``with math.NUMPY:`` of the JAX package: a no-op here as there."""

    def __enter__(self):
        return self

    def __exit__(self, *args):
        return False


NUMPY = _NumpyContext()

# --- device ---
_DEVICE = [None]


def _resolve(device) -> torch.device:
    from .. import resolve_device
    return resolve_device(device)


def set_default_device(device):
    """Where host constants go when the array layer needs them as torch
    tensors: None (the card) or 'cpu'. Choosing 'cuda' without a card raises."""
    _resolve(device)
    _DEVICE[0] = device


def get_default_device() -> torch.device:
    """The default device; raises when it is the card and no card is present."""
    return _resolve(_DEVICE[0])


class default_device:
    """``with math.default_device('cpu'): ...``"""

    def __init__(self, device):
        _resolve(device)
        self.device = device

    def __enter__(self):
        self.old = _DEVICE[0]
        _DEVICE[0] = self.device

    def __exit__(self, *args):
        _DEVICE[0] = self.old


# --- natives ---
_TORCH_DTYPES = {np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64, np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64, np.dtype(np.bool_): torch.bool,
                 np.dtype(np.complex64): torch.complex64, np.dtype(np.complex128): torch.complex128}


def _is_host(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic))


def to_torch(native, device=None) -> torch.Tensor:
    """A native as a torch tensor: itself, or a host array on `device` (the
    default device when None). A broadcast host view moves as its compact base
    and is expanded on the device."""
    if isinstance(native, torch.Tensor):
        return native
    arr = np.asarray(native)
    device = get_default_device() if device is None else torch.device(device)
    if arr.ndim and 0 in arr.strides and arr.size:
        compact = arr[tuple(slice(0, 1) if s == 0 else slice(None) for s in arr.strides)]
        return to_torch(np.array(compact), device).expand(arr.shape)
    arr = np.ascontiguousarray(arr).reshape(arr.shape)  # ascontiguousarray makes a 0-dim array 1-dim
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy()).to(device)


def _host(native) -> np.ndarray:
    if isinstance(native, torch.Tensor):
        return native.detach().cpu().numpy()
    return np.asarray(native)


def _meet(a, b):
    """Two natives as operands of one arithmetic operation: both host, or a
    host scalar as a Python number (as the array layer passes its constants,
    a scalar operand of the kernel) and a host array on the torch operand's
    device."""
    a_host, b_host = _is_host(a), _is_host(b)
    if a_host == b_host:
        return a, b
    if a_host:
        return _operand(a, b), b
    return a, _operand(b, a)


def _operand(x, like: torch.Tensor):
    x = np.asarray(x)
    return x.item() if x.ndim == 0 else to_torch(x, like.device)


def _host_to(x, like: torch.Tensor) -> torch.Tensor:
    """A host array as a torch tensor on `like`'s device."""
    return to_torch(np.asarray(x), like.device)


def _fix_host_dtype(result, *inputs):
    """numpy promotes f32 ⋆ i32 to f64 and i32 / i32 to f64; the JAX package
    keeps host math at the current precision (its `_keep_host`), and so does
    this port."""
    if isinstance(result, (np.ndarray, np.generic)):
        result = np.asarray(result)
        if result.dtype == np.float64 and get_precision() != 64 \
                and not any(getattr(i, 'dtype', None) == np.float64 for i in inputs):
            result = result.astype(np.float32)
        elif result.dtype == np.int64 and not any(getattr(i, 'dtype', None) == np.int64 for i in inputs):
            result = result.astype(np.int32)
        elif result.dtype == np.complex128 and get_precision() != 64 \
                and not any(getattr(i, 'dtype', None) == np.complex128 for i in inputs):
            result = result.astype(np.complex64)
    return result


class Tensor:
    """Uniform named-dim tensor: one native (torch or numpy) + `Shape`. Immutable."""
    __slots__ = ('_native', '_shape')
    __array_priority__ = 100.0
    __array_ufunc__ = None  # numpy defers to the reflected operators

    def __init__(self, native, shape: Shape):
        assert isinstance(shape, Shape), f"shape must be Shape, got {type(shape)}"
        if not isinstance(native, (torch.Tensor, np.ndarray)):
            native = np.asarray(native)
        assert tuple(native.shape) == tuple(shape.sizes), \
            f"native shape {tuple(native.shape)} does not match {shape}"
        self._native = native
        self._shape = shape

    # --- core accessors ---
    @property
    def shape(self) -> Shape:
        return self._shape

    @property
    def dtype(self):
        return self._native.dtype

    @property
    def rank(self) -> int:
        return self._shape.rank

    @property
    def available(self) -> bool:
        return True

    @property
    def is_host(self) -> bool:
        """True for a numpy native (a constant on the host)."""
        return _is_host(self._native)

    @property
    def device(self):
        return None if self.is_host else self._native.device

    def native(self, order=None):
        """The native array with its axes in `order` (missing dims get size 1).
        Returns the stored array itself when the order already matches."""
        if order is None:
            return self._native
        names = parse_dim_order(order)
        if names == self._shape.names:
            return self._native
        return _align_native(self._native, self._shape, names)

    def numpy(self, order=None) -> np.ndarray:
        return _host(self.native(order))

    def torch(self, order=None, device=None) -> torch.Tensor:
        """The native as a torch tensor with its axes in `order`: itself when it
        is one, else the host constant on `device` (default device if None)."""
        return to_torch(self.native(order), device)

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype)

    def tolist(self):
        return self.numpy().tolist()

    def item(self):
        return self._native.item()

    def __float__(self):
        return float(self._native)

    def __int__(self):
        return int(self._native)

    def __bool__(self):
        return bool(self._native)

    def __len__(self):
        assert self.rank >= 1
        return self._shape.sizes[0]

    # --- shape manipulation ---
    def _transposed(self, order_names: Tuple[str, ...]) -> 'Tensor':
        perm = tuple(self._shape.index(n) for n in order_names)
        if perm == tuple(range(self.rank)):
            return self
        n = self._native
        native = np.transpose(n, perm) if _is_host(n) else n.permute(perm)
        return Tensor(native, Shape(tuple(self._shape.get_dim(n) for n in order_names)))

    def _with_shape(self, shape: Shape) -> 'Tensor':
        return Tensor(self._native, shape)

    def _expand(self, dims: Shape) -> 'Tensor':
        """Add new dims in front (broadcast views); existing dims are kept."""
        new = [d for d in dims.dims if d.name not in self._shape]
        if not new:
            return self
        target = tuple(d.size for d in new) + tuple(self._shape.sizes)
        native = self._native.reshape((1,) * len(new) + tuple(self._shape.sizes))
        native = np.broadcast_to(native, target) if _is_host(native) else native.expand(target)
        return Tensor(native, Shape(tuple(new) + self._shape.dims))

    # --- slicing ---
    def __getitem__(self, item):
        sel = slicing_dict(self, item)
        return self._getitem_dict(sel)

    def _getitem_dict(self, sel: dict) -> 'Tensor':
        if not sel:
            return self
        idx = []
        for d in self._shape.dims:
            if d.name in sel:
                s = sel[d.name]
                if isinstance(s, str):
                    assert d.labels, f"dim {d.name} has no labels"
                    s = [d.labels.index(n.strip()) for n in s.split(',')] if ',' in s else d.labels.index(s.strip())
                if isinstance(s, Shape):
                    assert d.labels
                    s = [d.labels.index(n) for n in s.names]
                if isinstance(s, (tuple, list)):
                    if s and all(isinstance(n, str) for n in s):
                        assert d.labels, f"dim {d.name} has no labels"
                        s = [d.labels.index(n) for n in s]
                    s = list(s)
                idx.append(s)
            else:
                idx.append(slice(None))
        native = self._native
        offset = 0
        for axis, s in enumerate(idx):
            if isinstance(s, slice) and s == slice(None):
                continue
            ax = axis - offset
            if isinstance(s, list):
                native = np.take(native, s, axis=ax) if _is_host(native) else \
                    torch.index_select(native, ax, torch.tensor(s, device=native.device))
            elif isinstance(s, slice) and not _is_host(native) and s.step is not None and s.step < 0:
                native = torch.flip(native, (ax,))[(slice(None),) * ax + (slice(None, None, -s.step),)]
            else:
                native = native[(slice(None),) * ax + (s,)]
            if isinstance(s, int):
                offset += 1
        return Tensor(native, _shape_after_getitem(self._shape, sel))

    def __getattr__(self, name):
        if name.startswith('_') or name in ('shape', 'dtype'):
            raise AttributeError(name)
        shape = self.shape
        if name in shape:
            return BoundDim(self, name)
        if '~' + name in shape:
            return BoundDim(self, '~' + name)
        raise AttributeError(f"{type(self).__name__} has no attribute '{name}' (shape: {shape})")

    def dimension(self, name):
        return BoundDim(self, name)

    def _unstack(self, dim: str) -> tuple:
        axis = self._shape.index(dim)
        new_shape = self._shape.without(dim)
        n = self._native
        sl = (slice(None),) * axis
        return tuple(Tensor(n[sl + (i,)], new_shape) for i in range(self._shape.get_size(dim)))

    # --- arithmetic ---
    def _op1(self, fn) -> 'Tensor':
        """`fn` applied to the native; host results keep the current precision."""
        return Tensor(_fix_host_dtype(fn(self._native), self._native), self._shape)

    def _op2(self, other, fn, reverse=False) -> 'Tensor':
        if isinstance(other, TensorStack):
            return NotImplemented
        if isinstance(other, Tensor):
            if other._shape.rank == 0 and _is_host(other._native) and not _is_host(self._native):
                return self._op2(other._native.item(), fn, reverse)  # a host number: a scalar operand
            if self._shape.rank == 0 and _is_host(self._native) and not _is_host(other._native):
                return other._op2(self._native.item(), fn, not reverse)
            a, b, shape = _broadcast(self, other)
            a, b = _meet(a, b)
            res = fn(b, a) if reverse else fn(a, b)
            return Tensor(_fix_host_dtype(res, a, b), shape)
        if isinstance(other, np.generic):
            # a float32 scalar keeps its type on the host (numpy rounds as the JAX package does there);
            # any other numpy scalar acts as the Python number it holds
            other = np.asarray(other) if self.is_host and other.dtype == np.float32 else other.item()
        if isinstance(other, (int, float, bool, complex)) or (isinstance(other, np.ndarray) and other.ndim == 0) \
                or (isinstance(other, torch.Tensor) and other.ndim == 0):
            a = self._native
            if isinstance(other, np.ndarray) and not _is_host(a):
                other = other.item()
            elif isinstance(other, torch.Tensor) and _is_host(a):
                a = _host_to(a, other)
            res = fn(other, a) if reverse else fn(a, other)
            return Tensor(_fix_host_dtype(res, a), self._shape)
        if isinstance(other, (tuple, list, np.ndarray, torch.Tensor)):
            other = wrap(other, channel(vector=len(other)))
            return self._op2(other, fn, reverse)
        return NotImplemented

    def __add__(self, other): return self._op2(other, operator.add)
    def __radd__(self, other): return self._op2(other, operator.add, reverse=True)
    def __sub__(self, other): return self._op2(other, operator.sub)
    def __rsub__(self, other): return self._op2(other, operator.sub, reverse=True)
    def __mul__(self, other): return self._op2(other, operator.mul)
    def __rmul__(self, other): return self._op2(other, operator.mul, reverse=True)
    def __truediv__(self, other): return self._op2(other, operator.truediv)
    def __rtruediv__(self, other): return self._op2(other, operator.truediv, reverse=True)
    def __floordiv__(self, other): return self._op2(other, operator.floordiv)
    def __rfloordiv__(self, other): return self._op2(other, operator.floordiv, reverse=True)
    def __mod__(self, other): return self._op2(other, operator.mod)
    def __rmod__(self, other): return self._op2(other, operator.mod, reverse=True)
    def __pow__(self, other): return self._op2(other, operator.pow)
    def __rpow__(self, other): return self._op2(other, operator.pow, reverse=True)
    def __neg__(self): return self._op1(operator.neg)
    def __abs__(self): return self._op1(abs)

    def __invert__(self):
        return self._op1(lambda n: _logical_not(n) if _is_bool(n.dtype) else ~n)

    def __and__(self, other): return self._op2(other, _and)
    def __rand__(self, other): return self._op2(other, _and, reverse=True)
    def __or__(self, other): return self._op2(other, _or)
    def __ror__(self, other): return self._op2(other, _or, reverse=True)
    def __xor__(self, other): return self._op2(other, operator.xor)
    def __gt__(self, other): return self._op2(other, operator.gt)
    def __ge__(self, other): return self._op2(other, operator.ge)
    def __lt__(self, other): return self._op2(other, operator.lt)
    def __le__(self, other): return self._op2(other, operator.le)

    def __eq__(self, other):
        if other is None:
            return wrap(False)
        try:
            result = self._op2(other, lambda a, b: a == b)
        except (IncompatibleShapes, TypeError):
            return wrap(False)
        return wrap(False) if result is NotImplemented else result

    def __ne__(self, other):
        if other is None:
            return wrap(True)
        try:
            result = self._op2(other, lambda a, b: a != b)
        except (IncompatibleShapes, TypeError):
            return wrap(True)
        return wrap(True) if result is NotImplemented else result

    def __hash__(self):
        return id(self)

    def __repr__(self):
        if self.rank == 0:
            return f"{self.numpy()}"
        if self._shape.volume <= 16:
            return f"{self._shape} {self.numpy().tolist()}"
        return f"Tensor[{self._shape}, {self.dtype}]"


def _is_bool(dtype) -> bool:
    return dtype == torch.bool or dtype == np.bool_


def _logical_not(n):
    return np.logical_not(n) if _is_host(n) else torch.logical_not(n)


def _and(a, b):
    if _is_bool(getattr(a, 'dtype', None)) or isinstance(a, bool):
        return np.logical_and(a, b) if _is_host(a) else torch.logical_and(a, torch.as_tensor(b) if isinstance(b, bool) else b)
    return operator.and_(a, b)


def _or(a, b):
    if _is_bool(getattr(a, 'dtype', None)) or isinstance(a, bool):
        return np.logical_or(a, b) if _is_host(a) else torch.logical_or(a, torch.as_tensor(b) if isinstance(b, bool) else b)
    return operator.or_(a, b)


class TensorStack(Tensor):
    """Stack of uniform Tensors along one dim; component shapes may differ
    (staggered-grid components)."""
    __slots__ = ('_components', '_stack_dim')

    def __init__(self, components: Sequence[Tensor], stack_dim: Shape):
        assert len(stack_dim) == 1
        components = tuple(components)
        assert all(isinstance(c, Tensor) for c in components)
        sd = stack_dim.dims[0].with_size(len(components), stack_dim.dims[0].labels)
        self._components = components
        self._stack_dim = Shape((sd,))
        self._native = None
        self._shape = None

    @property
    def shape(self) -> Shape:
        if self._shape is None:  # computed once: a stack is immutable
            inner = merge_shapes(*[c.shape for c in self._components], allow_varying_sizes=True)
            self._shape = concat_shapes(self._stack_dim, inner)
        return self._shape

    @property
    def stack_dim(self) -> Shape:
        return self._stack_dim

    @property
    def components(self) -> Tuple[Tensor, ...]:
        return self._components

    @property
    def is_uniform(self) -> bool:
        key0 = {(d.name, d.size) for d in self._components[0].shape.dims}
        return all({(d.name, d.size) for d in c.shape.dims} == key0 for c in self._components)

    @property
    def dtype(self):
        return self._components[0].dtype

    @property
    def rank(self):
        return self.shape.rank

    @property
    def is_host(self) -> bool:
        return all(c.is_host for c in self._components)

    @property
    def device(self):
        return self._components[0].device

    def _contiguous(self) -> Tensor:
        """One uniform Tensor with the stack dim first (a copy of every component)."""
        assert self.is_uniform, f"cannot densify non-uniform stack {self.shape}"
        order = self._components[0].shape.names
        comps = [c._transposed(order) for c in self._components]
        natives = [c.native() for c in comps]
        if all(_is_host(n) for n in natives):
            native = np.stack(natives, axis=0)
        else:
            ref = next(n for n in natives if not _is_host(n))
            native = torch.stack([_host_to(n, ref) if _is_host(n) else n for n in natives], 0)
        return Tensor(native, concat_shapes(self._stack_dim, comps[0].shape))

    def native(self, order=None):
        return self._contiguous().native(order)

    def numpy(self, order=None):
        return _host(self.native(order))

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype)

    def _unstack(self, dim: str) -> tuple:
        if dim == self._stack_dim.name:
            return self._components
        return tuple(TensorStack([c if dim not in c.shape else c._unstack(dim)[i] for c in self._components],
                                 self._stack_dim)
                     for i in range(self.shape.get_size(dim)))

    def __getitem__(self, item):
        return self._getitem_dict(slicing_dict(self, item))

    def _getitem_dict(self, sel: dict) -> Tensor:
        sel = dict(sel)
        sname = self._stack_dim.name
        if sname in sel:
            s = sel.pop(sname)
            labels = self._stack_dim.dims[0].labels
            if isinstance(s, str):
                s = [labels.index(n.strip()) for n in s.split(',')] if ',' in s else labels.index(s.strip())
            if isinstance(s, int):
                comp = self._components[s]
                return comp._getitem_dict({k: v for k, v in sel.items() if k in comp.shape}) if sel else comp
            if isinstance(s, (slice, tuple, list)):
                idx = list(range(len(self._components)))[s] if isinstance(s, slice) else list(s)
                comps = [self._components[i] for i in idx]
                new_labels = tuple(labels[i] for i in idx) if labels else None
                sd = Shape((Dim(sname, len(comps), self._stack_dim.dims[0].dim_type, new_labels),))
                result = TensorStack(comps, sd)
                return result._getitem_dict(sel) if sel else result
            raise ValueError(f"invalid selection {s!r} for stack dim")
        if not sel:
            return self
        comps = [c._getitem_dict({k: v for k, v in sel.items() if k in c.shape}) for c in self._components]
        return TensorStack(comps, self._stack_dim)

    def _op1(self, fn) -> 'TensorStack':
        return TensorStack([c._op1(fn) for c in self._components], self._stack_dim)

    def _op2(self, other, fn, reverse=False) -> 'TensorStack':
        sname = self._stack_dim.name
        if isinstance(other, Tensor) and sname in other.shape:
            others = other._unstack(sname)
            comps = [c._op2(o, fn, reverse) for c, o in zip(self._components, others)]
        elif isinstance(other, (Tensor, int, float, bool, complex, tuple, list, np.ndarray, np.generic,
                                torch.Tensor)):
            comps = [c._op2(other, fn, reverse) for c in self._components]
        else:
            return NotImplemented
        return TensorStack(comps, self._stack_dim)

    def _expand(self, dims: Shape) -> 'TensorStack':
        new = dims.without(self._stack_dim.name)
        return TensorStack([c._expand(new) for c in self._components], self._stack_dim)

    def _transposed(self, order_names):
        return self

    def __repr__(self):
        return f"TensorStack[{self._stack_dim} over {len(self._components)} components]"


def _shape_after_getitem(shape: Shape, sel: dict) -> Shape:
    dims = []
    for d in shape.dims:
        if d.name not in sel:
            dims.append(d)
            continue
        s = sel[d.name]
        if isinstance(s, str):
            if ',' in s:
                names = tuple(n.strip() for n in s.split(','))
                dims.append(Dim(d.name, len(names), d.dim_type, names))
            continue
        if isinstance(s, int):
            continue
        if isinstance(s, slice):
            start, stop, step = s.indices(d.size)
            n = len(range(start, stop, step))
            labels = d.labels[s] if d.labels else None
            dims.append(Dim(d.name, n, d.dim_type, labels))
        elif isinstance(s, (tuple, list, np.ndarray)):
            s = list(s)
            if s and all(isinstance(n, str) for n in s):
                s = [d.labels.index(n) for n in s]
            labels = tuple(d.labels[i] for i in s) if d.labels else None
            dims.append(Dim(d.name, len(s), d.dim_type, labels))
        elif isinstance(s, Shape):
            dims.append(Dim(d.name, len(s.names), d.dim_type, s.names))
        else:
            dims.append(d)
    return Shape(tuple(dims))


def _align_native(native, shape: Shape, order: Tuple[str, ...]):
    """Transpose / expand `native` to axis order `order`; dims missing from the
    shape get size 1, dims missing from the order must have size 1."""
    host = _is_host(native)
    present = [n for n in order if n in shape]
    perm = [shape.index(n) for n in present]
    extra = [n for n in shape.names if n not in order]
    assert not extra or all(shape.get_size(n) == 1 for n in extra), \
        f"cannot convert {shape} to order {order}: dims {extra} missing from order"
    x = native
    if extra:
        axes = tuple(shape.index(n) for n in extra)
        x = np.squeeze(x, axis=axes) if host else x.squeeze(axes)
        kept = [n for n in shape.names if n in order]
        perm = [kept.index(n) for n in present]
    if perm != list(range(len(perm))):
        x = np.transpose(x, perm) if host else x.permute(perm)
    for ax in [i for i, n in enumerate(order) if n not in shape]:
        x = np.expand_dims(x, ax) if host else x.unsqueeze(ax)
    return x


def _broadcast(a: Tensor, b: Tensor):
    """Align two uniform tensors to their merged shape: (a_native, b_native, shape)."""
    if a._shape == b._shape:
        return a._native, b._native, a._shape
    shape = merge_shapes(a._shape, b._shape)
    return _align_native(a._native, a._shape, shape.names), _align_native(b._native, b._shape, shape.names), shape


def wrap(value, *shape: Shape) -> Tensor:
    """Wrap a value (number, numpy array, torch tensor, list, Tensor) as a
    Tensor without copying. Numbers and lists become host constants of the
    current precision."""
    if isinstance(value, Tensor):
        if shape:
            target = concat_shapes(*shape)
            assert set(target.names) == set(value.shape.names), f"wrap: shape mismatch {target} vs {value.shape}"
        return value
    if isinstance(value, (tuple, list)):
        if any(isinstance(v, Tensor) for v in value):
            from ._ops import stack
            dim = concat_shapes(*shape) if shape else channel(vector=len(value))
            return stack([wrap(v) for v in value], dim)
        value = np.asarray(value)
    if isinstance(value, (bool, int, float, complex)):
        assert not shape or concat_shapes(*shape).volume in (1,), "scalar with non-scalar shape"
        return Tensor(np.asarray(value, dtype=_dtype_for(value)), EMPTY_SHAPE)
    if isinstance(value, np.generic):
        value = np.asarray(value)
    if isinstance(value, (np.ndarray, torch.Tensor)):
        if isinstance(value, np.ndarray):
            if value.dtype == np.float64 and get_precision() != 64:
                value = value.astype(np.float32)
            elif value.dtype == np.int64:
                value = value.astype(np.int32)
        if value.ndim == 0:
            return Tensor(value, EMPTY_SHAPE)
        if not shape:
            raise ValueError(f"wrap(array) requires dims for an array of shape {tuple(value.shape)}")
        target = concat_shapes(*shape)
        sizes = tuple(value.shape)
        assert len(sizes) == target.rank, f"array rank {len(sizes)} != shape rank {target.rank} ({target})"
        target = target.with_sizes(sizes) if not target.well_defined else target
        assert tuple(target.sizes) == sizes, f"array shape {sizes} != {target}"
        return Tensor(value, target)
    raise TypeError(f"cannot wrap {type(value)}")


def _dtype_for(value):
    if isinstance(value, bool):
        return np.bool_
    if isinstance(value, int):
        return np.int32
    if isinstance(value, float):
        return default_float()
    if isinstance(value, complex):
        return backend_dtype('complex')
    raise TypeError(type(value))


def tensor(value, *shape: Shape, convert=True) -> Tensor:
    """Like `wrap`, converting floats to the current precision."""
    t = wrap(value, *shape)
    if convert and get_precision() == 32:
        if t.dtype in (np.float64, np.float16):
            t = t._op1(lambda x: x.astype(np.float32))
        elif t.dtype in (torch.float64, torch.float16):
            t = t._op1(lambda x: x.float())
    return t

"""Extrapolations: the values a field takes outside its sampled region —
port of `phiflow_tpu/math/_extrapolation.py`.

An `Extrapolation` pads Tensors (`pad`), decides how many outer faces a
staggered grid stores (`valid_outer_faces`) and derives the boundary of a
gradient (`spatial_gradient`). The array layer below the Field layer takes
plain descriptors instead (`math/_nd.py`: a float, `'boundary'`,
`'periodic'`, `PerSide`); `to_native` maps one onto the other where the Field
layer calls the array layer.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ._shape import Shape, EMPTY_SHAPE, channel, spatial, parse_dim_order
from ._tensor import Tensor, TensorStack, wrap, _is_host, to_torch

__all__ = [
    'Extrapolation', 'ConstantExtrapolation', 'ZERO', 'ONE', 'PERIODIC', 'BOUNDARY',
    'ZERO_GRADIENT', 'SYMMETRIC', 'REFLECT', 'ANTIREFLECT', 'ANTISYMMETRIC', 'NONE',
    'combine_sides', 'combine_by_direction', 'as_extrapolation', 'map', 'where',
    'remove_constant_offset', 'get_normal', 'get_tangential', 'domain_slice', 'from_dict',
    'Undefined', 'SYMMETRIC_GRADIENT', 'to_native',
]


class Extrapolation:
    """Base class. Subclasses define values outside a tensor's sampled region."""

    def __init__(self, pad_rank):
        self.pad_rank = pad_rank  # priority when multiple extrapolations pad the same tensor

    def to_dict(self) -> dict:
        raise NotImplementedError(type(self))

    # --- queries ---
    def valid_outer_faces(self, dim: str) -> Tuple[bool, bool]:
        """Whether the lower/upper outermost face values along `dim` are stored
        (not implied by this boundary condition). Determines staggered tensor sizes."""
        raise NotImplementedError(type(self))

    def determines_boundary_values(self, boundary_key) -> bool:
        raise NotImplementedError(type(self))

    @property
    def is_flexible(self) -> bool:
        """Whether the boundary can accommodate net flux (open boundary)."""
        raise NotImplementedError(type(self))

    def spatial_gradient(self) -> 'Extrapolation':
        """Extrapolation of the spatial gradient of a field with this extrapolation."""
        raise NotImplementedError(type(self))

    @property
    def shape(self) -> Shape:
        return EMPTY_SHAPE

    # --- padding ---
    def pad(self, value: Tensor, widths: Dict[str, Tuple[int, int]], already_padded=None, **kwargs) -> Tensor:
        """Pad `value` along named dims by (lower, upper) widths."""
        for dim, (lo, up) in widths.items():
            if lo == 0 and up == 0:
                continue
            if lo > 0:
                value = self._pad_side(value, dim, lo, upper_edge=False, **kwargs)
            if up > 0:
                value = self._pad_side(value, dim, up, upper_edge=True, **kwargs)
        return value

    def _pad_side(self, value: Tensor, dim: str, width: int, upper_edge: bool, **kwargs) -> Tensor:
        from ._ops import concat
        edge = self.pad_values(value, width, dim, upper_edge, **kwargs)
        parts = (value, edge) if upper_edge else (edge, value)
        return concat(parts, value.shape[dim])

    def pad_values(self, value: Tensor, width: int, dim: str, upper_edge: bool, already_padded=None, **kwargs) -> Tensor:
        """The values outside the tensor along one side of one dim (shape: dim→width)."""
        raise NotImplementedError(type(self))

    def sparse_pad_values(self, *args, **kwargs):
        raise NotImplementedError(type(self))

    # --- transform / selection ---
    def __getitem__(self, item):
        return self

    def _getitem_with_domain(self, item: dict, dim: str, upper_edge: bool, all_dims):
        return self[item]

    def transform(self, fn):
        return self

    # --- arithmetic ---
    def _op2(self, other, op, symbol) -> 'Extrapolation':
        if isinstance(other, (int, float, Tensor)):
            other = ConstantExtrapolation(wrap(other))
        if isinstance(other, ConstantExtrapolation) and not isinstance(self, ConstantExtrapolation):
            # linear-op with a constant leaves non-constant extrapolations unchanged up to offset;
            # keep self for value-independent BCs (PERIODIC, BOUNDARY, SYMMETRIC, ...)
            return self
        if type(other) == type(self) and other == self:
            return self
        return NotImplemented

    def __add__(self, other): return self._op2(other, lambda a, b: a + b, '+')
    def __radd__(self, other): return self._op2(other, lambda a, b: b + a, '+')
    def __sub__(self, other): return self._op2(other, lambda a, b: a - b, '-')
    def __rsub__(self, other): return self._op2(other, lambda a, b: b - a, '-')
    def __mul__(self, other): return self._op2(other, lambda a, b: a * b, '*')
    def __rmul__(self, other): return self._op2(other, lambda a, b: b * a, '*')
    def __truediv__(self, other): return self._op2(other, lambda a, b: a / b, '/')
    def __rtruediv__(self, other): return self._op2(other, lambda a, b: b / a, '/')
    def __neg__(self): return self

    @property
    def is_copy_pad(self) -> bool:
        return False

    def __abs__(self):
        return self


class ConstantExtrapolation(Extrapolation):
    """Dirichlet: constant value outside."""

    def __init__(self, value):
        super().__init__(pad_rank=5)
        self.value = wrap(value)

    def to_dict(self) -> dict:
        return {'type': 'constant', 'value': float(self.value) if self.value.rank == 0 else np.asarray(self.value.native()).tolist()}

    def valid_outer_faces(self, dim) -> Tuple[bool, bool]:
        return False, False

    def determines_boundary_values(self, boundary_key) -> bool:
        return True

    @property
    def is_flexible(self) -> bool:
        return False

    def spatial_gradient(self) -> Extrapolation:
        return ZERO

    @property
    def shape(self):
        return self.value.shape

    def pad_values(self, value: Tensor, width: int, dim: str, upper_edge: bool, **kwargs) -> Tensor:
        from ._ops import expand
        const = self.value
        if isinstance(value, TensorStack):
            # pad each component with matching const slice (vector const padding a stacked dim)
            sd = value.stack_dim
            comps = []
            for i, c in enumerate(value.components):
                ci = const[{sd.name.lstrip('~'): i}] if sd.name.lstrip('~') in const.shape or sd.name in const.shape else const
                comps.append(ConstantExtrapolation(ci).pad_values(c, width, dim, upper_edge, **kwargs))
            return TensorStack(comps, sd)
        target = value.shape.with_dim_size(dim, width)
        block = expand(const, target.without(const.shape.names))
        if set(block.shape.names) != set(target.names):
            block = expand(const, target)
        bn = block.native(target.names)
        if _is_host(bn) and _is_host(value.native()):
            bn = np.broadcast_to(bn, tuple(target.sizes)).astype(value.dtype)
        elif const.rank == 0 and const.is_host:  # a number: a fill on the device, no host→device copy
            like = value.native()
            bn = torch.full(tuple(target.sizes), const.native().item(), dtype=like.dtype, device=like.device)
        else:
            like = value.native()
            bn = to_torch(bn, like.device).to(like.dtype).expand(tuple(target.sizes))
        return Tensor(bn, target)

    def __eq__(self, other):
        if isinstance(other, ConstantExtrapolation):
            from ._ops import close
            try:
                return close(self.value, other.value, rel_tolerance=0, abs_tolerance=0)
            except Exception:
                return False
        if isinstance(other, (int, float)):
            from ._ops import close
            return self.value.rank == 0 and close(self.value, other, rel_tolerance=0, abs_tolerance=0)
        return False

    def __hash__(self):
        return hash('constant')

    def _op2(self, other, op, symbol):
        if isinstance(other, (int, float, Tensor)):
            other = ConstantExtrapolation(wrap(other))
        if isinstance(other, ConstantExtrapolation):
            return ConstantExtrapolation(op(self.value, other.value))
        return NotImplemented

    def __neg__(self):
        return ConstantExtrapolation(-self.value)

    def __abs__(self):
        return ConstantExtrapolation(abs(self.value))

    def __getitem__(self, item):
        return ConstantExtrapolation(self.value[{k: v for k, v in item.items() if k in self.value.shape}]) \
            if isinstance(item, dict) and self.value.rank > 0 else self

    def __repr__(self):
        return repr(self.value)


class _CopyExtrapolation(Extrapolation):
    """Base for value-independent extrapolations, padded by numpy's pad modes."""
    _pad_mode = None
    _name = None

    def __init__(self):
        super().__init__(pad_rank=2)

    def to_dict(self) -> dict:
        return {'type': self._name}

    @property
    def is_copy_pad(self):
        return True

    def determines_boundary_values(self, boundary_key) -> bool:
        return False

    def __eq__(self, other):
        return type(other) == type(self)

    def __hash__(self):
        return hash(self._name)

    def __repr__(self):
        return self._name

    def pad(self, value: Tensor, widths: Dict[str, Tuple[int, int]], already_padded=None, **kwargs) -> Tensor:
        if isinstance(value, TensorStack):
            return TensorStack([self.pad(c, {k: w for k, w in widths.items() if k in c.shape}, **kwargs)
                                for c in value.components], value.stack_dim)
        pad_spec = [(0, 0)] * value.rank
        any_pad = False
        for dim, (lo, up) in widths.items():
            if dim in value.shape:
                pad_spec[value.shape.index(dim)] = (lo, up)
                any_pad = any_pad or lo or up
        if not any_pad:
            return value
        native = _pad_native(value.native(), pad_spec, self._pad_mode)
        new_shape = value.shape
        for dim, (lo, up) in widths.items():
            if dim in new_shape:
                new_shape = new_shape.with_dim_size(dim, new_shape.get_size(dim) + lo + up)
        return Tensor(native, new_shape)

    def pad_values(self, value: Tensor, width: int, dim: str, upper_edge: bool, **kwargs) -> Tensor:
        return self._copy_pad_values(value, width, dim, upper_edge)

    def _copy_pad_values(self, value: Tensor, width: int, dim: str, upper_edge: bool) -> Tensor:
        padded = _CopyExtrapolation.pad(self, value, {dim: (0, width) if upper_edge else (width, 0)})
        size = value.shape.get_size(dim)
        return padded[{dim: slice(size, size + width) if upper_edge else slice(0, width)}]


class _PeriodicExtrapolation(_CopyExtrapolation):
    _pad_mode = 'wrap'
    _name = 'periodic'

    def valid_outer_faces(self, dim):
        return True, False

    @property
    def is_flexible(self):
        return False

    def spatial_gradient(self):
        return self


class _BoundaryExtrapolation(_CopyExtrapolation):
    """Zero-gradient / edge-replicate (BOUNDARY, alias ZERO_GRADIENT)."""
    _pad_mode = 'edge'
    _name = 'zero-gradient'

    def valid_outer_faces(self, dim):
        return True, True

    @property
    def is_flexible(self):
        return True

    def spatial_gradient(self):
        return ZERO


class _SymmetricExtrapolation(_CopyExtrapolation):
    """Mirror with the boundary point duplicated: (... a b | b a ...)"""
    _pad_mode = 'symmetric'
    _name = 'symmetric'

    def valid_outer_faces(self, dim):
        return True, True

    @property
    def is_flexible(self):
        return False

    def spatial_gradient(self):
        return ANTIREFLECT


class _ReflectExtrapolation(_CopyExtrapolation):
    """Mirror without duplicating the boundary point: (... a b c | b a ...)"""
    _pad_mode = 'reflect'
    _name = 'reflect'

    def valid_outer_faces(self, dim):
        return True, True

    @property
    def is_flexible(self):
        return False

    def spatial_gradient(self):
        return ANTISYMMETRIC


class _AntiSymmetricExtrapolation(_CopyExtrapolation):
    """Mirror with sign flip, boundary duplicated: (... a b | -b -a ...)"""
    _pad_mode = 'symmetric'
    _name = 'antisymmetric'

    def valid_outer_faces(self, dim):
        return False, False

    @property
    def is_flexible(self):
        return False

    def spatial_gradient(self):
        return REFLECT

    def pad_values(self, value, width, dim, upper_edge, **kwargs):
        return -self._copy_pad_values(value, width, dim, upper_edge)

    def pad(self, value, widths, **kwargs):
        return Extrapolation.pad(self, value, widths, **kwargs)


class _AntiReflectExtrapolation(_CopyExtrapolation):
    """Point-mirror about the edge value: pad = 2·edge − mirrored."""
    _pad_mode = 'reflect'
    _name = 'antireflect'

    def valid_outer_faces(self, dim):
        return True, True

    @property
    def is_flexible(self):
        return False

    def spatial_gradient(self):
        return SYMMETRIC

    def pad_values(self, value, width, dim, upper_edge, **kwargs):
        mirrored = self._copy_pad_values(value, width, dim, upper_edge)
        edge = value[{dim: -1 if upper_edge else 0}]
        return 2 * edge - mirrored

    def pad(self, value, widths, **kwargs):
        return Extrapolation.pad(self, value, widths, **kwargs)


class _SymmetricGradientExtrapolation(Extrapolation):
    """Extrapolates so the gradient at the boundary mirrors symmetrically
    (SYMMETRIC_GRADIENT). pad = 2·edge_extension − mirrored."""

    def __init__(self):
        super().__init__(pad_rank=3)

    def to_dict(self):
        return {'type': 'symmetric-gradient'}

    def valid_outer_faces(self, dim):
        return True, True

    def determines_boundary_values(self, key):
        return False

    @property
    def is_flexible(self):
        return True

    def spatial_gradient(self):
        return SYMMETRIC

    def pad_values(self, value, width, dim, upper_edge, **kwargs):
        edge = value[{dim: -1 if upper_edge else 0}]
        mirrored = REFLECT.pad_values(value, width, dim, upper_edge)
        return 2 * edge - mirrored

    def __eq__(self, other):
        return isinstance(other, _SymmetricGradientExtrapolation)

    def __hash__(self):
        return hash('symmetric-gradient')


class _NoExtrapolation(Extrapolation):
    """Values outside are undefined; padding is a zero-width no-op (NONE)."""

    def __init__(self):
        super().__init__(pad_rank=0)

    def to_dict(self):
        return {'type': 'none'}

    def valid_outer_faces(self, dim):
        return False, False

    def determines_boundary_values(self, key):
        return False

    @property
    def is_flexible(self):
        return False

    def spatial_gradient(self):
        return self

    def pad(self, value, widths, **kwargs):
        assert all(lo == 0 and up == 0 for lo, up in widths.values()), \
            f"cannot pad with extrapolation NONE (undefined outside values): {widths}"
        return value

    def pad_values(self, value, width, dim, upper_edge, **kwargs):
        raise AssertionError("cannot pad with extrapolation NONE")

    def __eq__(self, other):
        return isinstance(other, _NoExtrapolation)

    def __hash__(self):
        return hash('none')

    def __repr__(self):
        return 'none'


class Undefined(Extrapolation):
    """Undefined boundary that pads like `derived_from` (Undefined)."""

    def __init__(self, derived_from: Extrapolation):
        super().__init__(pad_rank=0)
        self.derived_from = derived_from

    def to_dict(self):
        return {'type': 'undefined', 'derived_from': self.derived_from.to_dict()}

    def valid_outer_faces(self, dim):
        return self.derived_from.valid_outer_faces(dim)

    def determines_boundary_values(self, key):
        return self.derived_from.determines_boundary_values(key)

    @property
    def is_flexible(self):
        return self.derived_from.is_flexible

    def spatial_gradient(self):
        return Undefined(self.derived_from.spatial_gradient())

    def pad(self, value, widths, **kwargs):
        return self.derived_from.pad(value, widths, **kwargs)

    def pad_values(self, value, width, dim, upper_edge, **kwargs):
        return self.derived_from.pad_values(value, width, dim, upper_edge, **kwargs)

    def __eq__(self, other):
        return isinstance(other, Undefined) and other.derived_from == self.derived_from

    def __hash__(self):
        return hash(('undefined', self.derived_from))


class _MixedExtrapolation(Extrapolation):
    """Different extrapolation per dim and side (combine_sides)."""

    def __init__(self, ext: Dict[str, Tuple[Extrapolation, Extrapolation]]):
        super().__init__(pad_rank=4)
        self.ext = dict(ext)

    def to_dict(self):
        return {'type': 'mixed',
                'dims': {dim: (lo.to_dict(), up.to_dict()) for dim, (lo, up) in self.ext.items()}}

    def _get(self, dim: str, upper: bool) -> Extrapolation:
        if dim in self.ext:
            return self.ext[dim][int(upper)]
        raise KeyError(f"dim '{dim}' not covered by {self}")

    def valid_outer_faces(self, dim):
        if dim not in self.ext:
            return True, True
        lo, up = self.ext[dim]
        return lo.valid_outer_faces(dim)[0], up.valid_outer_faces(dim)[1]

    def determines_boundary_values(self, key):
        if isinstance(key, str) and (key.endswith('-') or key.endswith('+')):
            dim, side = key[:-1], key[-1] == '+'
            return self._get(dim, side).determines_boundary_values(key)
        return any(e.determines_boundary_values(key) for pair in self.ext.values() for e in pair)

    @property
    def is_flexible(self):
        return any(e.is_flexible for pair in self.ext.values() for e in pair)

    def spatial_gradient(self):
        return _MixedExtrapolation({d: (lo.spatial_gradient(), up.spatial_gradient())
                                    for d, (lo, up) in self.ext.items()})

    @property
    def shape(self):
        from ._shape import merge_shapes
        return merge_shapes(*[e.shape for pair in self.ext.values() for e in pair])

    def pad(self, value, widths, **kwargs):
        for dim, (lo, up) in widths.items():
            if lo:
                value = self._get(dim, False).pad(value, {dim: (lo, 0)}, **kwargs)
            if up:
                value = self._get(dim, True).pad(value, {dim: (0, up)}, **kwargs)
        return value

    def pad_values(self, value, width, dim, upper_edge, **kwargs):
        return self._get(dim, upper_edge).pad_values(value, width, dim, upper_edge, **kwargs)

    def transform(self, fn):
        return _MixedExtrapolation({d: (fn(lo), fn(up)) for d, (lo, up) in self.ext.items()})

    def __getitem__(self, item):
        if isinstance(item, dict):
            return _MixedExtrapolation({d: (lo[item], up[item]) for d, (lo, up) in self.ext.items()})
        return self

    def __eq__(self, other):
        return isinstance(other, _MixedExtrapolation) and other.ext == self.ext

    def __hash__(self):
        return hash(tuple(sorted((d, lo, up) for d, (lo, up) in self.ext.items())))

    def _op2(self, other, op, symbol):
        if isinstance(other, _MixedExtrapolation) and set(other.ext) == set(self.ext):
            return _MixedExtrapolation({d: (op_ext(lo, other.ext[d][0], op, symbol), op_ext(up, other.ext[d][1], op, symbol))
                                        for d, (lo, up) in self.ext.items()})
        if isinstance(other, (int, float, Tensor, ConstantExtrapolation, _CopyExtrapolation)):
            return _MixedExtrapolation({d: (op_ext(lo, other, op, symbol), op_ext(up, other, op, symbol))
                                        for d, (lo, up) in self.ext.items()})
        return NotImplemented

    def __neg__(self):
        return self.transform(lambda e: -e)

    def __abs__(self):
        return self.transform(lambda e: abs(e))

    def __repr__(self):
        return f"mixed({', '.join(f'{d}={lo}/{up}' for d, (lo, up) in self.ext.items())})"


def op_ext(a: Extrapolation, b, op, symbol) -> Extrapolation:
    result = a._op2(b, op, symbol)
    if result is NotImplemented:
        if isinstance(b, Extrapolation):
            result = b._op2(a, lambda x, y: op(y, x), symbol)
        if result is NotImplemented:
            raise NotImplementedError(f"cannot compute {a} {symbol} {b}")
    return result


class _NormalTangentialExtrapolation(Extrapolation):
    """Different extrapolation for normal vs tangential vector components
    (combine_by_direction; queried by fluid.py:_accessible_extrapolation
    via get_normal)."""

    def __init__(self, normal: Extrapolation, tangential: Extrapolation):
        super().__init__(pad_rank=4)
        self.normal = normal
        self.tangential = tangential

    def to_dict(self):
        return {'type': 'normal-tangential', 'normal': self.normal.to_dict(), 'tangential': self.tangential.to_dict()}

    def valid_outer_faces(self, dim):
        # faces along the dim are normal components
        return self.normal.valid_outer_faces(dim)

    def determines_boundary_values(self, key):
        return self.normal.determines_boundary_values(key)

    @property
    def is_flexible(self):
        return self.normal.is_flexible

    def spatial_gradient(self):
        return _NormalTangentialExtrapolation(self.normal.spatial_gradient(), self.tangential.spatial_gradient())

    def pad_values(self, value, width, dim, upper_edge, component=None, **kwargs):
        ext = self.normal if (component is None or component == dim) else self.tangential
        return ext.pad_values(value, width, dim, upper_edge, **kwargs)

    def pad(self, value, widths, component=None, **kwargs):
        ext = self.normal if component is None else (self.normal if False else None)
        if component is not None:
            # pad dims matching component with normal, others tangential
            for dim, (lo, up) in widths.items():
                e = self.normal if dim == component else self.tangential
                value = e.pad(value, {dim: (lo, up)}, **kwargs)
            return value
        return Extrapolation.pad(self, value, widths, **kwargs)

    def _getitem_with_domain(self, item: dict, dim: str, upper_edge: bool, all_dims):
        if 'vector' in item:
            comp = item['vector']
            return self.normal if comp == dim else self.tangential
        return self

    def __eq__(self, other):
        return isinstance(other, _NormalTangentialExtrapolation) and \
            other.normal == self.normal and other.tangential == self.tangential

    def __hash__(self):
        return hash(('nt', self.normal, self.tangential))

    def __repr__(self):
        return f"normal={self.normal}, tangential={self.tangential}"


# --- singletons ---
ZERO = ConstantExtrapolation(0.)
ONE = ConstantExtrapolation(1.)
PERIODIC = _PeriodicExtrapolation()
BOUNDARY = _BoundaryExtrapolation()
ZERO_GRADIENT = BOUNDARY
SYMMETRIC = _SymmetricExtrapolation()
REFLECT = _ReflectExtrapolation()
ANTIREFLECT = _AntiReflectExtrapolation()
ANTISYMMETRIC = _AntiSymmetricExtrapolation()
SYMMETRIC_GRADIENT = _SymmetricGradientExtrapolation()
NONE = _NoExtrapolation()


def combine_sides(*by_dim_args, **by_dim) -> Extrapolation:
    """Different extrapolations per dim/side: ``combine_sides(x=PERIODIC, y=(ZERO, BOUNDARY))``."""
    if by_dim_args:
        assert len(by_dim_args) == 1 and isinstance(by_dim_args[0], dict)
        by_dim = {**by_dim_args[0], **by_dim}
    ext = {}
    for dim, e in by_dim.items():
        if dim.endswith('-') or dim.endswith('+'):
            base, upper = dim[:-1], dim.endswith('+')
            lo, up = ext.get(base, (None, None))
            e = as_extrapolation(e)
            ext[base] = (e if not upper else lo, e if upper else up)
        elif isinstance(e, (tuple, list)):
            ext[dim] = (as_extrapolation(e[0]), as_extrapolation(e[1]))
        else:
            e = as_extrapolation(e)
            ext[dim] = (e, e)
    ext = {d: (lo if lo is not None else up, up if up is not None else lo) for d, (lo, up) in ext.items()}
    flat = [e for pair in ext.values() for e in pair]
    if all(e == flat[0] for e in flat):
        return flat[0]
    return _MixedExtrapolation(ext)


def combine_by_direction(normal, tangential) -> Extrapolation:
    normal, tangential = as_extrapolation(normal), as_extrapolation(tangential)
    if normal == tangential:
        return normal
    return _NormalTangentialExtrapolation(normal, tangential)


def as_extrapolation(obj) -> Extrapolation:
    if obj is None:
        return NONE
    if isinstance(obj, Extrapolation):
        return obj
    if isinstance(obj, (int, float, complex)):
        return ConstantExtrapolation(wrap(obj))
    if isinstance(obj, Tensor):
        return ConstantExtrapolation(obj)
    if isinstance(obj, str):
        return {'periodic': PERIODIC, 'zero-gradient': ZERO_GRADIENT, 'boundary': BOUNDARY,
                'zero': ZERO, 'one': ONE, 'symmetric': SYMMETRIC, 'reflect': REFLECT,
                'antireflect': ANTIREFLECT, 'antisymmetric': ANTISYMMETRIC, 'none': NONE,
                'symmetric-gradient': SYMMETRIC_GRADIENT}[obj]
    if isinstance(obj, dict):
        return combine_sides(**{k: as_extrapolation(v) for k, v in obj.items()})
    if hasattr(obj, 'geometry') and hasattr(obj, 'values'):
        from ..field._embed import FieldEmbedding
        return FieldEmbedding(obj)
    raise ValueError(f"cannot create extrapolation from {obj!r}")


def from_dict(d: dict) -> Extrapolation:
    t = d['type']
    if t == 'constant':
        v = d['value']
        if isinstance(v, (list, tuple)):
            return ConstantExtrapolation(wrap(list(v), channel(vector=len(v))))
        return ConstantExtrapolation(wrap(v))
    if t == 'mixed':
        return _MixedExtrapolation({dim: (from_dict(lo), from_dict(up)) for dim, (lo, up) in d['dims'].items()})
    if t == 'normal-tangential':
        return _NormalTangentialExtrapolation(from_dict(d['normal']), from_dict(d['tangential']))
    if t == 'undefined':
        return Undefined(from_dict(d['derived_from']))
    return as_extrapolation(t)


def map(fn, extrapolation: Extrapolation) -> Extrapolation:
    """Apply `fn` to the leaves of a composite extrapolation."""
    if isinstance(extrapolation, _MixedExtrapolation):
        return _MixedExtrapolation({d: (map(fn, lo), map(fn, up)) for d, (lo, up) in extrapolation.ext.items()})
    if isinstance(extrapolation, _NormalTangentialExtrapolation):
        return combine_by_direction(map(fn, extrapolation.normal), map(fn, extrapolation.tangential))
    if isinstance(extrapolation, Undefined):
        return Undefined(map(fn, extrapolation.derived_from))
    return fn(extrapolation)


def where(mask, ext_true, ext_false) -> Extrapolation:
    ext_true, ext_false = as_extrapolation(ext_true), as_extrapolation(ext_false)
    if bool(mask):
        return ext_true
    return ext_false


def remove_constant_offset(extrapolation: Extrapolation) -> Extrapolation:
    """Replace constant extrapolations by ZERO, keeping value-independent ones."""
    def _rm(e):
        if isinstance(e, ConstantExtrapolation):
            return ZERO
        return e
    return map(_rm, extrapolation)


def get_normal(extrapolation: Extrapolation) -> Extrapolation:
    def _n(e):
        return e.normal if isinstance(e, _NormalTangentialExtrapolation) else e
    if isinstance(extrapolation, _NormalTangentialExtrapolation):
        return extrapolation.normal
    return map(_n, extrapolation)


def get_tangential(extrapolation: Extrapolation) -> Extrapolation:
    def _t(e):
        return e.tangential if isinstance(e, _NormalTangentialExtrapolation) else e
    if isinstance(extrapolation, _NormalTangentialExtrapolation):
        return extrapolation.tangential
    return map(_t, extrapolation)


def domain_slice(ext: Extrapolation, item: dict, domain_dims) -> Extrapolation:
    """Slice an extrapolation when slicing the field it belongs to."""
    if isinstance(ext, _MixedExtrapolation):
        names = parse_dim_order(domain_dims)
        kept = {d: pair for d, pair in ext.ext.items() if d in names}
        flat = [e for pair in kept.values() for e in pair]
        if kept and all(e == flat[0] for e in flat):
            return flat[0][item] if isinstance(item, dict) else flat[0]
        result = _MixedExtrapolation(kept) if kept else BOUNDARY
        return result[item] if isinstance(item, dict) else result
    return ext[item] if isinstance(item, dict) else ext




def _pad_native(native, pad_spec, mode: str):
    """`native` padded by (lower, upper) per axis in numpy's `mode`: np.pad on
    the host; on torch, slices of the edge rows ('edge', 'wrap') or a gather
    along the axis of the index pattern numpy's pad gives ('symmetric',
    'reflect')."""
    if _is_host(native):
        return np.pad(native, pad_spec, mode=mode)
    x = native
    for axis, (lo, up) in enumerate(pad_spec):
        if not lo and not up:
            continue
        n = x.shape[axis]
        if mode == 'edge':
            parts = [x.narrow(axis, 0, 1).expand(*[lo if a == axis else -1 for a in range(x.ndim)])] if lo else []
            parts.append(x)
            if up:
                parts.append(x.narrow(axis, n - 1, 1).expand(*[up if a == axis else -1 for a in range(x.ndim)]))
            x = torch.cat(parts, dim=axis)
        elif mode == 'wrap' and lo <= n and up <= n:
            x = torch.cat(([x.narrow(axis, n - lo, lo)] if lo else []) + [x] + ([x.narrow(axis, 0, up)] if up else []),
                          dim=axis)
        else:
            idx = np.pad(np.arange(n), (lo, up), mode=mode)
            x = torch.index_select(x, axis, torch.from_numpy(idx).to(x.device))
    return x


def _side_of(ext: Extrapolation, dim: str, upper: bool) -> Extrapolation:
    """The extrapolation of one side of `dim` (mixed ones resolved)."""
    while isinstance(ext, _MixedExtrapolation):
        ext = ext._get(dim, upper)
    return ext


def _side_to_native(ext: Extrapolation):
    """The array layer's rule for one side (`math/_nd.py`): a float, BOUNDARY,
    PERIODIC or a mirror; None where it has none."""
    from . import _nd
    while isinstance(ext, Undefined):
        ext = ext.derived_from
    if isinstance(ext, ConstantExtrapolation):
        return float(ext.value) if ext.value.rank == 0 else None
    return {_PeriodicExtrapolation: _nd.PERIODIC, _BoundaryExtrapolation: _nd.BOUNDARY,
            _SymmetricExtrapolation: _nd.SYMMETRIC, _ReflectExtrapolation: _nd.REFLECT,
            _AntiSymmetricExtrapolation: _nd.ANTISYMMETRIC, _AntiReflectExtrapolation: _nd.ANTIREFLECT,
            _SymmetricGradientExtrapolation: _nd.SYMMETRIC_GRADIENT}.get(type(ext))


def to_native(ext: Extrapolation, dims=None):
    """The array layer's descriptor of `ext` (`math/_nd.py`): a float for a
    scalar constant, `'boundary'`, `'periodic'`, one of the mirrors
    (`'symmetric'`, `'reflect'`, `'antisymmetric'`, `'antireflect'`,
    `'symmetric-gradient'`), or a `PerSide` of those by side for a mixed
    extrapolation (`dims`: the axis order). A vector-valued constant has a
    form per component: index it first (``ext[{'vector': dim}]``). Raises
    NotImplementedError for any other extrapolation."""
    from ._nd import PerSide
    form = _side_to_native(ext)
    if form is not None:
        return form
    if isinstance(ext, _MixedExtrapolation) and dims is not None:
        sides = [tuple(_side_to_native(_side_of(ext, d, upper)) for upper in (False, True)) for d in dims]
        if all(e is not None for pair in sides for e in pair):
            return PerSide(*sides)
    raise NotImplementedError(f"extrapolation {ext!r} has no array-layer form: scalar constants, BOUNDARY, "
                              f"PERIODIC, the mirrors (SYMMETRIC, REFLECT, ANTISYMMETRIC, ANTIREFLECT, "
                              f"SYMMETRIC_GRADIENT) and these by side are ported")

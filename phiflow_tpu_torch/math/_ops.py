"""Operations on named-dim Tensors — port of `phiflow_tpu/math/_ops.py`.

Every function works on host (numpy) and torch natives alike: host inputs
stay on the host, computed by numpy as the JAX package computes them; torch
inputs are computed by torch on their device.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Sequence

import numpy as np
import torch

from ._shape import (
    Shape, Dim, EMPTY_SHAPE, batch, spatial, channel, instance, merge_shapes, concat_shapes, parse_dim_order,
    _resolve_filter, DimFilter, CHANNEL, DUAL, INSTANCE,
)
from ._tensor import (
    Tensor, TensorStack, wrap, default_float, get_default_device, _broadcast, _align_native, _is_host, _meet,
    _host_to, _host, _fix_host_dtype, to_torch,
)

__all__ = ['zeros', 'ones', 'zeros_like', 'ones_like', 'seed', 'random_normal', 'random_uniform', 'linspace', 'arange',
           'meshgrid',
           'stack', 'unstack', 'concat', 'expand', 'rename_dims', 'pack_dims', 'unpack_dim', 'transpose', 'squeeze',
           'abs_', 'sign', 'sqrt', 'exp', 'log', 'sin', 'cos', 'floor', 'ceil', 'round_', 'is_finite', 'is_nan',
           'is_inf', 'to_float', 'to_int32', 'to_int64', 'to_bool', 'cast', 'maximum', 'minimum', 'clip', 'where',
           'safe_div', 'nan_to_0', 'sum_', 'mean', 'prod', 'max_', 'min_', 'any_', 'all_', 'finite_mean',
           'finite_sum', 'finite_max', 'finite_min', 'dot', 'close', 'always_close', 'assert_close', 'equal', 'pad',
           'shift', 'vec', 'vec_length', 'vec_squared', 'vec_normalize', 'dim_mask', 'gather', 'scatter',
           'boolean_mask', 'nonzero', 'quantile', 'median', 'pairwise_differences', 'find_closest', 'stop_gradient',
           'native_call', 'range_tensor', 'flatten', 'log2', 'log10', 'tan', 'arcsin', 'arccos', 'arctan', 'arctan2',
           'sinh', 'cosh', 'tanh', 'real', 'imag', 'conjugate', 'sigmoid', 'erf', 'factorial', 'degrees_to_radians',
           'radians_to_degrees', 'std', 'at_max', 'argmax', 'argmin', 'cumulative_sum', 'histogram', 'neighbor_mean',
           'sample_subgrid', 'grid_sample', 'closest_grid_values', 'fft', 'ifft', 'fftfreq', 'norm', 'length',
           'squared_norm', 'normalize', 'cross', 'cross_product', 'convolve', 'reshaped_native', 'reshaped_tensor',
           'assert_finite', 'print_', 'map_']


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def zeros(*shape: Shape, dtype=None) -> Tensor:
    s = concat_shapes(*shape)
    return Tensor(np.zeros(s.sizes, dtype=dtype or default_float()), s)


def ones(*shape: Shape, dtype=None) -> Tensor:
    s = concat_shapes(*shape)
    return Tensor(np.ones(s.sizes, dtype=dtype or default_float()), s)


def zeros_like(t) -> Tensor:
    if isinstance(t, TensorStack):
        return TensorStack([zeros_like(c) for c in t.components], t.stack_dim)
    if isinstance(t, Tensor):
        n = t.native()
        return Tensor(np.zeros_like(n) if _is_host(n) else torch.zeros_like(n), t.shape)
    return t * 0


def ones_like(t) -> Tensor:
    if isinstance(t, TensorStack):
        return TensorStack([ones_like(c) for c in t.components], t.stack_dim)
    n = t.native()
    return Tensor(np.ones_like(n) if _is_host(n) else torch.ones_like(n), t.shape)


_GENERATOR = [None]


def seed(s: int):
    """Restart the random draws of `random_normal` / `random_uniform` from `s`."""
    _GENERATOR[0] = torch.Generator().manual_seed(int(s))


def _generator() -> torch.Generator:
    if _GENERATOR[0] is None:
        seed(0)
    return _GENERATOR[0]


@contextlib.contextmanager
def using_generator(generator: torch.Generator):
    """Draw from `generator` (a CPU `torch.Generator`) within the context:
    a model that takes a seed draws its initial values from its own
    generator, whatever was drawn before."""
    old = _GENERATOR[0]
    _GENERATOR[0] = generator
    try:
        yield generator
    finally:
        _GENERATOR[0] = old


def _random(draw, shape: Shape, dtype) -> Tensor:
    """`draw(generator, torch dtype)` on the CPU generator, so that a seed
    gives the same numbers on every device, then on the default device."""
    native = draw(_generator(), _torch_dtype(dtype or default_float()))
    return Tensor(native.reshape(tuple(shape.sizes)).to(get_default_device()), shape)


def random_uniform(*shape: Shape, low=0., high=1., dtype=None) -> Tensor:
    s = concat_shapes(*shape)
    if np.issubdtype(np.dtype(dtype or default_float()), np.integer):
        return _random(lambda g, t: torch.randint(int(low), int(high), tuple(s.sizes), generator=g, dtype=t), s, dtype)
    return _random(lambda g, t: torch.rand(tuple(s.sizes), generator=g, dtype=t) * (high - low) + low, s, dtype)


def random_normal(*shape: Shape, dtype=None) -> Tensor:
    s = concat_shapes(*shape)
    return _random(lambda g, t: torch.randn(tuple(s.sizes), generator=g, dtype=t), s, dtype)


def linspace(start, stop, dim: Shape) -> Tensor:
    assert dim.rank == 1
    return Tensor(np.linspace(start, stop, dim.size, dtype=default_float()), dim)


def arange(dim: Shape, start=0, stop=None, step=1) -> Tensor:
    if stop is None:
        stop = start + dim.size * step
    n = np.arange(start, stop, step, dtype=np.int32)
    return Tensor(n, dim.with_size(int(n.shape[0])))


range_tensor = arange


def meshgrid(dims=spatial, stack_dim=channel('vector'), **sizes) -> Tensor:
    """Index grid: int tensor with spatial dims + a channel 'vector' labelled by the dim names (host)."""
    dim_fn = dims if callable(dims) else spatial
    grid_shape = dim_fn(**{k: (v if isinstance(v, int) else len(v)) for k, v in sizes.items()})
    arrays = [np.arange(v, dtype=np.int32) if isinstance(v, int) else np.asarray(v) for v in sizes.values()]
    mesh = np.meshgrid(*arrays, indexing='ij')
    sd = Shape((stack_dim.dims[0].with_size(len(arrays), tuple(sizes.keys())),))
    return Tensor(np.stack(mesh, axis=-1), concat_shapes(grid_shape, sd))


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------

def _stack_natives(natives, axis=0):
    if all(_is_host(n) for n in natives):
        return np.stack(natives, axis=axis)
    ref = next(n for n in natives if not _is_host(n))
    return torch.stack([_host_to(n, ref) if _is_host(n) else n for n in natives], axis)


def _cat_natives(natives, axis=0):
    if all(_is_host(n) for n in natives):
        return np.concatenate(natives, axis=axis)
    ref = next(n for n in natives if not _is_host(n))
    return torch.cat([_host_to(n, ref).expand(n.shape) if _is_host(n) else n for n in natives], axis)


def stack(values, dim: Shape, expand_values=False, **kwargs) -> Tensor:
    """Stack tensors (or a dict label → tensor) along a new dim. Inputs of
    different shapes make a `TensorStack`, which keeps them as they are."""
    if isinstance(values, dict):
        labels = tuple(values.keys())
        dim = Shape((dim.dims[0].with_size(len(labels), labels),))
        values = list(values.values())
    values = [wrap(v) for v in values]
    if expand_values:
        common = merge_shapes(*[v.shape for v in values], allow_varying_sizes=True)
        definite = Shape(tuple(d for d in common.dims if d.size is not None))
        values = [v._expand(definite.without(v.shape.names)) for v in values]
    dim = Shape((dim.dims[0].with_size(len(values), dim.dims[0].labels),))
    names0 = values[0].shape.names
    values = [v._transposed(names0) if (set(v.shape.names) == set(names0) and v.shape.names != names0) else v
              for v in values]
    shapes = [v.shape for v in values]
    if all(s == shapes[0] for s in shapes) and not any(isinstance(v, TensorStack) for v in values):
        return Tensor(_stack_natives([v.native() for v in values]), concat_shapes(dim, shapes[0]))
    return TensorStack(values, dim)


def unstack(value, dim: DimFilter) -> tuple:
    names = _resolve_filter(dim, value.shape)
    if len(names) > 1:
        value = pack_dims(value, names, batch('_unstack'))
        return value._unstack('_unstack')
    return value._unstack(names[0])


def concat(values: Sequence[Tensor], dim) -> Tensor:
    values = [wrap(v) for v in values]
    name = dim if isinstance(dim, str) else dim.name
    common = merge_shapes(*[v.shape.without(name) for v in values])
    natives, labels_parts, total, d0 = [], [], 0, None
    for v in values:
        if name not in v.shape:
            v = v._expand(Shape((Dim(name, 1, dim.dim_type if isinstance(dim, Shape) else CHANNEL),)))
        d = v.shape.get_dim(name)
        d0 = d0 or d
        labels_parts.append(d.labels)
        total += d.size
        an = _align_native(v._contiguous().native() if isinstance(v, TensorStack) else v.native(), v.shape,
                           (name,) + common.names)
        target = (d.size,) + tuple(common.sizes)
        natives.append(np.broadcast_to(an, target) if _is_host(an) else an.expand(target))
    labels = tuple(l for lp in labels_parts for l in lp) if all(lp is not None for lp in labels_parts) else None
    out_dim = Dim(name, total, d0.dim_type, labels)
    return Tensor(_cat_natives(natives), concat_shapes(Shape((out_dim,)), common))


def expand(value, *dims: Shape) -> Tensor:
    return wrap(value)._expand(concat_shapes(*dims))


def rename_dims(value, dims: DimFilter, names) -> Tensor:
    if isinstance(value, Shape):
        old = _resolve_filter(dims, value)
        new = names if isinstance(names, Shape) else None
        new_names = parse_dim_order(names)
        result = []
        for d in value.dims:
            if d.name in old:
                i = old.index(d.name)
                if new is not None:
                    nd = new.dims[i]
                    result.append(Dim(nd.name, d.size, nd.dim_type, nd.labels or d.labels))
                else:
                    result.append(Dim(new_names[i], d.size, d.dim_type, d.labels))
            else:
                result.append(d)
        return Shape(tuple(result))
    value = wrap(value)
    if isinstance(value, TensorStack):
        old = _resolve_filter(dims, value.shape)
        sname = value.stack_dim.name
        if sname in old:
            new_list = names if isinstance(names, Shape) else parse_dim_order(names)
            new_sd = rename_dims(value.stack_dim, sname,
                                 names[old.index(sname)] if isinstance(names, Shape) else new_list[old.index(sname)])
            rest_old = tuple(n for n in old if n != sname)
            comps = value.components
            if rest_old:
                rest_new = [n for o, n in zip(old, parse_dim_order(names)) if o != sname]
                comps = [rename_dims(c, rest_old, rest_new) for c in comps]
            return TensorStack(comps, new_sd)
        return TensorStack([rename_dims(c, dims, names) for c in value.components], value.stack_dim)
    return Tensor(value.native(), rename_dims(value.shape, dims, names))


def pack_dims(value: Tensor, dims: DimFilter, packed_dim: Shape, pos=None) -> Tensor:
    value = wrap(value)
    if isinstance(value, TensorStack):
        value = value._contiguous()
    names = [n for n in _resolve_filter(dims, value.shape) if n in value.shape]
    if not names:
        return value._expand(packed_dim.with_size(1))
    if len(names) == 1 and packed_dim.rank == 1:
        return rename_dims(value, names[0], packed_dim)
    other = [n for n in value.shape.names if n not in names]
    order = tuple(names) + tuple(other)
    t = value._transposed(order)
    volume = int(np.prod([t.shape.get_size(n) for n in names]))
    native = t.native().reshape((volume,) + tuple(t.shape.sizes[len(names):]))
    pd = packed_dim.dims[0].with_size(volume)
    return Tensor(native, Shape((pd,) + t.shape.dims[len(names):]))


def flatten(value, flat_dim: Shape = instance('flat')) -> Tensor:
    """All dims of `value` packed into `flat_dim`, in the value's order."""
    return pack_dims(value, lambda s: s, flat_dim)


def unpack_dim(value: Tensor, dim, *unpacked: Shape) -> Tensor:
    value = wrap(value)
    name = dim if isinstance(dim, str) else dim.name
    target = concat_shapes(*unpacked)
    i = value.shape.index(name)
    sizes = value.shape.sizes
    native = value.native().reshape(sizes[:i] + tuple(target.sizes) + sizes[i + 1:])
    return Tensor(native, Shape(value.shape.dims[:i] + target.dims + value.shape.dims[i + 1:]))


def transpose(value: Tensor, order) -> Tensor:
    return wrap(value)._transposed(parse_dim_order(order))


def squeeze(value: Tensor, dims: DimFilter) -> Tensor:
    for n in _resolve_filter(dims, value.shape):
        assert value.shape.get_size(n) == 1
        value = value[{n: 0}]
    return value


# ---------------------------------------------------------------------------
# elementwise math
# ---------------------------------------------------------------------------

def _unary(np_fn, torch_fn):
    def host(n, *args, **kwargs):
        with np.errstate(invalid='ignore', divide='ignore', over='ignore'):  # NaN and ±inf as results, as in JAX
            return np_fn(n, *args, **kwargs)

    def op(x, *args, **kwargs):
        return wrap(x)._op1(lambda n: host(n, *args, **kwargs) if _is_host(n) else torch_fn(n, *args, **kwargs))
    return op


def _on_cpu(torch_fn):
    """A host array through `torch_fn` on the CPU, back as numpy: for the
    functions numpy lacks (erf, the gamma function)."""
    return lambda n: torch_fn(torch.from_numpy(np.ascontiguousarray(n))).numpy()


def _torch_sign(n):
    """sign with NaN kept, as `jnp.sign` has it (`torch.sign(nan)` is 0)."""
    return torch.where(torch.isnan(n), n, torch.sign(n)) if n.is_floating_point() else torch.sign(n)


def _torch_imag(n):
    """The imaginary part; 0 for real input, as `jnp.imag` gives it."""
    return torch.imag(n) if n.is_complex() else torch.zeros_like(n)


def _torch_factorial(n):
    """n! as Γ(n + 1), 0 for negative n (`jax.scipy.special.factorial`)."""
    x = n if n.is_floating_point() else n.to(_torch_dtype(default_float()))
    return torch.where(x < 0, torch.zeros_like(x), torch.exp(torch.lgamma(x + 1)))


def _torch_sigmoid(n):
    return torch.sigmoid(n if n.is_floating_point() else n.to(_torch_dtype(default_float())))


abs_ = _unary(np.abs, torch.abs)
sign = _unary(np.sign, _torch_sign)
sqrt = _unary(np.sqrt, torch.sqrt)
exp = _unary(np.exp, torch.exp)
log = _unary(np.log, torch.log)
log2 = _unary(np.log2, torch.log2)
log10 = _unary(np.log10, torch.log10)
sin = _unary(np.sin, torch.sin)
cos = _unary(np.cos, torch.cos)
tan = _unary(np.tan, torch.tan)
arcsin = _unary(np.arcsin, torch.arcsin)
arccos = _unary(np.arccos, torch.arccos)
_arctan1 = _unary(np.arctan, torch.arctan)
sinh = _unary(np.sinh, torch.sinh)
cosh = _unary(np.cosh, torch.cosh)
tanh = _unary(np.tanh, torch.tanh)
floor = _unary(np.floor, torch.floor)
ceil = _unary(np.ceil, torch.ceil)
round_ = _unary(np.round, torch.round)
is_finite = _unary(np.isfinite, torch.isfinite)
is_nan = _unary(np.isnan, torch.isnan)
is_inf = _unary(np.isinf, torch.isinf)
real = _unary(np.real, torch.real)
imag = _unary(np.imag, _torch_imag)
conjugate = _unary(np.conj, lambda n: torch.conj(n).resolve_conj())
sigmoid = _unary(lambda n: 1 / (1 + np.exp(-n)), _torch_sigmoid)
erf = _unary(_on_cpu(torch.erf), torch.erf)
factorial = _unary(_on_cpu(_torch_factorial), _torch_factorial)


def arctan(x, divide_by=None) -> Tensor:
    """arctan(x), or the full-quadrant arctan2(x, divide_by) when `divide_by` is given."""
    if divide_by is None:
        return _arctan1(x)
    return arctan2(x, divide_by)


def degrees_to_radians(x):
    return wrap(x) * (np.pi / 180)


def radians_to_degrees(x):
    return wrap(x) * (180 / np.pi)


def _torch_dtype(np_dtype):
    from ._tensor import _TORCH_DTYPES
    return _TORCH_DTYPES[np.dtype(np_dtype)]


def cast(x, dtype) -> Tensor:
    """`x` as `dtype` (a numpy or torch dtype)."""
    def fn(n):
        if _is_host(n):
            from ._tensor import _TORCH_DTYPES
            np_dtype = next((k for k, v in _TORCH_DTYPES.items() if v == dtype), dtype) \
                if isinstance(dtype, torch.dtype) else dtype
            return n.astype(np_dtype)
        return n.to(dtype if isinstance(dtype, torch.dtype) else _torch_dtype(dtype))
    return wrap(x)._op1(fn)


def to_float(x) -> Tensor:
    return cast(x, default_float())


def to_int32(x) -> Tensor:
    return cast(x, np.int32)


def to_int64(x) -> Tensor:
    return cast(x, np.int64)


def to_bool(x) -> Tensor:
    return cast(x, np.bool_)


def _binary(np_fn, torch_fn):
    """A function of two natives on either backend; a scalar meeting a torch
    tensor becomes a 0-dim CPU tensor of its dtype (a scalar operand)."""
    def fn(a, b):
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            return np_fn(a, b)
        a, b = _meet(a, b)
        if not isinstance(a, torch.Tensor):
            a = torch.tensor(a, dtype=b.dtype)
        if not isinstance(b, torch.Tensor):
            b = torch.tensor(b, dtype=a.dtype)
        return torch_fn(a, b)
    return fn


_maximum = _binary(np.maximum, torch.maximum)
_minimum = _binary(np.minimum, torch.minimum)
_arctan2 = _binary(np.arctan2, torch.atan2)


def arctan2(y, x) -> Tensor:
    return wrap(y)._op2(wrap(x), _arctan2)


def maximum(a, b) -> Tensor:
    return wrap(a)._op2(b, _maximum)


def minimum(a, b) -> Tensor:
    return wrap(a)._op2(b, _minimum)


def clip(x, lower=0., upper=1.) -> Tensor:
    return minimum(maximum(wrap(x), lower), upper)


def where(condition, value_true=1., value_false=0.) -> Tensor:
    if any(hasattr(x, 'geometry') and hasattr(x, 'values') for x in (condition, value_true, value_false)):
        from ..field._field_math import where as field_where
        return field_where(condition, value_true, value_false)
    condition, vt, vf = wrap(condition), wrap(value_true), wrap(value_false)
    stacks = [t for t in (condition, vt, vf) if isinstance(t, TensorStack)]
    if stacks:
        sd = stacks[0].stack_dim

        def comp(t, i):
            return t[{sd.name: i}] if sd.name in t.shape else t
        return TensorStack([where(comp(condition, i), comp(vt, i), comp(vf, i)) for i in range(sd.size)], sd)
    shape = merge_shapes(condition.shape, vt.shape, vf.shape)
    c, a, b = (_align_native(t.native(), t.shape, shape.names) for t in (condition, vt, vf))
    if all(_is_host(x) for x in (c, a, b)):
        return Tensor(np.broadcast_to(_fix_host_dtype(np.where(c, a, b), a, b), tuple(shape.sizes)), shape)
    ref = next(x for x in (c, a, b) if not _is_host(x))
    c = _host_to(c, ref) if _is_host(c) else c
    if c.dtype != torch.bool:  # a numeric condition holds where it is nonzero, as in numpy and JAX
        c = c != 0
    # a one-element host value of the other value's dtype enters as a Python number: no copy to the device
    if _is_host(a) != _is_host(b):
        host, dev = (a, b) if _is_host(a) else (b, a)
        if host.size == 1 and _torch_dtype(host.dtype) == dev.dtype:
            a, b = (host.item(), dev) if _is_host(a) else (dev, host.item())
            return Tensor(torch.where(c.to(dev.device), a, b).expand(tuple(shape.sizes)), shape)
    a, b = (_host_to(x, ref) if _is_host(x) else x for x in (a, b))
    if a.dtype != b.dtype and a.ndim == 0 and b.ndim:
        a = a.to(b.dtype)
    elif a.dtype != b.dtype and b.ndim == 0 and a.ndim:
        b = b.to(a.dtype)
    return Tensor(torch.where(c.to(ref.device), a.to(ref.device), b.to(ref.device)).expand(tuple(shape.sizes)), shape)


def safe_div(numerator, denominator) -> Tensor:
    n, d = wrap(numerator), wrap(denominator)

    def fn(a, b):
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            with np.errstate(divide='ignore', invalid='ignore'):
                return np.where(b == 0, np.zeros_like(a * b), a / np.where(b == 0, np.ones_like(b), b))
        a, b = _meet(a, b)
        like = a if isinstance(a, torch.Tensor) else b
        a, b = (x if isinstance(x, torch.Tensor) else torch.full_like(like, x) for x in (a, b))
        return torch.where(b == 0, torch.zeros_like(a * b), a / torch.where(b == 0, torch.ones_like(b), b))
    return n._op2(d, fn)


def nan_to_0(x) -> Tensor:
    return wrap(x)._op1(lambda n: np.nan_to_num(n, nan=0.0, posinf=0.0, neginf=0.0) if _is_host(n)
                        else torch.nan_to_num(n, nan=0.0, posinf=0.0, neginf=0.0))


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------

def _np_or_torch(np_fn, torch_fn):
    def fn(n, axes):
        return np_fn(n, axis=axes) if _is_host(n) else torch_fn(n, axes)
    return fn


def _int_result(n: torch.Tensor):
    """The dtype of an integer or boolean sum or product as the JAX package
    gives it: int64 stays int64, narrower integers and booleans give int32
    (torch promotes them all to int64)."""
    if n.is_floating_point() or n.is_complex():
        return None
    return torch.int64 if n.dtype == torch.int64 else torch.int32


def _t_sum(n, axes):
    return torch.sum(n, dim=axes, dtype=_int_result(n))


def _t_mean(n, axes):
    """The mean; of an integer or boolean tensor in the default float, as in JAX."""
    if not (n.is_floating_point() or n.is_complex()):
        n = n.to(_torch_dtype(default_float()))
    return torch.mean(n, dim=axes)


def _t_prod(n, axes):
    dtype = _int_result(n)
    for ax in sorted(axes, reverse=True):
        n = torch.prod(n, dim=ax, dtype=dtype)
    return n


def _t_std(n, axes):
    """The population standard deviation (`jnp.std`, no correction)."""
    if not (n.is_floating_point() or n.is_complex()):
        n = n.to(_torch_dtype(default_float()))
    return torch.std(n, dim=axes, correction=0)


def _t_max(n, axes):
    return torch.amax(n, dim=axes)


def _t_min(n, axes):
    return torch.amin(n, dim=axes)


def _t_any(n, axes):
    for ax in sorted(axes, reverse=True):
        n = torch.any(n, dim=ax)
    return n


def _t_all(n, axes):
    for ax in sorted(axes, reverse=True):
        n = torch.all(n, dim=ax)
    return n


def _reduce(value, dim: DimFilter, native_fn, default_filter=lambda s: s.non_batch) -> Tensor:
    value = wrap(value)
    if isinstance(value, TensorStack):
        if value.is_uniform:
            value = value._contiguous()
        else:
            # a staggered grid's components: reduce each, then over the stack dim
            reduced = [_reduce(c, dim, native_fn, default_filter) for c in value.components]
            if dim is None or value.stack_dim.name in _resolve_filter(dim, value.shape):
                if any(r.shape for r in reduced):
                    raise NotImplementedError("partial reduction over non-uniform stack: reduce components first")
                return Tensor(native_fn(_stack_natives([r.native() for r in reduced]), (0,)), EMPTY_SHAPE)
            return TensorStack(reduced, value.stack_dim)
    if dim is None:
        names = default_filter(value.shape).names
    else:
        names = [n for n in _resolve_filter(dim, value.shape) if n in value.shape]
    if not names:
        return value
    axes = tuple(value.shape.index(n) for n in names)
    native = native_fn(value.native(), axes)
    return Tensor(_fix_host_dtype(native, value.native()), value.shape.without(names))


_sum = _np_or_torch(np.sum, _t_sum)
_mean = _np_or_torch(np.mean, _t_mean)
_max = _np_or_torch(np.max, _t_max)
_min = _np_or_torch(np.min, _t_min)
_any = _np_or_torch(np.any, _t_any)
_all = _np_or_torch(np.all, _t_all)
_prod = _np_or_torch(np.prod, _t_prod)
_std = _np_or_torch(np.std, _t_std)


def sum_(value, dim: DimFilter = None) -> Tensor:
    if isinstance(value, (tuple, list)):
        return functools.reduce(lambda a, b: wrap(a) + b, value)
    return _reduce(value, dim, _sum)


def mean(value, dim: DimFilter = None, weight=None) -> Tensor:
    if weight is not None:
        w = wrap(weight)
        return sum_(wrap(value) * w, dim) / sum_(w, dim)
    return _reduce(value, dim, _mean)


def prod(value, dim: DimFilter = None) -> Tensor:
    return _reduce(value, dim, _prod)


def max_(value, dim: DimFilter = None) -> Tensor:
    if isinstance(value, (tuple, list)):
        return functools.reduce(maximum, [wrap(v) for v in value])
    return _reduce(value, dim, _max)


def min_(value, dim: DimFilter = None) -> Tensor:
    if isinstance(value, (tuple, list)):
        return functools.reduce(minimum, [wrap(v) for v in value])
    return _reduce(value, dim, _min)


def std(value, dim: DimFilter = None) -> Tensor:
    """The standard deviation over `dim` (default: the non-batch dims), without correction."""
    return _reduce(value, dim, _std)


def any_(value, dim: DimFilter = None) -> Tensor:
    return _reduce(value, dim, _any, default_filter=lambda s: s)


def all_(value, dim: DimFilter = None) -> Tensor:
    return _reduce(value, dim, _all, default_filter=lambda s: s)


def finite_mean(value, dim: DimFilter = None) -> Tensor:
    value = wrap(value)
    fin = is_finite(value)
    return safe_div(sum_(where(fin, value, 0), dim), sum_(to_float(fin), dim))


def finite_sum(value, dim: DimFilter = None) -> Tensor:
    value = wrap(value)
    return sum_(where(is_finite(value), value, 0), dim)


def finite_max(value, dim: DimFilter = None) -> Tensor:
    value = wrap(value)
    return max_(where(is_finite(value), value, -np.inf), dim)


def finite_min(value, dim: DimFilter = None) -> Tensor:
    value = wrap(value)
    return min_(where(is_finite(value), value, np.inf), dim)


def at_max(value, key, dim: DimFilter):
    """`value` where `key` is largest along `dim`."""
    key = wrap(key)
    names = [n for n in _resolve_filter(dim, key.shape) if n in key.shape]
    packed = len(names) > 1
    idx = argmax(pack_dims(key, names, instance('_amax')) if packed else key, '_amax' if packed else names[0])
    value = wrap(value)
    value = pack_dims(value, names, instance('_amax')) if packed else value
    return gather(value, idx, dims='_amax' if packed else names[0])


def _arg_extremum(value, dim, np_fn, torch_fn) -> Tensor:
    value = wrap(value)
    names = _resolve_filter(dim, value.shape)
    assert len(names) == 1, f"one dim expected, got {names}"
    axis = value.shape.index(names[0])
    n = value.native()
    native = np_fn(n, axis=axis).astype(np.int32) if _is_host(n) else torch_fn(n, dim=axis).to(torch.int32)
    return Tensor(native, value.shape.without(names[0]))


def argmax(value: Tensor, dim: DimFilter) -> Tensor:
    """The int32 index of the largest entry along `dim` (the first NaN, if any)."""
    return _arg_extremum(value, dim, np.argmax, torch.argmax)


def argmin(value: Tensor, dim: DimFilter) -> Tensor:
    """The int32 index of the smallest entry along `dim` (the first NaN, if any)."""
    return _arg_extremum(value, dim, np.argmin, torch.argmin)


def cumulative_sum(value: Tensor, dim: DimFilter) -> Tensor:
    """The running sum along `dim`; integers and booleans as `sum` gives them."""
    value = wrap(value)
    names = _resolve_filter(dim, value.shape)
    axis = value.shape.index(names[0])
    n = value.native()
    native = np.cumsum(n, axis=axis) if _is_host(n) else torch.cumsum(n, dim=axis, dtype=_int_result(n))
    return Tensor(_fix_host_dtype(native, n), value.shape)


def dot(a: Tensor, a_dims, b: Tensor, b_dims) -> Tensor:
    """Contract `a_dims` of a with `b_dims` of b; dims of both that remain are
    batch dims of the product."""
    a, b = wrap(a), wrap(b)
    a_names = _resolve_filter(a_dims, a.shape)
    b_names = _resolve_filter(b_dims, b.shape)
    a_rem, b_rem = a.shape.without(a_names), b.shape.without(b_names)
    shared = [n for n in a_rem.names if n in b_rem]
    a_only, b_only = a_rem.without(shared), b_rem.without(shared)
    an = a.native(tuple(shared) + a_only.names + tuple(a_names))
    bn = b.native(tuple(shared) + tuple(b_names) + b_only.names)
    an, bn = _meet(an, bn)
    k = int(np.prod([a.shape.get_size(n) for n in a_names]))
    s_sizes = tuple(a.shape.get_size(n) for n in shared)
    am = an.reshape(s_sizes + (int(np.prod(a_only.sizes)), k))
    bm = bn.reshape(s_sizes + (k, int(np.prod(b_only.sizes))))
    out = (np.matmul if _is_host(am) else torch.matmul)(am, bm)
    out = out.reshape(s_sizes + tuple(a_only.sizes) + tuple(b_only.sizes))
    return Tensor(out, concat_shapes(a.shape.only(shared, reorder=True), a_only, b_only))


# ---------------------------------------------------------------------------
# comparison / testing (on the host: a torch native is copied there)
# ---------------------------------------------------------------------------

def _pair_numpy(first, other):
    f = first._contiguous() if isinstance(first, TensorStack) else first
    o = other._contiguous() if isinstance(other, TensorStack) else other
    an, bn, _ = _broadcast(f, o)
    return _host(an), _host(bn)


def close(*tensors, rel_tolerance=1e-5, abs_tolerance=0, equal_nan=False) -> bool:
    tensors = [wrap(t) for t in tensors]
    for other in tensors[1:]:
        an, bn = _pair_numpy(tensors[0], other)
        if not np.allclose(an, bn, rtol=rel_tolerance, atol=abs_tolerance, equal_nan=equal_nan):
            return False
    return True


always_close = close


def assert_close(*tensors, rel_tolerance=1e-5, abs_tolerance=0, msg="", equal_nan=False):
    tensors = [wrap(t) for t in tensors]
    for other in tensors[1:]:
        an, bn = _pair_numpy(tensors[0], other)
        np.testing.assert_allclose(an, bn, rtol=rel_tolerance, atol=abs_tolerance, err_msg=msg,
                                   equal_nan=bool(equal_nan))


def equal(a, b) -> bool:
    try:
        return close(a, b, rel_tolerance=0, abs_tolerance=0)
    except Exception:
        return False


# ---------------------------------------------------------------------------
# padding & shifting
# ---------------------------------------------------------------------------

def pad(value: Tensor, widths: dict, mode=0, **kwargs) -> Tensor:
    """Pad along named dims. `mode` is an Extrapolation, Tensor, or number."""
    from ._extrapolation import as_extrapolation
    value = wrap(value)
    if isinstance(value, TensorStack):
        return TensorStack([pad(c, {k: v for k, v in widths.items() if k in c.shape}, mode, **kwargs)
                            for c in value.components], value.stack_dim)
    return as_extrapolation(mode).pad(value, widths, **kwargs)


def shift(value: Tensor, offsets: tuple, dims: DimFilter = spatial, padding=None, stack_dim=channel('shift'),
          extend_bounds=0):
    """Shifted copies of `value`, one per offset: padded with `padding` if
    given, else trimmed to the overlap."""
    value = wrap(value)
    names = [n for n in _resolve_filter(dims, value.shape) if n in value.shape]
    pad_lower = max(0, -min(offsets)) + extend_bounds
    pad_upper = max(0, max(offsets)) + extend_bounds
    if padding is not None:
        value = pad(value, {n: (pad_lower, pad_upper) for n in names}, padding)
    results = []
    for offset in offsets:
        components = {}
        for n in names:
            size = value.shape.get_size(n)
            if padding is not None:
                start, length = pad_lower + offset, size - pad_lower - pad_upper
            else:
                start, length = offset - min(offsets), size - (max(offsets) - min(offsets))
            components[n] = value[{n: slice(start, start + length)}]
        if stack_dim is None:
            assert len(names) == 1
            results.append(components[names[0]])
        else:
            results.append(stack(components, stack_dim))
    return results


# ---------------------------------------------------------------------------
# vectors
# ---------------------------------------------------------------------------

def vec(name='vector', **components) -> Tensor:
    return stack({k: wrap(v) for k, v in components.items()}, channel(name), expand_values=True)


def vec_squared(v: Tensor, vec_dim: DimFilter = channel) -> Tensor:
    v = wrap(v)
    if isinstance(v, TensorStack):
        return sum_([c ** 2 for c in v.components])
    return sum_(v ** 2, vec_dim)


def vec_length(v: Tensor, vec_dim: DimFilter = channel, eps=None) -> Tensor:
    sq = vec_squared(wrap(v), vec_dim)
    if eps is not None:
        sq = maximum(sq, eps)
    return sqrt(sq)


def vec_normalize(v: Tensor, vec_dim: DimFilter = channel, epsilon=1e-15) -> Tensor:
    v = wrap(v)
    return v / vec_length(v, vec_dim, eps=epsilon)


norm = vec_length
length = vec_length
squared_norm = vec_squared
normalize = vec_normalize


def cross(a: Tensor, b: Tensor) -> Tensor:
    """The cross product of two vectors: a scalar for 2D, a vector for 3D."""
    a, b = wrap(a), wrap(b)
    ch = a.shape.channel.only('vector') if 'vector' in a.shape else a.shape.channel[0:1]
    n = ch.size if ch else b.shape.channel.size
    if n == 2:
        return a.vector[0] * b.vector[1] - a.vector[1] * b.vector[0]
    assert n == 3
    labels = a.shape.get_labels('vector') or ('x', 'y', 'z')
    av, bv = [a.vector[i] for i in range(3)], [b.vector[i] for i in range(3)]
    return stack({labels[0]: av[1] * bv[2] - av[2] * bv[1],
                  labels[1]: av[2] * bv[0] - av[0] * bv[2],
                  labels[2]: av[0] * bv[1] - av[1] * bv[0]}, channel('vector'), expand_values=True)


cross_product = cross


def dim_mask(all_dims: Shape, dims: DimFilter, mask_dim=channel('vector')) -> Tensor:
    if all_dims.rank == 1 and all_dims.dims[0].labels:
        all_names = all_dims.dims[0].labels
    elif all_dims.spatial:
        all_names = all_dims.spatial.names
    else:
        all_names = all_dims.names
    names = parse_dim_order(dims) if not callable(dims) or isinstance(dims, Shape) else dims(all_dims).names
    d = mask_dim.dims[0].with_size(len(all_names), all_names)
    return Tensor(np.asarray([1.0 if n in names else 0.0 for n in all_names], default_float()), Shape((d,)))


# ---------------------------------------------------------------------------
# gather / scatter / boolean mask (the particle ops)
# ---------------------------------------------------------------------------

def _index_components(indices: Tensor, dims, target: Shape):
    """(dims, one integer Tensor per dim): the entries of a channel dim whose
    labels name the dims, or `indices` itself for one dim."""
    ch = indices.shape.channel
    if dims is None:
        if ch.rank == 1 and ch.labels[0]:
            dims = ch.labels[0]
            return tuple(dims), [indices[{ch.name: i}] for i in range(len(dims))]
        dims = target.instance.names or target.spatial.names
        assert len(dims) == 1, f"cannot infer the indexed dim of {target}"
        return tuple(dims), [indices]
    dims = _resolve_filter(dims, target)
    if ch.rank == 1 and ch.size == len(dims) and len(dims) > 1:
        return tuple(dims), [indices[{ch.name: i}] for i in range(len(dims))]
    assert len(dims) == 1
    return tuple(dims), [indices]


def _linear_index(components, sizes, list_shape: Shape, clamp=False):
    """The row-major linear index of integer components over `list_shape`,
    and (with `clamp`) the mask of entries inside every dim, as natives."""
    lin, valid = None, None
    for c, n in zip(components, sizes):
        cn = _align_native(c.native(), c.shape, list_shape.names)
        if _is_host(cn):
            cn = np.broadcast_to(cn.astype(np.int64), tuple(list_shape.sizes))
        else:
            cn = cn.to(torch.int64).expand(tuple(list_shape.sizes))
        if clamp:
            inside = (cn >= 0) & (cn < n)
            valid = inside if valid is None else valid & inside
            cn = np.clip(cn, 0, n - 1) if _is_host(cn) else torch.clamp(cn, 0, n - 1)
        lin = cn if lin is None else lin * n + cn
    return lin, valid


def _same_place(a, b):
    """Two natives on one backend: a host array meets a torch tensor on its device."""
    if _is_host(a) and not _is_host(b):
        return _host_to(a, b), b
    if _is_host(b) and not _is_host(a):
        return a, _host_to(b, a)
    return a, b


def gather(values: Tensor, indices: Tensor, dims: DimFilter = None) -> Tensor:
    """Gather slices of `values` at `indices`.

    `indices` either has a channel dim whose labels name the gathered dims,
    or `dims` names the dim(s) and `indices` is integer-valued (a channel dim
    of as many entries for several dims)."""
    values, indices = wrap(values), wrap(indices)
    if isinstance(values, TensorStack):
        if not values.is_uniform:
            raise NotImplementedError("gather on non-uniform stack")
        values = values._contiguous()
    dims, components = _index_components(indices, dims, values.shape)
    batch_shape = merge_shapes(*[c.shape for c in components])
    kept = values.shape.without(dims)
    sizes = [values.shape.get_size(d) for d in dims]
    flat = values._transposed(dims + kept.names).native()
    flat = flat.reshape((int(np.prod(sizes)),) + tuple(kept.sizes))
    lin, _ = _linear_index(components, sizes, batch_shape)
    flat, lin = _same_place(flat, lin)
    lin = lin.reshape(-1)
    gathered = np.take(flat, lin, axis=0) if _is_host(flat) else torch.index_select(flat, 0, lin)
    gathered = gathered.reshape(tuple(batch_shape.sizes) + tuple(kept.sizes))
    return Tensor(gathered, concat_shapes(batch_shape, kept))


def _scatter_host(out, lin, vals, mode):
    if mode == 'update':
        out[lin] = vals
    elif mode in ('add', 'mean'):
        np.add.at(out, lin, vals)
    elif mode in ('max', 'maximum'):
        np.maximum.at(out, lin, vals)
    else:
        np.minimum.at(out, lin, vals)
    return out


def _scatter_torch(out, lin, vals, mode):
    if mode == 'update':
        return out.index_put_((lin,), vals)
    if mode in ('add', 'mean'):
        return out.index_add_(0, lin, vals)
    index = lin.reshape((-1,) + (1,) * (vals.ndim - 1)).expand(vals.shape)
    return out.scatter_reduce_(0, index, vals, 'amax' if mode in ('max', 'maximum') else 'amin')


def scatter(base_grid, indices: Tensor, values, mode: str = 'update', outside_handling: str = 'discard',
            indices_gradient=False, default=None) -> Tensor:
    """Scatter `values` into `base_grid` at `indices` with `mode` 'update',
    'add', 'mean', 'max' or 'min'; indices outside the grid are dropped
    ('discard'), moved to its edge ('clamp') or trusted ('undefined').
    `base_grid` may be a Shape (zeros, or `default`, of it)."""
    if mode not in ('update', 'add', 'mean', 'max', 'maximum', 'min', 'minimum'):
        raise ValueError(f"scatter mode {mode!r}")
    if isinstance(base_grid, Shape):
        base = zeros(base_grid) + (0 if default is None else default)
    else:
        base = wrap(base_grid)
    values, indices = wrap(values), wrap(indices)
    if isinstance(values, TensorStack):
        values = values._contiguous()
    dims, components = _index_components(indices, None, base.shape)
    list_shape = merge_shapes(*[c.shape for c in components])
    kept = base.shape.without(dims)
    sizes = [base.shape.get_size(d) for d in dims]
    target = tuple(list_shape.sizes) + tuple(kept.sizes)
    vn = _align_native(values.native(), values.shape, list_shape.names + kept.names)
    lin, valid = _linear_index(components, sizes, list_shape, clamp=outside_handling in ('clamp', 'discard'))
    flat_size = int(np.prod(sizes))
    bt = base._transposed(dims + kept.names)
    flat_base = bt.native().reshape((flat_size,) + tuple(kept.sizes))
    if outside_handling == 'discard':
        # invalid writes go to one extra row, dropped after
        lin = np.where(valid, lin, flat_size) if _is_host(lin) else torch.where(valid, lin, flat_size)
        pad_row = (1,) + tuple(kept.sizes)
        flat_base = np.concatenate([flat_base, np.zeros(pad_row, flat_base.dtype)]) if _is_host(flat_base) else \
            torch.cat([flat_base, flat_base.new_zeros(pad_row)])
    if all(_is_host(x) for x in (flat_base, lin, vn)):
        vals = np.broadcast_to(vn, target).reshape((-1,) + tuple(kept.sizes)).astype(flat_base.dtype)
        lin = lin.reshape(-1)
        out = _scatter_host(np.array(flat_base) if mode != 'mean' else np.zeros_like(flat_base), lin, vals, mode)
        if mode == 'mean':
            counts = np.zeros((flat_base.shape[0],) + (1,) * (vals.ndim - 1), flat_base.dtype)
            np.add.at(counts, lin, np.ones((vals.shape[0],) + (1,) * (vals.ndim - 1), flat_base.dtype))
            out = np.where(counts > 0, out / np.maximum(counts, 1), flat_base)
    else:
        ref = next(x for x in (flat_base, lin, vn) if not _is_host(x))
        flat_base, lin, vn = (_host_to(x, ref) if _is_host(x) else x for x in (flat_base, lin, vn))
        vals = vn.expand(target).reshape((-1,) + tuple(kept.sizes)).to(flat_base.dtype)
        lin = lin.reshape(-1)
        out = _scatter_torch(flat_base.clone() if mode != 'mean' else torch.zeros_like(flat_base), lin, vals, mode)
        if mode == 'mean':
            counts = torch.zeros((flat_base.shape[0],) + (1,) * (vals.ndim - 1), dtype=flat_base.dtype,
                                 device=flat_base.device)
            counts.index_add_(0, lin, torch.ones((vals.shape[0],) + (1,) * (vals.ndim - 1), dtype=flat_base.dtype,
                                                 device=flat_base.device))
            out = torch.where(counts > 0, out / torch.clamp(counts, min=1), flat_base)
    if outside_handling == 'discard':
        out = out[:-1]
    out = out.reshape(tuple(bt.shape.sizes))
    return Tensor(out, bt.shape)._transposed(base.shape.names)


def boolean_mask(value: Tensor, dim: DimFilter, mask: Tensor) -> Tensor:
    """The slices of `value` along `dim` where `mask` is True. The size of the
    result depends on the data: on the card it waits for the mask."""
    value, mask = wrap(value), wrap(mask)
    names = _resolve_filter(dim, value.shape)
    assert len(names) == 1, "boolean_mask supports a single dim"
    name = names[0]
    axis = value.shape.index(name)
    native, m = value.native(), mask.native()
    if _is_host(native) and _is_host(m):
        idx = np.nonzero(np.asarray(m))[0]
        result = np.take(native, idx, axis=axis)
    else:
        native, m = _same_place(native, m)
        idx = torch.nonzero(m.reshape(-1)).reshape(-1)
        result = torch.index_select(native, axis, idx)
    return Tensor(result, value.shape.with_dim_size(name, int(idx.shape[0])))


def nonzero(value: Tensor, list_dim=instance('nonzero'), index_dim=channel('vector')) -> Tensor:
    """The int32 indices of the non-zero entries of `value`, one per entry of
    `list_dim`, labelled by `value`'s dims along `index_dim`."""
    value = wrap(value)
    dims = value.shape.non_batch.non_channel
    arr = value.native()
    if _is_host(arr):
        idx = np.stack(np.nonzero(arr), axis=-1).astype(np.int32)
    else:
        idx = torch.nonzero(arr).to(torch.int32)
    ld = list_dim.dims[0].with_size(int(idx.shape[0]))
    cd = index_dim.dims[0].with_size(len(dims.names), dims.names)
    return Tensor(idx, Shape((ld, cd)))


# ---------------------------------------------------------------------------
# order statistics
# ---------------------------------------------------------------------------

def quantile(value: Tensor, quantiles, dims: DimFilter = None) -> Tensor:
    """Quantiles of `value` over `dims` (default: all non-batch dims), with
    linear interpolation; several quantiles along a channel dim 'quantiles'."""
    value = wrap(value)
    names = tuple(_resolve_filter(dims, value.shape)) if dims is not None else value.shape.non_batch.names
    q_list = quantiles if isinstance(quantiles, (tuple, list)) else [quantiles]
    keep = value.shape.without(names)
    native = value.native(tuple(keep.names) + tuple(names))
    flat = native.reshape(tuple(keep.sizes) + (-1,))
    if _is_host(flat):
        result = np.quantile(flat, np.asarray(q_list, flat.dtype), axis=-1).astype(flat.dtype)
        result = np.moveaxis(result, 0, -1)
    else:
        q = torch.tensor(q_list, dtype=flat.dtype).to(flat.device)
        result = torch.movedim(torch.quantile(flat, q, dim=-1), 0, -1)
    out = Tensor(result, concat_shapes(keep, Shape((Dim('quantiles', len(q_list), CHANNEL, None),))))
    return out if isinstance(quantiles, (tuple, list)) else out[{'quantiles': 0}]


def median(value: Tensor, dims: DimFilter = None) -> Tensor:
    """Median over `dims` (default: all non-batch dims)."""
    return quantile(value, 0.5, dims)


def histogram(values: Tensor, bins=20, weights=None, same_bins: DimFilter = None):
    """(counts, bin edges) of all entries of `values`: `bins` equal bins from
    the smallest to the largest entry (or the given edges), counts along a
    spatial dim `bins`. As `jnp.histogram`: a value goes to the bin whose
    lower edge it reaches, the largest edge into the last bin, values
    outside the edges nowhere; the counts have the weights' dtype."""
    values = wrap(values)
    native = values.native().reshape(-1)
    w = None if weights is None else wrap(weights).native().reshape(-1)
    if isinstance(bins, Tensor):
        bins = bins.native()
    if _is_host(native) and (w is None or _is_host(w)) and (isinstance(bins, int) or _is_host(np.asarray(bins))):
        edges = np.linspace(native.min(), native.max(), bins + 1).astype(native.dtype) if isinstance(bins, int) \
            else np.asarray(bins)
        w = np.ones_like(native) if w is None else w
        idx = np.searchsorted(edges, native, side='right')
        idx = np.where(native == edges[-1], len(edges) - 1, idx)
        counts = np.zeros(len(edges) + 1, w.dtype)
        np.add.at(counts, idx, w)
        counts = counts[1:len(edges)]
    else:
        native = to_torch(native)
        if isinstance(bins, int):
            edges = torch.linspace(0, 1, bins + 1, dtype=native.dtype, device=native.device)
            lo, hi = torch.min(native), torch.max(native)
            edges = lo + (hi - lo) * edges
            edges[-1] = hi
        else:
            edges = to_torch(bins, native.device).to(native.dtype)
        w = torch.ones_like(native) if w is None else to_torch(w, native.device)
        idx = torch.searchsorted(edges, native, right=True)
        idx = torch.where(native == edges[-1], len(edges) - 1, idx)
        counts = torch.zeros(len(edges) + 1, dtype=w.dtype, device=native.device).index_add_(0, idx, w)
        counts = counts[1:len(edges)]
    n_bins = int(counts.shape[0])
    return Tensor(counts, spatial(bins=n_bins)), Tensor(edges, spatial(bins=n_bins + 1))


def neighbor_mean(grid: Tensor, dims: DimFilter = spatial, padding=None) -> Tensor:
    """The mean of neighbouring values along each of `dims`; without
    `padding` each of those dims loses one entry (values at the midpoints)."""
    grid = wrap(grid)
    for n in [n for n in _resolve_filter(dims, grid.shape) if n in grid.shape]:
        lo, up = shift(grid, (0, 1), n, padding, stack_dim=None)
        grid = (lo + up) * 0.5
    return grid


def sample_subgrid(grid: Tensor, start: Tensor, size: Shape) -> Tensor:
    """A window of `size` cells of `grid`, linearly interpolated, whose first
    cell sits at the fractional index `start` (a `vector` dim labelled by the
    sampled dims); reads beyond the grid clamp to its border."""
    grid, start = wrap(grid), wrap(start)
    for dim in start.shape.get_labels('vector') or size.names:
        n_out, n_in = size.get_size(dim), grid.shape.get_size(dim)
        s = start[{'vector': dim}]
        i0 = floor(s)
        frac = s - i0
        idx_lo = clip(wrap(np.arange(n_out, dtype=np.int32), spatial(**{dim: n_out})) + cast(i0, np.int32), 0,
                      n_in - 1)
        idx_hi = clip(idx_lo + 1, 0, n_in - 1)
        grid = gather(grid, idx_lo, dims=dim) * (1 - frac) + gather(grid, idx_hi, dims=dim) * frac
    return grid


def grid_sample(grid: Tensor, coordinates: Tensor, extrap, **kwargs) -> Tensor:
    """Multilinear interpolation of `grid` at the fractional indices
    `coordinates` (a channel `vector` labelled by the grid's dims; 0 is the
    first cell's centre), beyond the grid by `extrap` (`math/_nd.py`)."""
    from ._extrapolation import as_extrapolation
    from ._nd import grid_sample_tensor
    return grid_sample_tensor(grid, coordinates, as_extrapolation(extrap) if extrap is not None else None)


def closest_grid_values(grid: Tensor, coordinates: Tensor, extrap, stack_dim_prefix='closest_', **kwargs) -> Tensor:
    """The 2^d grid values around each coordinate, along dims `closest_<dim>` of size 2."""
    from ._extrapolation import as_extrapolation
    from ._nd import closest_grid_values_tensor
    return closest_grid_values_tensor(grid, coordinates, as_extrapolation(extrap), stack_dim_prefix)


def _fourier(x, dims, np_fn, torch_fn) -> Tensor:
    x = wrap(x)
    axes = tuple(x.shape.index(n) for n in _resolve_filter(dims, x.shape))
    n = x.native()
    return Tensor(np_fn(n, axes=axes) if _is_host(n) else torch_fn(n, dim=axes), x.shape)


def fft(x: Tensor, dims: DimFilter = spatial) -> Tensor:
    """The n-dimensional discrete Fourier transform over `dims` (complex)."""
    return _fourier(x, dims, np.fft.fftn, torch.fft.fftn)


def ifft(k: Tensor, dims: DimFilter = spatial) -> Tensor:
    """The inverse of `fft` over `dims` (complex)."""
    return _fourier(k, dims, np.fft.ifftn, torch.fft.ifftn)


def fftfreq(resolution: Shape, dx=1, dtype=None) -> Tensor:
    """The Fourier frequencies of each spatial dim of `resolution`, stacked along `vector`."""
    comps = {d.name: Tensor(np.fft.fftfreq(d.size, d=1.0).astype(dtype or default_float()), Shape((d,)))
             for d in resolution.spatial.dims}
    return stack(comps, channel('vector'), expand_values=True) / wrap(dx)


# ---------------------------------------------------------------------------
# neighbour search
# ---------------------------------------------------------------------------

def pairwise_differences(positions: Tensor, max_distance=None, format='dense', method='auto', default=None,
                         domain=None, periodic=False, avg_neighbors=8.):
    """Pairwise position deltas x_j − x_i within `max_distance`.

    Dense: a dual copy of the instance dim, (instance, ~instance, vector),
    min-image where periodic, `default` (NaN) beyond `max_distance` and on
    the diagonal. Cell list (`method='cell-list'`, or 'auto' for more than
    4096 points with `domain` and `max_distance`): COMPACT, the dual dim
    '~neighbors' of static width 3^d · capacity holds each point's
    candidates (`math/_neighbors.py`), `default` (NaN) in empty slots."""
    positions = wrap(positions)
    inst = positions.shape.instance
    assert inst.rank == 1
    n_particles = inst.volume
    use_cell_list = method == 'cell-list' or (
        method == 'auto' and domain is not None and max_distance is not None
        and n_particles is not None and n_particles > 4096)
    if use_cell_list:
        assert domain is not None and max_distance is not None, \
            "cell-list search requires `domain` and `max_distance`"
        from ._neighbors import cell_list_neighbors
        labels = positions.shape.get_labels('vector')
        pos_n = positions.torch((inst.names[0], 'vector'))
        lo, up = (np.asarray(b.numpy() if isinstance(b, Tensor) else b).reshape(-1) for b in domain)
        idx, deltas_n, mask_n = cell_list_neighbors(pos_n, float(max_distance), lo, up, periodic=bool(periodic))
        fill = float('nan') if default is None else float(default)
        deltas_n = torch.where(mask_n[..., None], deltas_n, fill)
        out_shape = Shape((Dim(inst.names[0], pos_n.shape[0], INSTANCE, None),
                           Dim('~neighbors', idx.shape[1], DUAL, None),
                           Dim('vector', len(labels), CHANNEL, tuple(labels))))
        return Tensor(deltas_n, out_shape)
    others = rename_dims(positions, inst, Shape((inst.dims[0].as_type(DUAL),)))
    deltas = others - positions  # (instance, dual, vector)
    if periodic and domain is not None:
        lo, up = domain
        size = wrap(up) - wrap(lo)
        deltas = (deltas + size / 2) % size - size / 2
    if max_distance is not None:
        dist = vec_length(deltas)
        mask = (dist < max_distance) & (dist > 0)
        deltas = where(mask, deltas, float('nan') if default is None else default)
    return deltas


def _argmin(value: Tensor, dim: str) -> Tensor:
    axis = value.shape.index(dim)
    n = value.native()
    native = np.argmin(n, axis=axis).astype(np.int32) if _is_host(n) else torch.argmin(n, dim=axis).to(torch.int32)
    return Tensor(native, value.shape.without(dim))


def find_closest(vectors: Tensor, query: Tensor, index_dim=channel('index')) -> Tensor:
    """The index along `vectors`' instance (or spatial) dim of the vector
    closest to each query point."""
    vectors, query = wrap(vectors), wrap(query)
    inst = vectors.shape.instance or vectors.shape.spatial
    if query.shape.instance:
        diffs = vectors - rename_dims(query, query.shape.instance, instance('_query'))
    else:
        diffs = vectors - query
    idx = _argmin(vec_squared(diffs), inst.names[0])
    if query.shape.instance:
        idx = rename_dims(idx, '_query', query.shape.instance)
    return idx


# ---------------------------------------------------------------------------
# gradients and native functions
# ---------------------------------------------------------------------------

def stop_gradient(x):
    """`x` with every torch native detached: no gradient flows through it
    (Tensors, Fields, sequences and dicts of them, torch tensors)."""
    from ._functional import _detached
    return _detached(x)


def native_call(f, *inputs, channels_last=True, channel_dim='vector', spatial_dim=None):
    """Call a function of native arrays (a network) on named tensors: each
    input as (batch, *spatial, channels) with ``channels_last`` or (batch,
    channels, *spatial), the batch dims merged into one and a scalar input
    given a channel axis of 1; the result back with the first input's
    spatial dims and `channel_dim` of the result's channel count."""
    inputs = [wrap(i) for i in inputs]
    b = merge_shapes(*[i.shape.batch for i in inputs])
    natives = []
    for i in inputs:
        sp, ch = i.shape.spatial, i.shape.channel
        order = b.names + (sp.names + ch.names if channels_last else ch.names + sp.names)
        n = i.torch(order)
        n = n.reshape((b.volume if b else 1,) + tuple(n.shape[len(b.names):]))
        if not ch:  # a scalar field gets a channel axis of 1
            n = n.unsqueeze(-1) if channels_last else n.unsqueeze(1)
        natives.append(n)
    result = f(*natives)
    sp = inputs[0].shape.spatial
    if channels_last:
        ch_size = result.shape[-1]
        out_shape = concat_shapes(b, sp, channel(**{channel_dim: ch_size}))
        native = result.reshape(tuple(b.sizes) + tuple(sp.sizes) + (ch_size,))
    else:
        ch_size = result.shape[1]
        out_shape = concat_shapes(b, channel(**{channel_dim: ch_size}), sp)
        native = result.reshape(tuple(b.sizes) + (ch_size,) + tuple(sp.sizes))
    return Tensor(native, out_shape)


# ---------------------------------------------------------------------------
# convolution, native reshapes, printing, mapping
# ---------------------------------------------------------------------------

def convolve(value: Tensor, kernel: Tensor, extrapolation=None) -> Tensor:
    """The cross-correlation of `value` with `kernel` over their shared
    spatial dims (`lax.conv_general_dilated`, 'VALID'): each output dim
    shrinks by the kernel's size − 1, unless `extrapolation` pads `value`
    first (k // 2 below, (k − 1) // 2 above). In the default float."""
    from ._extrapolation import as_extrapolation
    value, kernel = wrap(value), wrap(kernel)
    sp = value.shape.spatial.only(kernel.shape.spatial)
    if extrapolation is not None:
        widths = {d: (kernel.shape.get_size(d) // 2, (kernel.shape.get_size(d) - 1) // 2) for d in sp.names}
        value = pad(value, widths, as_extrapolation(extrapolation))
    rest = value.shape.without(sp.names)
    v_sizes = tuple(value.shape.get_size(n) for n in sp.names)
    k_sizes = tuple(kernel.shape.get_size(n) for n in sp.names)
    vn, kn = value._transposed(rest.names + sp.names).native(), kernel._transposed(
        kernel.shape.without(sp.names).names + sp.names).native()
    host = _is_host(vn) and _is_host(kn)
    device = vn.device if not _is_host(vn) else kn.device if not _is_host(kn) else torch.device('cpu')
    dtype = _torch_dtype(default_float())
    vn = to_torch(vn, device).to(dtype).reshape((-1, 1) + v_sizes)
    kn = to_torch(kn, device).to(dtype).reshape((-1, 1) + k_sizes)
    assert kn.shape[0] == 1, "batched kernels not supported yet"
    conv = {1: torch.nn.functional.conv1d, 2: torch.nn.functional.conv2d, 3: torch.nn.functional.conv3d}[sp.rank]
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=False):  # float32 products
        out = conv(vn, kn)
    out_sizes = tuple(out.shape[2:])
    out = out.reshape(tuple(rest.sizes) + out_sizes)
    shape = Shape(tuple(rest.dims) + tuple(Dim(n, s, sp.get_dim(n).dim_type, None) for n, s in zip(sp.names, out_sizes)))
    return Tensor(out.numpy() if host else out, shape)._transposed(value.shape.names)


def reshaped_native(value: Tensor, groups, force_expand=True):
    """The native with the dims of each entry of `groups` (a Shape, or a dim
    name) packed into one axis, in that order."""
    value = wrap(value)
    if isinstance(value, TensorStack):
        value = value._contiguous()
    sizes, order = [], []
    for g in groups:
        if isinstance(g, Shape):
            names = [n for n in g.names if n in value.shape]
            order.extend(names)
            sizes.append(int(np.prod([value.shape.get_size(n) for n in names])) if names else 1)
        else:
            order.append(g)
            sizes.append(value.shape.get_size(g))
    return value.native(tuple(order)).reshape(sizes)


def reshaped_tensor(native, groups, convert=True):
    """A native as a Tensor of the dims of `groups` (Shapes), reshaped to them;
    a host array moves to the default device with `convert`."""
    dims = []
    for g in groups:
        if not isinstance(g, Shape):
            raise TypeError(g)
        dims.extend(g.dims)
    target = Shape(tuple(dims))
    if convert or isinstance(native, torch.Tensor):
        return Tensor(to_torch(native).reshape(tuple(target.sizes)), target)
    return Tensor(np.reshape(np.asarray(native), tuple(target.sizes)), target)


def assert_finite(t: Tensor):
    assert bool(all_(is_finite(t))), "tensor contains non-finite values"


def print_(value=None, name=""):
    if name:
        print(name)
    print(value)


def map_(fn, *values, dims=None, **kwargs):
    """`fn` on each entry of `dims` (all dims by default) of `values`, the
    results stacked along those dims."""
    values = [wrap(v) for v in values]
    loop_shape = merge_shapes(*[v.shape if dims is None else v.shape.only(dims) for v in values])
    results = []
    for idx in loop_shape.meshgrid():
        results.append(fn(*[v[{k: i for k, i in idx.items() if k in v.shape}] for v in values], **kwargs))
    if not results:
        return None
    out = results
    for d in reversed(loop_shape.dims):
        out = [stack(out[i:i + d.size], Shape((d,))) for i in range(0, len(out), d.size)]
    return out[0]

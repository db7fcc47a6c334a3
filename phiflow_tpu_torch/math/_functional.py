"""Functional transforms — port of `phiflow_tpu/math/_functional.py`
(`:86-366`) onto PyTorch's eager execution and `torch.autograd`.

`jit_compile` returns the function itself, and `jit_compile_linear` marks a
function as linear in its first argument, which is how `solve_linear` knows
that it may apply it matrix-free.

`gradient` (= `functional_gradient`), `jacobian` and `custom_gradient` are
the JAX package's, on `torch.autograd`: the arguments differentiated are
copied into fresh leaves that require grad — a host constant (a numpy
native: `wrap(1.)`) becomes a torch leaf on the default device — the
output's first element (a Tensor or a Field's values) is summed into the
scalar loss, and the gradients come back in the structure of each argument
(a Tensor, a Field with the gradient as values, a tuple, a torch tensor).
Returned outputs are detached. Solves inside `f` differentiate implicitly
(`math/_solve.py::implicit_solve`), the window interpolation through its
backward kernel (`ops/interp.py`).

`iterate` applies a map a number of times, or records the trajectory along
a batch dim; `map_s2b` / `map_d2c` / `map_c2d`, `broadcast`,
`get_function_parameters`, `trace_check`, `when_available` and
`perf_counter` follow the JAX package.
"""
from __future__ import annotations

import builtins
import functools
import inspect
import time
from typing import Callable, Union

import numpy as np
import torch

from ._shape import Shape, batch, dual, merge_shapes, concat_shapes, parse_dim_order
from ._tensor import Tensor, TensorStack, get_default_device, wrap

__all__ = ['jit_compile', 'jit_compile_linear', 'LinearFunction', 'gradient', 'functional_gradient', 'jacobian',
           'custom_gradient', 'iterate', 'map_s2b', 'map_d2c', 'map_c2d', 'broadcast', 'get_function_parameters',
           'trace_check', 'when_available', 'perf_counter']


def jit_compile(f: Callable = None, auxiliary_args: str = '', forget_traces: bool = False):
    """The function itself (eager execution); the arguments are those of the JAX package."""
    if f is None:
        return functools.partial(jit_compile, auxiliary_args=auxiliary_args, forget_traces=forget_traces)
    return f


class LinearFunction:
    """A function f(x, *aux) that is linear (or affine) in its first argument."""

    def __init__(self, f: Callable, auxiliary_args='', forget_traces=False):
        self.f = f
        self.aux_names = set(parse_dim_order(auxiliary_args))
        try:
            self.signature = inspect.signature(f)
        except (TypeError, ValueError):
            self.signature = None
        functools.update_wrapper(self, f)

    def __call__(self, *args, **kwargs):
        return self.f(*args, **kwargs)

    def bind(self, *args, **kwargs):
        """Close over all but the first argument → unary linear operator."""
        def op(x):
            return self.f(x, *args, **kwargs)
        return op


def jit_compile_linear(f: Callable = None, auxiliary_args: str = '', forget_traces: bool = False):
    if f is None:
        return functools.partial(jit_compile_linear, auxiliary_args=auxiliary_args, forget_traces=forget_traces)
    if isinstance(f, LinearFunction):
        return f
    return LinearFunction(f, auxiliary_args, forget_traces)


# ---------------------------------------------------------------------------
# the structures gradients pass through
# ---------------------------------------------------------------------------

def _is_field(x) -> bool:
    return hasattr(x, 'geometry') and hasattr(x, 'values') and hasattr(x, 'with_values')


def _flatten(x):
    """(leaves, rebuild): the natives of `x` — torch tensors and numpy
    arrays inside Tensors, Fields' values, sequences and dicts, and bare
    torch tensors — and a function that puts new leaves in their places.
    Anything else is a constant without leaves."""
    if isinstance(x, TensorStack):
        parts = [_flatten(c) for c in x.components]
        return _join(parts, lambda comps: TensorStack(comps, x.stack_dim))
    if isinstance(x, Tensor):
        return [x.native()], lambda leaves: Tensor(leaves[0], x.shape)
    if isinstance(x, torch.Tensor):
        return [x], lambda leaves: leaves[0]
    if _is_field(x):
        leaves, rebuild = _flatten(x.values)
        return leaves, lambda new: x.with_values(rebuild(new))
    if isinstance(x, (tuple, list)):
        parts = [_flatten(v) for v in x]
        return _join(parts, lambda items: type(x)(items) if not hasattr(x, '_fields') else type(x)(*items))
    if isinstance(x, dict):
        keys = list(x)
        parts = [_flatten(x[k]) for k in keys]
        return _join(parts, lambda items: dict(zip(keys, items)))
    return [], lambda leaves: x


def _join(parts, combine):
    leaves = [leaf for p in parts for leaf in p[0]]
    counts = [len(p[0]) for p in parts]

    def rebuild(new):
        out, i = [], 0
        for (_, rb), n in zip(parts, counts):
            out.append(rb(list(new[i:i + n])))
            i += n
        return combine(out)
    return leaves, rebuild


def _is_float(native) -> bool:
    return native.is_floating_point() if isinstance(native, torch.Tensor) else np.issubdtype(native.dtype, np.floating)


def _leaves_of(x):
    """`x` with each float native a fresh torch leaf that requires grad (host
    constants on the default device), and the list of leaves (None for a
    native that is not float)."""
    natives, rebuild = _flatten(x)
    leaves = []
    for n in natives:
        if not _is_float(n):
            leaves.append(None)
            continue
        t = n.detach() if isinstance(n, torch.Tensor) else torch.from_numpy(np.array(n)).to(get_default_device())
        leaves.append(t.requires_grad_())
    return rebuild([leaf if leaf is not None else n for leaf, n in zip(leaves, natives)]), leaves


def _detached(x):
    natives, rebuild = _flatten(x)
    return rebuild([n.detach() if isinstance(n, torch.Tensor) else n for n in natives])


def _scalar_loss(loss) -> torch.Tensor:
    """The sum of every entry of the loss (a Tensor, a Field, a number): a
    batched loss gives the gradient of the sum, as in the JAX package."""
    natives, _ = _flatten(loss.values if _is_field(loss) else wrap(loss) if not isinstance(loss, Tensor) else loss)
    total = None
    for n in natives:
        s = n.sum() if isinstance(n, torch.Tensor) else torch.as_tensor(np.sum(n))
        total = s if total is None else total + s.to(total.device)
    return total


def gradient(f: Callable, wrt=0, get_output=True):
    """Gradient function of `f` w.r.t. argument(s) `wrt` (an index, a name,
    names separated by commas, or a list).

    `f`'s output (its first element if a tuple; the rest are aux outputs) is
    summed to a scalar loss. With `get_output` the function returns (loss,
    *aux, grad) or (loss, *aux, *grads), else the gradient(s) alone. It
    carries `f`'s signature, so `jit_compile(gradient(f))` binds arguments by
    name."""
    try:
        sig = inspect.signature(f)
        param_names = list(sig.parameters)
    except (TypeError, ValueError):
        sig, param_names = None, None
    if isinstance(wrt, str):
        wrt_idx = [param_names.index(n.strip()) for n in wrt.split(',')]
    elif isinstance(wrt, int):
        wrt_idx = [wrt]
    else:
        wrt_idx = [param_names.index(w) if isinstance(w, str) else w for w in wrt]
    single = len(wrt_idx) == 1

    def grad_fn(*args, **kwargs):
        if param_names is not None and kwargs:
            # keyword arguments bound into positional order so that the wrt indices resolve
            ba = sig.bind(*args, **kwargs)
            ba.apply_defaults()
            call_args = [ba.arguments[n] for n in param_names if n in ba.arguments]
        else:
            call_args = list(args)
        leaves = []
        for i in wrt_idx:
            call_args[i], arg_leaves = _leaves_of(call_args[i])
            leaves.append(arg_leaves)
        with torch.enable_grad():
            result = f(*call_args)
            loss, aux = (result[0], result[1:]) if isinstance(result, tuple) else (result, ())
            scalar = _scalar_loss(loss)
            flat = [leaf for arg in leaves for leaf in arg if leaf is not None]
            if flat and scalar.requires_grad:
                grads = list(torch.autograd.grad(scalar, flat, allow_unused=True))
            else:
                grads = [None] * len(flat)
        grads = iter(grads)
        out = []
        for i, arg_leaves in zip(wrt_idx, leaves):
            natives = []
            for leaf in arg_leaves:
                if leaf is None:
                    natives.append(None)
                    continue
                g = next(grads)
                natives.append(torch.zeros_like(leaf) if g is None else g)
            _, rebuild = _flatten(call_args[i])
            out.append(rebuild(natives))
        grads = out[0] if single else out
        if get_output:
            loss, aux = _detached(loss), tuple(_detached(a) for a in aux)
            if single:
                return (loss, *aux, grads)
            return (loss, *aux, *grads)
        return grads

    if sig is not None:  # f's signature, so that jit_compile(gradient(f)) binds arguments by name
        grad_fn.__signature__ = sig
    grad_fn.__name__ = f"gradient({getattr(f, '__name__', 'f')})"
    return grad_fn


functional_gradient = gradient


def jacobian(f: Callable, wrt=0, get_output=True):
    """The dense Jacobian of `f`'s output (a Tensor) w.r.t. one Tensor
    argument, for small systems: a Tensor with the output's dims followed by
    the argument's as dual dims (`~x`); with `get_output`, (output, jacobian)."""
    if isinstance(wrt, str):
        wrt = list(inspect.signature(f).parameters).index(wrt.split(',')[0].strip())

    def jac_fn(*args, **kwargs):
        x = args[wrt] if isinstance(args[wrt], Tensor) else wrap(args[wrt])
        x_native = x.torch(x.shape.names).detach()

        def call(native):
            full = list(args)
            full[wrt] = Tensor(native, x.shape)
            return wrap(f(*full, **kwargs))

        out = call(x_native)
        jac = torch.autograd.functional.jacobian(lambda n: call(n).torch(out.shape.names), x_native)
        result = Tensor(jac, concat_shapes(out.shape, dual(**{n: x.shape.get_size(n) for n in x.shape.names})))
        return (_detached(out), result) if get_output else result

    return jac_fn


def custom_gradient(f: Callable, gradient: Callable, auxiliary_args: str = ''):
    """`f` with a custom reverse-mode gradient: ``gradient(*args, dy)``
    returns the gradient of each argument (a tuple, or one value for a
    single argument), as in the JAX package. Arguments and outputs are this
    package's Tensors, Fields or torch tensors."""

    class _Custom(torch.autograd.Function):
        @staticmethod
        def forward(ctx, meta, *natives):
            args = meta['rebuild'](list(natives))
            out = f(*args)
            out_natives, out_rebuild = _flatten(out)
            meta['out_rebuild'] = out_rebuild
            ctx.meta = meta
            ctx.save_for_backward(*[n for n in natives if isinstance(n, torch.Tensor)])
            return tuple(n if isinstance(n, torch.Tensor) else torch.as_tensor(n) for n in out_natives)

        @staticmethod
        def backward(ctx, *dys):
            meta = ctx.meta
            saved = iter(ctx.saved_tensors)
            natives = [next(saved) if isinstance(n, torch.Tensor) else n for n in meta['natives']]
            args = meta['rebuild'](natives)
            dy = meta['out_rebuild'](list(dys))
            grads = gradient(*args, dy)
            if not isinstance(grads, (tuple, list)):
                grads = (grads,)
            flat = []
            for arg, g in zip(meta['args'], grads):
                n_arg = len(_flatten(arg)[0])
                g_natives = _flatten(g)[0] if g is not None else [None] * n_arg
                flat.extend(to_native_grad(gn) for gn in g_natives)
            return (None, *flat)

    def to_native_grad(g):
        if g is None or isinstance(g, torch.Tensor):
            return g
        return torch.as_tensor(np.asarray(g))

    @functools.wraps(f)
    def wrapped(*args):
        natives, rebuild = _flatten(list(args))
        meta = dict(rebuild=rebuild, natives=natives, args=args)
        inputs = [n if isinstance(n, torch.Tensor) else torch.as_tensor(np.asarray(n)) for n in natives]
        outs = _Custom.apply(meta, *inputs)
        return meta['out_rebuild'](list(outs))

    return wrapped


def iterate(map_function: Callable, iterations: Union[int, Shape], *x0, f_kwargs: dict = None, range=range,
            measure=None, substeps: int = 1, **f_kwargs_additional):
    """Apply `map_function` to `x0` repeatedly.

    An int `iterations` returns the final state; a batch Shape
    (``batch(time=100)``) the trajectory along that dim, the initial state
    included (size iterations + 1). `measure` (e.g. `perf_counter`) adds
    the time of each iteration as a last output; `substeps` applies the map
    that many times an iteration."""
    f_kwargs = dict(f_kwargs or {})
    f_kwargs.update(f_kwargs_additional)
    record = isinstance(iterations, Shape)
    n = iterations.size if record else int(iterations)
    state = tuple(x0)
    trajectory = [state]
    measurements = []
    for _ in range(n):
        t0 = measure() if measure else None
        for _ in builtins.range(substeps):
            result = map_function(*state, **f_kwargs)
            state = result if isinstance(result, tuple) else (result,)
        if measure:
            measurements.append(float(measure() - t0))
        if record:
            trajectory.append(state)
    if record:
        result = tuple(_stack_states([t[k] for t in trajectory], iterations) for k in builtins.range(len(state)))
    else:
        result = state
    if measure:  # the time of each iteration along the trajectory's dim (`iterations` for a count)
        dim = iterations.with_size(n) if record else batch(iterations=n)
        result = result + (Tensor(np.asarray(measurements, np.float32), dim),)
    return result[0] if len(result) == 1 else result


def _stack_states(items, dim: Shape):
    from . import _ops as ops
    if all(x is None for x in items):
        return None
    items = [x for x in items if x is not None]
    dim = dim.with_size(len(items))
    first = items[0]
    if _is_field(first):
        return first.with_values(ops.stack([x.values for x in items], dim))
    return ops.stack(items, dim)


def map_s2b(f: Callable) -> Callable:
    """`f` with spatial dims as batch dims: `f` itself, named dims make it so."""
    return f


def map_d2c(f: Callable) -> Callable:
    """`f` with dual dims as channel dims: `f` itself."""
    return f


def map_c2d(f: Callable) -> Callable:
    """`f` with channel dims as dual dims: `f` itself."""
    return f


def broadcast(f: Callable = None, dims=None, range=range, unwrap_scalars=True):
    """Decorator: call `f` for each slice along `dims` (the batch dims when
    None) of its Tensor arguments and stack the results."""
    if f is None:
        return functools.partial(broadcast, dims=dims, range=range, unwrap_scalars=unwrap_scalars)

    @functools.wraps(f)
    def wrapper(*args, **kwargs):
        from . import _ops as ops
        shapes = [a.shape for a in list(args) + list(kwargs.values()) if isinstance(getattr(a, 'shape', None), Shape)]
        loop = merge_shapes(*shapes)
        loop = loop.only(dims) if dims is not None else loop.batch
        if not loop:
            return f(*args, **kwargs)

        def sl(a, idx):
            if isinstance(getattr(a, 'shape', None), Shape) and hasattr(a, '__getitem__'):
                return a[{k: v for k, v in idx.items() if k in a.shape}]
            return a

        out = [f(*[sl(a, idx) for a in args], **{k: sl(v, idx) for k, v in kwargs.items()})
               for idx in loop.meshgrid()]
        for d in reversed(loop.dims):
            size = d.size
            out = [ops.stack(out[i:i + size], Shape((d,))) for i in builtins.range(0, len(out), size)]
        return out[0]

    return wrapper


def get_function_parameters(f) -> dict:
    return dict(inspect.signature(f).parameters)


def trace_check(f, *args, **kwargs):
    """(True, ''): eager functions need no retracing."""
    return True, ""


def when_available(fn: Callable, *args, **kwargs):
    """Run `fn` once the values are available: at once, as execution is eager."""
    fn(*args, **kwargs)


def perf_counter(*args):
    return wrap(time.perf_counter())

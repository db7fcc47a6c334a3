"""`jit_compile`, `jit_compile_linear` and `LinearFunction` — the part of
`phiflow_tpu/math/_functional.py` (`:86-130`) that `solve_linear` uses.

The port runs eagerly: `jit_compile` returns the function itself, and
`jit_compile_linear` marks a function as linear in its first argument, which
is how `solve_linear` knows that it may apply it matrix-free. Gradients and
`iterate` come with a later slice.
"""
from __future__ import annotations

import functools
import inspect
from typing import Callable

from ._shape import parse_dim_order

__all__ = ['jit_compile', 'jit_compile_linear', 'LinearFunction']


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

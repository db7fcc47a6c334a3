"""Explicit time integrators over a state or a tuple of states — port of
`phiflow_tpu/physics/integrate.py`: a state is anything with + and ·
(Fields, Tensors, torch tensors), a tuple is integrated entry by entry."""
from __future__ import annotations

__all__ = ['rk4', 'euler']


def _mul(state, factor):
    if isinstance(state, tuple):
        return tuple(_mul(s, factor) for s in state)
    return state * factor


def _add(a, b):
    if isinstance(a, tuple):
        return tuple(_add(x, y) for x, y in zip(a, b))
    return a + b


def _slope(pde, state, pde_kwargs):
    return pde(*state, **pde_kwargs) if isinstance(state, tuple) else pde(state, **pde_kwargs)


def rk4(pde, state, dt, **pde_kwargs):
    """One classical Runge–Kutta step of d state / dt = pde(state)."""
    k1 = _slope(pde, state, pde_kwargs)
    k2 = _slope(pde, _add(state, _mul(k1, dt / 2)), pde_kwargs)
    k3 = _slope(pde, _add(state, _mul(k2, dt / 2)), pde_kwargs)
    k4 = _slope(pde, _add(state, _mul(k3, dt)), pde_kwargs)
    incr = _add(_add(k1, _mul(k2, 2)), _add(_mul(k3, 2), k4))
    return _add(state, _mul(incr, dt / 6))


def euler(pde, state, dt, **pde_kwargs):
    """One explicit Euler step of d state / dt = pde(state)."""
    return _add(state, _mul(_slope(pde, state, pde_kwargs), dt))

"""The port's entry point, the analogue of `__graft_entry__.entry`: the
flagship model's step and its initial state, for a harness to call and time.

    fn, args = entry()          # on the card
    fn, args = entry('cpu')     # the plain PyTorch versions on the CPU
    velocity, smoke, pressure = fn(*args)

`fn` is `SmokePlume(resolution=16, dims=3, cg_tol=1e-3, max_iterations=64)
.step` (per-phase at 16³: K6 and the V-cycle's kernels on the card) and
`args` its initial state, three Fields on the model's device.
"""
from __future__ import annotations

__all__ = ['entry']


def entry(device=None):
    """(fn, (velocity, smoke, pressure)): the 3D smoke plume's step and its
    initial state on `device` (the card unless 'cpu'; no card raises)."""
    from .models import SmokePlume

    model = SmokePlume(resolution=16, dims=3, cg_tol=1e-3, max_iterations=64, device=device)
    v0, s0, p0 = model.initial_state()

    def fn(velocity, smoke, pressure):
        return model.step(velocity, smoke, pressure)

    return fn, (v0, s0, p0)

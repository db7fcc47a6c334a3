"""Profiling and timing on `torch.profiler` and the host clock — port of
`phiflow_tpu/utils/_profile.py`."""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Tuple

import torch

from ..math._functional import _flatten

__all__ = ['profile', 'profile_function', 'benchmark', 'Timer']


def _default_log_dir() -> str:
    return os.path.join(tempfile.gettempdir(), 'phiflow_tpu_torch_profile')


def _sync(tree):
    """Wait for the cards that hold a torch tensor of `tree` (a state, a result)."""
    devices = {leaf.device for leaf in _flatten(tree)[0] if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile(log_dir: str = None, host_tracer_level=2, python_tracer_level=1):
    """Trace what runs inside the block with `torch.profiler` (the host, and
    the card's kernels where CUDA is available) and write it as a Chrome
    trace, `<log_dir>/trace.json` (viewable in Perfetto or chrome://tracing).
    Yields `log_dir` (default: a folder in the temporary directory).
    `python_tracer_level` > 1 also records Python call stacks."""
    log_dir = log_dir or _default_log_dir()
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities, with_stack=python_tracer_level > 1) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


def profile_function(fn: Callable, *args, log_dir=None, warmup=1, runs=3, **kwargs):
    """`fn(*args, **kwargs)` called `warmup` times, then `runs` times under
    `profile`, waiting for the card after each phase; returns (the last
    result, log_dir)."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    _sync(result)
    with profile(log_dir) as log_dir:
        for _ in range(runs):
            result = fn(*args, **kwargs)
        _sync(result)
    return result, log_dir


def benchmark(step_fn: Callable, state, n: int = 10, warmup: int = 2) -> Tuple[float, object]:
    """Seconds a step on the host clock over `n` steps after `warmup` ones,
    waiting for the card before the clock starts and before it is read.
    `step_fn(*state) -> state'`. Returns (seconds a step, the last state)."""
    state = tuple(state) if isinstance(state, (tuple, list)) else (state,)
    for _ in range(warmup):
        result = step_fn(*state)
        state = result if isinstance(result, tuple) else (result,)
    _sync(state)
    t0 = time.perf_counter()
    for _ in range(n):
        result = step_fn(*state)
        state = result if isinstance(result, tuple) else (result,)
    _sync(state)
    return (time.perf_counter() - t0) / n, state


class Timer:
    """Context timer on the host clock: ``with Timer() as t: ...; t.elapsed``
    (seconds). Work queued on the card is not waited for."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.elapsed = time.perf_counter() - self.start

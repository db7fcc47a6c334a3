"""Visualisation abstractions — port of `phiflow_tpu/vis/_vis_base.py`:
`PlottingLibrary` + `Recipe` dispatch, the observable `VisModel`,
`Control` / `Action` records, the background play loop and the step
benchmark. Plain Python, no array library."""
from __future__ import annotations

import threading
import time
import warnings
from typing import Callable, Optional, Tuple


class Control:
    """A user-controllable parameter with a value range."""

    def __init__(self, name: str, control_type: type, initial, value_range=None, description="", kwargs=None):
        self.name = name
        self.control_type = control_type
        self.initial = initial
        self.value_range = value_range
        self.description = description
        self.kwargs = kwargs or {}
        self._value = initial

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        self._value = self.control_type(v)

    def __repr__(self):
        return f"Control({self.name}={self._value})"


class Action:
    """A user-triggerable function."""

    def __init__(self, name: str, fn: Callable, description=""):
        self.name = name
        self.fn = fn
        self.description = description

    def __call__(self):
        return self.fn()


class VisModel:
    """Observable model: fields, curves, controls, actions, progress."""

    def __init__(self, name: str = None, description: str = "", scene=None):
        self.name = name or type(self).__name__
        self.description = description
        self.scene = scene
        self.steps = 0
        self.controls: list = []
        self.actions: list = []
        self._invalidated = []

    @property
    def field_names(self) -> tuple:
        raise NotImplementedError(type(self))

    def get_field(self, name, dim_selection: dict):
        raise NotImplementedError(type(self))

    @property
    def curve_names(self) -> tuple:
        return ()

    def get_curve(self, name):
        raise NotImplementedError(type(self))

    def progress(self):
        """Advance the simulation by one step."""
        raise NotImplementedError(type(self))

    @property
    def is_finished(self) -> bool:
        return False

    def prepare(self):
        pass

    def add_observer(self, fn):
        self._invalidated.append(fn)

    def invalidate(self):
        for fn in self._invalidated:
            fn()


class AsyncPlay:
    """Background play loop."""

    def __init__(self, model: VisModel, max_steps: Optional[int], framerate: Optional[float]):
        self.model = model
        self.max_steps = max_steps
        self.framerate = framerate
        self._paused = False
        self._thread = None

    def start(self):
        def loop():
            step = 0
            while not self._paused and (self.max_steps is None or step < self.max_steps):
                t0 = time.perf_counter()
                self.model.progress()
                step += 1
                if self.framerate:
                    dt = 1.0 / self.framerate - (time.perf_counter() - t0)
                    if dt > 0:
                        time.sleep(dt)
                if self.model.is_finished:
                    break
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def pause(self):
        self._paused = True

    def join(self, timeout=None):
        if self._thread:
            self._thread.join(timeout)


def play_async(model: VisModel, max_steps=None, framerate=None) -> AsyncPlay:
    return AsyncPlay(model, max_steps, framerate).start()


def benchmark(model: VisModel, sequence_count: int) -> Tuple[int, float]:
    """Time `sequence_count` steps; returns (completed_steps, elapsed_seconds)."""
    start = time.perf_counter()
    for i in range(sequence_count):
        model.progress()
        if model.is_finished:
            return i + 1, time.perf_counter() - start
    return sequence_count, time.perf_counter() - start


class Gui:
    """Abstract GUI backend."""

    def __init__(self, asynchronous=False):
        self.asynchronous = asynchronous
        self.app: Optional[VisModel] = None
        self.config = {}

    def configure(self, config: dict):
        self.config.update(config)

    def setup(self, app: VisModel):
        self.app = app

    def show(self, caller_is_main: bool):
        raise NotImplementedError(type(self))

    def auto_play(self):
        play_async(self.app)


class Recipe:
    """A plotting recipe: can_plot(data) + plot(axis, data) dispatch."""

    def can_plot(self, data, space) -> bool:
        raise NotImplementedError(type(self))

    def plot(self, data, figure, subplot, space, *args, **kwargs):
        raise NotImplementedError(type(self))


class PlottingLibrary:
    """A matplotlib/plotly-style backend with an ordered recipe list."""

    def __init__(self, name: str, recipes=()):
        self.name = name
        self.recipes = list(recipes)

    def create_figure(self, size, rows, cols, subplots, titles, log_dims=()):
        raise NotImplementedError(type(self))

    def finalize(self, figure):
        pass

    def show(self, figure):
        raise NotImplementedError(type(self))

    def save(self, figure, path, dpi=120, transparent=False):
        raise NotImplementedError(type(self))

    def plot(self, data, figure, subplot, space, *args, plot_type: str = None, **kwargs):
        """Dispatch to the first matching recipe. `plot_type` (e.g. 'stream',
        'histogram', 'bar') prefers recipes whose class name contains it."""
        candidates = self.recipes
        if plot_type:
            preferred = [r for r in self.recipes if plot_type.lower() in type(r).__name__.lower()]
            candidates = preferred + [r for r in self.recipes if r not in preferred]
        for recipe in candidates:
            if recipe.can_plot(data, space):
                recipe.plot(data, figure, subplot, space, *args, **kwargs)
                return recipe
        raise NotImplementedError(f"No {self.name} recipe can plot {data}")


def gui_interrupt(*args, **kwargs):
    raise KeyboardInterrupt()


def display_name(python_name: str) -> str:
    n = list(python_name)
    n[0] = n[0].upper()
    return ''.join(n).replace('_', ' ')

"""Viewer — port of `phiflow_tpu/vis/_viewer.py`: a run loop over the Field
variables of the caller's namespace (`view`), per-step performance logging
into a scene, and `Record`, the per-step snapshots of those Fields stacked
into a trajectory along a batch dim. GUI backends (`_web.WebGui`) attach to
it as a `VisModel`."""
from __future__ import annotations

import inspect
import time
from typing import Union

from ..field import Field, Scene
from ._vis_base import VisModel
from ._log import SceneLog

__all__ = ['Viewer', 'Record', 'view', 'create_viewer']


class Record:
    """Per-step snapshots of viewer fields, stackable into a trajectory.

    Attribute access stacks the recorded snapshots of that field over a new
    batch dim named after the recording dim: ``viewer.rec.smoke``.
    """

    def __init__(self, dim: Union[str, None]):
        self.dim = dim
        self.history: dict = {}

    def append(self, variables: dict):
        if not self.history:
            self.history = {name: [] for name in variables}
        for name, val in variables.items():
            self.history[name].append(val)

    @property
    def recorded_fields(self):
        return tuple(self.history.keys())

    def get_snapshot(self, name: str, frame: int):
        return self.history[name][frame]

    def recording_size(self, name: str) -> int:
        return len(self.history[name])

    def __getattr__(self, item: str):
        if item.startswith('_') or item not in self.__dict__.get('history', {}):
            raise AttributeError(
                f"No recording for {item!r}; recorded: {tuple(self.__dict__.get('history', {}))}")
        from ..field import stack as field_stack
        from ..math import batch
        snapshots = [v for v in self.history[item] if v is not None]
        return field_stack(snapshots, batch(self.dim)) if snapshots else None

    def __getitem__(self, item: str):
        return self.__getattr__(item)

    def __repr__(self):
        return ", ".join(f"{name} ({len(v)})" for name, v in self.history.items())


class Viewer(VisModel):
    """Tracks Field variables of the calling namespace and provides a step loop
    with per-step performance logging."""

    def __init__(self, namespace: dict, fields: tuple, scene: Scene = None, log_performance=True):
        super().__init__(scene=scene)
        self._namespace = namespace
        self._field_names = fields
        self.log_performance = log_performance
        self.log = SceneLog(scene)
        self._step_fn = None

    @property
    def field_names(self):
        return self._field_names

    def get_field(self, name, dim_selection: dict = None):
        ns = self._namespace() if callable(self._namespace) else self._namespace
        value = ns.get(name)
        if dim_selection and isinstance(value, Field):
            return value[dim_selection]
        return value

    def range(self, *args, warmup=0, **rec_dim):
        """Iterate the run loop: ``for frame in viewer.range(100):``.
        A keyword form ``viewer.range(frames=100)`` additionally records every
        tracked field each step into ``viewer.rec`` (a `Record`)."""
        n = args[0] if args else (next(iter(rec_dim.values())) if rec_dim else None)
        if rec_dim:
            self.rec = Record(next(iter(rec_dim.keys())))
            self.rec.append({name: self.get_field(name) for name in self._field_names})
        frame = 0
        while n is None or frame < n:
            t0 = time.perf_counter()
            yield frame
            elapsed = time.perf_counter() - t0
            self.steps += 1
            if rec_dim:
                self.rec.append({name: self.get_field(name) for name in self._field_names})
            if self.log_performance and self.scene is not None and frame >= warmup:
                self.log.log_scalars(frame, step_time=elapsed)
            self.invalidate()
            frame += 1

    def log_scalars(self, frame=None, **values):
        self.log.log_scalars(frame if frame is not None else self.steps, **values)

    def progress(self):
        if self._step_fn is not None:
            self._step_fn()
            self.steps += 1


def create_viewer(namespace: dict, fields: tuple, scene=None, log_performance=True) -> Viewer:
    return Viewer(namespace, fields, scene, log_performance)


def view(*fields: str, scene: Union[bool, Scene] = False, play=False, log_performance=True, **config) -> Viewer:
    """Create a Viewer over the caller's Field variables."""
    frame = inspect.currentframe().f_back
    namespace = lambda: {**frame.f_globals, **frame.f_locals}  # live view of the caller's vars
    if not fields:
        fields = tuple(name for name, v in namespace().items() if isinstance(v, Field))
    if scene is True:
        scene = Scene.create('~/phiflow_tpu_torch_scenes')
    return Viewer(namespace, fields, scene if isinstance(scene, Scene) else None, log_performance)

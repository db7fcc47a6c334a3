"""Scenes — simulation output directories; port of
`phiflow_tpu/field/_scene.py` in the same layout, so that either package
reads the other's: a directory `sim_XXXXXX` with one `.npz` a field and
frame (`<name>_<frame:06d>.npz`, `field/_field_io.py`'s schema), the
properties in `description.json`, the calling script copied into `src/`.
A `SceneBatch` is one directory a batch entry.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Union

import numpy as np

from ..math import Tensor, Shape
from ._field import Field
from ._field_io import write as write_field, read as read_field_file

__all__ = ['Scene', 'SceneBatch']


def _slugify(name: str) -> str:
    return ''.join(c if c.isalnum() or c in '-_' else '_' for c in name)


class Scene:
    """One simulation output directory."""

    def __init__(self, path: str):
        self._path = path
        self._properties = None

    @property
    def path(self) -> str:
        return self._path

    @property
    def exists(self) -> bool:
        return os.path.isdir(self._path)

    # --- creation / listing ---
    @staticmethod
    def create(parent_directory: str, count: Union[int, Shape] = 1, copy_calling_script=True,
               **properties) -> 'Scene':
        """Create one scene directory (the next free `sim_XXXXXX`), a list of
        `count` of them, or — when `count` is a batch Shape — one directory an
        entry, returned as a `SceneBatch` whose write / read slice and stack
        Fields along the batch dims."""
        parent_directory = os.path.expanduser(parent_directory)
        os.makedirs(parent_directory, exist_ok=True)
        if isinstance(count, Shape):
            scenes = [Scene.create(parent_directory, 1, copy_calling_script, **properties)
                      for _ in range(count.volume)]
            return SceneBatch(scenes, count)
        if count > 1:
            return [Scene.create(parent_directory, 1, copy_calling_script, **properties) for _ in range(count)]
        existing = Scene.list(parent_directory)
        next_id = 0
        taken = {os.path.basename(s.path) for s in existing}
        while f"sim_{next_id:06d}" in taken:
            next_id += 1
        path = os.path.join(parent_directory, f"sim_{next_id:06d}")
        os.makedirs(path)
        scene = Scene(path)
        if properties:
            scene.put_properties(**properties)
        if copy_calling_script:
            try:
                scene.copy_calling_script()
            except OSError:  # the script cannot be read or copied: the scene stands without it
                pass
        return scene

    @staticmethod
    def list(parent_directory: str, include_other: bool = False):
        parent_directory = os.path.expanduser(parent_directory)
        if not os.path.isdir(parent_directory):
            return []
        names = sorted(os.listdir(parent_directory))
        scenes = []
        for n in names:
            full = os.path.join(parent_directory, n)
            if os.path.isdir(full) and (n.startswith('sim_') or include_other):
                scenes.append(Scene(full))
        return scenes

    @staticmethod
    def at(directory: str, id: int = None) -> 'Scene':
        directory = os.path.expanduser(directory)
        if id is not None:
            directory = os.path.join(directory, f"sim_{id:06d}")
        assert os.path.isdir(directory), f"no scene at {directory}"
        return Scene(directory)

    # --- properties (description.json) ---
    @property
    def properties(self) -> dict:
        if self._properties is None:
            f = os.path.join(self._path, 'description.json')
            if os.path.isfile(f):
                with open(f) as fh:
                    self._properties = json.load(fh)
            else:
                self._properties = {}
        return self._properties

    def put_properties(self, **properties):
        props = self.properties
        for k, v in properties.items():
            if isinstance(v, Tensor):
                v = np.asarray(v.numpy()).tolist()
            props[k] = v
        with open(os.path.join(self._path, 'description.json'), 'w') as fh:
            json.dump(props, fh, indent=2)

    put_property = put_properties

    # --- field IO ---
    def write(self, data: dict = None, frame: int = 0, **fields):
        fields = {**(data or {}), **fields}
        for name, field in fields.items():
            if field is None:
                continue
            file = os.path.join(self._path, f"{_slugify(name)}_{frame:06d}.npz")
            write_field(field, file)

    def read_field(self, name: str, frame: int = 0) -> Field:
        file = os.path.join(self._path, f"{_slugify(name)}_{frame:06d}.npz")
        return read_field_file(file)

    def read(self, *names: str, frame: int = 0):
        results = [self.read_field(n, frame) for n in names]
        return results[0] if len(results) == 1 else tuple(results)

    @property
    def fieldnames(self) -> tuple:
        names = set()
        for f in os.listdir(self._path):
            if f.endswith('.npz') and '_' in f:
                names.add(f.rsplit('_', 1)[0])
        return tuple(sorted(names))

    @property
    def frames(self) -> tuple:
        frames = set()
        for f in os.listdir(self._path):
            if f.endswith('.npz') and '_' in f:
                try:
                    frames.add(int(f.rsplit('_', 1)[1][:-4]))
                except ValueError:
                    pass
        return tuple(sorted(frames))

    def copy_calling_script(self, full_trace=False, include_context_information=True):
        """Copy the calling script (the innermost frame outside this package
        and site-packages; with `full_trace` every such frame) into `src/`."""
        import inspect
        src_dir = os.path.join(self._path, 'src')
        os.makedirs(src_dir, exist_ok=True)
        package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for frame_info in inspect.stack():
            fn = frame_info.filename
            if fn and os.path.isfile(fn) and not os.path.abspath(fn).startswith(package) \
                    and 'site-packages' not in fn and not fn.startswith('<'):
                shutil.copy(fn, os.path.join(src_dir, os.path.basename(fn)))
                if not full_trace:
                    break

    def subpath(self, name: str, create=False) -> str:
        p = os.path.join(self._path, name)
        if create:
            os.makedirs(p, exist_ok=True)
        return p

    def remove(self):
        if self.exists:
            shutil.rmtree(self._path)

    def __repr__(self):
        return f"Scene({self._path})"


class SceneBatch:
    """Batched scenes: one directory an entry of a batch Shape
    (`Scene.create(..., batch(b=4))`).

    `write` slices each field along the batch dims and writes the slice into
    the matching directory; `read` reassembles the batch by stacking."""

    def __init__(self, scenes, batch_shape: Shape):
        assert len(scenes) == batch_shape.volume
        self.scenes = scenes
        self.batch_shape = batch_shape

    @property
    def paths(self):
        return [s.path for s in self.scenes]

    def _indices(self):
        import itertools
        names = self.batch_shape.names
        ranges = [range(s) for s in self.batch_shape.sizes]
        for i, combo in enumerate(itertools.product(*ranges)):
            yield i, dict(zip(names, combo))

    def write(self, data: dict = None, frame: int = 0, **fields):
        fields = {**(data or {}), **fields}
        for i, sel in self._indices():
            sliced = {}
            for name, field in fields.items():
                if field is None:
                    continue
                f_sel = {k: v for k, v in sel.items() if k in field.shape}
                sliced[name] = field[f_sel] if f_sel else field
            self.scenes[i].write(sliced, frame=frame)

    def read_field(self, name: str, frame: int = 0) -> Field:
        from ..math import stack as math_stack, batch as batch_dim
        fields = [s.read_field(name, frame) for s in self.scenes]
        if self.batch_shape.rank == 1:
            values = math_stack([f.values for f in fields], self.batch_shape)
            return fields[0].with_values(values)
        # multi-dim batch: stack innermost-first
        shape = self.batch_shape
        values = math_stack([f.values for f in fields], batch_dim(_flat=len(fields)))
        from ..math import unpack_dim
        values = unpack_dim(values, '_flat', shape)
        return fields[0].with_values(values)

    def read(self, *names: str, frame: int = 0):
        results = [self.read_field(n, frame) for n in names]
        return results[0] if len(results) == 1 else tuple(results)

    def put_properties(self, **properties):
        for s in self.scenes:
            s.put_properties(**properties)

    def remove(self):
        for s in self.scenes:
            s.remove()

    def __len__(self):
        return len(self.scenes)

    def __getitem__(self, i):
        return self.scenes[i]

    def __repr__(self):
        return f"SceneBatch({self.batch_shape}, {len(self.scenes)} scenes)"

"""Checkpoints of any state of the port's structures — port of
`phiflow_tpu/utils/_checkpoint.py` without orbax: a checkpoint is one pickle
holding the state with host (numpy) copies of its arrays and the list of
those arrays, written to a temporary file and renamed into place, so a
reader never finds half a file. Loading puts the arrays back as torch
tensors on a chosen device, or leaves them numpy. Unpickling runs code:
load only checkpoints this program wrote."""
from __future__ import annotations

import os
import pickle
import re
from typing import Any, List, Optional

import numpy as np
import torch

from ..math._functional import _flatten as _flatten_natives, _join

__all__ = ['CheckpointManager', 'save_checkpoint', 'load_checkpoint']


def _flatten(x):
    """(arrays, rebuild) of a state: the natives of Tensors and Fields, torch
    tensors, and numpy arrays, inside tuples, lists and dicts."""
    if isinstance(x, (np.ndarray, np.generic)):
        return [x], lambda leaves: leaves[0]
    if isinstance(x, (tuple, list)) and not hasattr(x, '_fields'):
        return _join([_flatten(v) for v in x], type(x))
    if isinstance(x, dict):
        keys = list(x)
        return _join([_flatten(x[k]) for k in keys], lambda items: dict(zip(keys, items)))
    return _flatten_natives(x)


def _host(leaf):
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _on(leaves, device):
    if device is None:
        return list(leaves)
    return [torch.from_numpy(np.array(leaf)).to(device) for leaf in leaves]


def _pkl(path: str) -> str:
    path = os.path.abspath(os.path.expanduser(path))
    return path if path.endswith('.pkl') else path + '.pkl'


def save_checkpoint(path: str, state: Any) -> str:
    """Save `state` to `<path>.pkl` (tmp file + rename); returns the path.
    The file describes itself: it restores without a template."""
    path = _pkl(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    natives, rebuild = _flatten(state)
    leaves = [_host(n) for n in natives]
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        pickle.dump({'tree': rebuild(leaves), 'leaves': leaves}, f)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, template: Any = None, device=None):
    """The state saved by `save_checkpoint`: as saved, or with `template`
    its arrays put into the template's structure (for a class that changed
    since the save). `device`: the arrays as torch tensors there ('cuda',
    'cpu', a torch.device); None leaves them numpy, host constants that move
    to a tensor's device where they meet one."""
    with open(_pkl(path), 'rb') as f:
        data = pickle.load(f)
    if template is not None:
        return _flatten(template)[1](_on(data['leaves'], device))
    natives, rebuild = _flatten(data['tree'])
    return rebuild(_on(natives, device))


class CheckpointManager:
    """Numbered checkpoints in `directory` (`<step>.pkl`), keeping the latest
    `max_to_keep`."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(os.path.expanduser(directory))
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f'{int(step)}.pkl')

    def save(self, step: int, state: Any):
        save_checkpoint(self._path(step), state)
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else []:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None, template: Any = None, device=None):
        step = step if step is not None else self.latest_step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return load_checkpoint(self._path(step), template, device)

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(re.compile(r'^(\d+)\.pkl$').match, os.listdir(self.directory))
                      if m)

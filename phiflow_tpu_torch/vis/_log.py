"""Scene scalar logging — port of `phiflow_tpu/vis/_log.py`: `SceneLog`
writes `log_<name>.txt` curves and `info.log` into a scene's folder (the
port's `field.Scene`), `load_scalars` reads a curve back as a Tensor."""
from __future__ import annotations

import logging
import os
from typing import Union

import numpy as np

from ..math import Tensor, wrap, spatial, channel
from ..field import Scene

__all__ = ['SceneLog', 'load_scalars']


class SceneLog:
    """Writes `log_<name>.txt` scalar curves and `info.log` into a scene directory."""

    def __init__(self, scene: Scene = None):
        self.scene = scene
        self._logger = logging.getLogger('phiflow_tpu_torch.scene')
        self._logger.setLevel(logging.INFO)
        if scene is not None:
            handler = logging.FileHandler(os.path.join(scene.path, 'info.log'))
            handler.setFormatter(logging.Formatter('%(asctime)s %(message)s'))
            self._logger.addHandler(handler)

    def log(self, message: str):
        self._logger.info(message)

    def log_scalars(self, frame: int = None, **values):
        if self.scene is None:
            return
        for name, value in values.items():
            value = float(value.values if hasattr(value, 'values') else value)
            path = os.path.join(self.scene.path, f"log_{name}.txt")
            with open(path, 'a') as f:
                if frame is not None:
                    f.write(f"{frame} {value}\n")
                else:
                    f.write(f"{value}\n")


def load_scalars(scene: Union[str, Scene], name: str, prefix='log_', suffix='.txt') -> Tensor:
    """A scalar curve written by `SceneLog.log_scalars`: (iteration) or, with
    frames, (iteration, vector: iteration, name), float32 on the host."""
    path = scene.path if isinstance(scene, Scene) else scene
    file = os.path.join(path, f"{prefix}{name}{suffix}")
    data = np.loadtxt(file, ndmin=2).astype(np.float32)
    if data.shape[1] == 2:
        return wrap(data, spatial('iteration'), channel(vector='iteration,' + name))
    return wrap(data[:, 0], spatial('iteration'))

"""Prebuilt simulation models of the port (mirrors `phiflow_tpu/models`).

Each model's module has its own `state_from_numpy` / `state_to_numpy`; the
smoke model's are also exported here.
"""
from . import cavity, flip, moving_obstacle, smoke
from .cavity import LidDrivenCavity
from .flip import FlipLiquid
from .moving_obstacle import MovingObstacles
from .smoke import SmokePlume, state_from_numpy, state_to_numpy

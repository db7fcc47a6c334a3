"""Prebuilt simulation models of the port (mirrors `phiflow_tpu/models`).

Each model's module has its own `state_from_numpy` / `state_to_numpy`; the
smoke model's are also exported here.
"""
from . import flip, smoke
from .flip import FlipLiquid
from .smoke import SmokePlume, state_from_numpy, state_to_numpy

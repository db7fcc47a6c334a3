"""Prebuilt simulation models of the port (mirrors `phiflow_tpu/models`)."""
from .smoke import SmokePlume, state_from_numpy, state_to_numpy

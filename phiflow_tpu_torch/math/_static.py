"""Hashable wrapper of a host array — port of `phiflow_tpu/math/_static.py`."""
from __future__ import annotations

import numpy as np

__all__ = ['HashableArray']


class HashableArray:
    """Immutable numpy array, hashable and comparable."""
    __slots__ = ('array', '_bytes')

    def __init__(self, array):
        self.array = np.asarray(array)
        self.array.setflags(write=False)
        self._bytes = self.array.tobytes()

    def __eq__(self, other):
        return isinstance(other, HashableArray) and self.array.shape == other.array.shape \
            and self.array.dtype == other.array.dtype and self._bytes == other._bytes

    def __hash__(self):
        return hash((self.array.shape, str(self.array.dtype), self._bytes))

    def __repr__(self):
        return f"static{self.array!r}"

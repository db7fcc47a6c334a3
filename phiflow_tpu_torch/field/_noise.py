"""Spectral noise — port of `phiflow_tpu/field/_noise.py`.

White noise from the port's generator (`math.random_normal`, a CPU
`torch.Generator`: `math.seed`, or a model's own seed), filtered on the host
in numpy by 1/k^(2·smoothness) with the lowest frequencies removed, brought
back by an inverse FFT, scaled to the standard deviation `scale` and zero
mean — the JAX package's host synthesis, step by step. The values are a host
Tensor, as there; a model moves them to its device (`models.to_device`).
JAX's threefry draws are not reproduced, so the two packages agree on the
filter, not on the draw.
"""
from __future__ import annotations

import numpy as np

from ..geom import Geometry, UniformGrid
from ..math import EMPTY_SHAPE, Shape, Tensor, channel, default_float
from ..math import _ops as ops
from ._field import FieldInitializer

__all__ = ['Noise']


class Noise(FieldInitializer):
    """Random smooth noise: a spectrum filtered by 1/k^(2·smoothness)."""

    def __init__(self, *shape: Shape, scale=10., smoothness=1.0, **channel_dims):
        self.scale = scale
        self.smoothness = smoothness
        self._shape = shape[0] if shape else EMPTY_SHAPE
        for s in shape[1:]:
            self._shape = self._shape & s
        if channel_dims:
            self._shape = self._shape & channel(**channel_dims)

    @property
    def shape(self):
        return self._shape

    def _sample(self, geometry: Geometry, at: str, boundaries, **kwargs) -> Tensor:
        if isinstance(geometry, UniformGrid):
            return self._sample_grid(geometry.resolution)
        return ops.random_normal(geometry.shape.non_channel & self._shape)

    def _sample_grid(self, resolution: Shape) -> Tensor:
        """The filtered noise on the grid's cells, on the host."""
        shape = self._shape & resolution
        rnd = ops.random_normal(shape).numpy() + 1j * ops.random_normal(shape).numpy()
        spatial_axes = [shape.index(n) for n in resolution.names]
        k_grids = np.meshgrid(*[np.fft.fftfreq(d.size) * d.size for d in resolution.dims], indexing='ij')
        k2 = np.zeros_like(k_grids[0])
        for kg in k_grids:
            k2 = k2 + kg ** 2
        lowest_frequency = 0.1
        weight_mask = (k2 > lowest_frequency ** 2).astype(np.float32)
        with np.errstate(divide='ignore'):
            inv_k2 = np.where(k2 > 0, 1.0 / np.where(k2 > 0, k2, 1.0), 0.0)
        amplitude = (inv_k2 ** self.smoothness) * weight_mask
        # the filter broadcast over the dims that are not the grid's (e.g. `vector`)
        full = np.ones([d.size if i in spatial_axes else 1 for i, d in enumerate(shape.dims)], np.float32)
        amp_full = full * amplitude.reshape([shape.dims[i].size if i in spatial_axes else 1
                                             for i in range(len(shape.dims))])
        filtered = rnd * amp_full
        result = np.real(np.fft.ifftn(filtered, axes=spatial_axes)).astype(np.dtype(default_float()))
        std = result.std(axis=tuple(spatial_axes), keepdims=True)
        std[std == 0] = 1
        result = result / std * self.scale
        result = result - result.mean(axis=tuple(spatial_axes), keepdims=True)
        return Tensor(result, shape)

    def __repr__(self):
        return f"Noise(scale={self.scale}, smoothness={self.smoothness})"

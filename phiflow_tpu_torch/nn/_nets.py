"""Network architectures — port of `phiflow_tpu/nn/_nets.py` onto `torch.nn`.

The JAX package builds flax modules; here each architecture is a
`torch.nn.Module` computing what the flax module computes, wrapped in
`Network`, which is called channels-last as JAX's is: ``net(x)`` with x of
shape (batch, *spatial, channels), the layout `math.native_call` produces.
The convolutions run channels-first inside (PyTorch's layout) and the
module transposes at its entry and exit.

What flax does and PyTorch's defaults do not, done here as flax does it:
kernels drawn lecun-normal (a normal of variance 1/fan_in truncated at two
standard deviations, flax's `variance_scaling(1, 'fan_in',
'truncated_normal')`) from a `torch.Generator` seeded 0 in module order,
biases zero; `GroupNorm` with ε = 1e-6; `gelu` in its tanh approximation;
padding 'SAME' (zeros) or 'CIRCULAR' for a periodic net; `max_pool` over
windows of 2 that floors; the U-Net's upsampling a repeat of each entry
along every spatial axis, cropped to the skip connection's shape; the
classifier flattening its features channels-last. The random draws are not
JAX's: `parameters_from_numpy` (`nn/__init__.py`) carries a flax parameter
tree across, in module order.

Parameters are created on the default device of `math` (the card unless
`math.set_default_device('cpu')`).
"""
from __future__ import annotations

import math as _math
from typing import Callable, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ['Network', 'InvertibleNetwork', 'dense_net', 'mlp', 'u_net', 'conv_net', 'res_net', 'conv_classifier',
           'invertible_net']

_ACTIVATIONS = {
    'relu': F.relu, 'silu': F.silu, 'gelu': lambda x: F.gelu(x, approximate='tanh'), 'tanh': torch.tanh,
    'sigmoid': torch.sigmoid, 'softplus': F.softplus, 'leakyrelu': lambda x: F.leaky_relu(x, 0.01),
}


def _act(name) -> Callable:
    if callable(name):
        return name
    return _ACTIVATIONS[name.lower().replace('_', '')]


class Network:
    """A `torch.nn.Module` called channels-last, as the JAX package's
    `Network` calls its flax module. `params` is the module's parameters by
    name; assigning a dict of tensors or arrays loads them."""

    def __init__(self, module: nn.Module, params, input_shape):
        self.module = module
        if params is not None:
            self.params = params
        self.input_shape = input_shape

    def _input(self, x) -> torch.Tensor:
        p = next(self.module.parameters())
        return torch.as_tensor(x, dtype=p.dtype, device=p.device) if not isinstance(x, torch.Tensor) else x

    def __call__(self, *args):
        xs = [self._input(a) for a in args]
        return self.module(xs[0] if len(xs) == 1 else torch.cat(xs, dim=-1))

    @property
    def params(self) -> dict:
        return dict(self.module.named_parameters())

    @params.setter
    def params(self, values: dict):
        with torch.no_grad():
            for name, p in self.module.named_parameters():
                p.copy_(torch.as_tensor(np.asarray(values[name]) if not isinstance(values[name], torch.Tensor)
                                        else values[name], dtype=p.dtype, device=p.device))

    @property
    def parameters(self) -> dict:
        return self.params

    def __repr__(self):
        n = sum(p.numel() for p in self.module.parameters())
        return f"Network[{type(self.module).__name__}, {n} parameters]"


class InvertibleNetwork(Network):

    def inverse(self, y):
        return self.module(self._input(y), invert=True)


# --- flax's initialisation, in module order ---

def _init(module: nn.Module, seed: int = 0) -> nn.Module:
    """Kernels lecun-normal (truncated at ±2σ, σ corrected for the
    truncation as flax's), biases 0, GroupNorm 1 and 0; then onto the
    default device."""
    from ..math import get_default_device
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
                fan_in = m.weight[0].numel()
                std = _math.sqrt(1.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
    return module.to(get_default_device())


def _conv(d: int, c_in: int, c_out: int, k: int, periodic: bool) -> nn.Module:
    cls = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}[d]
    pad = k // 2
    return cls(c_in, c_out, k, padding=pad, padding_mode='circular' if periodic and pad else 'zeros')


def _first(x: torch.Tensor) -> torch.Tensor:
    """(N, *spatial, C) → (N, C, *spatial)."""
    return x.movedim(-1, 1)


def _last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


def _max_pool(x: torch.Tensor, d: int) -> torch.Tensor:
    return {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[d](x, 2, 2)


# --- architectures ---

class _DenseNet(nn.Module):

    def __init__(self, in_channels, layers, out_channels, activation, softmax):
        super().__init__()
        widths = [in_channels, *layers]
        self.hidden = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.out = nn.Linear(widths[-1], out_channels)
        self.act, self.softmax = _act(activation), softmax

    def forward(self, x):
        for layer in self.hidden:
            x = self.act(layer(x))
        x = self.out(x)
        return torch.softmax(x, -1) if self.softmax else x


def dense_net(in_channels: int, out_channels: int, layers: Sequence[int],
              batch_norm=False, activation='ReLU', softmax=False) -> Network:
    """Fully-connected network: Dense + activation per layer, a last Dense."""
    return Network(_init(_DenseNet(in_channels, tuple(layers), out_channels, activation, softmax)), None,
                   (in_channels,))


mlp = dense_net


class _ConvBlock(nn.Module):
    """Conv 3^d ('SAME' or 'CIRCULAR'), GroupNorm(min(8, filters), ε 1e-6) with
    `batch_norm`, activation; channels-first."""

    def __init__(self, c_in, filters, activation, batch_norm, periodic, d):
        super().__init__()
        self.conv = _conv(d, c_in, filters, 3, periodic)
        self.norm = nn.GroupNorm(min(8, filters), filters, eps=1e-6) if batch_norm else None
        self.act = _act(activation)

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return self.act(x)


class _UNet(nn.Module):

    def __init__(self, in_channels, out_channels, levels, filters, activation, batch_norm, d, periodic):
        super().__init__()
        f = [filters * 2 ** i if isinstance(filters, int) else filters[i] for i in range(levels)]
        block = lambda a, b: _ConvBlock(a, b, activation, batch_norm, periodic, d)
        self.d = d
        self.down = nn.ModuleList()
        c = in_channels
        for level in range(levels - 1):
            self.down.append(nn.ModuleList([block(c, f[level]), block(f[level], f[level])]))
            c = f[level]
        self.bottom = nn.ModuleList([block(c, f[-1]), block(f[-1], f[-1])])
        self.up = nn.ModuleList()
        c = f[-1]
        for level in reversed(range(levels - 1)):
            self.up.append(nn.ModuleList([block(c + f[level], f[level]), block(f[level], f[level])]))
            c = f[level]
        self.out = _conv(d, c, out_channels, 1, False)

    def forward(self, x):
        x = _first(x)
        skips = []
        for b1, b2 in self.down:
            x = b2(b1(x))
            skips.append(x)
            x = _max_pool(x, self.d)
        b1, b2 = self.bottom
        x = b2(b1(x))
        for (b1, b2), target in zip(self.up, reversed(skips)):
            for axis in range(2, 2 + self.d):  # nearest-neighbour upsampling, cropped to the skip's shape
                x = x.repeat_interleave(2, dim=axis)
            x = x[(slice(None), slice(None)) + tuple(slice(0, s) for s in target.shape[2:])]
            x = b2(b1(torch.cat([x, target], dim=1)))
        return _last(self.out(x))


def u_net(in_channels: int, out_channels: int, levels: int = 4, filters: Union[int, Sequence[int]] = 16,
          batch_norm: bool = True, activation='ReLU', in_spatial: Union[int, tuple] = 2,
          periodic=False, use_res_blocks=False, **kwargs) -> Network:
    """U-Net with skip connections: two conv blocks a level, max-pooled down,
    upsampled by repetition, a last 1^d conv."""
    d = in_spatial if isinstance(in_spatial, int) else len(in_spatial)
    module = _UNet(in_channels, out_channels, levels, filters, activation, batch_norm, d, periodic)
    return Network(_init(module), None, (2 ** levels * 2,) * d + (in_channels,))


class _ConvNet(nn.Module):

    def __init__(self, in_channels, out_channels, layers, activation, batch_norm, d, periodic):
        super().__init__()
        widths = [in_channels, *layers]
        self.blocks = nn.ModuleList(_ConvBlock(a, b, activation, batch_norm, periodic, d)
                                    for a, b in zip(widths[:-1], widths[1:]))
        self.out = _conv(d, widths[-1], out_channels, 1, False)

    def forward(self, x):
        x = _first(x)
        for block in self.blocks:
            x = block(x)
        return _last(self.out(x))


def conv_net(in_channels: int, out_channels: int, layers: Sequence[int], batch_norm=False,
             activation='ReLU', in_spatial: Union[int, tuple] = 2, periodic=False) -> Network:
    """Plain convolutional network: a conv block a layer, a last 1^d conv."""
    d = in_spatial if isinstance(in_spatial, int) else len(in_spatial)
    module = _ConvNet(in_channels, out_channels, tuple(layers), activation, batch_norm, d, periodic)
    return Network(_init(module), None, (16,) * d + (in_channels,))


class _ResNet(nn.Module):

    def __init__(self, in_channels, out_channels, layers, activation, d, periodic):
        super().__init__()
        self.act = _act(activation)
        self.layers = nn.ModuleList()
        c = in_channels
        for width in layers:  # flax's order: the two convs, then the projection of the input
            self.layers.append(nn.ModuleList([_conv(d, c, width, 3, periodic), _conv(d, width, width, 3, periodic)]
                                             + ([_conv(d, c, width, 1, False)] if c != width else [])))
            c = width
        self.out = _conv(d, c, out_channels, 1, False)

    def forward(self, x):
        x = _first(x)
        for convs in self.layers:
            y = convs[1](self.act(convs[0](x)))
            x = self.act((convs[2](x) if len(convs) == 3 else x) + y)
        return _last(self.out(x))


def res_net(in_channels: int, out_channels: int, layers: Sequence[int], batch_norm=False,
            activation='ReLU', in_spatial: Union[int, tuple] = 2, periodic=False) -> Network:
    """Residual network: two 3^d convs a layer around a (projected) skip, a
    last 1^d conv."""
    d = in_spatial if isinstance(in_spatial, int) else len(in_spatial)
    module = _ResNet(in_channels, out_channels, tuple(layers), activation, d, periodic)
    return Network(_init(module), None, (16,) * d + (in_channels,))


class _ConvClassifier(nn.Module):

    def __init__(self, in_features, spatial_shape, num_classes, blocks, dense_layers, activation, batch_norm,
                 periodic, softmax):
        super().__init__()
        d = len(spatial_shape)
        self.d, self.act, self.softmax = d, _act(activation), softmax
        widths = [in_features, *blocks]
        self.blocks = nn.ModuleList(_ConvBlock(a, b, activation, batch_norm, periodic, d)
                                    for a, b in zip(widths[:-1], widths[1:]))
        sizes = list(spatial_shape)
        for _ in blocks:
            sizes = [s // 2 for s in sizes]
        dense = [int(np.prod(sizes)) * widths[-1], *dense_layers]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dense[:-1], dense[1:]))
        self.out = nn.Linear(dense[-1], num_classes)

    def forward(self, x):
        x = _first(x)
        for block in self.blocks:
            x = _max_pool(block(x), self.d)
        x = _last(x).reshape(x.shape[0], -1)  # flattened channels-last, as flax flattens
        for layer in self.dense:
            x = self.act(layer(x))
        x = self.out(x)
        return torch.softmax(x, -1) if self.softmax else x


def conv_classifier(in_features: int, in_spatial: Union[tuple, list], num_classes: int,
                    blocks=(64, 128, 256), block_sizes=None, dense_layers=(256,),
                    batch_norm=True, activation='ReLU', softmax=True, periodic=False) -> Network:
    """Convolutional classifier: a conv block and a max pool a block, then
    dense layers on the flattened features."""
    spatial_shape = tuple(in_spatial)
    module = _ConvClassifier(in_features, spatial_shape, num_classes, tuple(blocks), tuple(dense_layers), activation,
                             batch_norm, periodic, softmax)
    return Network(_init(module), None, spatial_shape + (in_features,))


class _CouplingLayer(nn.Module):
    """Affine coupling (RealNVP): one half of the channels scales and shifts
    the other by a dense net of it, tanh-bounded scale."""

    def __init__(self, channels, hidden, activation, swap):
        super().__init__()
        h = channels // 2
        self.channels, self.h, self.swap, self.act = channels, h, swap, _act(activation)
        n_a = channels - h if swap else h
        self.net = nn.ModuleList([nn.Linear(n_a, hidden), nn.Linear(hidden, hidden),
                                  nn.Linear(hidden, 2 * (channels - h))])

    def forward(self, x, invert=False):
        c, h = self.channels, self.h
        a, b = (x[..., :h], x[..., h:]) if not self.swap else (x[..., h:], x[..., :h])
        p = self.net[2](self.act(self.net[1](self.act(self.net[0](a)))))
        scale, shift = torch.tanh(p[..., :c - h]), p[..., c - h:]
        b = (b - shift) * torch.exp(-scale) if invert else b * torch.exp(scale) + shift
        return torch.cat([a, b] if not self.swap else [b, a], dim=-1)


class _InvertibleNet(nn.Module):

    def __init__(self, channels, num_blocks, hidden, activation):
        super().__init__()
        self.layers = nn.ModuleList(_CouplingLayer(channels, hidden, activation, swap=bool(i % 2))
                                    for i in range(num_blocks))

    def forward(self, x, invert=False):
        for layer in (reversed(self.layers) if invert else self.layers):
            x = layer(x, invert=invert)
        return x


def invertible_net(num_blocks: int = 3, construct_net='dense', in_channels: int = 2,
                   hidden: int = 64, activation='ReLU', **kwargs) -> InvertibleNetwork:
    """Invertible net of affine coupling layers; `inverse` undoes it."""
    module = _InvertibleNet(in_channels, num_blocks, hidden, activation)
    return InvertibleNetwork(_init(module), None, (in_channels,))

"""Networks and optimizers on `torch.nn` — port of `phiflow_tpu/nn`.

`Network` wraps a `torch.nn.Module` (`_nets.py`), `Optimizer` a torch
optimizer computing optax's update (`_optim.py`), so that the JAX package's
imperative API (``net = u_net(...); opt = adam(net); update_weights(net,
opt, loss, *data)``) runs unchanged; `math.native_call(net, x)` bridges
named tensors to the channels-last layout.

`parameters_from_numpy(net, tree)` carries a flax parameter tree (numpy
arrays) across: module by module under flax's names, a Dense
kernel (in, out) becomes a Linear weight (out, in), a Conv kernel
(*k, in, out) a weight (out, in, *k), a GroupNorm's scale / bias its weight /
bias. `load_state` reads this package's files and those of the JAX
package's `save_state` (a pickle of the numpy parameter tree).
"""
from __future__ import annotations

import pickle

import numpy as np
import torch
from torch import nn as _tnn

from ._nets import (
    Network, InvertibleNetwork, dense_net, mlp, u_net, conv_net, res_net, conv_classifier, invertible_net,
)
from ._optim import (
    Optimizer, adam, sgd, rmsprop, adagrad, update_weights, train, set_learning_rate, get_learning_rate,
)

__all__ = ['Network', 'dense_net', 'mlp', 'u_net', 'conv_net', 'res_net', 'conv_classifier', 'invertible_net',
           'parameter_count', 'get_parameters', 'save_state', 'load_state', 'parameters_from_numpy', 'Optimizer',
           'adam', 'sgd', 'rmsprop', 'adagrad', 'update_weights', 'train', 'set_learning_rate', 'get_learning_rate']

_PARAMETRIZED = (_tnn.Linear, _tnn.Conv1d, _tnn.Conv2d, _tnn.Conv3d, _tnn.GroupNorm)


def parameter_count(net: Network) -> int:
    return sum(p.numel() for p in net.module.parameters())


def get_parameters(net: Network) -> dict:
    """The parameters by name (the module's names)."""
    return dict(net.module.named_parameters())


_FLAX_NAMES = {_tnn.Linear: 'Dense', _tnn.Conv1d: 'Conv', _tnn.Conv2d: 'Conv', _tnn.Conv3d: 'Conv',
               _tnn.GroupNorm: 'GroupNorm'}


def _flax_paths(module, prefix=(), counters=None):
    """(torch module, flax path) of every parametrized module: flax names a
    submodule ClassName_k, k counting that class within its parent in the
    order of creation, which the modules of `_nets.py` register in;
    `ModuleList`s are no scope. The tree's own key order cannot be used: a
    tree through `jax.tree_util` has its keys sorted."""
    counters = {} if counters is None else counters
    for child in module.children():
        if isinstance(child, _tnn.ModuleList):
            yield from _flax_paths(child, prefix, counters)
            continue
        cls = _FLAX_NAMES.get(type(child), type(child).__name__)
        k = counters.get(cls, 0)
        counters[cls] = k + 1
        path = prefix + (f'{cls}_{k}',)
        if isinstance(child, _PARAMETRIZED):
            yield child, path
        else:
            yield from _flax_paths(child, path, {})


def parameters_from_numpy(net: Network, tree: dict) -> Network:
    """Load JAX's flax parameters (a nested dict of numpy arrays) into
    `net`, in place; raises where a module is missing or a shape differs."""
    with torch.no_grad():
        for tm, path in _flax_paths(net.module):
            fm = tree
            for key in path:
                if key not in fm:
                    raise KeyError(f"{'/'.join(path)}: not in the parameter tree")
                fm = fm[key]
            if isinstance(tm, _tnn.GroupNorm):
                pairs = [(tm.weight, fm['scale']), (tm.bias, fm['bias'])]
            else:
                k = np.asarray(fm['kernel'])
                k = k.T if isinstance(tm, _tnn.Linear) else np.transpose(k, (k.ndim - 1, k.ndim - 2) + tuple(
                    range(k.ndim - 2)))
                pairs = [(tm.weight, k), (tm.bias, fm['bias'])]
            for p, v in pairs:
                v = np.array(v)
                if tuple(p.shape) != v.shape:
                    raise ValueError(f"{'/'.join(path)}: parameter of shape {tuple(p.shape)}, array {v.shape}")
                p.copy_(torch.from_numpy(v).to(p.dtype))
    return net


def _path(path: str) -> str:
    return path if path.endswith('.pkl') or path.endswith('.npz') else path + '.pkl'


def save_state(obj, path: str):
    """Save a network's parameters or an optimizer's state (a pickle of numpy
    arrays by name); returns the path."""
    if isinstance(obj, Network):
        data = {n: p.detach().cpu().numpy() for n, p in obj.module.named_parameters()}
    elif isinstance(obj, Optimizer):
        data = _to_numpy(obj.state)
    else:
        data = _to_numpy(obj)
    path = _path(path)
    with open(path, 'wb') as f:
        pickle.dump(data, f)
    return path


def load_state(obj, path: str):
    """Load a network's parameters or an optimizer's state in place: files of
    this package's `save_state`, and a network's from the JAX package's (its
    flax tree, through `parameters_from_numpy`)."""
    with open(_path(path), 'rb') as f:
        data = pickle.load(f)
    if isinstance(obj, Network):
        if set(data) == set(dict(obj.module.named_parameters())):
            obj.params = data
        else:
            parameters_from_numpy(obj, data)
    elif isinstance(obj, Optimizer):
        obj.state = _to_torch(data)
    return obj


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    return x


def _to_torch(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_torch(v) for v in x)
    return x

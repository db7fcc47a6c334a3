"""Optimizers and the training loop — port of `phiflow_tpu/nn/_optim.py`,
computing what its optax transforms compute.

`adam` and `sgd` are `torch.optim.Adam` and `torch.optim.SGD`: their update
formulas are optax's (`sgd` with momentum is optax's `trace`; JAX's `sgd`
takes `dampening` and `weight_decay` and ignores them, and so does this
one). Where torch's formula differs, a `torch.optim.Optimizer` of this module
computes optax's:

* `rmsprop`: ν = α·ν + (1 − α)·g², update −lr·g / √(ν + ε) — optax puts ε
  inside the square root, torch outside; momentum is optax's trace of the
  scaled updates;
* `adagrad`: the accumulator starts at 0.1 (torch: 0), update
  −lr·g / √(acc + ε); JAX's `adagrad` takes `lr_decay` and `weight_decay`
  and ignores them.

`update_weights` takes the gradient of the loss's sum with respect to the
network's parameters by `torch.autograd` (solves inside the loss
differentiate implicitly) and applies one step.
"""
from __future__ import annotations

from typing import Callable

import torch

from ._nets import Network

__all__ = ['Optimizer', 'adam', 'sgd', 'rmsprop', 'adagrad', 'update_weights', 'train', 'set_learning_rate',
           'get_learning_rate']


class Optimizer:
    """A torch optimizer bound to a Network: `factory(parameters,
    learning_rate)` builds it."""

    def __init__(self, net: Network, factory: Callable, learning_rate: float):
        self.net = net
        self.learning_rate = learning_rate
        self.optimizer = factory(list(net.module.parameters()), learning_rate)

    @property
    def state(self) -> dict:
        return self.optimizer.state_dict()

    @state.setter
    def state(self, value: dict):
        self.optimizer.load_state_dict(value)

    def rebuild(self, learning_rate: float):
        """A new learning rate; the moments are kept."""
        self.learning_rate = learning_rate
        for group in self.optimizer.param_groups:
            group['lr'] = learning_rate

    def step(self, grads):
        """Apply the gradients, one per parameter in the module's order (None: 0)."""
        params = list(self.net.module.parameters())
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g.detach().to(p.dtype)
        self.optimizer.step()
        for p in params:
            p.grad = None


class _RMSprop(torch.optim.Optimizer):
    """optax.rmsprop: ε inside the square root, momentum as a trace of the
    scaled updates."""

    def __init__(self, params, lr, alpha, eps, momentum):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['nu'] = torch.zeros_like(p)
                    if group['momentum']:
                        state['trace'] = torch.zeros_like(p)
                nu = state['nu']
                nu.mul_(group['alpha']).add_((1 - group['alpha']) * p.grad * p.grad)
                update = -group['lr'] * p.grad * torch.rsqrt(nu + group['eps'])
                if group['momentum']:
                    update = state['trace'].mul_(group['momentum']).add_(update)
                p.add_(update)


class _Adagrad(torch.optim.Optimizer):
    """optax.adagrad: the accumulator starts at 0.1; update −lr·g/√(acc + ε)."""

    def __init__(self, params, lr, eps, initial_accumulator_value=0.1):
        super().__init__(params, dict(lr=lr, eps=eps, initial=initial_accumulator_value))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['sum'] = torch.full_like(p, group['initial'])
                acc = state['sum']
                acc.add_(p.grad * p.grad)
                scale = torch.where(acc > 0, torch.rsqrt(acc + group['eps']), torch.zeros_like(acc))
                p.add_(-group['lr'] * scale * p.grad)


def adam(net: Network, learning_rate: float = 1e-3, betas=(0.9, 0.999), epsilon=1e-7) -> Optimizer:
    return Optimizer(net, lambda params, lr: torch.optim.Adam(params, lr, betas=tuple(betas), eps=epsilon),
                     learning_rate)


def sgd(net: Network, learning_rate: float = 1e-3, momentum=0.0, dampening=0.0, weight_decay=0.0,
        nesterov=False) -> Optimizer:
    return Optimizer(net, lambda params, lr: torch.optim.SGD(params, lr, momentum=momentum,
                                                             nesterov=bool(nesterov and momentum)), learning_rate)


def rmsprop(net: Network, learning_rate: float = 1e-2, alpha=0.99, eps=1e-8, momentum=0.0) -> Optimizer:
    return Optimizer(net, lambda params, lr: _RMSprop(params, lr, alpha, eps, momentum), learning_rate)


def adagrad(net: Network, learning_rate: float = 1e-2, lr_decay=0., weight_decay=0., eps=1e-10) -> Optimizer:
    return Optimizer(net, lambda params, lr: _Adagrad(params, lr, eps), learning_rate)


def set_learning_rate(optimizer: Optimizer, learning_rate: float):
    optimizer.rebuild(learning_rate)


def get_learning_rate(optimizer: Optimizer) -> float:
    return optimizer.learning_rate


def update_weights(net: Network, optimizer: Optimizer, loss_function: Callable, *loss_args, **loss_kwargs):
    """One optimization step: the gradient of the loss (its first output,
    summed) with respect to the network's parameters, then the optimizer's
    update. Returns what `loss_function` returned, detached."""
    from ..math._functional import _detached, _scalar_loss
    params = list(net.module.parameters())
    with torch.enable_grad():
        result = loss_function(*loss_args, **loss_kwargs)
        loss = result[0] if isinstance(result, tuple) else result
        grads = torch.autograd.grad(_scalar_loss(loss), params, allow_unused=True)
    optimizer.step(grads)
    return _detached(result)


def train(net: Network, optimizer: Optimizer, loss_function: Callable, data, epochs: int = 1,
          batch_size: int = None, callback: Callable = None):
    """An epoch loop over a list of data batches: one `update_weights` a batch."""
    losses = []
    for _ in range(epochs):
        for batch in data:
            args = batch if isinstance(batch, (tuple, list)) else (batch,)
            loss = update_weights(net, optimizer, loss_function, *args)
            losses.append(loss)
            if callback:
                callback(loss)
    return losses

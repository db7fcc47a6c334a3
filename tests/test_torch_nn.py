"""The port's `nn` (`phiflow_tpu_torch/nn`: networks on `torch.nn`, optax's
optimizers on `torch.optim`) against the JAX package's flax / optax one, on
the CPU: the analogues of `tests/test_nn.py`; each architecture, with JAX's
parameters carried across by `parameters_from_numpy`, gives JAX's output
within 1e-5 of its largest entry; one `update_weights` step of each
optimizer from the same parameters and data gives JAX's parameters within
1e-5; `load_state` reads a file of JAX's `save_state`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiflow_tpu import nn as jnn
import phiflow_tpu_torch.math as math
from phiflow_tpu_torch import nn
from phiflow_tpu_torch.field import CenteredGrid, Noise, native_call
from phiflow_tpu_torch.math import extrapolation

TOL = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with math.default_device('cpu'):
        yield


def _tree(net):
    return jax.tree_util.tree_map(np.asarray, net.params)


# --- the analogues of tests/test_nn.py ---

def test_dense_net_train():
    net = nn.dense_net(1, 1, [16, 16])
    opt = nn.adam(net, 1e-2)
    x = torch.linspace(-1, 1, 64)[:, None]
    y = x ** 2

    def loss():
        return ((net(x) - y) ** 2).sum()

    l0 = float(loss().detach())
    for _ in range(50):
        nn.update_weights(net, opt, loss)
    assert float(loss().detach()) < 0.5 * l0


def test_parameter_count_and_state_io(tmp_path):
    net = nn.dense_net(2, 3, [8])
    assert nn.parameter_count(net) == 2 * 8 + 8 + 8 * 3 + 3
    path = nn.save_state(net, str(tmp_path / 'weights'))
    before = [p.detach().clone() for p in net.module.parameters()]
    net.params = {k: v * 0 for k, v in net.params.items()}
    nn.load_state(net, path)
    assert all(torch.equal(a, b) for a, b in zip(before, net.module.parameters()))


def test_u_net_shapes():
    net = nn.u_net(2, 3, levels=3, filters=4, in_spatial=2)
    assert net(np.zeros((2, 32, 32, 2), np.float32)).shape == (2, 32, 32, 3)


def test_conv_and_res_net():
    x = np.zeros((1, 16, 16, 1), np.float32)
    assert nn.conv_net(1, 2, [8, 8])(x).shape == (1, 16, 16, 2)
    assert nn.res_net(1, 2, [8, 8])(x).shape == (1, 16, 16, 2)


def test_conv_classifier():
    net = nn.conv_classifier(1, (16, 16), num_classes=4, blocks=(8, 16))
    y = net(np.zeros((3, 16, 16, 1), np.float32))
    assert y.shape == (3, 4)
    assert torch.allclose(y.sum(-1), torch.ones(3), atol=1e-5)


def test_invertible_net():
    net = nn.invertible_net(num_blocks=2, in_channels=4)
    x = torch.randn(5, 4)
    assert torch.allclose(net.inverse(net(x)), x, atol=1e-4)


def test_native_call_with_field():
    net = nn.conv_net(1, 1, [4], in_spatial=2)
    grid = CenteredGrid(Noise(), extrapolation.PERIODIC, x=16, y=16)
    out = native_call(net, grid)
    assert out.shape.spatial.sizes == (16, 16)
    assert 'vector' in out.shape


def test_learning_rate():
    net = nn.dense_net(1, 1, [4])
    opt = nn.adam(net, 1e-3)
    assert nn.get_learning_rate(opt) == 1e-3
    nn.set_learning_rate(opt, 1e-4)
    assert nn.get_learning_rate(opt) == 1e-4
    assert opt.optimizer.param_groups[0]['lr'] == 1e-4


# --- against the JAX package ---

NETS = {
    'dense': (lambda m: m.dense_net(3, 2, [8, 8], activation='tanh'), (5, 3)),
    'conv-2d': (lambda m: m.conv_net(2, 3, [4, 4], in_spatial=2), (2, 12, 10, 2)),
    'conv-2d-periodic': (lambda m: m.conv_net(2, 3, [4, 4], in_spatial=2, periodic=True), (2, 12, 10, 2)),
    'conv-3d-groupnorm': (lambda m: m.conv_net(2, 3, [16], batch_norm=True, in_spatial=3), (1, 6, 8, 5, 2)),
    'conv-3d-periodic-gelu': (lambda m: m.conv_net(1, 2, [4], in_spatial=3, periodic=True, activation='gelu'),
                              (1, 6, 8, 5, 1)),
    'res': (lambda m: m.res_net(2, 3, [4, 4, 6], in_spatial=2), (2, 12, 10, 2)),
    'u-net-periodic': (lambda m: m.u_net(2, 3, levels=2, filters=[4, 6], in_spatial=2, periodic=True,
                                         activation='silu'), (2, 8, 12, 2)),
    'classifier': (lambda m: m.conv_classifier(1, (16, 12), num_classes=4, blocks=(4, 8)), (3, 16, 12, 1)),
    'invertible': (lambda m: m.invertible_net(num_blocks=3, in_channels=4, hidden=8), (5, 4)),
}


@pytest.mark.parametrize('name', list(NETS))
def test_network_with_jax_parameters_gives_jax_output(name):
    make, shape = NETS[name]
    jnet, net = make(jnn), make(nn)
    assert nn.parameter_count(net) == jnn.parameter_count(jnet)
    nn.parameters_from_numpy(net, _tree(jnet))
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    pairs = [(net(x), jnet(x))]
    if name == 'invertible':
        pairs.append((net.inverse(x), jnet.inverse(x)))
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert np.abs(got.detach().numpy() - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize('optimizer,kwargs', [
    ('adam', dict(learning_rate=1e-2)), ('sgd', dict(learning_rate=1e-2, momentum=0.9, nesterov=True)),
    ('rmsprop', dict(learning_rate=1e-2, momentum=0.5)), ('adagrad', dict(learning_rate=1e-1))],
    ids=['adam', 'sgd', 'rmsprop', 'adagrad'])
def test_update_weights_step_matches_optax(optimizer, kwargs):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 3)).astype(np.float32)
    y = rng.standard_normal((16, 2)).astype(np.float32)
    jnet, net = jnn.dense_net(3, 2, [8]), nn.dense_net(3, 2, [8])
    nn.parameters_from_numpy(net, _tree(jnet))
    jopt, opt = getattr(jnn, optimizer)(jnet, **kwargs), getattr(nn, optimizer)(net, **kwargs)
    jloss = jnn.update_weights(jnet, jopt, lambda: jnp.sum((jnet(x) - y) ** 2))
    loss = nn.update_weights(net, opt, lambda: ((net(x) - torch.from_numpy(y)) ** 2).sum())
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    ref = nn.parameters_from_numpy(nn.dense_net(3, 2, [8]), _tree(jnet))
    for got, want in zip(net.module.parameters(), ref.module.parameters()):
        assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


def test_load_state_reads_a_jax_file(tmp_path):
    jnet = jnn.conv_net(2, 3, [4, 8], batch_norm=True, in_spatial=2)
    path = jnn.save_state(jnet, str(tmp_path / 'jax_weights'))
    net = nn.load_state(nn.conv_net(2, 3, [4, 8], batch_norm=True, in_spatial=2), path)
    x = np.random.default_rng(3).standard_normal((1, 8, 8, 2)).astype(np.float32)
    ref = np.asarray(jnet(x))
    assert np.abs(net(x).detach().numpy() - ref).max() <= TOL * np.abs(ref).max()


def test_training_through_the_projection_lowers_the_loss():
    """A network's output projected by `make_incompressible` (implicit CG) in
    the loss: 5 Adam steps lower it."""
    from phiflow_tpu_torch.physics import fluid
    net = nn.conv_net(2, 2, [8], in_spatial=2)
    opt = nn.adam(net, 1e-2)
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.standard_normal((1, 16, 16, 2)).astype(np.float32))
    target = torch.tensor(rng.standard_normal((16, 16)).astype(np.float32))

    def loss():
        out = net(x)[0]
        v, p, _ = fluid.make_incompressible_native((out[:-1, :, 0], out[:, :-1, 1]), None, 1.0, rel_tol=1e-5,
                                                   abs_tol=0.)
        return ((p - target) ** 2).mean() + (v[0] ** 2).mean()

    losses = [float(nn.update_weights(net, opt, loss)) for _ in range(5)]
    assert losses[-1] < losses[0]

"""The port's functional layer (`math/_functional.py`: `gradient`,
`jacobian`, `custom_gradient`, `iterate`, `broadcast`; `stop_gradient`,
`native_call`, `l2_loss` / `l1_loss`) against the JAX package's on the same
numpy inputs, on the CPU, with the examples `gradient_descent.py` and
`optimize_throw.py` written against both. Tolerance 1e-6 relative to each
result's largest entry (float32 arithmetic in the same order up to XLA's
fusions)."""
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.field import CenteredGrid as JCenteredGrid
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.field import CenteredGrid, Field

TOL = 1e-6


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _np(x):
    if hasattr(x, 'values') and hasattr(x, 'geometry'):
        x = x.values
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    return np.asarray(x.numpy(x.shape.names) if hasattr(x, 'shape') and hasattr(x.shape, 'names') else x,
                      dtype=np.float64)


def _close(got, ref, tol=TOL):
    got, ref = _np(got), _np(ref)
    if isinstance(ref, list):
        for g, r in zip(got, ref):
            _close(g, r, tol)
        return
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * max(np.abs(ref).max(), 1.0), (got, ref)


def _inputs(m, seed=0):
    rng = np.random.default_rng(seed)
    x = m.tensor(rng.standard_normal((5, 3)).astype(np.float32), m.spatial('x'), m.channel(vector='a,b,c'))
    y = m.tensor(rng.standard_normal(5).astype(np.float32), m.spatial('x'))
    return x, y


def _f(m):
    def f(x, y, scale=2.0):
        loss = m.sum(m.sin(x) * y * scale + x ** 2, 'vector')
        return loss, m.mean(x)
    return f


@pytest.mark.parametrize('wrt', [0, 'y', [0, 1], 'x,y'], ids=['index', 'name', 'list', 'names'])
def test_gradient_by_index_name_and_list(wrt):
    """A batched loss (summed) with an aux output, `get_output` both ways."""
    jx, jy = _inputs(jm)
    x, y = _inputs(tm)
    ref = jm.gradient(_f(jm), wrt=wrt, get_output=True)(jx, jy, scale=3.0)
    got = tm.gradient(_f(tm), wrt=wrt, get_output=True)(x, y, scale=3.0)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close(g, r)
    only = tm.gradient(_f(tm), wrt=wrt, get_output=False)(x, y)
    ref_only = jm.gradient(_f(jm), wrt=wrt, get_output=False)(jx, jy)
    _close(only, ref_only)


def test_gradient_of_a_field_argument_and_a_host_constant():
    """A CenteredGrid argument comes back as a CenteredGrid of gradients; a
    host constant (`wrap(2.)`, a numpy native) is promoted to a torch leaf."""
    rng = np.random.default_rng(1)
    values = rng.standard_normal((6, 5)).astype(np.float32)

    def loss(m, grid_cls):
        def f(grid, c):
            return m.sum(grid.values ** 3 * c + c ** 2)
        return f

    jg = JCenteredGrid(jm.tensor(values, jm.spatial('x,y')), 0., x=6, y=5)
    g = CenteredGrid(tm.tensor(values, tm.spatial('x,y')), 0., x=6, y=5)
    ref = jm.gradient(loss(jm, JCenteredGrid), wrt=[0, 1], get_output=False)(jg, jm.wrap(2.))
    got = tm.gradient(loss(tm, CenteredGrid), wrt=[0, 1], get_output=False)(g, tm.wrap(2.))
    assert isinstance(got[0], Field) and got[0].geometry == g.geometry
    assert isinstance(got[1].native(), torch.Tensor)
    _close(got[0], ref[0])
    _close(got[1], ref[1])


def test_gradient_binds_arguments_by_name():
    """`jit_compile(gradient(f))` carries f's signature, so that keyword
    arguments bind (examples/differentiable_pressure.py calls it with v=...)."""
    jx, jy = _inputs(jm)
    x, y = _inputs(tm)
    fn = tm.jit_compile(tm.gradient(_f(tm), wrt='x', get_output=False))
    assert list(__import__('inspect').signature(fn).parameters) == ['x', 'y', 'scale']
    _close(fn(y=y, x=x), jm.jit_compile(jm.gradient(_f(jm), wrt='x', get_output=False))(y=jy, x=jx))


def test_jacobian_matches_jax():
    """Against `jax.jacobian` of the same function on arrays (the JAX
    package's `jacobian` of a Tensor function does not rebuild its output)."""
    import jax
    import jax.numpy as jnp
    a = np.random.default_rng(2).standard_normal(4).astype(np.float32)
    out, jac = tm.jacobian(lambda x: tm.sin(x) * x ** 2 + tm.sum(x, 'x'), get_output=True)(tm.tensor(a, tm.spatial('x')))
    ref = np.asarray(jax.jacobian(lambda x: jnp.sin(x) * x ** 2 + jnp.sum(x))(jnp.asarray(a)))
    _close(out, np.sin(a) * a ** 2 + a.sum())
    assert jac.shape.names == ('x', '~x')
    assert np.abs(jac.numpy(jac.shape.names) - ref).max() <= 1e-5 * np.abs(ref).max()


def test_custom_gradient_replaces_the_backward():
    """``gradient(x, dy) -> dx``: on this package's Tensors and on torch
    tensors; JAX's on its arrays (its Tensor pytrees do not pass its
    `custom_vjp`)."""
    import jax
    import jax.numpy as jnp

    def f(x):
        return x ** 2

    def grad(x, dy):
        return 3 * dy * x

    ref = np.asarray(jax.grad(lambda x: jnp.sum(jm.custom_gradient(f, grad)(x)))(jnp.float32([1., 2.])))
    g = tm.gradient(lambda x: tm.sum(tm.custom_gradient(f, grad)(x)), get_output=False)(
        tm.wrap(np.float32([1., 2.]), tm.spatial('x')))
    _close(g, ref)
    t = torch.tensor([1., 2.], requires_grad=True)
    tm.custom_gradient(f, grad)(t).sum().backward()
    _close(t.grad.numpy(), ref)


def test_iterate_with_int_batch_shape_measure_and_substeps():
    def step(x, v, dt=0.5):
        return x + dt * v, v * 0.9

    runs = {}
    for m in (jm, tm):
        x0, v0 = m.wrap(np.float32([0., 1.]), m.spatial('x')), m.wrap(np.float32([1., -1.]), m.spatial('x'))
        runs[m] = m.iterate(step, 3, x0, v0, dt=0.25), m.iterate(step, m.batch(time=3), x0, v0, substeps=2)
    for got, ref in zip(runs[tm], runs[jm]):
        _close(list(got), list(ref))
    assert runs[tm][1][0].shape.get_size('time') == 4
    timed = tm.iterate(step, 2, *runs[tm][0], measure=tm.perf_counter)
    assert timed[-1].shape.volume == 2 and timed[-1].numpy().min() >= 0


def test_gradient_descent_example():
    """examples/gradient_descent.py: 50 descent steps on cos(|x|) from one
    start, and batched from a grid of starts, the trajectories equal."""
    def run(m):
        pot_grad = m.gradient(lambda pos: m.cos(m.vec_length(pos)), 'pos', get_output=False)
        step = lambda x: x - .1 * pot_grad(x)
        single = m.iterate(step, m.batch(iter=50), m.vec(x=1., y=0.))
        starts = m.tensor(np.random.default_rng(3).uniform(-3, 3, (6, 2)).astype(np.float32), m.batch('b'),
                          m.channel(vector='x,y'))
        return single, m.iterate(step, m.batch(iter=50), starts)
    (single, batched), (j_single, j_batched) = run(tm), run(jm)
    _close(single, j_single, 1e-5)
    _close(batched, j_batched, 1e-5)


def test_optimize_throw_example():
    """examples/optimize_throw.py: 25 gradient-descent steps on the launch
    velocity through the analytic flight, the velocity a host constant."""
    def run(m):
        def simulate_hit(pos, height, vel, angle, gravity=1.):
            vel_x, vel_y = m.cos(angle) * vel, m.sin(angle) * vel
            height = m.maximum(height, .01)
            hit_time = (vel_y + m.sqrt(vel_y ** 2 + 2 * gravity * height)) / gravity
            return pos + vel_x * hit_time, hit_time, height, vel_x, vel_y

        def loss_function(pos, height, vel, angle, target):
            return m.l2_loss(simulate_hit(pos, height, vel, angle)[0] - target)

        grad_fun = m.gradient(loss_function, wrt='vel', get_output=False)

        def gradient_descent_step(vel, pos, height, angle, target, step_size=.1):
            return vel - step_size * grad_fun(pos, height, vel, angle, target)

        return m.iterate(gradient_descent_step, m.batch(iter=25), m.wrap(1.), target=10., pos=0., height=1.,
                         angle=0.)
    got, ref = run(tm), run(jm)
    _close(got, ref, 1e-5)
    assert abs(float(got.iter[-1]) * float(np.sqrt(2 / 1.)) - 10.) < 0.05


def test_stop_gradient_losses_and_broadcast():
    x, y = _inputs(tm)
    jx, jy = _inputs(jm)
    g = tm.gradient(lambda a: tm.sum(tm.stop_gradient(a) * a), get_output=False)(y)
    _close(g, jy)
    _close(tm.l2_loss(x), jm.l2_loss(jx))
    _close(tm.l1_loss(x), jm.l1_loss(jx))
    per_slice = tm.broadcast(lambda a: tm.sum(a ** 2))(tm.rename_dims(x, 'x', tm.batch('b')))
    _close(per_slice, jm.sum(jx ** 2, 'vector'))


def test_native_call_channels_last_and_first():
    x, _ = _inputs(tm)
    jx, _ = _inputs(jm)
    for last in (True, False):
        got = tm.native_call(lambda n: n * 2 + 1, x, channels_last=last)
        ref = jm.native_call(lambda n: n * 2 + 1, jx, channels_last=last)
        assert got.shape.names == ref.shape.names
        _close(got, ref)

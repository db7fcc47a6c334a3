"""`Burgers` and `Noise` of the port against the JAX package's, on the CPU.

`Noise`: the JAX package's white noise (its `ops.random_normal` patched in
the test to return numbers drawn here) fed to both filters, within 1e-6 of
the field's scale; the port's own draw has the standard deviation `scale` and
mean 0 (1e-5). `Burgers(32)`: 3 Field steps from JAX's `v0` as numpy,
explicit within 1e-5 of the field's scale, implicit within 1e-4 with CG
counts at most 1 apart; `step_native` bit-equal to the Field step; a seed
gives the same `v0` on every call. Also `diffuse.implicit`, `differential`
and `explicit` (orders 2 and 4) of a centred vector grid and
`advect.differential` (orders 2, 4, 6; a staggered grid at order 2) against
JAX."""
import jax
import numpy as np
import pytest
import torch

import phiflow_tpu.field as jf
import phiflow_tpu.math as jm
from phiflow_tpu.field import _noise as jnoise
from phiflow_tpu.geom import Box as JBox
from phiflow_tpu.math import SolveTape as JSolveTape
from phiflow_tpu.models import Burgers as JaxBurgers
from phiflow_tpu.physics import advect as jadvect, diffuse as jdiffuse

import phiflow_tpu_torch.field as tf
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.field import _noise as tnoise
from phiflow_tpu_torch.geom import Box
from phiflow_tpu_torch.models import Burgers
from phiflow_tpu_torch.models.burgers import state_from_numpy, state_to_numpy
from phiflow_tpu_torch.physics import advect, diffuse

NAMES = ('x', 'y')


@pytest.fixture(autouse=True, scope='module')
def _cpu():
    with tm.default_device('cpu'):
        yield


def _jax_components(field):
    return [np.asarray(field.values[{'vector': d}].native(NAMES)) for d in NAMES]


def _scaled_error(got, ref):
    return max(float(np.abs(g - r).max()) for g, r in zip(got, ref)) / max(float(np.abs(r).max()) for r in ref)


# ---------------------------------------------------------------------------
# Noise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('shape,smoothness', [((24, 16), 1.0), ((16, 16), 0.5)])
def test_noise_filter_matches_jax_on_the_same_white_noise(monkeypatch, shape, smoothness):
    """Both packages' spectral filters on one white noise: the JAX package's
    draw replaced by numbers from numpy, the port's by the same numbers."""
    draws = []
    rng = np.random.default_rng(11)

    def jax_draw(*shape_args, dtype=None):
        s = jm.concat_shapes(*shape_args)
        arr = rng.standard_normal(s.sizes).astype(np.float32)
        draws.append((s.names, arr))
        return jm.wrap(arr, s)
    monkeypatch.setattr(jnoise.ops, 'random_normal', jax_draw)
    used = []

    def port_draw(*shape_args, dtype=None):
        s = tm.concat_shapes(*shape_args)
        names, arr = draws[len(used)]
        used.append(names)
        assert s.names == names
        return tm.wrap(arr, s)
    monkeypatch.setattr(tnoise.ops, 'random_normal', port_draw)
    nx, ny = shape
    ref = jf.CenteredGrid(jf.Noise(vector='x,y', smoothness=smoothness), jm.extrapolation.PERIODIC,
                          bounds=JBox(x=nx, y=ny), x=nx, y=ny)
    got = tf.CenteredGrid(tf.Noise(vector='x,y', smoothness=smoothness), tm.extrapolation.PERIODIC,
                          bounds=Box(x=nx, y=ny), x=nx, y=ny)
    assert got.values.shape.names == ref.values.shape.names
    assert _scaled_error([got.values.numpy(NAMES + ('vector',))],
                         [np.asarray(ref.values.native(NAMES + ('vector',)))]) <= 1e-6
    jscalar = jf.CenteredGrid(jf.Noise(), 0., x=nx, y=ny)
    scalar = tf.CenteredGrid(tf.Noise(), 0., x=nx, y=ny)
    assert len(used) == len(draws) == 4
    assert _scaled_error([scalar.values.numpy(NAMES)], [np.asarray(jscalar.values.native(NAMES))]) <= 1e-6


def test_noise_own_draw_has_scale_and_zero_mean():
    tm.seed(3)
    g = tf.CenteredGrid(tf.Noise(vector='x,y', scale=2.5), tm.extrapolation.PERIODIC, x=32, y=24)
    arr = g.values.numpy(NAMES + ('vector',))
    np.testing.assert_allclose(arr.std(axis=(0, 1)), [2.5, 2.5], rtol=1e-5)
    np.testing.assert_allclose(arr.mean(axis=(0, 1)), [0., 0.], atol=1e-5 * 2.5)
    tm.seed(3)
    again = tf.CenteredGrid(tf.Noise(vector='x,y', scale=2.5), tm.extrapolation.PERIODIC, x=32, y=24)
    assert np.array_equal(again.values.numpy(NAMES + ('vector',)), arr)


def test_burgers_seed_gives_one_initial_state():
    a = state_to_numpy(Burgers(16, device='cpu', seed=4).initial_state_native())
    tm.random_normal(tm.spatial(x=3))  # the global draws do not move a model's own
    b = state_to_numpy(Burgers(16, device='cpu', seed=4).initial_state_native())
    c = state_to_numpy(Burgers(16, device='cpu', seed=5).initial_state_native())
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    np.testing.assert_allclose([x.std() for x in a], [20., 20.], rtol=1e-5)


# ---------------------------------------------------------------------------
# Burgers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('implicit', [False, True], ids=['explicit', 'implicit'])
def test_burgers_field_steps_match_jax(implicit):
    """Burgers(32) from JAX's v0, 3 steps: explicit within 1e-5 of the
    field's scale, implicit within 1e-4 with CG counts at most 1 apart. The
    displacements reach about 25 cells: the ±2 clamp acts all over the grid."""
    jm_ = JaxBurgers(32, implicit=implicit)
    (jv,) = jm_.initial_state()
    model = Burgers(32, implicit=implicit, device='cpu')
    (v,) = model.state_fields(state_from_numpy(_jax_components(jv), device='cpu'))
    assert v.boundary == model.v0.boundary
    assert float(np.abs(_jax_components(jv)[0]).max()) * model.dt > 2  # the clamp is reached
    jstep = jm_.step if implicit else jax.jit(jm_.step)  # eager: the solve's runtime count every step
    for _ in range(3):
        with JSolveTape(record_runtime=True) as jtape:
            (jv,) = jstep(jv)
            jax.block_until_ready(jv.values.native())
        with tm.SolveTape() as tape:
            (v,) = model.step(v)
        assert _scaled_error([c.numpy() for c in model.state_natives(v)], _jax_components(jv)) \
            <= (1e-4 if implicit else 1e-5)
        if implicit:
            assert len(tape) == 1 and tape[0].converged
            assert abs(tape[0].iterations - jtape.solve_infos[-1].runtime_stats['iterations']) <= 1


@pytest.mark.parametrize('implicit', [False, True], ids=['explicit', 'implicit'])
def test_burgers_native_step_equals_field_step(implicit):
    model = Burgers(24, implicit=implicit, device='cpu', seed=2)
    (v,) = model.initial_state()
    native = model.initial_state_native()
    for _ in range(2):
        with tm.SolveTape() as tape:
            (v,) = model.step(v)
        native = model.step_native(native)
        for a, b in zip(model.state_natives(v), native):
            assert torch.equal(a, b)
        if implicit:
            assert tape[0].iterations == model.last_solve.iterations


def test_implicit_diffusion_matches_jax():
    """`diffuse.implicit` of a periodic centred vector grid: one CG over both
    components (one residual norm), within 1e-5 of the field's scale."""
    arr = np.random.default_rng(12).standard_normal((20, 16, 2)).astype(np.float32)
    shape, jshape = tm.spatial('x,y') & tm.channel(vector='x,y'), jm.spatial('x,y') & jm.channel(vector='x,y')
    g = tf.CenteredGrid(tm.wrap(torch.from_numpy(arr.copy()), shape), tm.extrapolation.PERIODIC, x=20, y=16)
    jg = jf.CenteredGrid(jm.wrap(arr, jshape), jm.extrapolation.PERIODIC, x=20, y=16)
    got = diffuse.implicit(g, 0.4, 0.5, tm.Solve('CG', 1e-6, 1e-6))
    ref = jdiffuse.implicit(jg, 0.4, 0.5, jm.Solve('CG', 1e-6, 1e-6))
    order = NAMES + ('vector',)
    assert _scaled_error([got.values.numpy(order)], [np.asarray(ref.values.native(order))]) <= 1e-5
    for o in (2, 4):
        assert _scaled_error([diffuse.differential(g, 0.3, order=o).values.numpy(order)],
                             [np.asarray(jdiffuse.differential(jg, 0.3, order=o).values.native(order))]) <= 1e-5
        assert _scaled_error([diffuse.explicit(g, 0.05, 0.5, order=o).values.numpy(order)],
                             [np.asarray(jdiffuse.explicit(jg, 0.05, 0.5, order=o).values.native(order))]) <= 1e-5


@pytest.mark.parametrize('order', [2, 4, 6])
def test_advection_differential_matches_jax(order):
    """−(v·∇)v of a periodic centred vector grid, and −(v·∇)u of a closed
    box's staggered grid at order 2."""
    arr = np.random.default_rng(13).standard_normal((16, 20, 2)).astype(np.float32)
    shape, jshape = tm.spatial('x,y') & tm.channel(vector='x,y'), jm.spatial('x,y') & jm.channel(vector='x,y')
    g = tf.CenteredGrid(tm.wrap(torch.from_numpy(arr.copy()), shape), tm.extrapolation.PERIODIC, x=16, y=20,
                        bounds=Box(x=2., y=3.))
    jg = jf.CenteredGrid(jm.wrap(arr, jshape), jm.extrapolation.PERIODIC, x=16, y=20, bounds=JBox(x=2., y=3.))
    order_names = NAMES + ('vector',)
    got = advect.differential(g, g, order=order).values.numpy(order_names)
    ref = np.asarray(jadvect.differential(jg, jg, order=order).values.native(order_names))
    assert _scaled_error([got], [ref]) <= 1e-5
    if order == 2:
        comps = [np.random.default_rng(14 + i).standard_normal(s).astype(np.float32)
                 for i, s in enumerate(((15, 20), (16, 19)))]
        v = tf.StaggeredGrid(tm.stack([tm.wrap(torch.from_numpy(c.copy()), tm.spatial('x,y')) for c in comps],
                                      tm.dual(vector='x,y')), 0., x=16, y=20)
        jv = jf.StaggeredGrid(jm.stack([jm.wrap(c, jm.spatial('x,y')) for c in comps], jm.dual(vector='x,y')), 0.,
                              x=16, y=20)
        sg, jsg = advect.differential(v, v), jadvect.differential(jv, jv)
        assert _scaled_error([sg.vector[d].values.numpy(NAMES) for d in NAMES],
                             [np.asarray(jsg.vector[d].values.native(NAMES)) for d in NAMES]) <= 1e-5

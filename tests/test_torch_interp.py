"""The port's window interpolation (K6 `window_interp_3d`, K7
`window_interp_2d`, `math/_nd.py::shift_window_interp`) against the JAX
package: its Pallas kernels in interpret mode and its `fori_loop` route. The
port runs on the CPU, where its wrappers take the plain PyTorch twin.

Tolerances: 2e-4 on interpolated values (the JAX suite's own for these
kernels: the two sides sum the window in different orders); lo / up are
selections of grid values and must be equal exactly."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phiflow_tpu.ops import interp as JI
from phiflow_tpu_torch.ops import interp as TI

VALUE_TOL = 2e-4


def _inputs(shape, K, seed, padded=True, spread=1.0):
    rng = np.random.default_rng(seed)
    d = len(shape)
    grid_shape = tuple(n + 2 * K for n in shape) if padded else shape
    grid = rng.standard_normal(grid_shape).astype(np.float32)
    disp = (spread * rng.uniform(-K - 0.5, K + 0.5, (d,) + shape)).astype(np.float32)  # beyond ±K: the clamp
    return grid, disp


def _check(got, ref, extrema):
    if not extrema:
        got, ref = (got,), (ref,)
    assert float(np.abs(got[0].numpy() - np.asarray(ref[0])).max()) < VALUE_TOL
    for g, r in zip(got[1:], ref[1:]):
        assert np.array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize('K', [1, 2])
@pytest.mark.parametrize('extrema,negate,scale', [(False, False, None), (True, False, None),
                                                  (True, True, (0.5, -1.5, 2.0)), (False, True, (1.0, 0.3, 0.7))],
                         ids=['plain', 'extrema', 'extrema-negate-scale', 'negate-scale'])
def test_window_interp_3d_matches_pallas(K, extrema, negate, scale):
    grid, disp = _inputs((16, 16, 16), K, seed=K)
    ref = JI.window_interp_3d(jnp.asarray(grid), jnp.asarray(disp), K, compute_extrema=extrema, negate=negate,
                              disp_scale=scale, interpret=True)
    got = TI.window_interp_3d(torch.from_numpy(grid), torch.from_numpy(disp), K, compute_extrema=extrema,
                              negate=negate, disp_scale=scale)
    _check(got, ref, extrema)


@pytest.mark.parametrize('K', [1, 2])
@pytest.mark.parametrize('extrema', [False, True])
def test_window_interp_3d_const_pad_matches_pallas(K, extrema):
    """The raw grid with a constant halo; displacements as a sequence."""
    grid, disp = _inputs((16, 16, 128), K, seed=10 + K, padded=False)
    ref = JI.window_interp_3d(jnp.asarray(grid), [jnp.asarray(d) for d in disp], K, compute_extrema=extrema,
                              const_pad=0.25, disp_scale=(1.0, -1.0, 0.5), interpret=True)
    got = TI.window_interp_3d(torch.from_numpy(grid), [torch.from_numpy(d) for d in disp], K,
                              compute_extrema=extrema, const_pad=0.25, disp_scale=(1.0, -1.0, 0.5))
    _check(got, ref, extrema)


@pytest.mark.parametrize('K', [1, 2])
@pytest.mark.parametrize('extrema,negate,scale', [(False, False, None), (True, False, None),
                                                  (True, True, (0.5, -1.5)), (False, True, (1.0, 0.3))],
                         ids=['plain', 'extrema', 'extrema-negate-scale', 'negate-scale'])
def test_window_interp_2d_matches_pallas(K, extrema, negate, scale):
    grid, disp = _inputs((16, 24), K, seed=20 + K)
    ref = JI.window_interp_2d(jnp.asarray(grid), jnp.asarray(disp), K, compute_extrema=extrema, negate=negate,
                              disp_scale=scale, interpret=True)
    got = TI.window_interp_2d(torch.from_numpy(grid), torch.from_numpy(disp), K, compute_extrema=extrema,
                              negate=negate, disp_scale=scale)
    _check(got, ref, extrema)


@pytest.mark.parametrize('d', [2, 3])
def test_integer_displacements_count_one_corner(d):
    """Displacements of exactly 0 and ±K (a state at rest; the clamp): the
    upper tap has weight 0 and is no corner, so lo = up = the one grid value,
    equal to the JAX kernel's exactly."""
    K = 2
    shape = (16, 24) if d == 2 else (16, 16, 16)
    rng = np.random.default_rng(30 + d)
    grid = rng.standard_normal(tuple(n + 2 * K for n in shape)).astype(np.float32)
    disp = rng.choice(np.array([-K, 0, K], np.float32), (d,) + shape)
    jfn, tfn = (JI.window_interp_2d, TI.window_interp_2d) if d == 2 else (JI.window_interp_3d, TI.window_interp_3d)
    ref = jfn(jnp.asarray(grid), jnp.asarray(disp), K, compute_extrema=True, interpret=True)
    got = tfn(torch.from_numpy(grid), torch.from_numpy(disp), K, compute_extrema=True)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert np.array_equal(got[1].numpy(), got[2].numpy())
    assert np.array_equal(got[0].numpy(), got[1].numpy())


@pytest.mark.parametrize('extrap', ['zero', 'boundary', 'periodic'])
@pytest.mark.parametrize('shape', [(12, 20), (10, 12, 20)], ids=['2d', '3d'])
def test_shift_window_interp_matches_fori_loop(shape, extrap):
    """The three extrapolations through `shift_window_interp` against JAX's
    `fori_loop` route (its CPU route), at a size that is no power of two; the
    displacements include exact integers."""
    from phiflow_tpu import math as jmath
    from phiflow_tpu.math import extrapolation
    from phiflow_tpu.math._nd import shift_window_interp as jax_swi
    from phiflow_tpu_torch.math import BOUNDARY, PERIODIC, shift_window_interp
    K = 2
    d = len(shape)
    names = 'xyz'[:d]
    grid, disp = _inputs(shape, K, seed=40 + d, padded=False)
    disp[:, ::3] = np.round(disp[:, ::3])
    jext, text = {'zero': (extrapolation.ZERO, 0.0), 'boundary': (extrapolation.BOUNDARY, BOUNDARY),
                  'periodic': (extrapolation.PERIODIC, PERIODIC)}[extrap]
    jgrid = jmath.Tensor(jnp.asarray(grid), jmath.spatial(**dict(zip(names, shape))))
    scale = (0.8, -1.1, 0.6)[:d]
    ref = jax_swi(jgrid, [jnp.asarray(a) for a in disp], jext, K, compute_extrema=True, negate=True,
                  disp_scale=scale)
    got = shift_window_interp(torch.from_numpy(grid), [torch.from_numpy(a) for a in disp], text, K,
                              compute_extrema=True, negate=True, disp_scale=scale)
    _check(got, [r.native(tuple(names)) for r in ref], True)


def test_refuses_batch_axes_and_bad_input():
    from phiflow_tpu_torch.math import shift_window_interp
    grid = torch.zeros(2, 8, 8)
    disp = [torch.zeros(8, 8)] * 2
    with pytest.raises(NotImplementedError, match='slice'):
        shift_window_interp(grid, disp, 0.0, 1)
    with pytest.raises(NotImplementedError, match='slice'):
        TI.window_interp_2d(grid, disp, 1, const_pad=0.0)
    with pytest.raises(ValueError, match='shape'):
        TI.window_interp_2d(torch.zeros(9, 10), disp, 1)  # neither padded nor raw
    with pytest.raises(ValueError, match='not both'):
        TI.window_interp_2d(torch.zeros(8, 8), disp, 1, const_pad=0.0, halo='edge')
    with pytest.raises(ValueError, match='extrapolation'):
        shift_window_interp(torch.zeros(8, 8), disp, 'reflect', 1)

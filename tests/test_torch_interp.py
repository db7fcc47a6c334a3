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
    """Leading batch axes are taken (a displacement without them is shared
    by every entry); batch axes that do not broadcast, and bad input, raise."""
    from phiflow_tpu_torch.math import shift_window_interp
    gen = torch.Generator().manual_seed(0)
    grid = torch.rand(2, 8, 8, generator=gen)
    disp = [torch.rand(8, 8, generator=gen) - 0.5] * 2
    out = shift_window_interp(grid, disp, 0.0, 1)
    assert out.shape == (2, 8, 8)
    assert all(torch.equal(out[e], shift_window_interp(grid[e], disp, 0.0, 1)) for e in range(2))
    with pytest.raises(ValueError, match='broadcast'):
        TI.window_interp_2d(grid, [torch.zeros(3, 8, 8)] * 2, 1, const_pad=0.0)
    with pytest.raises(ValueError, match='shape'):
        TI.window_interp_2d(torch.zeros(9, 10), disp, 1)  # neither padded nor raw
    with pytest.raises(ValueError, match='not both'):
        TI.window_interp_2d(torch.zeros(8, 8), disp, 1, const_pad=0.0, halo='edge')
    with pytest.raises(ValueError, match='extrapolation'):
        shift_window_interp(torch.zeros(8, 8), disp, 'mirror', 1)
    # a mirror rule is taken since the open-boundary slice: the grid padded by it, the kernel's padded route
    from phiflow_tpu_torch.math import _nd
    padded = _nd.pad(_nd.pad(grid[0], -2, 1, 1, 'reflect'), -1, 1, 1, 'reflect')
    assert torch.equal(shift_window_interp(grid[0], disp, 'reflect', 1), TI.window_interp_2d(padded, disp, 1))


# ---------------------------------------------------------------------------
# K6 / K7 on the card: the float4 route and the blocks that skip the halo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('out_shape,offset,expected', [
    ((12, 24, 264), 0, True), ((256, 256, 256), 0, True), ((12, 24, 262), 0, False), ((256, 256, 255), 0, False),
    ((12, 24, 264), 1, False), ((4096, 4096), 0, True), ((37, 45), 0, False), ((16, 24), 2, False)],
    ids=['3d-rows-264', '3d-256', '3d-rows-262', '3d-z-face', '3d-misaligned', '2d-4096', '2d-rows-45',
         '2d-misaligned'])
def test_vector_route(out_shape, offset, expected):
    """float4 loads and stores exactly where every row holds a multiple of 4
    outputs and every array starts on a 16-byte boundary (a closed box's z
    face component, 255 cells a row, takes the scalar route)."""
    storage = torch.zeros(64 + offset)
    aligned = storage[:4]
    shifted = storage[offset:offset + 4]
    assert shifted.data_ptr() % 16 == (4 * offset) % 16
    assert TI.vector_route(out_shape, (aligned, shifted, aligned)) is expected


WI_TX, WI_TY = 128, 8  # csrc/interp.cu: a warp's 128 outputs of a row, four a lane; a block's rows, one a warp


@pytest.mark.parametrize('layout', ['padded', 'raw'])
@pytest.mark.parametrize('K', [1, 2, 3])
@pytest.mark.parametrize('out_shape', [(12, 24, 262), (12, 24, 264), (40, 300), (40, 45)],
                         ids=['3d-262', '3d-264', '2d-300', '2d-45'])
def test_window_blocks_cover_and_interior_taps_lie_inside(out_shape, K, layout):
    """The kernel's blocks (csrc/interp.cu::window_interp_kernel): a block of
    WI_TY rows × WI_TX outputs (× one plane in 3D) covers every output once,
    four a lane; a block that the kernel takes for interior addresses its
    corners directly, so every tap any of its outputs can reach — o − K − 1
    … o + K + 1 along each axis after the clip, the zero-weight upper tap of
    δ = +K included — must lie inside the raw grid. Both layouts; the 3D rows
    of 262 and 264 hold interior and border blocks."""
    D = len(out_shape)
    shift = [-K if layout == 'padded' else 0] * D
    n = [o + 2 * K if layout == 'padded' else o for o in out_shape]
    grid = [-(-out_shape[-1] // WI_TX), -(-out_shape[-2] // WI_TY)] + ([out_shape[0]] if D == 3 else [])
    covered = np.zeros(out_shape, np.int32)
    interiors = 0
    for bz in range(grid[2] if D == 3 else 1):
        for by in range(grid[1]):
            for bx in range(grid[0]):
                r0, c0 = by * WI_TY, bx * WI_TX
                interior = (r0 - K - shift[-2] >= 0 and r0 + WI_TY + K - shift[-2] < n[-2]
                            and c0 - K - shift[-1] >= 0 and c0 + WI_TX + K - shift[-1] < n[-1])
                if D == 3:
                    interior = interior and bz - K - shift[0] >= 0 and bz + 1 + K - shift[0] < n[0]
                rows = range(r0, min(r0 + WI_TY, out_shape[-2]))
                cols = range(c0, min(c0 + WI_TX, out_shape[-1]))
                lead = (bz,) if D == 3 else ()
                for r in rows:
                    covered[lead + (r, slice(cols.start, cols.stop))] += 1
                if interior and len(rows) and len(cols):
                    interiors += 1
                    firsts = lead + (rows[0], cols[0])
                    lasts = lead + (rows[-1], cols[-1])
                    for e in range(D):
                        assert firsts[e] - K - shift[e] >= 0  # floor(δ) ≥ −K
                        assert lasts[e] + K + 1 - shift[e] < n[e]  # the upper tap of δ = +K
    assert (covered == 1).all()
    if out_shape[-1] > 2 * WI_TX:
        assert interiors > 0

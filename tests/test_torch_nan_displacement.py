"""A NaN displacement in the port's window interpolation (K6 / K7 and their
backward K6ᵀ / K7ᵀ, `ops/interp.py`; on the CPU their twins) against the JAX
package's window sum (`phiflow_tpu/math/_nd.py::shift_window_interp`, its
`fori_loop` route) and `jax.grad` of it, and the fused advection's twin (K5,
`ops/advect3d.py`) at a NaN velocity against JAX's `SmokePlume._fused_advect`
in interpret mode.

JAX's rule: `jnp.clip` keeps NaN, so every tent weight of the output is NaN
and so is the output; the extrema's corner test fails everywhere, so lo / up
keep ±3.4e38. Its gradient puts NaN into d_grid at each of the output's
(2K + 1)^D taps (folded back through the pad: onto an edge cell, a wrapped
cell, or dropped past a constant halo), and into d_disp on each finite axis;
a NaN axis gets 0 unless another axis is NaN too. Without a cotangent of the
output itself (lo / up only) nothing is NaN and d_disp is 0.

The port must show the same NaN pattern in every result, equal values
elsewhere (1e-5 of each result's largest finite entry: the two sum taps in
different orders), and d_disp exactly 0 on the NaN axis of an output with a
single NaN axis."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiflow_tpu.math as jm
from phiflow_tpu.math import _nd as jnd, extrapolation as jext
from phiflow_tpu_torch.ops import interp as TI

TOL = 1e-5
HALOS = {'const': (lambda: jext.ConstantExtrapolation(0.25), dict(const_pad=0.25)),
         'edge': (lambda: jext.BOUNDARY, dict(halo='edge')),
         'wrap': (lambda: jext.PERIODIC, dict(halo='wrap'))}


def _same(got, ref, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert (np.isnan(got) == np.isnan(ref)).all(), f'{what}: NaN patterns differ'
    got, ref = np.nan_to_num(got), np.nan_to_num(ref)
    assert np.abs(got - ref).max() <= TOL * max(np.abs(ref).max(), 1e-6), (what, np.abs(got - ref).max())


def _jax_side(grid, disps, K, scale, halos, weights, extrema):
    """JAX's forward results and `jax.grad` of Σ weights · results for each
    halo form, traced in one jit: ([results per form], [d_grid, d_disp...])."""
    d = grid.ndim
    names = tuple('xyz'[:d])
    shape = jm.spatial(**{n: s for n, s in zip(names, grid.shape)})

    def f(g, *ds):
        total, outs = 0., []
        for halo, ws in zip(halos, weights):
            r = jnd.shift_window_interp(jm.Tensor(g, shape), list(ds), HALOS[halo][0](), K,
                                        compute_extrema=extrema, disp_scale=scale)
            r = [x.native(names) for x in (r if extrema else (r,))]
            outs.append(r)
            total = total + sum(jnp.sum(x * w) for x, w in zip(r, ws) if w is not None)
        return total, outs
    grads, outs = jax.jit(jax.grad(f, argnums=tuple(range(1 + d)), has_aux=True))(
        jnp.asarray(grid), *[jnp.asarray(x) for x in disps])
    return [[np.asarray(x) for x in o] for o in outs], [np.asarray(g) for g in grads]


def _port_side(grid, disps, K, scale, halos, weights, extrema):
    d = grid.ndim
    g = torch.tensor(grid, requires_grad=True)
    ds = [torch.tensor(x, requires_grad=True) for x in disps]
    fn = TI.window_interp_3d if d == 3 else TI.window_interp_2d
    total, outs = 0., []
    for halo, ws in zip(halos, weights):
        r = fn(g, ds, K, compute_extrema=extrema, disp_scale=scale, **HALOS[halo][1])
        r = list(r if extrema else (r,))
        outs.append([x.detach().numpy() for x in r])
        total = total + sum((x * torch.tensor(w)).sum() for x, w in zip(r, ws) if w is not None)
    total.backward()
    return outs, [g.grad.numpy()] + [x.grad.numpy() for x in ds]


def _compare(jax_side, port_side, lone=None):
    (j_outs, j_grads), (t_outs, t_grads) = jax_side, port_side
    for f, (jo, to) in enumerate(zip(j_outs, t_outs)):
        for i, (a, b) in enumerate(zip(to, jo)):
            _same(a, b, f'form {f} result {i}')
    for i, (a, b) in enumerate(zip(t_grads, j_grads)):
        _same(a, b, 'd_grid' if i == 0 else f'd_disp[{i - 1}]')
    if lone is not None:  # the NaN axis of an output with one NaN axis: exactly 0, as in JAX
        mask, axis = lone
        assert (t_grads[1 + axis][mask] == 0).all() and (j_grads[1 + axis][mask] == 0).all()


def test_fault_inputs_match_jax():
    """The fault's own inputs: K = 1, a 6 × 7 grid of `default_rng(0)`, the
    x and y displacements of the same generator's `random() − 0.5`, y at
    (2, 3) NaN, upstream gradient 1; a zero constant halo (the fault's) and
    the edge and wrap halos."""
    rng = np.random.default_rng(0)
    grid = rng.standard_normal((6, 7)).astype(np.float32)
    dx = (rng.random((6, 7)) - 0.5).astype(np.float32)
    dy = (rng.random((6, 7)) - 0.5).astype(np.float32)
    dy[2, 3] = np.nan
    ones = [np.ones((6, 7), np.float32)]
    halos = ('const', 'edge', 'wrap')
    jax_side = _jax_side(grid, [dx, dy], 1, (1.0, 1.0), halos, [ones] * 3, False)
    port_side = _port_side(grid, [dx, dy], 1, (1.0, 1.0), halos, [ones] * 3, False)
    _compare(jax_side, port_side)
    d_grid, d_dx, d_dy = port_side[1]
    assert d_dy[2, 3] == 0 and np.isnan(d_dx[2, 3])
    assert np.isnan(d_grid).sum() == 9 and np.isnan(d_grid[1:4, 2:5]).all()
    assert np.isnan(port_side[0][0][0][2, 3]) and np.isfinite(np.delete(port_side[0][0][0].ravel(), 2 * 7 + 3)).all()


def _nan_case(d, K, seed, shape):
    """A grid, displacements with fractional, integer and clipped values, a
    tenth of the outputs NaN on the last axis alone and a twentieth on every
    axis; returns (grid, disps, scale, the lone-NaN outputs)."""
    rng = np.random.default_rng(seed)
    scale = (0.8, -1.1, 0.6)[:d]
    grid = rng.standard_normal(shape).astype(np.float32)
    disps = []
    for a in range(d):
        cells = np.where(rng.random(shape) < 0.2, rng.integers(-K - 1, K + 2, shape), rng.uniform(-K - 1, K + 1, shape))
        disps.append((cells / scale[a]).astype(np.float32))
    lone = rng.random(shape) < 0.1
    every = rng.random(shape) < 0.05
    disps = [np.where(every | (lone if a == d - 1 else False), np.float32(np.nan), x) for a, x in enumerate(disps)]
    return grid, disps, scale, lone & ~every


@pytest.mark.parametrize('K', [1, 2])
@pytest.mark.parametrize('d', [2, 3])
def test_nan_displacements_match_jax(d, K):
    """Forward, lo / up, d_grid and d_disp at NaN displacements, every halo
    form with the extrema (value, lo and up weighted), in one `jax.grad`."""
    shape = (7, 9, 6)[:d] if d == 3 else (9, 11)
    grid, disps, scale, lone = _nan_case(d, K, 40 + 10 * d + K, shape)
    rng = np.random.default_rng(d * K)
    halos = tuple(HALOS)
    weights = [[rng.standard_normal(shape).astype(np.float32) for _ in range(3)] for _ in halos]
    jax_side = _jax_side(grid, disps, K, scale, halos, weights, True)
    port_side = _port_side(grid, disps, K, scale, halos, weights, True)
    _compare(jax_side, port_side, (lone, d - 1))
    big = np.float32(3.4e38)
    nan_out = np.isnan(disps[d - 1])
    for value, lo, up in port_side[0]:
        assert np.isnan(value[nan_out]).all() and (lo[nan_out] == big).all() and (up[nan_out] == -big).all()


@pytest.mark.parametrize('d', [2, 3])
def test_nan_displacements_without_the_outputs_cotangent(d):
    """lo / up weighted, the output itself not: no NaN in any gradient, and
    d_disp 0 at the NaN outputs, as `jax.grad` gives."""
    shape = (5, 6, 7)[:d] if d == 3 else (8, 9)
    grid, disps, scale, _ = _nan_case(d, 1, 70 + d, shape)
    rng = np.random.default_rng(5)
    weights = [[None, rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)]]
    jax_side = _jax_side(grid, disps, 1, scale, ('edge',), weights, True)
    port_side = _port_side(grid, disps, 1, scale, ('edge',), weights, True)
    _compare(jax_side, port_side)
    assert all(np.isfinite(g).all() for g in port_side[1])


def test_fused_advect_twin_at_nan_velocities_matches_jax():
    """K5's twin (`SmokePlume._fused_advect_native`: the three fused calls of
    a closed-box step) with NaN on a few velocity faces against JAX's
    `SmokePlume._fused_advect` in interpret mode: the same NaN pattern in the
    smoke and each velocity component, equal elsewhere within 2e-5."""
    import test_torch_transfer_advect as TA
    from phiflow_tpu.models import SmokePlume as JaxSmoke
    from phiflow_tpu_torch.models import SmokePlume
    N = 16
    rng = np.random.default_rng(12)
    vel = [rng.uniform(-1.9, 1.9, s).astype(np.float32) for s in ((N - 1, N, N), (N, N - 1, N), (N, N, N - 1))]
    for v in vel:
        v[tuple(rng.integers(0, n) for n in v.shape)] = np.nan
    smoke = rng.uniform(0., 1., (N, N, N)).astype(np.float32)
    model = SmokePlume(resolution=N, dims=3, device='cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the inflow ball's sqrt in one thread (ROADMAP §3, a flaky first call)
    try:
        tv, ts = model._fused_advect_native(tuple(torch.from_numpy(a) for a in vel), torch.from_numpy(smoke))
    finally:
        torch.set_num_threads(threads)
    jax_model = JaxSmoke(resolution=N, dims=3)
    jv, js = jax_model._fused_advect(*TA._jax_state(jax_model, *vel, smoke), interpret=True)
    ref = np.asarray(js.values.native(TA.ORDER))
    assert np.isnan(ref).any()
    _same_abs(ts.numpy(), ref, 'smoke')
    for d, dim in enumerate(TA.ORDER):
        _same_abs(tv[d].numpy(), np.asarray(jv.vector[dim].values.native(TA.ORDER)), dim)


def _same_abs(got, ref, what, tol=2e-5):
    assert got.shape == ref.shape, what
    assert (np.isnan(got) == np.isnan(ref)).all(), f'{what}: NaN patterns differ'
    assert np.abs(np.nan_to_num(got) - np.nan_to_num(ref)).max() < tol, what


def test_grid_nan_reaches_fewer_outputs_in_the_kernels():
    """Fault 3.13's own inputs (the 6 × 7 grid of `default_rng(0)`, x and y
    displacements of the same generator's `random() − 0.5`, the grid NaN at
    (2, 3), a constant halo of 0.25). Before the repair the kernels' corner
    gather reached 3 of the 9 outputs JAX makes NaN. The repaired kernels
    (`_repaired_kernels`) give JAX's NaN pattern in the value (the 9 outputs),
    lo and up, and in d_disp, and agree elsewhere within 1e-5."""
    rng = np.random.default_rng(0)
    grid = rng.standard_normal((6, 7)).astype(np.float32)
    disps = [(rng.random((6, 7)) - 0.5).astype(np.float32) for _ in range(2)]
    grid[2, 3] = np.nan
    g_out = np.random.default_rng(4).standard_normal((6, 7)).astype(np.float32)
    ws = [g_out, np.ones((6, 7), np.float32), np.ones((6, 7), np.float32)]
    (ref,), ref_grads = _jax_side(grid, disps, 1, (1.0, 1.0), ('const',), [ws], True)
    from test_torch_grid_nonfinite import _repaired_kernels
    val, lo, up, dd = _repaired_kernels(grid, disps, 1, np.float32(0.25), g_out)
    assert np.isnan(ref[0]).sum() == 9
    _same(val, ref[0], 'value')
    _same(lo, ref[1], 'lo')
    _same(up, ref[2], 'up')
    for a in range(2):  # the fix kernel's outputs: the 9 whose window holds the NaN
        hit = np.isnan(ref[0])
        assert (np.isnan(dd[a][hit]) == np.isnan(ref_grads[1 + a][hit])).all() and np.isnan(dd[a][hit]).all()

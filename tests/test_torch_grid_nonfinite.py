"""A NaN or an infinity in the *grid* of the port's window interpolation (K6 /
K7 and their backward K6ᵀ / K7ᵀ, `ops/interp.py`; on the CPU their twins)
against the JAX package's window sum (`phiflow_tpu/math/_nd.py::
shift_window_interp`, its `fori_loop` route) and `jax.grad` of it, and the
fused advection's twin (K5, `ops/advect3d.py`) at a non-finite smoke against
JAX's `SmokePlume._fused_advect` in interpret mode.

JAX's rule: the window sum multiplies every one of the (2K + 1)^D taps by its
tent weight, so a NaN anywhere in the window, or an infinity at a tap of
weight 0, makes the output NaN, and weighted infinities sum to ±inf or NaN.
lo / up take NaN from a NaN corner with weight (`jnp.minimum` /
`jnp.maximum`). Under `jax.grad`, d_disp of an output whose window holds such
a value is NaN or ±inf on every axis (AD multiplies g · value by the tent's
slope, 0 past its kink), 0 without the output's own cotangent; d_grid keeps
g · W, and lo / up pass no gradient at an output where they are NaN.

The CUDA kernels read only the 2^D corners with weight; a first kernel tests
every grid cell once and a second recomputes the outputs whose window holds a
non-finite cell (`csrc/interp.cu`, test_shell and the fix kernels).
`_repaired_kernels` models that in numpy and is held to JAX here; the card
holds the kernels to the twins (`chip_smoke.py`, check_grid_nonfinite)."""
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
    """Equal NaN and ±inf patterns, finite entries within TOL of the largest
    finite reference entry."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert (np.isnan(got) == np.isnan(ref)).all(), f'{what}: NaN patterns differ'
    assert (np.isposinf(got) == np.isposinf(ref)).all() and (np.isneginf(got) == np.isneginf(ref)).all(), \
        f'{what}: infinities differ'
    fin = np.isfinite(ref)
    if fin.any():
        scale = max(float(np.abs(ref[fin]).max()), 1e-6)
        assert np.abs(got[fin] - ref[fin]).max() <= TOL * scale, (what, np.abs(got[fin] - ref[fin]).max())


def _jax_side(grid, disps, K, scale, halos, weights, extrema):
    """JAX's results and `jax.grad` of Σ weights · results for each halo form,
    traced in one jit. A leading batch axis of the grid is mapped with vmap."""
    d = disps[0].ndim
    names = tuple('xyz'[:d])
    shape = jm.spatial(**{n: s for n, s in zip(names, disps[0].shape)})

    def one(g, ds, halo):
        r = jnd.shift_window_interp(jm.Tensor(g, shape), list(ds), HALOS[halo][0](), K,
                                    compute_extrema=extrema, disp_scale=scale)
        return [x.native(names) for x in (r if extrema else (r,))]

    def f(g, *ds):
        total, outs = 0., []
        for halo, ws in zip(halos, weights):
            r = jax.vmap(lambda gg: one(gg, ds, halo))(g) if g.ndim > d else one(g, ds, halo)
            outs.append(r)
            total = total + sum(jnp.sum(x * w) for x, w in zip(r, ws) if w is not None)
        return total, outs
    grads, outs = jax.jit(jax.grad(f, argnums=tuple(range(1 + d)), has_aux=True))(
        jnp.asarray(grid), *[jnp.asarray(x) for x in disps])
    return [[np.asarray(x) for x in o] for o in outs], [np.asarray(g) for g in grads]


def _port_side(grid, disps, K, scale, halos, weights, extrema):
    d = disps[0].ndim
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


def _compare(jax_side, port_side):
    (j_outs, j_grads), (t_outs, t_grads) = jax_side, port_side
    for f, (jo, to) in enumerate(zip(j_outs, t_outs)):
        for i, (a, b) in enumerate(zip(to, jo)):
            _same(a, b, f'form {f} result {i}')
    for i, (a, b) in enumerate(zip(t_grads, j_grads)):
        _same(a, b, 'd_grid' if i == 0 else f'd_disp[{i - 1}]')


def _case(d, K, seed, shape, bad, batch=()):
    """A grid with a few cells `bad` (NaN, inf or -inf; one of each for
    'mixed'), displacements with fractional, integer and clipped values."""
    rng = np.random.default_rng(seed)
    scale = (0.8, -1.1, 0.6)[:d]
    grid = rng.standard_normal(batch + shape).astype(np.float32)
    values = {'nan': [np.nan] * 3, 'inf': [np.inf] * 3, '-inf': [-np.inf] * 3,
              'mixed': [np.nan, np.inf, -np.inf]}[bad]
    flat = grid.reshape(-1)
    for v, i in zip(values, rng.choice(flat.size, 3, replace=False)):
        flat[i] = v
    disps = []
    for a in range(d):
        cells = np.where(rng.random(shape) < 0.2, rng.integers(-K - 1, K + 2, shape), rng.uniform(-K - 1, K + 1, shape))
        disps.append((cells / scale[a]).astype(np.float32))
    return grid, disps, scale


@pytest.mark.parametrize('bad', ['nan', 'mixed'])
@pytest.mark.parametrize('K', [1, 2])
@pytest.mark.parametrize('d', [2, 3])
def test_grid_nonfinite_matches_jax(d, K, bad):
    """Value, lo / up, d_grid and d_disp on a grid with NaN cells, or a NaN,
    a +inf and a -inf ('mixed'), at taps of weight 0 and with weight, every
    halo form with the extrema (value, lo and up weighted), in one `jax.grad`."""
    shape = (6, 7, 5) if d == 3 else (9, 11)
    grid, disps, scale = _case(d, K, 100 + 10 * d + K + len(bad), shape, bad)
    rng = np.random.default_rng(d * K + len(bad))
    halos = tuple(HALOS)
    weights = [[rng.standard_normal(shape).astype(np.float32) for _ in range(3)] for _ in halos]
    jax_side = _jax_side(grid, disps, K, scale, halos, weights, True)
    port_side = _port_side(grid, disps, K, scale, halos, weights, True)
    _compare(jax_side, port_side)
    value = jax_side[0][0][0]
    assert np.isnan(value).any() and np.isfinite(value).any()


@pytest.mark.parametrize('d', [2, 3])
def test_grid_nonfinite_without_the_outputs_cotangent(d):
    """lo / up weighted, the output not: d_disp 0 everywhere, d_grid without
    the shares of NaN extrema, as `jax.grad` gives."""
    shape = (5, 6, 7) if d == 3 else (8, 9)
    grid, disps, scale = _case(d, 1, 70 + d, shape, 'mixed')
    rng = np.random.default_rng(5)
    weights = [[None, rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)]]
    jax_side = _jax_side(grid, disps, 1, scale, ('const',), weights, True)
    port_side = _port_side(grid, disps, 1, scale, ('const',), weights, True)
    _compare(jax_side, port_side)
    assert all((g == 0).all() for g in port_side[1][1:])


def test_grid_nonfinite_batch_matches_jax():
    """Two grids of a batch, one clean, one with NaN / ±inf cells, under
    shared displacements (summed over the batch in d_disp)."""
    shape = (6, 8)
    grid, disps, scale = _case(2, 1, 9, shape, 'mixed', batch=(2,))
    grid[0] = np.random.default_rng(1).standard_normal(shape)
    rng = np.random.default_rng(3)
    weights = [[rng.standard_normal((2,) + shape).astype(np.float32) for _ in range(3)]]
    jax_side = _jax_side(grid, disps, 1, scale, ('edge',), weights, True)
    port_side = _port_side(grid, disps, 1, scale, ('edge',), weights, True)
    _compare(jax_side, port_side)
    assert np.isfinite(port_side[0][0][0][0]).all() and not np.isfinite(port_side[0][0][0][1]).all()


# ---------------------------------------------------------------------------
# numpy model of the repaired kernels (`csrc/interp.cu`)
# ---------------------------------------------------------------------------

def _taps(K, d):
    """The window's taps in the window sum's order, axis 0 fastest."""
    W = 2 * K + 1
    for t in range(W ** d):
        yield tuple((t // W ** a) % W - K for a in range(d))


def _repaired_kernels(grid, disps, K, const, g_out=None, scale=None):
    """What K6 / K7 and K6ᵀ's d_disp compute with a constant halo: the first
    kernel's corner gather (the 2^D corners floor(δ), floor(δ) + 1 with their
    tent weights, lo / up over those with weight, NaN kept); a non-finite grid
    cell raises the flag; the fix kernels then recompute every output over
    every tap: the value (Σ v · Π w) and d_disp (Σ g v · Π_{f≠a} w_f ·
    slope_a, times the clip's derivative and the scale). Returns (value, lo,
    up, d_disp per axis or None without `g_out`)."""
    d = grid.ndim
    scale = scale or (1.0,) * d
    f32 = np.float32
    padded = np.pad(grid, K + 1, constant_values=const)
    flag = not np.isfinite(grid).all()
    val = np.zeros(grid.shape, f32)
    lo, up = np.full(grid.shape, f32(3.4e38)), np.full(grid.shape, f32(-3.4e38))
    dd = [np.zeros(grid.shape, f32) for _ in range(d)] if g_out is not None else None
    for c in np.ndindex(grid.shape):
        x = [f32(scale[a]) * disps[a][c] for a in range(d)]
        delta = [f32(np.clip(v, -K, K)) for v in x]
        at = lambda s: padded[tuple(c[a] + K + 1 + s[a] for a in range(d))]
        with np.errstate(invalid='ignore'):
            for corner in np.ndindex(*(2,) * d):
                s = [int(np.floor(delta[a])) + corner[a] for a in range(d)]
                w = [f32(max(0., 1. - abs(delta[a] - s[a]))) for a in range(d)]
                v = at(s)
                val[c] += f32(np.prod(w, dtype=f32)) * v
                if all(abs(delta[a] - s[a]) < 1 for a in range(d)):  # min.NaN / max.NaN
                    lo[c] = np.nan if np.isnan(v) or np.isnan(lo[c]) else min(lo[c], v)
                    up[c] = np.nan if np.isnan(v) or np.isnan(up[c]) else max(up[c], v)
            if not flag:
                continue
            acc, dacc = f32(0), [f32(0)] * d
            for s in _taps(K, d):
                u = [f32(1) - abs(delta[a] - f32(s[a])) for a in range(d)]
                w = [max(f32(0), ua) for ua in u]
                acc = acc + at(s) * f32(np.prod(w, dtype=f32))
                if dd is not None:
                    gv = f32(g_out[c]) * at(s)
                    for a in range(d):
                        slope = (1. if u[a] > 0 else 0.5 if u[a] == 0 else 0.) * (-1. if delta[a] - s[a] >= 0 else 1.)
                        dacc[a] = dacc[a] + gv * f32(np.prod([w[f] for f in range(d) if f != a], dtype=f32)) * f32(slope)
            val[c] = acc
            if dd is not None:
                for a in range(d):
                    m = max(x[a], -K)
                    dclip = (1. if K > m else .5 if K == m else 0.) * (1. if x[a] > -K else .5 if x[a] == -K else 0.)
                    dd[a][c] = dacc[a] * f32(dclip) * f32(scale[a])
    return val, lo, up, dd


@pytest.mark.parametrize('bad', ['inf', 'mixed'])
def test_repaired_kernels_model_matches_jax(bad):
    """The numpy model of the repaired kernels against JAX on ±inf cells
    (value, lo / up, and d_disp at the outputs the fix kernel recomputes),
    K = 2, a constant halo."""
    shape = (7, 8)
    grid, disps, scale = _case(2, 2, 55 + len(bad), shape, bad)
    g_out = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    ws = [g_out, None, None]
    (ref,), ref_grads = _jax_side(grid, disps, 2, scale, ('const',), [ws], True)
    val, lo, up, dd = _repaired_kernels(grid, disps, 2, np.float32(0.25), g_out, scale)
    _same(val, ref[0], 'value')
    _same(lo, ref[1], 'lo')
    _same(up, ref[2], 'up')
    hit = ~np.isfinite(ref[0])
    for a in range(2):
        _same(dd[a][hit], ref_grads[1 + a][hit], f'd_disp[{a}]')


def test_fused_advect_twin_at_nonfinite_smoke_matches_jax():
    """K5's twin (`SmokePlume._fused_advect_native`, the three fused calls of
    a closed-box step) with the smoke NaN, +inf and -inf at three cells
    against JAX's `SmokePlume._fused_advect` in interpret mode: the same NaN
    and infinity pattern in the smoke, equal elsewhere within 2e-5."""
    import test_torch_transfer_advect as TA
    from phiflow_tpu.models import SmokePlume as JaxSmoke
    from phiflow_tpu_torch.models import SmokePlume
    N = 16
    rng = np.random.default_rng(13)
    vel = [rng.uniform(-1.9, 1.9, s).astype(np.float32) for s in ((N - 1, N, N), (N, N - 1, N), (N, N, N - 1))]
    smoke = rng.uniform(0., 1., (N, N, N)).astype(np.float32)
    for v, at in zip((np.nan, np.inf, -np.inf), ((3, 4, 5), (9, 9, 2), (12, 5, 10))):
        smoke[at] = v
    model = SmokePlume(resolution=N, dims=3, device='cpu')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the inflow ball's sqrt in one thread (ROADMAP §3, a flaky first call)
    try:
        _, ts = model._fused_advect_native(tuple(torch.from_numpy(a) for a in vel), torch.from_numpy(smoke))
    finally:
        torch.set_num_threads(threads)
    jax_model = JaxSmoke(resolution=N, dims=3)
    _, js = jax_model._fused_advect(*TA._jax_state(jax_model, *vel, smoke), interpret=True)
    ref = np.asarray(js.values.native(TA.ORDER))
    got = ts.numpy()
    assert np.isnan(ref).any()
    assert (np.isnan(got) == np.isnan(ref)).all() and (np.isinf(got) == np.isinf(ref)).all()
    fin = np.isfinite(ref)
    assert np.abs(got[fin] - ref[fin]).max() < 2e-5

"""The gradient of the port's window interpolation (K6 / K7 and their
backward, `ops/interp.py::_WindowInterp`) against `jax.grad` of the JAX
package's window sum (`phiflow_tpu/math/_nd.py::shift_window_interp`, its
`fori_loop` route on the CPU). On the CPU the backward is the twin's VJP;
`_grad_kernel_model` below is a numpy model of the CUDA backward
(`csrc/interp.cu`: `window_interp_grid_grad_kernel` and, for d_disp,
`window_interp_disp_grad_kernel`: its tap selection, JAX's
slopes at the kinks, the extrema chain's tie shares, and the gather that
writes each grid cell once — the blocks of `grad_plan`, their slot windows
with the halo, the clamped edge sides, the wrapped axes and the batch),
held against the twin here.

Displacements mix fractional values, integers (from rest), exactly ±K and
beyond (the clip), so every kink of JAX's AD rules is met. Tolerance 1e-5 of
each gradient's largest entry (the two sides sum taps in different orders);
the kernel model 1e-5 as well."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import phiflow_tpu.math as jm
from phiflow_tpu.math import _nd as jnd, extrapolation as jext
import phiflow_tpu_torch.math as tm
from phiflow_tpu_torch.math._nd import shift_window_interp
from phiflow_tpu_torch.ops import interp as TI

TOL = 1e-5
HALOS = {'const': (lambda: jext.ConstantExtrapolation(0.25), dict(const_pad=0.25)),
         'edge': (lambda: jext.BOUNDARY, dict(halo='edge')),
         'wrap': (lambda: jext.PERIODIC, dict(halo='wrap'))}


def _displacements(rng, shape, K, scale):
    """Per axis, a mix of fractional cells, integers 0 and ±1, exactly ±K
    and beyond ±K, divided by the scale so that the kernel's product lands
    on them (scale ±1 keeps integers exact)."""
    d = len(shape)
    out = []
    for a in range(d):
        frac = rng.uniform(-K - 0.5, K + 0.5, shape)
        ints = rng.integers(-1, 2, shape).astype(np.float64)
        edges = rng.choice([-K, K, -K - 1.0, K + 0.75], shape)
        pick = rng.integers(0, 3, shape)
        cells = np.where(pick == 0, frac, np.where(pick == 1, ints, edges))
        out.append((cells / scale[a]).astype(np.float32))
    return out


def _jax_grads(grid, disps, K, extrema, scale, ext, weights):
    names = tuple('xyz'[:grid.ndim])
    shape = jm.spatial(**{n: s for n, s in zip(names, grid.shape)})

    def f(g, *ds):
        r = jnd.shift_window_interp(jm.Tensor(g, shape), list(ds), ext, K, compute_extrema=extrema, disp_scale=scale)
        r = r if extrema else (r,)
        return sum(jnp.sum(ri.native(names) * w) for ri, w in zip(r, weights))
    grads = jax.grad(f, argnums=tuple(range(1 + grid.ndim)))(jnp.asarray(grid), *[jnp.asarray(x) for x in disps])
    return [np.asarray(g) for g in grads]


def _port_grads(grid, disps, K, extrema, scale, halo, weights):
    g = torch.tensor(grid, requires_grad=True)
    ds = [torch.tensor(x, requires_grad=True) for x in disps]
    fn = TI.window_interp_3d if grid.ndim == 3 else TI.window_interp_2d
    r = fn(g, ds, K, compute_extrema=extrema, disp_scale=scale, **halo)
    r = r if extrema else (r,)
    sum((ri * torch.tensor(w)).sum() for ri, w in zip(r, weights)).backward()
    return [g.grad.numpy()] + [x.grad.numpy() for x in ds]


def _close(got, ref):
    for a, b in zip(got, ref):
        assert np.abs(a - b).max() <= TOL * max(np.abs(b).max(), 1e-6), (np.abs(a - b).max(), np.abs(b).max())


@pytest.mark.parametrize('K', [1, 2])
@pytest.mark.parametrize('d', [2, 3])
def test_twin_vjp_matches_jax_window_sum(d, K):
    """Every halo form with the extrema (value, lo and up weighted): one
    `jax.grad` of the sum over the forms, so that JAX traces once."""
    rng = np.random.default_rng(100 * d + 10 * K)
    shape = (5, 6, 7)[:d]
    scale = (1.0, -1.0, 1.0)[:d]
    names = tuple('xyz'[:d])
    jshape = jm.spatial(**{n: s for n, s in zip(names, shape)})
    grid = rng.standard_normal(shape).astype(np.float32)
    disps = _displacements(rng, shape, K, scale)
    forms = [(h, True) for h in HALOS]
    weights = [[rng.standard_normal(shape).astype(np.float32) for _ in range(3 if e else 1)] for _, e in forms]

    def f(g, *ds):
        total = 0.
        for (halo, extrema), ws in zip(forms, weights):
            r = jnd.shift_window_interp(jm.Tensor(g, jshape), list(ds), HALOS[halo][0](), K, compute_extrema=extrema,
                                        disp_scale=scale)
            total = total + sum(jnp.sum(ri.native(names) * w) for ri, w in zip(r if extrema else (r,), ws))
        return total
    ref = [np.asarray(x) for x in jax.grad(f, argnums=tuple(range(1 + d)))(jnp.asarray(grid),
                                                                           *[jnp.asarray(x) for x in disps])]
    g = torch.tensor(grid, requires_grad=True)
    ds = [torch.tensor(x, requires_grad=True) for x in disps]
    fn = TI.window_interp_3d if d == 3 else TI.window_interp_2d
    total = 0.
    for (halo, extrema), ws in zip(forms, weights):
        r = fn(g, ds, K, compute_extrema=extrema, disp_scale=scale, **HALOS[halo][1])
        total = total + sum((ri * torch.tensor(w)).sum() for ri, w in zip(r if extrema else (r,), ws))
    total.backward()
    _close([g.grad.numpy()] + [x.grad.numpy() for x in ds], ref)


@pytest.mark.parametrize('d', [2, 3])
def test_ties_and_fractional_scales_match_jax(d):
    """Integer-valued grids (tied taps in the extrema chain), integer
    displacements from rest, and a fractional scale per axis."""
    rng = np.random.default_rng(7 + d)
    shape = (4, 5, 6)[:d]
    grid = np.round(rng.standard_normal(shape)).astype(np.float32)
    for disps, scale in (([np.zeros(shape, np.float32)] * d, (1.0,) * d),
                         (_displacements(rng, shape, 1, (0.8, -1.1, 0.6)[:d]), (0.8, -1.1, 0.6)[:d])):
        weights = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
        ref = _jax_grads(grid, disps, 1, True, scale, jext.BOUNDARY, weights)
        _close(_port_grads(grid, disps, 1, True, scale, dict(halo='edge'), weights), ref)


def test_slope_at_rest_follows_jax_rules():
    """Taps 5 / 7 / 3 at s = −1 / 0 / +1 and δ = 0: dout/dδ is −8 under
    JAX's rules (|x|' = +1 at 0, the tent's slope halved at its kink), not
    the −2 of torch.abs / torch.clamp."""
    grid = torch.tensor([5., 7., 3.])[:, None].expand(3, 3).contiguous()  # axis 0: s = −1, 0, +1 around row 1
    disp = [torch.zeros(3, 3, requires_grad=True), torch.zeros(3, 3)]
    out = TI.window_interp_2d(grid, disp, 1, halo='edge')
    out[1].sum().backward()
    assert torch.equal(disp[0].grad[1], torch.full((3,), -8.0))


def test_padded_grid_gradient_is_the_pads_pullback():
    """A padded grid's gradient, pulled back through the pad, is the
    gradient of the raw grid with the same halo."""
    rng = np.random.default_rng(3)
    K, shape = 2, (6, 5, 7)
    for mode, pad_mode in (('edge', 'replicate'), ('wrap', 'circular')):
        grid = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, requires_grad=True)
        disps = [torch.tensor(x) for x in _displacements(rng, shape, K, (1., 1., 1.))]
        w = [torch.tensor(rng.standard_normal(shape), dtype=torch.float32) for _ in range(3)]
        padded = F.pad(grid[None, None], (K,) * 6, mode=pad_mode)[0, 0]
        loss = sum((o * wi).sum() for o, wi in zip(TI.window_interp_3d(padded, disps, K, compute_extrema=True), w))
        g_padded, = torch.autograd.grad(loss, grid)
        loss = sum((o * wi).sum() for o, wi in zip(TI.window_interp_3d(grid, disps, K, compute_extrema=True,
                                                                       halo=mode), w))
        g_raw, = torch.autograd.grad(loss, grid)
        assert torch.allclose(g_padded, g_raw, atol=1e-5)


def test_gradcheck_float64_at_fractional_displacements():
    rng = np.random.default_rng(11)
    shape = (3, 3, 2)
    grid = torch.tensor(rng.standard_normal(shape), dtype=torch.float64, requires_grad=True)
    # fractional cells away from the kinks: distance to every integer ≥ 0.1
    frac = rng.uniform(0.1, 0.9, (3,) + shape) + rng.integers(-1, 1, (3,) + shape)
    disps = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in frac]

    def f(g, *ds):
        return TI.window_interp_3d(g, list(ds), 1, compute_extrema=True, halo='edge', disp_scale=(1., 1., 1.))
    assert torch.autograd.gradcheck(f, (grid, *disps), eps=1e-6, atol=1e-6)


def test_shift_window_interp_per_side_halo_is_differentiable():
    """A moving lid's constants by side: the grid is padded by PyTorch
    operations and handed to the kernel padded; its gradient reaches the raw
    grid as the pad's pullback (equal to a constant halo where all sides
    agree)."""
    rng = np.random.default_rng(5)
    grid = torch.tensor(rng.standard_normal((6, 7)), dtype=torch.float32, requires_grad=True)
    disps = [torch.tensor(x) for x in _displacements(rng, (6, 7), 1, (1., 1.))]
    g1, = torch.autograd.grad(shift_window_interp(grid, disps, tm.PerSide((0., 0.), (0., 0.)), 1).sum(), grid)
    g2, = torch.autograd.grad(shift_window_interp(grid, disps, 0.0, 1).sum(), grid)
    assert torch.allclose(g1, g2, atol=1e-6)


def test_tensor_halo_constant_raises():
    grid = torch.zeros(4, 5)
    disps = [torch.zeros(4, 5), torch.zeros(4, 5)]
    with pytest.raises(TypeError):
        shift_window_interp(grid, disps, torch.tensor(1.0, requires_grad=True), 1)
    with pytest.raises(TypeError):
        TI.window_interp_2d(grid, disps, 1, const_pad=torch.tensor(1.0))


# ---------------------------------------------------------------------------
# a numpy model of the CUDA backward kernel
# ---------------------------------------------------------------------------

def _above(a, b):
    return 1.0 if a > b else (0.5 if a == b else 0.0)


def _resolve(l, n, mode):
    if mode == 'wrap':
        return l % n, False
    if mode == 'edge':
        return min(max(l, 0), n - 1), False
    return l, not 0 <= l < n


def _axis_window(x, K):
    """`axis_window`: (floor, corner weights, corner slopes, the extra tap's
    slope and offset, the clip's derivative, whether there are taps)."""
    f32 = np.float32
    kf = f32(K)
    m = x if x > -kf else -kf  # fmaxf: NaN gives -K
    d = m if m < kf else kf
    f = int(np.floor(d))
    w4, dw4 = [], []
    for j in range(4):
        s = f - 1 + j
        t = f32(d - f32(s))
        one_m = f32(1) - (t if t >= 0 else -t)
        tap = -K <= s <= K and one_m >= 0
        w4.append(f32(max(f32(0), one_m)) if tap else f32(0))
        dw4.append(f32(-(1.0 if one_m > 0 else 0.5) * (1.0 if t >= 0 else -1.0)) if tap else f32(0))
    dwx, sx = (dw4[0], -1) if dw4[0] != 0 else (dw4[3], 2)
    return f, w4[1:3], dw4[1:3], dwx, sx, f32(_above(x, -kf) * _above(kf, m)), x == x


def _slot(grid, disps, ups, K, extrema, scale, mode, shift, const, c, L, own):
    """`slot` of the kernel for the output at index c (its window position,
    logical, L): its floors (None: no taps), its 2^d corner coefficients (bit
    e of a corner = axis e) and, with `own`, its d_disp (None otherwise)."""
    f32 = np.float32
    d = len(c)
    nc = 1 << d
    rmode = 'edge' if mode is None else mode
    wins = [_axis_window(f32(f32(scale[e]) * disps[e][c]), K) for e in range(d)]
    go = ups[0][c] if ups[0] is not None else f32(0)
    gd = [f32(0)] * d
    floors, coef = None, [f32(0)] * nc
    if all(w[6] for w in wins):
        floors = tuple(w[0] for w in wins)
        r = [[_resolve(L[e] + wins[e][0] + (i if i < 2 else wins[e][4]) - shift, grid.shape[e], rmode)
              for i in range(3)] for e in range(d)]

        def value(taps):
            idx = [r[e][taps[e]] for e in range(d)]
            return const if any(o for _, o in idx) else grid[tuple(i for i, _ in idx)]
        bits = [[(b >> e) & 1 for e in range(d)] for b in range(nc)]
        W = [f32(np.prod([wins[e][1][bb[e]] for e in range(d)], dtype=f32)) for bb in bits]
        exists = [all(bb[e] == 0 or wins[e][2][1] != 0 for e in range(d)) for bb in bits]
        v = [value(bb) if (exists[b] if own else (extrema and W[b] != 0)) else f32(0) for b, bb in enumerate(bits)]
        if own:
            for b, bb in enumerate(bits):
                for e in range(d):
                    fac = f32(wins[e][2][bb[e]] * np.prod([wins[k][1][bb[k]] for k in range(d) if k != e], dtype=f32))
                    gd[e] = f32(gd[e] + v[b] * fac)
            for e in range(d):
                for bb in bits:
                    if wins[e][3] == 0 or bb[e]:
                        continue
                    fac = f32(wins[e][3] * np.prod([wins[k][1][bb[k]] for k in range(d) if k != e], dtype=f32))
                    if fac != 0:
                        gd[e] = f32(gd[e] + value([2 if k == e else bb[k] for k in range(d)]) * fac)
        coef = [f32(go * Wb) for Wb in W]
        if extrema:
            pre_lo, pre_up, m_lo, m_up = [], [], f32(3.4e38), f32(-3.4e38)
            for b in range(nc):
                pre_lo.append(m_lo)
                pre_up.append(m_up)
                if W[b] != 0:
                    m_lo, m_up = min(m_lo, v[b]), max(m_up, v[b])
            G_lo = ups[1][c] if ups[1] is not None else f32(0)
            G_up = ups[2][c] if ups[2] is not None else f32(0)
            for b in reversed(range(nc)):
                if W[b] == 0:
                    continue
                s_lo, s_up = f32(G_lo * _above(pre_lo[b], v[b])), f32(G_up * _above(v[b], pre_up[b]))
                G_lo, G_up = f32(G_lo - s_lo), f32(G_up - s_up)
                coef[b] = f32(coef[b] + f32(s_lo + s_up))
    d_disp = None
    if own and floors is None:  # a NaN displacement: NaN on an axis beside another NaN one (with g_out), else 0
        nan_axes = [not w[6] for w in wins]
        d_disp = [f32(np.nan) if ups[0] is not None and any(n for i, n in enumerate(nan_axes) if i != e) else f32(0)
                  for e in range(d)]
    elif own:
        d_disp = [f32(f32(f32(go * f32(scale[e])) * wins[e][5]) * gd[e]) for e in range(d)]
    return floors, coef, d_disp


def _nan_taps(d_grid, grid_shared, grid_shape, disps, ups, K, scale, mode, shift, out_shape, nb):
    """The d_disp kernel's second duty (after d_grid's): NaN into every tap of
    an output with a NaN displacement and an upstream gradient, each tap
    resolved as the forward does (past a constant halo: dropped)."""
    if ups[0] is None:
        return
    d = len(out_shape)
    rmode = 'edge' if mode is None else mode
    disp_shared = disps[0].ndim == d
    for entry in range(nb):
        dsp = [x if disp_shared else x[entry] for x in disps]
        for c in itertools.product(*[range(n) for n in out_shape]):
            if not any(np.isnan(np.float32(np.float32(scale[e]) * dsp[e][c])) for e in range(d)):
                continue
            for s in itertools.product(range(-K, K + 1), repeat=d):
                r = [_resolve(c[e] + s[e] - shift, grid_shape[e], rmode) for e in range(d)]
                if not any(o for _, o in r):
                    d_grid[tuple(([] if grid_shared else [entry]) + [i for i, _ in r])] = np.nan


H100 = dict(sms=132, smem_per_sm=233472)  # `grad_plan`'s budget on the H100 (`sm_budget` there)


def _wide_model(grid, disps, K, extrema, scale, mode, const, ups, gshape, out_shape, shift):
    """`window_interp_wide_grid_grad_kernel` in float32: each cell sums the
    outputs within K of it, ascending (axis 0 slowest), taking a corner
    where cell = output + floor + corner bit on every axis (on a clamped edge
    side, at or past it); a shared grid's cells add the entries in order.
    d_disp from `slot` of each output (`window_interp_disp_grad_kernel`)."""
    f32 = np.float32
    d = len(disps)
    nb = ups[0].shape[0]
    grid_shared, disp_shared = grid.ndim == d, disps[0].ndim == d
    d_grid = np.zeros(grid.shape, f32)
    d_disp = [np.zeros((nb,) + out_shape, f32) for _ in range(d)]
    cache = {}
    for entry in range(nb):
        g_e = grid if grid_shared else grid[entry]
        dsp = [x if disp_shared else x[entry] for x in disps]
        up = [None if u is None else u[entry] for u in ups]
        for c in itertools.product(*[range(n) for n in out_shape]):
            _, _, dd = _slot(g_e, dsp, up, K, extrema, scale, mode, shift, const, c, c, True)
            for e in range(d):
                d_disp[e][(entry,) + c] = dd[e]
        for cell in itertools.product(*[range(n) for n in gshape]):
            l = [r + shift for r in cell]
            at_lo = [mode == 'edge' and r == 0 for r in cell]
            at_hi = [mode == 'edge' and r == n - 1 for r, n in zip(cell, gshape)]
            # the kernel skips an output past a non-wrapped side: its range clipped to the outputs
            ranges = [range(li - K, li + K + 1) if mode == 'wrap' else range(max(li - K, 0), min(li + K, n - 1) + 1)
                      for li, n in zip(l, out_shape)]
            acc = f32(0)
            for j in itertools.product(*ranges):
                c = tuple(x % n for x, n in zip(j, out_shape))
                key = (entry, c, j)
                if key not in cache:
                    cache[key] = _slot(g_e, dsp, up, K, extrema, scale, mode, shift, const, c, j, False)[:2]
                floors, coef = cache[key]
                if floors is None:
                    continue
                u = [l[e] - j[e] - floors[e] for e in range(d)]
                ok = [[(at_lo[e] or b >= u[e]) and (at_hi[e] or b <= u[e]) for b in (0, 1)] for e in range(d)]
                for b in range(1 << d):
                    if all(ok[e][(b >> e) & 1] for e in range(d)):
                        acc = f32(acc + coef[b])
            idx = cell if grid_shared else (entry,) + cell
            d_grid[idx] = acc if entry == 0 or not grid_shared else f32(d_grid[idx] + acc)
    _nan_taps(d_grid, grid_shared, gshape, disps, ups, K, scale, mode, shift, out_shape, nb)
    return d_grid, d_disp


def _grad_kernel_model(grid, disps, K, extrema, scale, mode, const, ups, sms=H100['sms']):
    """`window_interp_grid_grad_kernel` in float32 over the blocks of `grad_plan`
    (planned for `sms` SMs of the H100's), or past its K the wide kernel's
    (`_wide_model`).
    grid: (nb, *raw) or (*raw) shared; disps: d arrays (nb, *out) or (*out)
    shared; ups: out[, lo, up] as (nb, *out) (None entries zero). Each
    block computes its slot window plane by plane (halo included; the owner
    of an output also its d_disp), and each owned cell sums the slots within K
    of it, planes, rows and columns ascending, taking a corner where cell =
    slot + floor + corner bit on every axis; at K = 1 a cell on one clamped
    edge side then, plane by plane, the taps past it (exact on the other
    axes), and any other cell on a side every tap at or past its sides, slot
    by slot; a shared grid's cells add the entries in order. Asserts that
    every cell and every output is written exactly once an entry. Returns
    (d_grid in the grid's shape, [d_disp (nb, *out)])."""
    f32 = np.float32
    d = len(disps)
    out_shape = ups[0].shape[1:]
    nb = ups[0].shape[0]
    grid_shared, disp_shared = grid.ndim == d, disps[0].ndim == d
    gshape = grid.shape[-d:]
    shift = -K if mode is None else 0
    plan = TI.grad_plan(d, K, gshape, nb, grid_shared, sms=sms, smem_per_sm=H100['smem_per_sm'])
    if plan['route'] == 'wide':
        return _wide_model(grid, disps, K, extrema, scale, mode, const, ups, gshape, out_shape, shift)
    sy, sz = plan['window']
    window = ((sy, sz) if d == 3 else (sz,))
    tile, chunk = plan['tile'], plan['chunk']
    n0 = gshape[0]
    chunks = -(-n0 // chunk)
    edge = mode == 'edge'
    d_grid = np.zeros(grid.shape, f32)
    grid_writes = np.zeros(grid.shape, np.int64)
    d_disp = [np.zeros((nb,) + out_shape, f32) for _ in range(d)]
    disp_writes = np.zeros((nb,) + out_shape, np.int64)
    cache = {}
    for bz, by, bx in itertools.product(*[range(n) for n in plan['grid'][::-1]]):
        entries = range(nb) if grid_shared else [bz // chunks]
        xc = bz if grid_shared else bz % chunks
        x0, x1 = xc * chunk, min(xc * chunk + chunk, n0)
        org = (by * tile[0], bx * tile[1]) if d == 3 else (bx * tile[0],)
        for entry in entries:
            g_e = grid if grid_shared else grid[entry]
            dsp = [x if disp_shared else x[entry] for x in disps]
            up = [None if u is None else u[entry] for u in ups]
            slots = {}
            for p in range(x0 + shift - K, x1 + shift + K):
                for loc in itertools.product(*[range(n) for n in window]):
                    L = (p,) + tuple(org[i] + shift - K + loc[i] for i in range(d - 1))
                    if mode == 'wrap':
                        c = tuple(l % n for l, n in zip(L, out_shape))
                    elif all(0 <= l < n for l, n in zip(L, out_shape)):
                        c = L
                    else:
                        slots[(p,) + loc] = (None, None)
                        continue
                    raw = [L[i + 1] - shift for i in range(d - 1)]
                    own = (x0 + shift <= p < x1 + shift and
                           all(K <= loc[i] < window[i] - K and raw[i] < gshape[i + 1] for i in range(d - 1)))
                    key = (entry, c, L, own)
                    if key not in cache:
                        cache[key] = _slot(g_e, dsp, up, K, extrema, scale, mode, shift, const, c, L, own)
                    floors, coef, dd = cache[key]
                    slots[(p,) + loc] = (floors, coef)
                    if own:
                        disp_writes[(entry,) + c] += 1
                        for e in range(d):
                            d_disp[e][(entry,) + c] = dd[e]
            for x in range(x0, x1):
                for loc in itertools.product(*[range(K, n - K) for n in window]):
                    cell = (x,) + tuple(org[i] + loc[i] - K for i in range(d - 1))
                    if any(cell[i] >= gshape[i] for i in range(d)):
                        continue
                    at_lo = [edge and cell[e] == 0 for e in range(d)]
                    at_hi = [edge and cell[e] == gshape[e] - 1 for e in range(d)]
                    acc = f32(0)
                    sides = sum(at_lo) + sum(at_hi)
                    # no clamped side, or at K = 1 one: per slot plane the exact taps, then those past the side;
                    # otherwise every tap at or past the sides, slot by slot
                    one = sides == 0 or (K == 1 and sides == 1)
                    passes = [(False, True)] + ([(True, False)] if sides == 1 else []) if one else [(True, True)]
                    for p0 in range(-K, K + 1):
                        for past, exact in passes:
                            for off in itertools.product(*[range(-K, K + 1)] * (d - 1)):
                                off = (p0,) + off
                                floors, coef = slots[(x + shift + p0,) + tuple(loc[i] + off[i + 1]
                                                                                for i in range(d - 1))]
                                if floors is None:
                                    continue
                                u = [-off[e] - floors[e] for e in range(d)]  # the corner bit the cell needs
                                ok = [[(exact and b == u[e]) or (past and ((at_lo[e] and b < u[e])
                                                                            or (at_hi[e] and b > u[e])))
                                       for b in (0, 1)] for e in range(d)]
                                if past and not exact:  # exact on every other axis, past the side on its own
                                    ok = [[b == u[e] for b in (0, 1)] if not (at_lo[e] or at_hi[e]) else ok[e]
                                          for e in range(d)]
                                for b in range(1 << d):
                                    if all(ok[e][(b >> e) & 1] for e in range(d)):
                                        acc = f32(acc + coef[b])
                    idx = cell if grid_shared else (entry,) + cell
                    d_grid[idx] = acc if entry == entries[0] else f32(d_grid[idx] + acc)
                    grid_writes[idx] += 1
    assert (grid_writes == (nb if grid_shared else 1)).all(), 'a grid cell written other than once an entry'
    assert (disp_writes == 1).all(), 'an output d_disp written other than once'
    _nan_taps(d_grid, grid_shared, gshape, disps, ups, K, scale, mode, shift, out_shape, nb)
    return d_grid, d_disp


def _model_against_twin(d, K, mode, extrema, shape, rng, nb=None, shared=None, nan=False, sms=H100['sms']):
    """The model and the twin's VJP on one set of inputs (ties in the
    extrema chain, every kink of the displacements): `nb` entries with the
    grid or the displacements `shared`; `nan`: a tenth of the outputs with a
    NaN displacement on one axis and a twentieth on every axis, held against
    the twin on the same inputs (JAX's rule: the same NaN pattern in d_grid
    and d_disp, d_disp exactly 0 on the NaN axis of an output with one)."""
    gshape = tuple(n + 2 * K for n in shape) if mode is None else shape
    scale = (1.0, -1.0, 0.5)[:d]
    lead = () if nb is None else (nb,)
    grid = np.round(rng.standard_normal((lead if shared != 'grid' else ()) + gshape) * 2).astype(np.float32) / 2
    disps = [np.stack(x) if lead and shared != 'disp' else x[0]
             for x in zip(*[_displacements(rng, shape, K, scale) for _ in range(nb if lead and shared != 'disp' else 1)])]
    ups = [rng.standard_normal((nb or 1,) + shape).astype(np.float32) for _ in range(3)]
    if nan:
        lead_d = lead if shared != 'disp' else ()
        hole = rng.random(lead_d + shape) < 0.1
        every = rng.random(lead_d + shape) < 0.05
        disps = [np.where(every | (hole if e == d - 1 else False), np.float32(np.nan), x) for e, x in enumerate(disps)]
    const = 0.25
    t_ups = [torch.tensor(u if lead else u[0]) for u in (ups if extrema else ups[:1])]
    ref_grid, ref_disp = TI._window_interp_vjp_plain(
        torch.tensor(grid), [torch.tensor(x) for x in disps], K, extrema, tuple(TI._f32(s) for s in scale), mode,
        const, t_ups, True, True)
    got_grid, got_disp = _grad_kernel_model(grid, disps, K, extrema, scale, mode, np.float32(const),
                                            ups if extrema else [ups[0], None, None], sms)
    got_disp = [x.sum(0) if x.shape[0] > 1 and disps[0].ndim == d else (x if lead else x[0]) for x in got_disp]
    if nan:
        only = hole & ~every  # the last axis NaN alone: its d_disp exactly 0
        assert (got_disp[-1][only] == 0).all() and np.isnan(got_disp[0][only]).all()
        assert np.isnan(got_grid).any()
    for got, ref in zip([got_grid, *got_disp], [ref_grid, *ref_disp]):
        ref = ref.numpy()
        assert got.shape == ref.shape
        assert (np.isnan(got) == np.isnan(ref)).all(), 'NaN patterns differ'
        got, ref = np.nan_to_num(got), np.nan_to_num(ref)
        assert np.abs(got - ref).max() <= TOL * max(np.abs(ref).max(), 1e-6), (np.abs(got - ref).max(), np.abs(ref).max())


@pytest.mark.parametrize('d,K,mode,extrema', [(2, 1, 'const', True), (2, 2, 'wrap', True), (2, 2, None, False),
                                               (3, 1, 'edge', True), (3, 2, 'const', False), (3, 1, None, True)])
def test_backward_kernel_model_matches_twin(d, K, mode, extrema):
    shape = (4, 5, 3)[:d] if d == 3 else (5, 6)
    _model_against_twin(d, K, mode, extrema, shape, np.random.default_rng(20 + 5 * d + K))


@pytest.mark.parametrize('case,d,K,mode,extrema,shape,kw', [
    ('wrap, extents <= 2K', 2, 2, 'wrap', True, (3, 4), {}),
    ('wrap, extents <= 2K', 3, 1, 'wrap', True, (2, 2, 5), {}),
    ('edge, K = 2', 2, 2, 'edge', True, (5, 7), {}),
    ('edge, K = 2', 3, 2, 'edge', True, (4, 5, 6), {}),
    ('ragged: two column tiles', 2, 1, 'const', True, (5, 300), {}),
    ('ragged: tiles, chunks of 2', 3, 1, 'edge', True, (3, 17, 33), dict(sms=1)),
    ('NaN displacements', 2, 1, 'const', True, (6, 7), dict(nan=True)),
    ('NaN displacements', 3, 1, 'wrap', True, (4, 5, 3), dict(nan=True)),
    ('batch, shared grid', 2, 1, 'edge', True, (5, 6), dict(nb=3, shared='grid')),
    ('batch, shared grid', 3, 1, None, True, (3, 4, 5), dict(nb=2, shared='grid')),
    ('batch, shared displacement', 2, 2, 'wrap', True, (5, 6), dict(nb=3, shared='disp')),
    ('batch, shared displacement', 3, 1, 'const', False, (3, 4, 5), dict(nb=2, shared='disp')),
    ('wide: 3D K = 8', 3, 8, 'const', True, (3, 4, 5), {}),
    ('wide: 3D K = 8', 3, 8, 'edge', True, (4, 3, 5), dict(nan=True)),
    ('wide: 3D K = 8', 3, 8, None, False, (2, 3, 4), dict(nb=2, shared='grid')),
    ('wide: 2D K = 33', 2, 33, 'edge', True, (5, 40), {}),
    ('wide: 2D K = 33', 2, 33, None, True, (3, 5), dict(nb=2, shared='disp')),
])
def test_backward_kernel_model_cases(case, d, K, mode, extrema, shape, kw):
    """The cases the kernel's indexing has to get right beyond the basic six:
    a wrapped axis of at most 2K cells (one output's taps on one cell twice),
    clamped edge sides at K = 2, tiles and chunks that do not divide the
    grid (chunks of 2 where the plan has one SM), outputs without taps,
    batches with a shared input, and K past the slot window (the wide
    kernel)."""
    _model_against_twin(d, K, mode, extrema, shape, np.random.default_rng(len(case) + 10 * d + K), **kw)


@pytest.mark.parametrize('d,shape,nb', [(3, (256, 256, 256), 1), (3, (512, 256, 256), 1), (2, (4096, 4096), 1),
                                        (3, (128, 128, 128), 4), (2, (1024, 1024), 4)])
@pytest.mark.parametrize('K', [1, 2])
def test_grad_plan_covers_each_cell_once(d, shape, nb, K):
    """`grad_plan` at the paths' shapes (and a padded grid, K more a side):
    every cell owned by exactly one block an entry (a shared grid: one
    block), shared memory within 227 KB, the launch within its limits."""
    for padded, shared in ((False, False), (True, nb > 1)):
        gshape = tuple(n + 2 * K for n in shape) if padded else shape
        plan = TI.grad_plan(d, K, gshape, nb, shared, **H100)
        assert plan['route'] == 'tiled' and plan['smem'] <= 232448 and plan['ring'] == 2 * K + 2
        assert plan['grid'][1] <= 65535 and plan['grid'][2] <= 65535 and plan['threads'] <= 1024
        chunks = -(-gshape[0] // plan['chunk'])
        assert plan['grid'][2] == chunks * (1 if shared else nb)
        owned = np.zeros((1 if shared else nb,) + gshape, np.int8)
        tile = plan['tile']
        for bz in range(plan['grid'][2]):
            x0 = (bz % chunks) * plan['chunk']
            for by in range(plan['grid'][1]):
                for bx in range(plan['grid'][0]):
                    box = (bz // chunks, slice(x0, x0 + plan['chunk']))
                    box += (slice(by * tile[0], (by + 1) * tile[0]),) if d == 3 else ()
                    owned[box + (slice(bx * tile[-1], (bx + 1) * tile[-1]),)] += 1
        assert (owned == 1).all()


def test_grad_plan_ring_and_limits():
    """The ring of 2K + 2 slot planes where it fits, one plane past that;
    K beyond the window (3D K > 7, 2D K > 32) on the wide kernel, which
    plans a thread a cell; K < 1 refused."""
    plan = lambda d, K, shape, nb=1, shared=False: TI.grad_plan(d, K, shape, nb, shared, **H100)
    assert [plan(3, K, (64, 64, 64))['ring'] for K in range(1, 8)] == [4, 6, 8, 10, 1, 1, 1]
    assert plan(2, 17, (64, 64))['ring'] == 36 and plan(2, 18, (64, 64))['ring'] == 1
    assert [plan(3, K, (64,) * 3)['route'] for K in (7, 8, 40)] == ['tiled', 'wide', 'wide']
    assert [plan(2, K, (64,) * 2)['route'] for K in (32, 33, 200)] == ['tiled', 'wide', 'wide']
    assert plan(3, 8, (80, 65, 70))['grid'] == (3, 9, 80) and plan(3, 8, (80, 65, 70), 3)['grid'] == (3, 9, 240)
    assert plan(3, 8, (80, 65, 70), 3, True)['grid'] == (3, 9, 80) and plan(2, 33, (100, 65))['grid'] == (3, 13, 1)
    with pytest.raises(ValueError):
        plan(3, 0, (64,) * 3)

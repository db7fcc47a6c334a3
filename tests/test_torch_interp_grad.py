"""The gradient of the port's window interpolation (K6 / K7 and their
backward, `ops/interp.py::_WindowInterp`) against `jax.grad` of the JAX
package's window sum (`phiflow_tpu/math/_nd.py::shift_window_interp`, its
`fori_loop` route on the CPU). On the CPU the backward is the twin's VJP;
`_grad_kernel_model` below is a line-by-line numpy model of the CUDA
backward kernel (`csrc/interp.cu::window_interp_grad_kernel`: its tap
selection, JAX's slopes at the kinks, the extrema chain's tie shares and
the halo's resolution of the atomic sums), held against the twin here.

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


def _grad_kernel_model(grid, disps, K, extrema, scale, mode, const, g_out, g_lo, g_up):
    """`window_interp_grad_kernel` cell by cell in float32: per axis the
    candidate taps floor(δ) − 1 … floor(δ) + 2 inside [−K, K] with a weight
    or a slope; corners in mixed radix 3, axis 0 fastest; atomic sums into
    the grid's raw shape (`mode` None: padded, shift −K, edge)."""
    f32 = np.float32
    d = len(disps)
    out_shape = disps[0].shape
    shift = -K if mode is None else 0
    rmode = 'edge' if mode is None else mode
    d_grid = np.zeros_like(grid)
    d_disp = [np.zeros(out_shape, f32) for _ in range(d)]
    kf = f32(K)
    for o in itertools.product(*[range(n) for n in out_shape]):
        taps = []
        dclip = []
        for e in range(d):
            x = f32(f32(scale[e]) * disps[e][o])
            m = max(x, -kf)
            delta = min(m, kf)
            dclip.append(_above(x, -kf) * _above(kf, m))
            f = int(np.floor(delta))
            axis_taps = []
            for j in range(4):
                s = f - 1 + j
                t = f32(delta - f32(s))
                dist = t if t >= 0 else -t
                one_m = f32(1) - dist
                if s < -K or s > K or one_m < 0:
                    continue
                axis_taps.append((f32(max(0.0, one_m)), -(1.0 if one_m > 0 else 0.5) * (1.0 if t >= 0 else -1.0),
                                  o[e] + s))
            taps.append(axis_taps)
        gd = [0.0] * d
        hits = []
        for c in range(3 ** d):
            j = [(c // 3 ** e) % 3 for e in range(d)]
            if any(j[e] >= len(taps[e]) for e in range(d)):
                continue
            w = [taps[e][j[e]][0] for e in range(d)]
            W = f32(np.prod(w, dtype=f32))
            dfac = [taps[a][j[a]][1] * np.prod([w[e] for e in range(d) if e != a]) for a in range(d)]
            if W == 0 and all(df == 0 for df in dfac):
                continue
            idx, outside = [], False
            for e in range(d):
                r, out = _resolve(taps[e][j[e]][2] - shift, grid.shape[e], rmode)
                idx.append(r)
                outside = outside or out
            v = const if outside else grid[tuple(idx)]
            if W != 0:
                if not outside:
                    d_grid[tuple(idx)] += g_out[o] * W
                hits.append((v, tuple(idx), outside))
            for a in range(d):
                gd[a] += v * dfac[a]
        for a in range(d):
            d_disp[a][o] = g_out[o] * scale[a] * dclip[a] * gd[a]
        if extrema and hits:
            pre_lo, pre_up, m_lo, m_up = [], [], 3.4e38, -3.4e38
            for v, _, _ in hits:
                pre_lo.append(m_lo)
                pre_up.append(m_up)
                m_lo, m_up = min(m_lo, v), max(m_up, v)
            G_lo, G_up = g_lo[o], g_up[o]
            for i in reversed(range(len(hits))):
                s_lo, s_up = G_lo * _above(pre_lo[i], hits[i][0]), G_up * _above(hits[i][0], pre_up[i])
                G_lo, G_up = G_lo - s_lo, G_up - s_up
                if not hits[i][2]:
                    d_grid[hits[i][1]] += s_lo + s_up
    return d_grid, d_disp


@pytest.mark.parametrize('d,K,mode,extrema', [(2, 1, 'const', True), (2, 2, 'wrap', True), (2, 2, None, False),
                                               (3, 1, 'edge', True), (3, 2, 'const', False), (3, 1, None, True)])
def test_backward_kernel_model_matches_twin(d, K, mode, extrema):
    rng = np.random.default_rng(20 + 5 * d + K)
    shape = (4, 5, 3)[:d] if d == 3 else (5, 6)
    gshape = tuple(n + 2 * K for n in shape) if mode is None else shape
    grid = np.round(rng.standard_normal(gshape) * 2).astype(np.float32) / 2  # ties in the extrema chain
    scale = (1.0, -1.0, 0.5)[:d]
    disps = _displacements(rng, shape, K, scale)
    ups = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    const = 0.25
    ref_grid, ref_disp = TI._window_interp_vjp_plain(
        torch.tensor(grid), [torch.tensor(x) for x in disps], K, extrema, tuple(TI._f32(s) for s in scale), mode,
        const, [torch.tensor(u) for u in (ups if extrema else ups[:1])], True, True)
    got_grid, got_disp = _grad_kernel_model(grid, disps, K, extrema, scale, mode, np.float32(const), *ups)
    for got, ref in zip([got_grid, *got_disp], [ref_grid, *ref_disp]):
        ref = ref.numpy()
        assert np.abs(got - ref).max() <= TOL * max(np.abs(ref).max(), 1e-6)

"""Fused 3D advection — port of `phiflow_tpu/ops/advect3d.py`.

Semi-Lagrangian interpolation of the smoke step with the displacements built
from the raw staggered (MAC) velocity arrays: at an output point of component
d (logical index ξ),

  δ_d(ξ) = P_d[ξ]                                (own faces — alias)
  δ_e(ξ) = ¼ Σ_{a∈{−1,0}} Σ_{b∈{0,1}} P_e[ξ + a·ê_d + b·ê_e]   (e ≠ d)

and at a cell-centred output point δ_e(ξ) = ½ (P_e[ξ] + P_e[ξ + ê_e]).

Every array lives on a common LOGICAL (N+1)³ face/cell grid: a component's
logical index along its own axis is its face index, a cell axis' is the cell
index. A `Source` is a raw array plus how it extends past its extent: a
constant (the closed box's velocity), its edge value (zero-gradient smoke) or
a wrap (periodic). The closed box's component d holds the interior faces
1..N−1 (N−1 entries on axis d, logical = raw + 1); a periodic one holds faces
0..N−1 (logical = raw). This replaces the TPU slab staging (`stage_slab*`):
the CUDA kernel resolves boundaries by index and reads the raw arrays.

`fused_advect_3d` computes every `OutSpec` of a call: on CUDA in one launch
of K5 (`csrc/advect3d.cu`, tiled by `advect_plan`; a lift plane is one more
small pass, and a fix kernel that returns at once unless an advected source
holds a NaN or an infinity follows every launch), on the CPU by `_fused_advect_plain` — the TPU kernel's window
sum (tent weights over the (2K+1)³ window, extrema over the taps with
|δ−s| < 1) written with tensor slices.

Outputs have their exact shapes: N³ for a centred output; a staggered output
d has its source's extent on axis d, and its row a is face a+1 (the closed
box's interior faces 1..N−1; for a periodic component faces 1..N, which the
caller rolls by one).

K5 is forward-only, as the TPU kernel is: on CUDA the wrapper raises when
grad mode is on and an input requires grad (`_build.refuse_grad`), and a
differentiated smoke step takes the per-phase path instead
(`models/smoke.py`).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

__all__ = ['Source', 'OutSpec', 'fused_advect_3d']

class Source(NamedTuple):
    """An array the fused call reads: a velocity component (indices 0..2 of the
    source list, own_axis = its axis) or an advected array.

    mode: what the array holds past its raw extent — 'const' (the value
    `const`), 'edge' (its nearest edge value) or 'wrap' (periodic)."""
    values: torch.Tensor
    own_axis: Optional[int] = None
    mode: str = 'const'
    const: float = 0.0


class OutSpec(NamedTuple):
    """One advected output of the fused call.

    slab:    index of the source to interpolate.
    d_own:   staggered component axis (0/1/2) or None for a centered field.
    negate:  flip the displacement sign (MacCormack backward pass).
    extrema: also emit the min/max over the interpolation corners (MacCormack clamp).
    combine: optional (field_idx, lo_idx, up_idx, strength) indices into the
             blocked extras — the value w becomes
             clip(center + strength·0.5·(field − w), lo, up), where `center`
             is the interpolated source at the output point itself.
    add_blocked: optional (extra_idx, scale) — val += scale·extra.
    add_ball: optional (cx, cy, cz, radius, rate) in cell units — soft-sphere
             source rate·clip(0.5 + (radius − dist), 0, 1) at cell centres (i+½).
    emit_lift: optional (axis, scale) — an extra output scale·½(val[k] + val[k+1])
             along `axis` (the last row pairs with the first), so that lift[a]
             pairs with face a+1 of a staggered component.
    """
    slab: int
    d_own: Optional[int] = None
    negate: bool = False
    extrema: bool = False
    combine: Optional[Tuple[int, int, int, float]] = None
    add_blocked: Optional[Tuple[int, float]] = None
    add_ball: Optional[Tuple[float, float, float, float, float]] = None
    emit_lift: Optional[Tuple[int, float]] = None


def _shift(src: Source, N, ax: int) -> int:
    """Logical − raw index along `ax`: 1 on the own axis of an interior-face array."""
    return int(src.own_axis == ax and src.values.shape[ax] == N[ax] - 1)


def _out_shape(spec: OutSpec, sources, N):
    shape = list(N)
    if spec.d_own is not None:
        shape[spec.d_own] = sources[spec.d_own].values.shape[spec.d_own]
    return tuple(shape)


def _ds(spec: OutSpec):
    return [int(spec.d_own == ax) for ax in range(3)]


def _f32(x: float) -> float:
    return float(np.float32(x))


def _group(spec: OutSpec, planes):
    return planes[0] if len(planes) == 1 else tuple(planes)


def fused_advect_3d(sources: Sequence[Source], N: Sequence[int], K: int,
                    outs: Sequence[OutSpec], scales: Sequence[float],
                    blocked_extras: Sequence[torch.Tensor] = ()):
    """Advect per `outs`. sources[0..2] MUST be the x/y/z velocity components
    (displacements are built from them); scales convert velocity units to
    cells per axis (−dt/dx); blocked_extras are float32 arrays indexed by the
    output point (shape ≥ the output's on every axis).

    Returns one entry per OutSpec: the advected array, or a tuple
    (value, lo, up[, lift]) / (value, lift) when extrema / emit_lift is set."""
    N = tuple(int(n) for n in N)
    if len(N) != 3 or len(sources) < 3:
        raise ValueError("fused_advect_3d takes a 3D grid and the three velocity components first")
    for s in sources:
        if s.mode not in _build.SRC_MODE:
            raise ValueError(f"source mode {s.mode!r} not in {tuple(_build.SRC_MODE)}")
    if not 1 <= K <= 7:
        raise ValueError(f"window K must be in [1, 7], got {K}")
    if sources[0].values.is_cuda:
        return _advect_cuda(sources, N, K, outs, scales, blocked_extras)
    return _fused_advect_plain(sources, N, K, outs, scales, blocked_extras)


# ---------------------------------------------------------------------------
# plain PyTorch twin
# ---------------------------------------------------------------------------

def _logical(src: Source, N, H: int) -> torch.Tensor:
    """The source on logical indices [−H, N+H] per axis."""
    v = src.values.float()
    valid = []
    for ax in range(3):
        n = v.shape[ax]
        r = torch.arange(-H, N[ax] + 1 + H, device=v.device) - _shift(src, N, ax)
        if src.mode == 'wrap':
            ok, r = None, r % n
        else:
            ok = (r >= 0) & (r < n) if src.mode == 'const' else None
            r = r.clamp(0, n - 1)
        v = v.index_select(ax, r)
        valid.append(ok)
    if src.mode == 'const':
        mask = valid[0][:, None, None] & valid[1][None, :, None] & valid[2][None, None, :]
        v = torch.where(mask, v, torch.tensor(_f32(src.const), device=v.device))
    return v


def _fused_advect_plain(sources, N, K, outs, scales, blocked_extras):
    H = K + 1
    logical = {}

    def arr(i):
        if i not in logical:
            logical[i] = _logical(sources[i], N, H)
        return logical[i]

    results = []
    for spec in outs:
        O = _out_shape(spec, sources, N)
        ds = _ds(spec)

        def tap(i, off):
            a = arr(i)
            lo = [H + ds[ax] + off[ax] for ax in range(3)]
            return a[lo[0]:lo[0] + O[0], lo[1]:lo[1] + O[1], lo[2]:lo[2] + O[2]]

        d = spec.d_own
        planes = []
        for e in range(3):
            if d is not None and e == d:
                planes.append(tap(e, (0, 0, 0)))
            elif d is not None:
                acc = None
                for b in (0, 1):
                    for a in (-1, 0):
                        off = [0, 0, 0]
                        off[d] += a
                        off[e] += b
                        v = tap(e, off)
                        acc = v if acc is None else acc + v
                planes.append(acc * 0.25)
            else:
                off = [0, 0, 0]
                off[e] = 1
                planes.append((tap(e, (0, 0, 0)) + tap(e, off)) * 0.5)
        sgn = -1.0 if spec.negate else 1.0
        disp = [torch.clamp(_f32(sgn * scales[e]) * planes[e], -float(K), float(K)) for e in range(3)]
        W = 2 * K + 1
        wts = [[torch.clamp(1. - torch.abs(disp[e] - (i - K)), min=0.) for i in range(W)] for e in range(3)]
        if spec.extrema:
            cms = [[torch.abs(disp[e] - (i - K)) < 1. for i in range(W)] for e in range(3)]
            big = torch.tensor(3.4e38, dtype=torch.float32, device=disp[0].device)
            lo_acc = torch.full(O, 3.4e38, dtype=torch.float32, device=disp[0].device)
            up_acc = torch.full(O, -3.4e38, dtype=torch.float32, device=disp[0].device)
        acc = torch.zeros(O, dtype=torch.float32, device=disp[0].device)
        for iy in range(W):
            z_acc = torch.zeros_like(acc)
            for iz in range(W):
                x_acc = torch.zeros_like(acc)
                for ix in range(W):
                    window = tap(spec.slab, (ix - K, iy - K, iz - K))
                    x_acc = x_acc + window * wts[0][ix]
                    if spec.extrema:
                        cm = cms[1][iy] & cms[2][iz] & cms[0][ix]
                        lo_acc = torch.minimum(lo_acc, torch.where(cm, window, big))
                        up_acc = torch.maximum(up_acc, torch.where(cm, window, -big))
                z_acc = z_acc + x_acc * wts[2][iz]
            acc = acc + z_acc * wts[1][iy]
        val = acc
        if spec.combine is not None:
            f_idx, lo_idx, up_idx, strength = spec.combine
            center = tap(spec.slab, (0, 0, 0))
            ext = [blocked_extras[i][:O[0], :O[1], :O[2]].float() for i in (f_idx, lo_idx, up_idx)]
            corrected = center + _f32(0.5 * strength) * (ext[0] - val)
            val = torch.minimum(torch.maximum(corrected, ext[1]), ext[2])
        if spec.add_blocked is not None:
            extra_idx, scale = spec.add_blocked
            val = val + _f32(scale) * blocked_extras[extra_idx][:O[0], :O[1], :O[2]].float()
        if spec.add_ball is not None:
            cx, cy, cz, radius, rate = spec.add_ball
            g = [torch.arange(O[ax], dtype=torch.float32, device=val.device) + 0.5 for ax in range(3)]
            dist = torch.sqrt((g[0][:, None, None] - _f32(cx)) ** 2 + (g[1][None, :, None] - _f32(cy)) ** 2
                              + (g[2][None, None, :] - _f32(cz)) ** 2)
            frac = torch.clamp(0.5 + (_f32(radius) - dist), 0., 1.)
            val = val + _f32(rate) * frac
        planes_out = [val]
        if spec.extrema:
            planes_out += [lo_acc, up_acc]
        if spec.emit_lift is not None:
            axis, scale = spec.emit_lift
            planes_out.append(_f32(0.5 * scale) * (val + torch.roll(val, -1, axis)))
        results.append(_group(spec, planes_out))
    return results


# ---------------------------------------------------------------------------
# K5 on CUDA
# ---------------------------------------------------------------------------

ADV_TZ = 32               # K5's tile extent along z (csrc/advect3d.cu)
MAX_SOURCES, MAX_OUTS = 5, 4
SMEM_LIMIT = _build.SMEM_LIMIT
# (x, y) tile extents in order of preference: the largest whose staged arrays
# leave room for two blocks a SM, else the largest that fits one
_TILES = ((8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2), (1, 1))


def advect_plan(out_shapes: Sequence[Sequence[int]], K: int, n_sources: int, slabs: Sequence[int]):
    """Tiles of one K5 launch. A block owns t0 × t1 × 32 output points of the
    union of the outputs' shapes and stages in shared memory each source it
    reads: an advected source (a slab) over [o − K, o + t + K + 1] per axis,
    a velocity source read only for displacements over [o, o + t], the z
    range widened to whole groups of 4 (16-byte copies), each with three
    tables of resolved indices. Returns dict(tile, staged, smem, grid):
    `staged` maps a source to (offset, table offset, lower halos, extents);
    the kernel checks `smem` against the extents it is given."""
    if n_sources > MAX_SOURCES or not 1 <= len(out_shapes) <= MAX_OUTS:
        raise ValueError(f"K5 takes at most {MAX_SOURCES} sources and 1..{MAX_OUTS} outputs a call, got "
                         f"{n_sources} and {len(out_shapes)}")
    union = tuple(max(int(s[a]) for s in out_shapes) for a in range(3))
    slabs = set(slabs)
    read = [i for i in range(n_sources) if i < 3 or i in slabs]

    def layout(T, group):
        staged, off, tab = {}, 0, 0
        for i in read:
            lo, hi = (K, K + 2) if i in slabs else (0, 1)
            lo_z, hi_z = -(-lo // group) * group, -(-hi // group) * group
            e = (T[0] + lo + hi, T[1] + lo + hi, T[2] + lo_z + hi_z)
            staged[i] = (off, tab, (lo, lo, lo_z), e)
            off += e[0] * e[1] * e[2]
            tab += sum(e)
        return staged, 4 * (off + tab)

    # z widened to whole groups of 4 where a tile fits that way; a wide window with many slabs goes without
    fits = [(T, *layout(T, group)) for group in (4, 1) for T in ((t0, t1, ADV_TZ) for t0, t1 in _TILES)]
    fits = [f for f in fits if f[2] <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"K5: no tile fits {SMEM_LIMIT} bytes of shared memory at K={K}")
    T, staged, smem = next((f for f in fits if f[2] <= SMEM_LIMIT // 2), fits[0])
    grid = (-(-union[2] // T[2]), -(-union[1] // T[1]), -(-union[0] // T[0]))
    return dict(tile=T, staged=staged, smem=smem, grid=grid, union=union)


@functools.lru_cache(maxsize=1)
def _ctypes_args():
    import ctypes
    I, F, P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    Src = _build.src_struct()

    class Blk(ctypes.Structure):
        _fields_ = [('p', P), ('n1', I), ('n2', I)]

    class Staged(ctypes.Structure):
        _fields_ = [('off', I), ('tab', I), ('lo', I * 3), ('e', I * 3)]

    class OutArgs(ctypes.Structure):
        _fields_ = [('slab', I), ('d_own', I), ('scale', F * 3), ('extrema', I),
                    ('out', P), ('out_lo', P), ('out_up', P), ('o', I * 3),
                    ('combine', I), ('c_field', Blk), ('c_lo', Blk), ('c_up', Blk), ('c_half_strength', F),
                    ('add_blocked', I), ('add', Blk), ('add_scale', F),
                    ('add_ball', I), ('ball', F * 5)]

    class Shell(ctypes.Structure):
        _fields_ = [('c', I * 3), ('w', I * 3), ('cnt0', ctypes.c_longlong), ('cnt1', ctypes.c_longlong),
                    ('total', ctypes.c_longlong)]

    class AdvectArgs(ctypes.Structure):  # flag: _build.nonfinite_flag; tiles, fix_always, shell: set by the C entry
        _fields_ = [('src', Src * MAX_SOURCES), ('st', Staged * MAX_SOURCES), ('out', OutArgs * MAX_OUTS),
                    ('n_src', I), ('n_out', I), ('K', I), ('t', I * 2), ('log2_t1', I),
                    ('flag', P), ('tiles', I * 3), ('fix_always', I), ('shell', Shell * MAX_OUTS)]
    return Src, Blk, Staged, AdvectArgs


def _lib():
    import ctypes
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.library('advect3d', {
        'fused_advect': [P, I, I, I, I, P],
        'advect_lift': [P, P, I, I, I, I, F, I, P],
    })


def _check_f32(name, t):
    if not t.is_cuda or t.dtype != torch.float32 or t.ndim != 3 or not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous 3D float32 CUDA tensor, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _advect_cuda(sources, N, K, outs, scales, blocked_extras):
    _build.refuse_grad('fused_advect', *(s.values for s in sources), *blocked_extras)
    import ctypes
    Src, Blk, Staged, AdvectArgs = _ctypes_args()
    for i, s in enumerate(sources):
        _check_f32(f'sources[{i}]', s.values)
    for i, e in enumerate(blocked_extras):
        _check_f32(f'blocked_extras[{i}]', e)
    lib = _lib()
    device = sources[0].values.device
    stream = _build.stream_of(sources[0].values)
    shapes = [_out_shape(spec, sources, N) for spec in outs]
    plan = advect_plan(shapes, K, len(sources), [spec.slab for spec in outs])

    def blk(i, O):
        e = blocked_extras[i]
        if any(e.shape[ax] < O[ax] for ax in range(3)):
            raise ValueError(f"blocked_extras[{i}] of shape {tuple(e.shape)} is smaller than the output {O}")
        return Blk(e.data_ptr(), e.shape[1], e.shape[2])

    a = AdvectArgs()
    a.n_src, a.n_out, a.K = len(sources), len(outs), K
    a.t[0], a.t[1] = plan['tile'][:2]
    a.log2_t1 = plan['tile'][1].bit_length() - 1
    a.flag = _build.nonfinite_flag(sources[0].values)
    for i, s in enumerate(sources):
        a.src[i] = Src(s.values.data_ptr(), (ctypes.c_int * 3)(*s.values.shape),
                       (ctypes.c_int * 3)(*(_shift(s, N, ax) for ax in range(3))),
                       _build.SRC_MODE[s.mode], _f32(s.const))
        off, tab, lo, e = plan['staged'].get(i, (-1, 0, (0, 0, 0), (0, 0, 0)))
        a.st[i] = Staged(off, tab, (ctypes.c_int * 3)(*lo), (ctypes.c_int * 3)(*e))
    results = []
    for j, (spec, O) in enumerate(zip(outs, shapes)):
        sgn = -1.0 if spec.negate else 1.0
        val = torch.empty(O, dtype=torch.float32, device=device)
        planes = [val]
        o = a.out[j]
        o.slab = spec.slab
        o.d_own = -1 if spec.d_own is None else spec.d_own
        o.out = val.data_ptr()
        if spec.extrema:
            planes += [torch.empty_like(val), torch.empty_like(val)]
            o.out_lo, o.out_up = planes[1].data_ptr(), planes[2].data_ptr()
            o.extrema = 1
        for ax in range(3):
            o.o[ax] = O[ax]
            o.scale[ax] = _f32(sgn * scales[ax])
        if spec.combine is not None:
            f_idx, lo_idx, up_idx, strength = spec.combine
            o.combine = 1
            o.c_field, o.c_lo, o.c_up = blk(f_idx, O), blk(lo_idx, O), blk(up_idx, O)
            o.c_half_strength = _f32(0.5 * strength)
        if spec.add_blocked is not None:
            extra_idx, scale = spec.add_blocked
            o.add_blocked = 1
            o.add = blk(extra_idx, O)
            o.add_scale = _f32(scale)
        if spec.add_ball is not None:
            o.add_ball = 1
            for i, x in enumerate(spec.add_ball):
                o.ball[i] = _f32(x)
        results.append(planes)
    err = lib.fused_advect(ctypes.byref(a), *plan['union'], plan['smem'], stream)
    _build.check(lib, err, 'fused_advect')
    _build.LAUNCHES['fused_advect'] += 1
    for spec, O, planes in zip(outs, shapes, results):
        if spec.emit_lift is not None:
            axis, scale = spec.emit_lift
            lift = torch.empty_like(planes[0])
            err = lib.advect_lift(planes[0].data_ptr(), lift.data_ptr(), *O, int(axis), _f32(0.5 * scale),
                                  _build.block_x(O[2]), stream)
            _build.check(lib, err, 'advect_lift')
            planes.append(lift)
    return [_group(spec, planes) for spec, planes in zip(outs, results)]

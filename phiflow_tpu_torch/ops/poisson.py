"""The Poisson stencil of the pressure solve — port of `phiflow_tpu/ops/poisson.py`.

    lap(c) = Σ_d inv_dx²_d · [ a⁺_d(c)·p(c+e_d) + a⁻_d(c)·p(c−e_d) ] + c0(c)·p(c)

with per-axis/per-side boundary modes ``periodic`` (neighbour wraps),
``neumann`` (outer face flux dropped) and ``ghost0`` (ghost cell 0). Three
epilogues share the stencil: ``matvec`` (A·p), ``residual`` (b − A·p) and
``jacobi`` (p + ω/diag·(b − A·p)).

Three CUDA kernels (`csrc/poisson.cu`) carry it on the card:

* `poisson_apply` — K1, the CG matvec. ``with_dot=True`` also returns
  ⟨p, A·p⟩ from per-block partials (JAX arms a global capture box instead).
  Its masked form takes the coefficient arrays ``mA_list`` and ``c0`` that
  `stage_masks` makes from face masks (obstacles), the ``active`` cells (a
  free surface: the result is p itself where active is 0), or both.
* `poisson_smooth` — K2, damped-Jacobi sweeps, one launch per sweep;
  ``zero_init`` forms u₀ = w·b in registers, ``emit_dot`` returns ⟨u_out, b⟩.
* `residual_restrict` — K3, restrict_mean(b − A·u) without storing the fine
  residual.

Their plain twin is `_apply_plain` (`_apply_xla` of the JAX package, masks
included). A wrapper takes the twin only for tensors on the CPU; for 3D CUDA
tensors it launches its kernel or raises. Storage is float32 or bfloat16,
arithmetic float32 — the twins cast the same way; masks are float32.

The kernels are 3D, as the TPU kernels are: the JAX package computes a 2D
stencil through XLA on the TPU too (`_apply_xla`). So each wrapper decides on
dimensionality alone, before anything else: with two spatial axes
(``len(bc) == 2``) it computes with the PyTorch functions below on whatever
device the tensor lies, and with three it takes the kernel route above.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .transfer import restrict_mean

__all__ = ['poisson_apply', 'poisson_smooth', 'residual_restrict', 'stage_masks',
           'PERIODIC', 'NEUMANN', 'GHOST0']

PERIODIC, NEUMANN, GHOST0 = 'periodic', 'neumann', 'ghost0'
_MODE_CODE = {PERIODIC: 0, NEUMANN: 1, GHOST0: 2}
_EPILOGUE = {'matvec': 0, 'residual': 1, 'jacobi': 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# staging: face masks → cell-aligned coefficient arrays (once per solve)
# ---------------------------------------------------------------------------

def stage_masks(full_face_masks: Sequence[torch.Tensor], bc: Sequence[Tuple[str, str]],
                inv_dx2: Sequence[float]):
    """Stage per-axis full-face mask arrays into (mA_list, c0).

    full_face_masks[d]: the mask of every face along axis d — the cell grid's
    shape except that axis d has N+1 entries (N when periodic, where face N is
    face 0).

    Returns mA[d], the lower-face coefficient a⁻/inv per cell (plane 0 zeroed
    unless periodic; the stencil takes a⁺ as mA one cell up along d), and c0,
    the whole centre coefficient −Σ_d inv_d·(cA_d + cB_d) with the ghost0
    outer-face corrections."""
    ndim = len(bc)
    mA_list = []
    c0 = None
    for d, (F, (lo, hi), inv) in enumerate(zip(full_face_masks, bc, inv_dx2)):
        ax = F.ndim - ndim + d
        n_faces = F.shape[ax]
        if (lo, hi) == (PERIODIC, PERIODIC):
            mA = cA = F
            cB = torch.roll(F, -1, ax)
        else:
            N = n_faces - 1
            face_lo, face_hi = F.narrow(ax, 0, 1), F.narrow(ax, N, 1)
            zero_plane = torch.zeros_like(face_lo)
            interior = F.narrow(ax, 1, N - 1)  # faces 1..N−1: cell c's lower face for c ≥ 1, upper for c ≤ N−2
            # a⁻ per cell: face c, but the outer face 0 belongs to c0 (ghost), not a⁻
            mA = torch.cat([zero_plane, interior], dim=ax)
            cA = torch.cat([face_lo if lo == GHOST0 else zero_plane, interior], dim=ax)
            cB = torch.cat([interior, face_hi if hi == GHOST0 else zero_plane], dim=ax)
        mA_list.append(mA * 1.0)
        term = (cA + cB) * float(np.float32(inv))
        c0 = term if c0 is None else c0 + term
    return mA_list, -c0


# ---------------------------------------------------------------------------
# plain PyTorch twin (CPU path; the kernels' oracle on the card)
# ---------------------------------------------------------------------------

def _unmasked_coeffs_1d(n, lo, hi, dtype):
    """(a⁻, a⁺, c0) 1-axis profiles (length n) for the unmasked operator, /inv."""
    am = np.ones(n, np.float64)
    ap = np.ones(n, np.float64)
    c0 = np.full(n, -2.0, np.float64)
    if lo != PERIODIC:
        am[0] = 0.0
        c0[0] = -(1.0 + (1.0 if lo == GHOST0 else 0.0))
    if hi != PERIODIC:
        ap[n - 1] = 0.0
        c0[n - 1] = -(1.0 + (1.0 if hi == GHOST0 else 0.0))
    return am.astype(dtype), ap.astype(dtype), c0.astype(dtype)


@functools.lru_cache(maxsize=256)
def _unmasked_profiles(n, lo, hi, inv, trailing, device, dtype):
    """(a⁻, a⁺, c0·inv) of one axis as tensors on `device`, shaped to
    broadcast over `trailing` later axes. Cached: the stencil is applied
    hundreds of times a step with the same few (size, modes, device, dtype),
    and building the profiles anew is a host-to-device copy each time."""
    am, ap, c0 = (torch.from_numpy(a).to(device, dtype).reshape((n,) + (1,) * trailing)
                  for a in _unmasked_coeffs_1d(n, lo, hi, np.float32))
    return am, ap, c0 * inv


def _lap_plain(p, inv_dx2, bc, mA_list, c0):
    """A·p via torch.roll; p: (..., *spatial) with len(bc) trailing spatial axes."""
    ndim = len(bc)
    lap = None
    c0_eff = c0
    for d, ((lo, hi), inv) in enumerate(zip(bc, inv_dx2)):
        ax = p.ndim - ndim + d
        pm = torch.roll(p, 1, ax)
        pp = torch.roll(p, -1, ax)
        if mA_list is not None:
            mA = mA_list[d]
            max_ = mA.ndim - ndim + d
            term = mA * pm + torch.roll(mA, -1, max_) * pp
        else:
            am, ap, c0_term = _unmasked_profiles(p.shape[ax], lo, hi, float(np.float32(inv)), ndim - d - 1,
                                                 p.device, p.dtype)
            term = am * pm + ap * pp
            c0_eff = c0_term if c0_eff is None else c0_eff + c0_term
        term = term * float(np.float32(inv))
        lap = term if lap is None else lap + term
    return lap + c0_eff * p


def _apply_plain(p, inv_dx2, bc, mA_list, c0, active, b, mode, omega_over_diag):
    lap = _lap_plain(p, inv_dx2, bc, mA_list, c0)
    if mode == 'matvec':
        out = lap
    elif mode == 'residual':
        out = b - lap
    elif mode == 'jacobi':
        out = p + float(np.float32(omega_over_diag)) * (b - lap)
    else:
        raise ValueError(mode)
    if active is not None:
        out = torch.where(active != 0, out, p)
    return out


# ---------------------------------------------------------------------------
# CUDA launch plumbing
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _ctypes_grid():
    import ctypes

    class Grid(ctypes.Structure):
        _fields_ = [('n', ctypes.c_int * 3), ('inv', ctypes.c_float * 3),
                    ('lo', ctypes.c_int * 3), ('hi', ctypes.c_int * 3)]
    return Grid


def _lib():
    import ctypes
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.library('poisson', {
        'poisson_stencil': [P, I, P, I, P, P, P, P, P, P, P, P, I, F, I, P],
        'jacobi_sweep': [P, I, P, I, P, I, P, P, F, I, I, P],
        'residual_restrict': [P, I, P, I, P, P, I, P],
    })


def _grid(shape, inv_dx2, bc):
    Grid = _ctypes_grid()
    g = Grid()
    for ax in range(3):
        g.n[ax] = int(shape[ax])
        g.inv[ax] = float(np.float32(inv_dx2[ax]))
        g.lo[ax] = _MODE_CODE[bc[ax][0]]
        g.hi[ax] = _MODE_CODE[bc[ax][1]]
    return g


def _check_field(name, t, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, got {t.dtype}")
    if t.ndim != 3:
        raise ValueError(f"{name}: the kernel takes one 3D field, got shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")


def _check_bc(bc):
    if len(bc) != 3 or any(lo not in _MODE_CODE or hi not in _MODE_CODE for lo, hi in bc):
        raise ValueError(f"bc: three (lower, upper) pairs of {tuple(_MODE_CODE)} expected, got {bc}")


def _partials(shape, device):
    X, Y, Z = shape
    bx = _build.block_x(Z)
    return torch.empty(X * Y * ((Z + bx - 1) // bx), dtype=torch.float32, device=device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# K1: the CG matvec (and the residual / single Jacobi sweep epilogues)
# ---------------------------------------------------------------------------

def poisson_apply(p: torch.Tensor, inv_dx2: Sequence[float], bc: Sequence[Tuple[str, str]],
                  mA_list: Optional[Sequence[torch.Tensor]] = None,
                  c0: Optional[torch.Tensor] = None,
                  active: Optional[torch.Tensor] = None,
                  b: Optional[torch.Tensor] = None,
                  mode: str = 'matvec',
                  omega_over_diag: Optional[float] = None,
                  with_dot: bool = False):
    """Apply the (masked) Poisson stencil. p: (*batch, *spatial) with len(bc)
    trailing spatial axes. modes: 'matvec' → A·p | 'residual' → b − A·p |
    'jacobi' → p + ω/diag·(b − A·p). The result has p's dtype. With
    ``with_dot`` returns (result, ⟨p, result⟩) — the CG denominator ⟨p, A·p⟩.

    ``mA_list`` and ``c0`` (both or neither) are the coefficient arrays of
    `stage_masks`; where ``active`` is 0 the result is p itself.

    Two spatial axes: PyTorch operations on any device (module docstring). On
    CUDA in 3D: one field, masks of its shape or broadcastable to it."""
    if mode not in _EPILOGUE:
        raise ValueError(mode)
    if len(bc) == 2:
        return _poisson_apply_plain(p, inv_dx2, bc, mA_list, c0, active, b, mode, omega_over_diag, with_dot)
    if (mA_list is None) != (c0 is None):
        raise ValueError("mA_list and c0 come together (both from stage_masks) or not at all")
    if p.is_cuda:
        return _stencil_cuda(p, inv_dx2, bc, mA_list, c0, active, b, mode, omega_over_diag, with_dot)
    return _poisson_apply_plain(p, inv_dx2, bc, mA_list, c0, active, b, mode, omega_over_diag, with_dot)


def _poisson_apply_plain(p, inv_dx2, bc, mA_list=None, c0=None, active=None, b=None, mode='matvec',
                         omega_over_diag=None, with_dot=False):
    """`poisson_apply` through the twin, on any device."""
    pf = p.float()
    out = _apply_plain(pf, inv_dx2, bc, mA_list, c0, active,
                       None if b is None else b.float(), mode, omega_over_diag)
    dot = torch.sum(pf * out) if with_dot else None
    out = out.to(p.dtype)
    return (out, dot) if with_dot else out


def _mask_field(name, m, like):
    """A mask as a contiguous float32 tensor of the field's shape."""
    if m.device != like.device:
        raise ValueError(f"{name}: on {m.device}, the field on {like.device}")
    try:
        return m.to(torch.float32).expand(like.shape).contiguous()
    except RuntimeError:
        raise ValueError(f"{name}: shape {tuple(m.shape)} does not broadcast to {tuple(like.shape)}") from None


def _stencil_cuda(p, inv_dx2, bc, mA_list, c0, active, b, mode, omega_over_diag, with_dot):
    _check_bc(bc)
    _check_field('p', p)
    masks = [None] * 5
    if mA_list is not None:
        if len(mA_list) != 3:
            raise ValueError(f"mA_list: three arrays expected, got {len(mA_list)}")
        masks[:4] = [_mask_field(f'mA_list[{d}]', m, p) for d, m in enumerate(mA_list)] + [_mask_field('c0', c0, p)]
    if active is not None:
        masks[4] = _mask_field('active', active, p)
    if mode != 'matvec':
        if b is None:
            raise ValueError(f"mode {mode!r} needs b")
        _check_field('b', b, p.shape)
    if mode == 'jacobi' and omega_over_diag is None:
        raise ValueError("mode 'jacobi' needs omega_over_diag")
    import ctypes
    lib = _lib()
    out = torch.empty_like(p)
    partials = _partials(p.shape, p.device) if with_dot else None
    g = _grid(p.shape, inv_dx2, bc)
    err = lib.poisson_stencil(p.data_ptr(), _DTYPE_CODE[p.dtype], _ptr(b if mode != 'matvec' else None),
                              _DTYPE_CODE[b.dtype] if (b is not None and mode != 'matvec') else 0,
                              *(_ptr(m) for m in masks),
                              out.data_ptr(), _ptr(partials), ctypes.byref(g), _EPILOGUE[mode],
                              float(np.float32(omega_over_diag or 0.0)), _build.block_x(p.shape[2]),
                              _build.stream_of(p))
    _build.check(lib, err, 'poisson_stencil')
    _build.LAUNCHES['poisson_stencil'] += 1
    if any(m is not None for m in masks):
        _build.LAUNCHES['poisson_stencil_masked'] += 1  # the masked form's share of the count above
    if with_dot:
        return out, partials.sum()
    return out


# ---------------------------------------------------------------------------
# K2: damped-Jacobi sweeps — the V-cycle smoother
# ---------------------------------------------------------------------------

def poisson_smooth(u: Optional[torch.Tensor], b: torch.Tensor,
                   inv_dx2: Sequence[float], bc: Sequence[Tuple[str, str]],
                   omega_over_diag: float, sweeps: int, zero_init: bool = False,
                   out_dtype: Optional[torch.dtype] = None, emit_dot: bool = False):
    """``sweeps`` damped-Jacobi sweeps u ← u + w·(b − A·u) of the unmasked
    operator. ``zero_init`` starts from u = 0 (u may be None), so the first
    sweep is u₀ = w·b. Intermediate sweeps stay float32; the result is stored
    in ``out_dtype`` (default: u's dtype, b's with ``zero_init``). With
    ``emit_dot`` returns (u_out, ⟨u_out, b⟩) — the CG's ⟨z, r⟩ when this is
    the V-cycle's last fine post-smooth.

    Two spatial axes: PyTorch operations on any device. On CUDA in 3D one
    kernel launch per sweep; the zero-init sweep rides in the first launch, so
    a zero-init triple is two launches and sweeps must be ≥ 2."""
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    if u is None and not zero_init:
        raise ValueError("u is None: pass zero_init=True")
    out_dtype = out_dtype or (b.dtype if zero_init else u.dtype)
    if b.is_cuda and len(bc) != 2:
        return _smooth_cuda(u, b, inv_dx2, bc, omega_over_diag, sweeps, zero_init, out_dtype, emit_dot)
    return _poisson_smooth_plain(u, b, inv_dx2, bc, omega_over_diag, sweeps, zero_init, out_dtype, emit_dot)


def _poisson_smooth_plain(u, b, inv_dx2, bc, omega_over_diag, sweeps, zero_init, out_dtype, emit_dot):
    """`poisson_smooth` through the twin, on any device (out_dtype resolved)."""
    w = float(np.float32(omega_over_diag))
    bf = b.float()
    if zero_init:
        uf, remaining = w * bf, sweeps - 1
    else:
        uf, remaining = u.float(), sweeps
    for _ in range(remaining):
        uf = _apply_plain(uf, inv_dx2, bc, None, None, None, bf, 'jacobi', omega_over_diag)
    dot = torch.sum(uf * bf) if emit_dot else None
    out = uf.to(out_dtype)
    return (out, dot) if emit_dot else out


def _smooth_cuda(u, b, inv_dx2, bc, omega_over_diag, sweeps, zero_init, out_dtype, emit_dot):
    _check_bc(bc)
    _check_field('b', b)
    if not zero_init:
        _check_field('u', u, b.shape)
    elif sweeps < 2:
        raise ValueError("on CUDA a zero-init smooth needs sweeps >= 2 (u0 = w·b rides in the first launch)")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    import ctypes
    lib = _lib()
    g = _grid(b.shape, inv_dx2, bc)
    w = float(np.float32(omega_over_diag))
    bx = _build.block_x(b.shape[2])
    stream = _build.stream_of(b)
    launches = sweeps - 1 if zero_init else sweeps
    cur = u
    partials = None
    for s in range(launches):
        last = s == launches - 1
        out = torch.empty(b.shape, dtype=out_dtype if last else torch.float32, device=b.device)
        partials = _partials(b.shape, b.device) if (last and emit_dot) else None
        first_zero = zero_init and s == 0
        err = lib.jacobi_sweep(None if first_zero else cur.data_ptr(),
                               0 if first_zero else _DTYPE_CODE[cur.dtype],
                               b.data_ptr(), _DTYPE_CODE[b.dtype], out.data_ptr(), _DTYPE_CODE[out.dtype],
                               _ptr(partials), ctypes.byref(g), w, int(first_zero), bx, stream)
        _build.check(lib, err, 'jacobi_sweep')
        _build.LAUNCHES['jacobi_sweeps'] += 1
        cur = out
    if emit_dot:
        return cur, partials.sum()
    return cur


# ---------------------------------------------------------------------------
# K3: fused residual + 2× restriction — the V-cycle's downward transfer
# ---------------------------------------------------------------------------

def residual_restrict(u: torch.Tensor, b: torch.Tensor, inv_dx2: Sequence[float],
                      bc: Sequence[Tuple[str, str]]) -> torch.Tensor:
    """restrict_mean(b − A·u) over the spatial axes, in u's dtype. u, b:
    (X, Y, Z) or (X, Y) with even sizes; the 2D form is PyTorch operations on
    any device."""
    if u.is_cuda and len(bc) != 2:
        _check_bc(bc)
        _check_field('u', u)
        _check_field('b', b, u.shape)
        if any(n % 2 for n in u.shape):
            raise ValueError(f"residual_restrict needs even sizes, got {tuple(u.shape)}")
        import ctypes
        lib = _lib()
        out = torch.empty(tuple(n // 2 for n in u.shape), dtype=u.dtype, device=u.device)
        g = _grid(u.shape, inv_dx2, bc)
        err = lib.residual_restrict(u.data_ptr(), _DTYPE_CODE[u.dtype], b.data_ptr(), _DTYPE_CODE[b.dtype],
                                    out.data_ptr(), ctypes.byref(g), _build.block_x(u.shape[2] // 2),
                                    _build.stream_of(u))
        _build.check(lib, err, 'residual_restrict')
        _build.LAUNCHES['residual_restrict'] += 1
        return out
    return _residual_restrict_plain(u, b, inv_dx2, bc)


def _residual_restrict_plain(u, b, inv_dx2, bc):
    """`residual_restrict` through the twin, on any device."""
    r = _apply_plain(u.float(), inv_dx2, bc, None, None, None, b.float(), 'residual', None)
    return restrict_mean(r, len(bc)).to(u.dtype)

"""The Poisson stencil of the pressure solve — port of `phiflow_tpu/ops/poisson.py`.

    lap(c) = Σ_d inv_dx²_d · [ a⁺_d(c)·p(c+e_d) + a⁻_d(c)·p(c−e_d) ] + c0(c)·p(c)

with per-axis/per-side boundary modes ``periodic`` (neighbour wraps),
``neumann`` (outer face flux dropped) and ``ghost0`` (ghost cell 0). Three
epilogues share the stencil: ``matvec`` (A·p), ``residual`` (b − A·p) and
``jacobi`` (p + ω/diag·(b − A·p)).

Three CUDA kernels (`csrc/poisson.cu`) carry it on the card:

* `poisson_apply` — K1, the CG matvec. ``with_dot=True`` also returns
  ⟨p, A·p⟩ from per-block partials (JAX arms a global capture box instead).
  It marches runs of cells along x (`stencil_plan`) in the unmasked form and
  in the masked one (K1m), which takes the coefficient arrays ``mA_list`` and
  ``c0`` that `stage_masks` makes from face masks (obstacles), the
  ``active`` cells (a free surface: the result is p itself where active is
  0), or both.
* `poisson_smooth` — K2, damped-Jacobi sweeps, one launch for up to three
  (`smooth_plan`); ``zero_init`` forms u₀ = w·b from the staged b,
  ``emit_dot`` returns ⟨u_out, b⟩.
* `residual_restrict` — K3, restrict_mean(b − A·u) without storing the fine
  residual, marching runs of coarse cells along x (`restrict_plan`).

Their plain twin is `_apply_plain` (`_apply_xla` of the JAX package, masks
included). A wrapper takes the twin only for tensors on the CPU; for 3D CUDA
tensors it launches its kernel or raises. Storage is float32 or bfloat16,
arithmetic float32 — the twins cast the same way; masks are float32.

Batches: a field may carry leading batch axes, (*batch, X, Y, Z), each entry
an independent system; on CUDA the wrappers of K1–K3 launch once for the
whole batch (the kernels fold the entry into their grid), a dot comes out one
per entry, of the batch's shape, and the twins compute the same over the
leading axes. K1's masked forms take one field.

The kernels are 3D, as the TPU kernels are: the JAX package computes a 2D
stencil through XLA on the TPU too (`_apply_xla`). So each wrapper decides on
dimensionality alone, before anything else: with two spatial axes
(``len(bc) == 2``) it computes with the PyTorch functions below on whatever
device the tensor lies, and with three it takes the kernel route above.

None of the three kernels has a backward. Their wrappers raise on CUDA when
grad mode is on and an input requires grad (`_build.refuse_grad`); a solve
is differentiated implicitly instead (`math/_solve.py::implicit_solve`: its
forward and its adjoint run these kernels under `no_grad`).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .transfer import restrict_mean

__all__ = ['poisson_apply', 'poisson_smooth', 'residual_restrict', 'stage_masks', 'stencil_plan',
           'restrict_plan', 'PERIODIC', 'NEUMANN', 'GHOST0']

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


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """The twins' arithmetic type: float32, or float64 for a float64 field (on the CPU)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _coeff(inv, dtype) -> float:
    """A coefficient as the kernel's float32, or exact for float64 arithmetic."""
    return float(inv) if dtype == torch.float64 else float(np.float32(inv))


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
            am, ap, c0_term = _unmasked_profiles(p.shape[ax], lo, hi, _coeff(inv, p.dtype), ndim - d - 1,
                                                 p.device, p.dtype)
            term = am * pm + ap * pp
            c0_eff = c0_term if c0_eff is None else c0_eff + c0_term
        term = term * _coeff(inv, p.dtype)
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
                    ('lo', ctypes.c_int * 3), ('hi', ctypes.c_int * 3), ('nb', ctypes.c_int)]
    return Grid


def _lib():
    import ctypes
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.library('poisson', {
        'stencil': [P, I, P, I, P, P, P, P, P, P, P, P, I, F, I, I, I, I, I, P],
        'jacobi_smooth': [P, I, P, I, P, I, P, P, F, I, I, I, I, I, P],
        'residual_restrict': [P, I, P, I, P, P, I, I, I, I, I, P],
    })


def _grid(shape, inv_dx2, bc, nb=1):
    """The kernels' `Grid`: the spatial `shape` of each of `nb` entries."""
    Grid = _ctypes_grid()
    g = Grid()
    g.nb = int(nb)
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
    if t.ndim < 3:
        raise ValueError(f"{name}: the kernel takes 3D fields with leading batch axes, got shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")


def _check_bc(bc):
    if len(bc) != 3 or any(lo not in _MODE_CODE or hi not in _MODE_CODE for lo, hi in bc):
        raise ValueError(f"bc: three (lower, upper) pairs of {tuple(_MODE_CODE)} expected, got {bc}")


def _n_entries(t: torch.Tensor) -> int:
    """The entries of a field's leading batch axes (1 without any)."""
    return int(np.prod(t.shape[:-3], dtype=np.int64))


def per_entry(fn, nb: int, *xs: torch.Tensor) -> torch.Tensor:
    """`fn` of each system of the `nb` leading axes of `xs`, stacked: shape
    ``xs[0].shape[:nb] + fn's``. A system of a batch is computed from its own
    tensors, as an unbatched one is, so that it gets its own solve's numbers
    bit for bit (a reduction of the batch at once sums in another order).
    The one place where a solve's per-system reductions and the V-cycle's
    coarse product take a batch; ``nb == 0`` is ``fn(*xs)``."""
    if nb == 0:
        return fn(*xs)
    lead = tuple(xs[0].shape[:nb])
    out = torch.stack([fn(*e) for e in zip(*(x.reshape((-1,) + tuple(x.shape[nb:])).unbind(0) for x in xs))])
    return out.reshape(lead + tuple(out.shape[1:]))


def _dots(partials: torch.Tensor, lead) -> torch.Tensor:
    """A dot from a launch's per-block partials, one per entry of the batch `lead`: an entry's partials are
    contiguous and as many as its unbatched launch has, and are summed from a buffer of their own (a view at an
    offset may sum in another order)."""
    if not lead:
        return partials.sum()
    return per_entry(lambda e: e.clone().sum(), len(lead), partials.view(tuple(lead) + (-1,)))


def _batch_dot(a: torch.Tensor, b: torch.Tensor, ndim: int) -> torch.Tensor:
    """⟨a, b⟩ over the `ndim` trailing spatial axes, one per entry of the leading axes."""
    return per_entry(lambda x, y: torch.sum(x * y), a.ndim - ndim, a, b)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _aligned(*ts) -> bool:
    """Every given tensor's data starts on a 16-byte boundary (the march kernels' vector route)."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


# ---------------------------------------------------------------------------
# K1 (unmasked and masked) and K3: the march kernels' launch plans
# ---------------------------------------------------------------------------

_SMS = 132  # streaming multiprocessors of the H100 SXM part the cost models were measured on
MARCH_THREADS = 256  # threads a block at most (march::MAX_THREADS in csrc/poisson.cu)
# threads an SM holds of each kernel, as its registers a thread allow (ptxas, `chip_smoke.py`'s build lines): K1 by
# form, float32 — the boundary profiles, the active cells alone (48 registers: 5 blocks of 256), the coefficient
# arrays with or without the active cells (68–72 registers: 3 blocks)
_STENCIL_THREADS_PER_SM = {'plain': 1024, 'active': 1280, 'coeffs': 768}
_RESTRICT_THREADS_PER_SM = 512
MASKED_RUN = 4  # K1m's cells a run: 16 bytes of each float32 mask, in either dtype of p
_CHUNKS = (64, 32, 16, 8, 4, 2, 1)


def _march_plan(runs: int, rows: int, planes: int, steps, threads_per_sm: int, chunk: Optional[int],
                batch: int = 1) -> dict:
    """A march kernel's blocks: bx threads along z (a power of two up to a
    warp, so that a warp holds whole rows) by `by` rows, a whole number of
    warps and at most `MARCH_THREADS`, with no more rows than the field
    needs; each block marches over `chunk` planes of one of `batch` entries
    (the grid's z axis holds each entry's chunks in turn: an entry's blocks
    are those of its unbatched launch). The chunk minimises the
    estimated plane steps in series — a block's own, `steps(c)` (its halo
    planes included), times the waves of blocks the SMs run, a wave being
    the blocks they hold at once (a last wave that is partly empty takes a
    whole wave's time) — unless ``chunk`` fixes it."""
    bx = 1
    while bx < min(runs, 32):
        bx *= 2
    rows_p2 = 1
    while rows_p2 < rows:
        rows_p2 *= 2
    by = max(32 // bx, min(MARCH_THREADS // bx, rows_p2))
    tiles = -(-runs // bx) * -(-rows // by)
    slots = _SMS * min(32, threads_per_sm // (bx * by))

    def cost(c):
        return -(-tiles * -(-planes // c) // slots) * steps(c)
    if chunk is None:
        chunk = min((c for c in _CHUNKS if c <= max(planes, 1)), key=cost)
    elif chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    grid = (-(-runs // bx), -(-rows // by), batch * -(-planes // chunk))
    return dict(block=(bx, by), chunk=chunk, grid=grid, blocks=grid[0] * grid[1] * grid[2])


def _rows_aligned(Z: int, dtypes) -> bool:
    return all(Z * dt.itemsize % 16 == 0 for dt in dtypes if dt is not None)


@functools.lru_cache(maxsize=256)
def stencil_plan(shape: Sequence[int], p_dtype: torch.dtype, b_dtype: Optional[torch.dtype] = None,
                 aligned: bool = True, chunk: Optional[int] = None, form: str = 'plain', batch: int = 1) -> dict:
    """K1's launch for a 3D field of `shape` stored as ``p_dtype``
    (``b_dtype``: b's, where the epilogue reads it) in one of its ``form``s:
    'plain' (the boundary profiles), or K1m's 'active' (the active cells
    alone) and 'coeffs' (the coefficient arrays, with or without the active
    cells); the masks are float32 of the field's shape.

    A thread owns a run of z-neighbouring cells (``run``: 16 bytes of p
    unmasked, 4 float32 or 8 bfloat16 cells; masked, `MASKED_RUN` cells in
    either dtype, 16 bytes of each mask) and marches along x over ``chunk``
    planes. ``route`` is 'vector' (one vector load or store a run of each
    array) where every row of every array starts on a 16-byte boundary
    (unmasked: Z·itemsize of p and b a multiple of 16; masked: Z a multiple
    of the run; the tensors ``aligned``), else 'scalar' (the same threads,
    one value at a time, the ragged tail masked). Returns the route, the run,
    the block (bx, by), the chunk, the grid (z runs, y rows, x chunks of each
    of `batch` entries), the number of blocks and of the dot's partials (one
    a block, an entry's contiguous). Cached (a few
    launches a CG iteration ask for the same few plans): `shape` is a tuple
    or a `torch.Size`, and the returned dict is shared, not to be modified."""
    X, Y, Z = (int(n) for n in shape)
    if form not in _STENCIL_THREADS_PER_SM:
        raise ValueError(f"form {form!r} not in {tuple(_STENCIL_THREADS_PER_SM)}")
    if form == 'plain':
        run = 16 // p_dtype.itemsize
        vector = aligned and _rows_aligned(Z, (p_dtype, b_dtype))
    else:
        run = MASKED_RUN
        vector = aligned and Z % run == 0
    plan = _march_plan(-(-Z // run), Y, X, lambda c: c + 2, _STENCIL_THREADS_PER_SM[form], chunk, batch)
    return dict(route='vector' if vector else 'scalar', run=run, partials=plan['blocks'], **plan)


@functools.lru_cache(maxsize=256)
def restrict_plan(shape: Sequence[int], u_dtype: torch.dtype, b_dtype: torch.dtype, aligned: bool = True,
                  chunk: Optional[int] = None, batch: int = 1) -> dict:
    """K3's launch for `batch` fine fields of `shape` (all even), u stored as
    ``u_dtype`` and b as ``b_dtype``.

    A thread owns a run of coarse cells along z (``run``: 2 float32 or 4
    bfloat16 cells — 16 bytes of each of its two fine rows of u) and marches
    along x over ``chunk`` coarse planes, two fine planes each. ``route`` is
    'vector' where every fine row of u and of b starts on a 16-byte boundary,
    else 'scalar'. Returns the route, the run, the block (bx, by), the
    chunk, the grid (z runs, coarse y rows, x chunks) and the number of
    blocks, all over the coarse field. Cached as `stencil_plan` is."""
    X, Y, Z = (int(n) for n in shape)
    if X % 2 or Y % 2 or Z % 2:
        raise ValueError(f"residual_restrict needs even sizes, got {tuple(shape)}")
    run = 8 // u_dtype.itemsize
    vector = aligned and _rows_aligned(Z, (u_dtype, b_dtype))
    plan = _march_plan(-(-(Z // 2) // run), Y // 2, X // 2, lambda c: 2 * c + 2, _RESTRICT_THREADS_PER_SM, chunk,
                       batch)
    return dict(route='vector' if vector else 'scalar', run=run, **plan)


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
    CUDA in 3D: one launch for p and its leading batch axes (the dot one per
    entry); the masked forms take one field, masks of its shape or
    broadcastable to it."""
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
    dt = _compute_dtype(p)
    pf = p.to(dt)
    out = _apply_plain(pf, inv_dx2, bc, mA_list, c0, active,
                       None if b is None else b.to(dt), mode, omega_over_diag)
    dot = _batch_dot(pf, out, len(bc)) if with_dot else None
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


def _stencil_cuda(p, inv_dx2, bc, mA_list, c0, active, b, mode, omega_over_diag, with_dot, chunk=None):
    _build.refuse_grad('poisson_stencil', p, b, c0, active, *(mA_list or ()))
    _check_bc(bc)
    _check_field('p', p)
    lead, nb = tuple(p.shape[:-3]), _n_entries(p)
    if nb != 1 and (mA_list is not None or active is not None):
        raise NotImplementedError("a batch of masked systems (obstacles, active cells) comes with a later slice of "
                                  "the port: K1's masked forms take one field")
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
    g = _grid(p.shape[-3:], inv_dx2, bc, nb)
    b_read = b if mode != 'matvec' else None
    b_dt = _DTYPE_CODE[b_read.dtype] if b_read is not None else 0
    w = float(np.float32(omega_over_diag or 0.0))
    form = 'coeffs' if mA_list is not None else 'active' if active is not None else 'plain'
    plan = stencil_plan(p.shape[-3:], p.dtype, None if b_read is None else b_read.dtype,
                        _aligned(p, out, b_read, *masks), chunk, form, nb)
    partials = torch.empty(plan['partials'], dtype=torch.float32, device=p.device) if with_dot else None
    err = lib.stencil(p.data_ptr(), _DTYPE_CODE[p.dtype], _ptr(b_read), b_dt, *(_ptr(m) for m in masks),
                      out.data_ptr(), _ptr(partials), ctypes.byref(g), _EPILOGUE[mode], w,
                      int(plan['route'] == 'vector'), *plan['block'], plan['chunk'], plan['blocks'],
                      _build.stream_of(p))
    _build.check(lib, err, 'poisson_stencil')
    _build.LAUNCHES['poisson_stencil'] += 1
    if form != 'plain':
        _build.LAUNCHES['poisson_stencil_masked'] += 1  # the masked form's share of the count above
    if mA_list is not None:
        _build.LAUNCHES['poisson_stencil_coeffs'] += 1  # of those, the launches with coefficient arrays (obstacles)
    if with_dot:
        return out, _dots(partials, lead)
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
    kernel launch for up to three sweeps of b and its leading batch axes, the
    zero-init sweep among them (the dot one per entry); a longer smooth chains
    launches of three (`smooth_plan`)."""
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
    dot = _batch_dot(uf, bf, len(bc)) if emit_dot else None
    out = uf.to(out_dtype)
    return (out, dot) if emit_dot else out


SMOOTH_TILES = ((16, 64), (16, 16))  # (y, z) outputs a block (smooth::TY, TZ in csrc/poisson.cu): Z ≥ 64, Z < 64
# blocks an SM runs at the pace of one: two resident blocks take ≈ 1.4× one block's time a plane (H100 80GB HBM3,
# `chip_smoke.py --profile`'s chunk sweep); every plan's shared memory leaves room for two
_SMOOTH_PACE_PER_SM = 1.5
SMOOTH_MAX_SWEEPS = 3  # a launch's sweeps; a longer smooth is a chain of launches
SMEM_LIMIT = _build.SMEM_LIMIT


def _smooth_smem(stencil_sweeps: int, tile) -> int:
    """Bytes of one K2 block (smooth::Geom<S>::SMEM): three float32 planes a
    level of the S − 1 intermediate sweeps and of the staged u₀, and S + 1
    planes of b, each over the tile grown by S cells in y and z, its rows
    padded to whole quads of z-neighbours (a thread's unit of work)."""
    S = stencil_sweeps
    ty, tz = tile
    return 4 * (3 * S + S + 1) * (ty + 2 * S) * (-(-(tz + 2 * S) // 4) * 4)


def smooth_plan(shape: Sequence[int], sweeps: int, zero_init: bool, dtypes, chunk: Optional[int] = None,
                batch: int = 1) -> dict:
    """K2's launches for one `poisson_smooth` of `batch` 3D fields of `shape`
    (the grid's z axis holds each entry's x chunks in turn, an entry's
    blocks those of its unbatched launch).

    ``dtypes`` = (u's dtype or None, b's dtype, the result's dtype). The smooth
    is a chain of launches of at most 3 sweeps: the first takes u (or forms
    u₀ = w·b with ``zero_init``, which counts as one of its sweeps), a later
    one the float32 result before it; only the last stores ``out_dtype``.

    A block computes a tile of (y, z) outputs (16 × 64, or 16 × 16 where Z <
    64) over ``chunk`` x-planes, marching along x through S more planes on
    each side (S: the launch's stencil sweeps), one plane a step. The chunk
    is the one that minimises the estimated steps in series — the larger of a
    block's own steps and all blocks' steps over the SMs at the pace they run
    blocks — so coarse levels take short chunks and many blocks; ``chunk``
    fixes it instead (to time the choice against the others). Returns the
    tile, the chunk, the grid (z tiles, y tiles, x chunks), the number of
    blocks (the dot's partials), the largest launch's shared memory and the
    launches, each with its sweeps, ``zero_init``, stencil sweeps, shared
    memory and dtypes."""
    X, Y, Z = (int(n) for n in shape)
    u_dtype, b_dtype, out_dtype = dtypes
    tile = SMOOTH_TILES[0] if Z >= 64 else SMOOTH_TILES[1]
    launches = []
    left, first = int(sweeps), True
    while left > 0:
        k = min(SMOOTH_MAX_SWEEPS, left)
        zero = zero_init and first
        left -= k
        S = k - 1 if zero else k
        launches.append(dict(sweeps=k, zero_init=zero, stencil_sweeps=S, smem=_smooth_smem(S, tile),
                             u_dtype=None if zero else (u_dtype if first else torch.float32), b_dtype=b_dtype,
                             out_dtype=out_dtype if left == 0 else torch.float32))
        first = False
    ty, tz = tile
    tiles = -(-Y // ty) * -(-Z // tz)
    S = max(l['stencil_sweeps'] for l in launches)
    smem = max(l['smem'] for l in launches)
    slots = _SMS * _SMOOTH_PACE_PER_SM

    def cost(c):
        blocks, steps = tiles * -(-X // c), c + 2 * S
        return max(steps, blocks * steps / slots)
    if chunk is None:
        chunk = min((c for c in (64, 32, 16, 8, 4, 2, 1) if c <= max(X, 1)), key=cost)
    elif chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    grid = (-(-Z // tz), -(-Y // ty), batch * -(-X // chunk))
    return dict(tile=tile, chunk=chunk, grid=grid, blocks=grid[0] * grid[1] * grid[2], smem=smem,
                launches=launches)


def _smooth_cuda(u, b, inv_dx2, bc, omega_over_diag, sweeps, zero_init, out_dtype, emit_dot, chunk=None):
    _build.refuse_grad('jacobi_sweeps', u, b)
    _check_bc(bc)
    _check_field('b', b)
    lead, nb = tuple(b.shape[:-3]), _n_entries(b)
    if not zero_init:
        _check_field('u', u, b.shape)
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    import ctypes
    lib = _lib()
    plan = smooth_plan(b.shape[-3:], sweeps, zero_init, (None if zero_init else u.dtype, b.dtype, out_dtype), chunk,
                       nb)
    g = _grid(b.shape[-3:], inv_dx2, bc, nb)
    w = float(np.float32(omega_over_diag))
    stream = _build.stream_of(b)
    cur = u
    partials = None
    for i, launch in enumerate(plan['launches']):
        last = i == len(plan['launches']) - 1
        out = torch.empty(b.shape, dtype=launch['out_dtype'], device=b.device)
        partials = torch.empty(plan['blocks'], dtype=torch.float32, device=b.device) if (last and emit_dot) else None
        err = lib.jacobi_smooth(None if launch['zero_init'] else cur.data_ptr(),
                                _DTYPE_CODE[launch['u_dtype'] or torch.float32],
                                b.data_ptr(), _DTYPE_CODE[b.dtype], out.data_ptr(), _DTYPE_CODE[out.dtype],
                                _ptr(partials), ctypes.byref(g), w, launch['sweeps'], int(launch['zero_init']),
                                plan['tile'][1], plan['chunk'], launch['smem'], stream)
        _build.check(lib, err, 'jacobi_smooth')
        _build.LAUNCHES['jacobi_sweeps'] += 1
        cur = out
    if emit_dot:
        return cur, _dots(partials, lead)
    return cur


# ---------------------------------------------------------------------------
# K3: fused residual + 2× restriction — the V-cycle's downward transfer
# ---------------------------------------------------------------------------

def residual_restrict(u: torch.Tensor, b: torch.Tensor, inv_dx2: Sequence[float],
                      bc: Sequence[Tuple[str, str]]) -> torch.Tensor:
    """restrict_mean(b − A·u) over the spatial axes, in u's dtype. u, b:
    (*batch, X, Y, Z) or (*batch, X, Y) with even sizes (one launch for the
    batch on CUDA); the 2D form is PyTorch operations on any device."""
    if u.is_cuda and len(bc) != 2:
        return _residual_restrict_cuda(u, b, inv_dx2, bc)
    return _residual_restrict_plain(u, b, inv_dx2, bc)


def _residual_restrict_cuda(u, b, inv_dx2, bc, chunk=None):
    _build.refuse_grad('residual_restrict', u, b)
    _check_bc(bc)
    _check_field('u', u)
    _check_field('b', b, u.shape)
    import ctypes
    lib = _lib()
    nb = _n_entries(u)
    out = torch.empty(tuple(u.shape[:-3]) + tuple(n // 2 for n in u.shape[-3:]), dtype=u.dtype, device=u.device)
    plan = restrict_plan(u.shape[-3:], u.dtype, b.dtype, _aligned(u, b, out), chunk, nb)
    g = _grid(u.shape[-3:], inv_dx2, bc, nb)
    err = lib.residual_restrict(u.data_ptr(), _DTYPE_CODE[u.dtype], b.data_ptr(), _DTYPE_CODE[b.dtype],
                                out.data_ptr(), ctypes.byref(g), int(plan['route'] == 'vector'), *plan['block'],
                                plan['chunk'], plan['blocks'], _build.stream_of(u))
    _build.check(lib, err, 'residual_restrict')
    _build.LAUNCHES['residual_restrict'] += 1
    return out


def _residual_restrict_plain(u, b, inv_dx2, bc):
    """`residual_restrict` through the twin, on any device."""
    r = _apply_plain(u.float(), inv_dx2, bc, None, None, None, b.float(), 'residual', None)
    return restrict_mean(r, len(bc)).to(u.dtype)

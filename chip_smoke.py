#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (`phiflow_tpu_torch`) on one NVIDIA card and check it.

    python3 chip_smoke.py           # all phases, one card
    python3 chip_smoke.py --quick   # build + kernel-versus-twin checks at the small shapes only
    python3 chip_smoke.py --profile # all phases, then torch.profiler over 3 steps of each path

Phases; any failure exits non-zero and prints no result:
  1. the card's name and power limit (nvidia-smi) and the torch / CUDA versions;
  2. the build of phiflow_tpu_torch/csrc/*.cu with nvcc, one process per source;
  3. each kernel K1–K7 against its plain PyTorch twin on the card, at a shape
     of its path (256³; 4096² for K7) and at a small shape that is not a power
     of two, over the three boundary modes, float32 and bfloat16 where the path
     stores it; the median CUDA-event time of the kernel, of the twin and,
     where one PyTorch call computes the same function, of that call
     (library_ms — the port never calls it), beside the bound: the larger of
     bytes moved / 3.35 TB/s and float32 operations / 67 TFLOP/s (H100 SXM
     data sheet);
  4. three paths of SmokePlume(cg_tol=1e-3, max_iterations=100) on the card,
     each 2 warm-up steps, then 5 timed steps with every launch counter set to
     0 just before and read just after; ms per step, Mcells/s, the advection /
     pressure split, CG iterations, max |div|, the displacement bound and
     finiteness:
     4a. the fused path, `step` at 256³ (K1–K5);
     4b. the per-phase path at 256³ through `advect_smoke`, `advect_velocity`,
         `project` (K6 and K1–K4);
     4c. the per-phase path in 2D at 4096² (K7; the 2D projection is PyTorch
         operations);
  5. 2 steps from one numpy state on the CPU (the twins) and on the card (the
     kernels), compared at 1e-3 abs: fused at 64³, per-phase at 64³, 2D at 256²;
  6. the `kernels` JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import json
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BC_SETS = [(('neumann', 'neumann'),) * 3,
           (('periodic', 'periodic'),) * 3,
           (('neumann', 'ghost0'), ('periodic', 'periodic'), ('ghost0', 'neumann'))]
PATH_BC = BC_SETS[0]
SMALL = (24, 40, 72)
PATH_N = 256
PATH_N_2D = 4096  # 16.8 M cells, the cell count of 256³

KERNELS = {  # launch-counter name → (source, the Pallas kernel it replaces)
    'poisson_stencil': ('phiflow_tpu_torch/csrc/poisson.cu', 'phiflow_tpu/ops/poisson.py:284'),
    'jacobi_sweeps': ('phiflow_tpu_torch/csrc/poisson.cu', 'phiflow_tpu/ops/poisson.py:671'),
    'residual_restrict': ('phiflow_tpu_torch/csrc/poisson.cu', 'phiflow_tpu/ops/poisson.py:507'),
    'prolong_add': ('phiflow_tpu_torch/csrc/transfer.cu', 'phiflow_tpu/ops/transfer.py:101'),
    'fused_advect': ('phiflow_tpu_torch/csrc/advect3d.cu', 'phiflow_tpu/ops/advect3d.py:232'),
    'window_interp_3d': ('phiflow_tpu_torch/csrc/interp.cu', 'phiflow_tpu/ops/interp.py:111'),
    'window_interp_2d': ('phiflow_tpu_torch/csrc/interp.cu', 'phiflow_tpu/ops/interp.py:323'),
}
FUSED_KERNELS = ('poisson_stencil', 'jacobi_sweeps', 'residual_restrict', 'prolong_add', 'fused_advect')
PHASES_3D_KERNELS = ('poisson_stencil', 'jacobi_sweeps', 'residual_restrict', 'prolong_add', 'window_interp_3d')
PHASES_2D_KERNELS = ('window_interp_2d',)


class Checks:
    """Kernel-versus-twin comparisons and timings, by kernel."""

    def __init__(self):
        self.max_err = {k: 0.0 for k in KERNELS}
        self.passed = {k: 0 for k in KERNELS}
        self.timing = {}
        self.failed = []

    def compare(self, kernel, case, got, ref, tol):
        """float32 results: max |got − ref| ≤ tol. bfloat16 results: within one
        bf16 ulp of ref plus tol — both sides round float32 arithmetic once,
        their sums run in different orders, and where a result cancels to near
        zero the float32 difference alone can exceed its bf16 ulp."""
        import torch
        g, r = got.float(), ref.float()
        diff = (g - r).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        if got.dtype == torch.bfloat16:
            _, e = torch.frexp(r.abs())
            ok = bool((diff <= torch.ldexp(torch.ones_like(r), e - 8) + tol).all())
            tol_s = f'ulp+{tol:.0e}'
        else:
            ok = err <= tol
            tol_s = f'{tol:.0e}'
        ok = ok and bool(torch.isfinite(g).all())
        self.max_err[kernel] = max(self.max_err[kernel], err)
        print(f'check {kernel:17s} {case:58s} max_abs_err={err:.3e} tol={tol_s:10s} {"ok" if ok else "FAIL"}')
        if not ok:
            self.failed.append(f'{kernel} {case}')
        self.passed[kernel] += ok

    def compare_dot(self, kernel, case, got, ref, rtol):
        err = abs(float(got) - float(ref))
        ok = err <= rtol * max(abs(float(ref)), 1.0)
        print(f'check {kernel:17s} {case:58s} dot {float(got):.6e} vs {float(ref):.6e} '
              f'rel_err={err / max(abs(float(ref)), 1.0):.2e} tol={rtol:.0e} {"ok" if ok else "FAIL"}')
        if not ok:
            self.failed.append(f'{kernel} {case} dot')
        self.passed[kernel] += ok

    def time(self, kernel, what, fn_kernel, fn_plain, n_bytes, n_ops, fn_library=None, key=None):
        """Times are kept under `key` (default: the kernel's name, whose entry
        goes into the `kernels` line; any other key is printed only)."""
        ms = median_ms(fn_kernel)
        plain_ms = median_ms(fn_plain)
        library_ms = median_ms(fn_library) if fn_library is not None else None
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / F32_OPS_PER_S * 1e3
        bound_ms, bound_by = (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')
        self.timing[key or kernel] = dict(timed=what, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                          bound_by=bound_by, library_ms=library_ms)
        lib = 'n/a' if library_ms is None else f'{library_ms:.4f}'
        print(f'time  {kernel:17s} {what:58s} ms={ms:.4f} plain_ms={plain_ms:.4f} '
              f'library_ms={lib} bound_ms={bound_ms:.4f} ({bound_by}; {n_bytes / 1e6:.1f} MB, '
              f'{n_ops / 1e9:.2f} GFLOP)')


def median_ms(fn, reps=7, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 3: kernels against their twins
# ---------------------------------------------------------------------------

def check_poisson(ch, gen, quick):
    import torch
    from phiflow_tpu_torch.ops import poisson as P
    dev = 'cuda'
    f32, bf16 = torch.float32, torch.bfloat16
    inv = (1.0, 0.7, 1.3)

    def rnd(shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # --- small shape: every boundary set, epilogue and storage type ---
    for bcs in BC_SETS:
        tag = '/'.join(f'{lo[0]}{hi[0]}' for lo, hi in bcs)
        for dt in (f32, bf16):
            p, b = rnd(SMALL, dt), rnd(SMALL, dt)
            for mode in ('matvec', 'residual', 'jacobi'):
                got = P.poisson_apply(p, inv, bcs, b=b, mode=mode, omega_over_diag=0.15)
                ref = P._poisson_apply_plain(p, inv, bcs, b=b, mode=mode, omega_over_diag=0.15)
                ch.compare('poisson_stencil', f'{mode} {SMALL} {tag} {str(dt)[6:]}', got, ref, 2e-5)
            got, dot = P.poisson_apply(p, inv, bcs, with_dot=True)
            ref, rdot = P._poisson_apply_plain(p, inv, bcs, with_dot=True)
            ch.compare_dot('poisson_stencil', f'matvec with_dot {SMALL} {tag} {str(dt)[6:]}', dot, rdot, 1e-5)
        w = 0.9 / (-2.0 * sum(inv))
        u, b = rnd(SMALL), rnd(SMALL)
        for zero_init in (True, False):
            for sweeps in (2, 3):
                for out_dtype in (f32, bf16):
                    args = (None if zero_init else u, b, inv, bcs, w, sweeps)
                    got, dot = P.poisson_smooth(*args, zero_init=zero_init, out_dtype=out_dtype, emit_dot=True)
                    ref, rdot = P._poisson_smooth_plain(*args, zero_init, out_dtype, True)
                    case = f'{"zero-init" if zero_init else "warm"} sweeps={sweeps} {SMALL} {tag} ->{str(out_dtype)[6:]}'
                    ch.compare('jacobi_sweeps', case, got, ref, 2e-5)
                    ch.compare_dot('jacobi_sweeps', case, dot, rdot, 1e-5)
        for dt in (f32, bf16):
            u, b = rnd(SMALL, dt), rnd(SMALL)
            got = P.residual_restrict(u, b, inv, bcs)
            ref = P._residual_restrict_plain(u, b, inv, bcs)
            ch.compare('residual_restrict', f'{SMALL} {tag} u {str(dt)[6:]}, b float32', got, ref, 1e-5)
    if quick:
        return
    # --- the 256³ path's shapes and dtypes (closed box = neumann everywhere) ---
    N3 = (PATH_N,) * 3
    one = (1.0, 1.0, 1.0)
    w = 0.9 / (-6.0)
    p = rnd(N3)
    got, dot = P.poisson_apply(p, one, PATH_BC, with_dot=True)
    ref, rdot = P._poisson_apply_plain(p, one, PATH_BC, with_dot=True)
    ch.compare('poisson_stencil', f'CG matvec {N3} float32', got, ref, 2e-5)
    ch.compare_dot('poisson_stencil', f'CG matvec {N3} float32', dot, rdot, 1e-5)
    weight = torch.zeros((1, 1, 3, 3, 3), device=dev)
    weight[0, 0, 1, 1, 1] = -6.0
    for c in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        weight[(0, 0) + c] = 1.0
    F = torch.nn.functional
    ch.time('poisson_stencil', f'matvec + dot, {N3} float32', lambda: P.poisson_apply(p, one, PATH_BC, with_dot=True),
            lambda: P._poisson_apply_plain(p, one, PATH_BC, with_dot=True),
            nbytes(p, p), 22 * p.numel(),
            lambda: F.conv3d(F.pad(p[None, None], (1,) * 6, mode='replicate'), weight))
    b = rnd(N3)
    got = P.poisson_smooth(None, b, one, PATH_BC, w, 3, zero_init=True, out_dtype=bf16)
    ref = P._poisson_smooth_plain(None, b, one, PATH_BC, w, 3, True, bf16, False)
    ch.compare('jacobi_sweeps', f'pre-smooth zero-init x3 {N3} float32 -> bfloat16', got, ref, 2e-5)
    u = ref
    got, dot = P.poisson_smooth(u, b, one, PATH_BC, w, 3, out_dtype=f32, emit_dot=True)
    ref, rdot = P._poisson_smooth_plain(u, b, one, PATH_BC, w, 3, False, f32, True)
    ch.compare('jacobi_sweeps', f'post-smooth x3 + dot, u bfloat16, b {N3} float32', got, ref, 2e-5)
    ch.compare_dot('jacobi_sweeps', f'post-smooth x3 + dot {N3}', dot, rdot, 1e-5)
    uf = ref
    ch.time('jacobi_sweeps', f'one sweep, u b out {N3} float32',
            lambda: P.poisson_smooth(uf, b, one, PATH_BC, w, 1),
            lambda: P._poisson_smooth_plain(uf, b, one, PATH_BC, w, 1, False, f32, False),
            nbytes(uf, b, uf), 23 * uf.numel())
    u = uf.to(bf16)
    got = P.residual_restrict(u, b, one, PATH_BC)
    ref = P._residual_restrict_plain(u, b, one, PATH_BC)
    ch.compare('residual_restrict', f'u bfloat16, b float32 {N3} -> bfloat16', got, ref, 1e-5)
    ch.time('residual_restrict', f'u bfloat16, b float32 {N3} -> bfloat16',
            lambda: P.residual_restrict(u, b, one, PATH_BC),
            lambda: P._residual_restrict_plain(u, b, one, PATH_BC),
            nbytes(u, b, got), 23 * u.numel())


def check_transfer(ch, gen, quick):
    import torch
    from phiflow_tpu_torch.ops import transfer as T
    dev = 'cuda'
    coarse_small = tuple(n // 2 for n in SMALL)
    for dt in (torch.float32, torch.bfloat16):
        c = torch.randn(coarse_small, generator=gen, device=dev).to(dt)
        u = torch.randn(SMALL, generator=gen, device=dev).to(dt)
        ch.compare('prolong_add', f'c {coarse_small} + u {SMALL} {str(dt)[6:]}',
                   T.prolong_add(c, u), T._prolong_add_plain(c, u), 0.0)
        ch.compare('prolong_add', f'upsample c {coarse_small} {str(dt)[6:]}',
                   T.prolong_pc(c), T._prolong_add_plain(c, None), 0.0)
    if quick:
        return
    c = torch.randn((PATH_N // 2,) * 3, generator=gen, device=dev).to(torch.bfloat16)
    u = torch.randn((PATH_N,) * 3, generator=gen, device=dev).to(torch.bfloat16)
    got = T.prolong_add(c, u)
    ch.compare('prolong_add', f'c {tuple(c.shape)} + u {tuple(u.shape)} bfloat16', got,
                   T._prolong_add_plain(c, u), 0.0)
    ch.time('prolong_add', f'c {tuple(c.shape)} + u {tuple(u.shape)} bfloat16',
            lambda: T.prolong_add(c, u), lambda: T._prolong_add_plain(c, u),
            nbytes(c, u, got), u.numel(),
            lambda: torch.nn.functional.interpolate(c[None, None], scale_factor=2, mode='nearest'))


def _advect_inputs(N, gen, dev):
    """Random velocity (|v|·dt/dx up to 1.25 cells: the ±1 clip is reached)
    and smoke for the three fused calls of a step."""
    import torch
    shapes = [list(N) for _ in range(3)]
    for d in range(3):
        shapes[d][d] -= 1
    vel = [(torch.rand(s, generator=gen, device=dev) * 5.0 - 2.5).contiguous() for s in shapes]
    smoke = torch.rand(N, generator=gen, device=dev)
    return vel, smoke


def check_advect(ch, gen, quick):
    import torch
    from phiflow_tpu_torch.ops.advect3d import OutSpec, Source, fused_advect_3d, _fused_advect_plain
    dev = 'cuda'
    scales = (-0.5,) * 3
    K = 1
    for N in ([SMALL] if quick else [SMALL, (PATH_N,) * 3]):
        vel_t, smoke = _advect_inputs(N, gen, dev)
        vel = [Source(vel_t[d], own_axis=d) for d in range(3)]
        ball = (N[0] / 2, N[1] / 2, N[2] / 8, N[0] / 10, 0.2)
        s1 = vel + [Source(smoke, mode='edge')]
        o1 = [OutSpec(slab=3, extrema=True)]
        [(fwd, lo, up)] = _fused_advect_plain(s1, N, K, o1, scales, [])
        s2 = vel + [Source(fwd, mode='edge')]
        o2 = [OutSpec(slab=3, negate=True, combine=(0, 1, 2, 1.0), add_ball=ball, emit_lift=(2, 0.05))]
        [(_, lift)] = _fused_advect_plain(s2, N, K, o2, scales, [smoke, lo, up])
        o3 = [OutSpec(slab=d, d_own=d) for d in range(3)]
        o3[2] = o3[2]._replace(add_blocked=(0, 1.0))
        calls = [('call 1: smoke forward + extrema', s1, o1, []),
                 ('call 2: backward + combine + ball + lift', s2, o2, [smoke, lo, up]),
                 ('call 3: velocity + buoyancy', vel, o3, [lift])]
        if N == SMALL:
            # the periodic layout: wrapped sources, faces 0..N−1 on the own axis
            wrap = [Source(torch.rand(N, generator=gen, device=dev) * 5.0 - 2.5, own_axis=d, mode='wrap')
                    for d in range(3)]
            calls += [('periodic forward + extrema', wrap + [Source(smoke, mode='wrap')], o1, []),
                      ('periodic velocity', wrap, [OutSpec(slab=d, d_own=d) for d in range(3)], [])]
        for what, srcs, outs, extras in calls:
            got = fused_advect_3d(srcs, N, K, outs, scales, extras)
            ref = _fused_advect_plain(srcs, N, K, outs, scales, extras)
            for i, (g, r) in enumerate(zip(got, ref)):
                g = g if isinstance(g, tuple) else (g,)
                r = r if isinstance(r, tuple) else (r,)
                for j, (gg, rr) in enumerate(zip(g, r)):
                    ch.compare('fused_advect', f'{what} out{i}.{j} {N}', gg, rr, 2e-5)
        if N != SMALL:
            ch.time('fused_advect', f'call 1 (forward + extrema) {N} float32',
                    lambda: fused_advect_3d(s1, N, K, o1, scales),
                    lambda: _fused_advect_plain(s1, N, K, o1, scales, []),
                    nbytes(*vel_t, smoke) + 3 * nbytes(smoke), 60 * smoke.numel())


def _grid_sample_lookup(grid, disps, K, scale, padding_mode):
    """`torch.nn.functional.grid_sample` for the same lookup: a closure over
    the prebuilt normalised coordinate grid (align_corners=True), so that only
    the library call itself is timed."""
    import torch
    d = grid.ndim
    coords = []
    for ax in range(d):
        n = grid.shape[ax]
        idx = torch.arange(n, device=grid.device, dtype=torch.float32).reshape((-1,) + (1,) * (d - ax - 1))
        pos = idx + torch.clamp(scale[ax] * disps[ax], -float(K), float(K))
        coords.append(pos * (2.0 / (n - 1)) - 1.0)
    coord_grid = torch.stack(coords[::-1], dim=-1)[None]  # last entry first: (x, y[, z]) = (W, H[, D])
    F = torch.nn.functional
    return lambda: F.grid_sample(grid[None, None], coord_grid, mode='bilinear', padding_mode=padding_mode,
                                 align_corners=True)[0, 0]


def check_interp(ch, gen, quick):
    """K6 / K7 against their twin: values within 1e-5, lo / up exactly."""
    import torch
    from phiflow_tpu_torch.ops import interp as I
    dev = 'cuda'
    fns = {3: (I.window_interp_3d, 'window_interp_3d'), 2: (I.window_interp_2d, 'window_interp_2d')}

    def twin(grid, disps, K, extrema, negate, scale, mode, const=0.0):
        sgn = -1.0 if negate else 1.0
        return I._window_interp_plain(grid, list(disps), K, extrema, tuple(I._f32(sgn * x) for x in scale),
                                      mode, I._f32(const))

    def kernel(d, grid, disps, K, extrema, negate, scale, mode, const=0.0):
        halo = {None: {}, 'const': dict(const_pad=const), 'edge': dict(halo='edge'), 'wrap': dict(halo='wrap')}[mode]
        return fns[d][0](grid, disps, K, compute_extrema=extrema, negate=negate, disp_scale=scale, **halo)

    def compare(d, case, got, ref, extrema):
        name = fns[d][1]
        if not extrema:
            got, ref = (got,), (ref,)
        ch.compare(name, case + ' value', got[0], ref[0], 1e-5)
        for what, g, r in zip(('lo', 'up'), got[1:], ref[1:]):
            ch.compare(name, f'{case} {what} (exact)', g, r, 0.0)

    # --- small shapes: every halo, K, option; integer displacements ---
    for d, shape in ((3, SMALL), (2, SMALL[1:])):
        scale = (0.8, -1.1, 0.6)[:d]
        for K in (1, 2):
            for mode in (None, 'const', 'edge', 'wrap'):
                gshape = tuple(n + 2 * K for n in shape) if mode is None else shape
                grid = torch.randn(gshape, generator=gen, device=dev)
                # up to ±(K + 1) cells after scaling: the clamp is reached
                disps = (torch.rand((d,) + shape, generator=gen, device=dev) * 2 - 1) * ((K + 1) / 0.6)
                for extrema, negate in ((False, False), (True, False), (True, True)):
                    case = (f'{shape} K={K} {mode or "padded"}{" extrema" if extrema else ""}'
                            f'{" negate" if negate else ""}')
                    got = kernel(d, grid, disps, K, extrema, negate, scale, mode, 0.25)
                    ref = twin(grid, disps, K, extrema, negate, scale, mode, 0.25)
                    compare(d, case, got, ref, extrema)
        K = 2
        grid = torch.randn(tuple(n + 2 * K for n in shape), generator=gen, device=dev)
        ints = torch.randint(-1, 2, (d,) + shape, generator=gen, device=dev).float() * K  # −K, 0, +K
        got = kernel(d, grid, ints, K, True, False, (1.0,) * d, None)
        ref = twin(grid, ints, K, True, False, (1.0,) * d, None)
        compare(d, f'{shape} K={K} padded, integer displacements 0 and ±K', got, ref, True)
        ch.compare(fns[d][1], f'{shape} integer displacements: lo == up == value', got[1], got[2], 0.0)
    if quick:
        return
    # --- the paths' shapes: a velocity component (constant halo, no extrema)
    #     and the smoke's forward pass (edge halo, extrema), as a step calls them ---
    for d, shape in ((3, (PATH_N,) * 3), (2, (PATH_N_2D,) * 2)):
        name = fns[d][1]
        scale = (-0.5,) * d
        grid = torch.rand(shape, generator=gen, device=dev)
        disps = [torch.rand(shape, generator=gen, device=dev) * 5.0 - 2.5 for _ in range(d)]  # clips at ±1
        out_bytes = nbytes(grid)
        for K in (1, 2):
            got = kernel(d, grid, disps, K, True, False, scale, 'edge')
            ref = twin(grid, disps, K, True, False, scale, 'edge')
            compare(d, f'{shape} K={K} edge extrema', got, ref, True)
            del got, ref
        K = 1
        got = kernel(d, grid, disps, K, False, False, scale, 'const')
        ref = twin(grid, disps, K, False, False, scale, 'const')
        compare(d, f'{shape} K={K} const', got, ref, False)
        # corners: a weight product of d−1 multiplies, one FMA; the tent weights 4 ops per tap
        ops = (2 ** d * (d + 1) + 8 * d) * grid.numel()
        lib = _grid_sample_lookup(grid, disps, K, scale, 'zeros')
        print(f'note  {name:17s} grid_sample (zeros padding) vs twin, const halo 0: '
              f'max |diff| {float((lib() - ref).abs().max()):.2e}')
        ch.time(name, f'velocity component: const halo, no extrema, {shape} K=1',
                lambda: kernel(d, grid, disps, K, False, False, scale, 'const'),
                lambda: twin(grid, disps, K, False, False, scale, 'const'),
                nbytes(grid, *disps) + out_bytes, ops, lib)
        del lib
        lib = _grid_sample_lookup(grid, disps, K, scale, 'border')
        ch.time(name, f'smoke forward: edge halo + extrema, {shape} K=1',
                lambda: kernel(d, grid, disps, K, True, False, scale, 'edge'),
                lambda: twin(grid, disps, K, True, False, scale, 'edge'),
                nbytes(grid, *disps) + 3 * out_bytes, ops + 2 ** (d + 1) * grid.numel(), lib,
                key=name + ' +extrema')
        del lib, grid, disps, got, ref
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 4 and 5: the paths
# ---------------------------------------------------------------------------

def _stepper(model, per_phase):
    """One step through the model's public methods: `step` (the fused path at
    these sizes), or the three phases in turn — what `step` does wherever the
    fused path does not apply."""
    if not per_phase:
        return model.step, model._fused_advect

    def phases(v, s):
        s = model.advect_smoke(v, s)
        return model.advect_velocity(v, s), s

    def step(v, s, p):
        v, s = phases(v, s)
        v, p = model.project(v, p)
        return v, s, p
    return step, phases


def run_slice(tag, dims, N, per_phase, required, warmup=2, steps=5):
    import torch
    from phiflow_tpu_torch.field import divergence
    from phiflow_tpu_torch.models import SmokePlume
    from phiflow_tpu_torch.ops import _build
    model = SmokePlume(resolution=N, dims=dims, cg_tol=1e-3, max_iterations=100, device='cuda')
    step, advect = _stepper(model, per_phase)
    size = f'{N}^{dims}'
    v, s, p = model.initial_state()
    for _ in range(warmup):
        v, s, p = step(v, s, p)
    torch.cuda.synchronize()
    _build.reset_launches()
    iters = []
    t0 = time.perf_counter()
    for _ in range(steps):
        v, s, p = step(v, s, p)
        iters.append(model.last_solve.iterations)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    ms = elapsed / steps * 1e3
    print(f'{tag} {size}: {ms:.2f} ms/step, {N ** dims / (ms * 1e-3) / 1e6:.1f} Mcells/s over {steps} steps '
          f'after {warmup} warm-up steps; CG iterations per step {iters}')
    print(f'{tag} launches per step: ' + ', '.join(f'{k}={launches.get(k, 0) / steps:g}' for k in KERNELS))
    missing = [k for k in required if launches.get(k, 0) == 0]
    if missing:
        raise RuntimeError(f'{tag}: kernels not launched on the path: {missing}')
    # the advection / pressure split, from 3 more steps timed phase by phase
    adv, prs = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v2, s = advect(v, s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        v, p = model.project(v2, p)
        torch.cuda.synchronize()
        adv.append((t1 - t0) * 1e3)
        prs.append((time.perf_counter() - t1) * 1e3)
    print(f'{tag} split: advection {statistics.median(adv):.2f} ms, pressure {statistics.median(prs):.2f} ms '
          f'(median of 3 steps timed phase by phase)')
    div = float(divergence(v, model._dx).abs().max())
    disp = max(float(c.abs().max()) for c in v) * model.dt / model._dx
    finite = all(bool(torch.isfinite(t).all()) for t in (*v, s, p))
    print(f'{tag} max |div| after projection {div:.3e}; max |displacement| <= {disp:.3f} cells '
          f'(max|v|·dt/dx; certified <= max_cells={model.max_cells}: {disp <= model.max_cells}); '
          f'all finite: {finite}; max smoke {float(s.max()):.4f}')
    comps, cells = model._shapes()
    shapes_ok = [tuple(t.shape) for t in v] == comps and tuple(s.shape) == cells and tuple(p.shape) == cells
    if not (finite and shapes_ok and disp <= model.max_cells and div < 0.1):
        raise RuntimeError(f'{tag} output wrong: finite={finite} shapes_ok={shapes_ok} disp={disp} div={div}')
    return launches


def profile_slice(tag, dims, N, per_phase, warmup=2, steps=3):
    """torch.profiler over `steps` steps of a path: device time by kernel
    and the device's busy share of the wall time (the profiler's own host
    overhead included in that wall time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from phiflow_tpu_torch.models import SmokePlume
    model = SmokePlume(resolution=N, dims=dims, cg_tol=1e-3, max_iterations=100, device='cuda')
    step, _ = _stepper(model, per_phase)
    v, s, p = model.initial_state()
    for _ in range(warmup):
        v, s, p = step(v, s, p)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            v, s, p = step(v, s, p)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    # device-side kernel rows only: a CPU op's row repeats its kernels' time
    rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    ours = sum(r[2] for r in rows if any(k in r[0] for k in ('poisson_stencil_kernel', 'jacobi_sweep_kernel',
                                                             'residual_restrict_kernel', 'prolong_add_kernel',
                                                             'fused_advect_kernel', 'advect_lift_kernel',
                                                             'window_interp_kernel')))
    print(f'profile {tag} {N}^{dims}, {steps} steps: device busy {device_ms / steps:.2f} ms/step of '
          f'{wall_ms / steps:.2f} ms/step wall under the profiler ({100 * device_ms / wall_ms:.1f}% busy); '
          f'the port\'s kernels {ours / steps:.2f} ms/step, PyTorch kernels {(device_ms - ours) / steps:.2f} ms/step')
    for key, count, ms in rows[:16]:
        print(f'profile   {ms / steps:8.3f} ms/step {count / steps:7.1f} calls/step  {key[:110]}')


def smooth_state(N, dims=3, seed=0):
    """A smooth random closed-box state: low-mode sinusoids, |v|·dt/dx ≤ 0.6
    cells. Returns the velocity components, smoke and pressure."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def field(shape, amp):
        grids = np.meshgrid(*[np.arange(n) / N for n in shape], indexing='ij')
        out = np.zeros(shape)
        for _ in range(4):
            k = rng.integers(1, 4, dims)
            ph = rng.uniform(0, 2 * np.pi, dims)
            out += np.prod([np.sin(2 * np.pi * k[a] * grids[a] + ph[a]) for a in range(dims)], axis=0)
        return (amp * out / np.abs(out).max()).astype(np.float32)
    vel = [field(tuple(N - (a == d) for a in range(dims)), 1.2) for d in range(dims)]
    smoke = (0.5 + field((N,) * dims, 0.5)).astype(np.float32)
    return (*vel, smoke, np.zeros((N,) * dims, np.float32))


def cpu_vs_card(tag, dims, N, per_phase, steps=2, tol=1e-3):
    import numpy as np
    from phiflow_tpu_torch.models import SmokePlume, state_from_numpy, state_to_numpy
    arrays = smooth_state(N, dims)
    out = {}
    for dev in ('cpu', 'cuda'):
        model = SmokePlume(resolution=N, dims=dims, cg_tol=1e-3, max_iterations=100, device=dev)
        step, _ = _stepper(model, per_phase)
        v, s, p = state_from_numpy(*arrays, device=dev)
        for _ in range(steps):
            v, s, p = step(v, s, p)
        out[dev] = state_to_numpy((v, s, p))
    names = [f'v{"xyz"[d]}' for d in range(dims)] + ['smoke']
    errs = {n: float(np.abs(a - b).max()) for n, a, b in zip(names, out['cpu'], out['cuda'])}
    worst = max(errs.values())
    print(f'cpu vs card, {tag} {N}^{dims}, {steps} steps from one numpy state: '
          + ', '.join(f'{n} {e:.2e}' for n, e in errs.items())
          + f'; max {worst:.2e} tol {tol:.0e} {"ok" if worst <= tol else "FAIL"}')
    if not worst <= tol:
        raise RuntimeError(f'CPU and card disagree ({tag}): {errs}')


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the path whose run gives a kernel's `launches` in the `kernels` line: the one that brought it
COUNTED_ON = {**{k: 'fused' for k in FUSED_KERNELS}, 'window_interp_3d': 'per-phase',
              'window_interp_2d': 'per-phase-2d'}
PATHS = [  # (tag, dims, N, per-phase?, the kernels it must launch)
    ('fused', 3, PATH_N, False, FUSED_KERNELS),
    ('per-phase', 3, PATH_N, True, PHASES_3D_KERNELS),
    ('per-phase-2d', 2, PATH_N_2D, True, PHASES_2D_KERNELS),
]


def main(argv):
    quick = '--quick' in argv
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    from phiflow_tpu_torch.ops import _build
    card = card_line()
    print(f'card: {card}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}, '
          f'{torch.cuda.device_count()} visible device(s)')
    t = _build.build(force=True, verbose=True)
    print(f'build: {len(_build.SOURCES)} sources in {t:.1f} s (one nvcc each, in parallel)')
    for name in _build.SOURCES:
        with open(_build.ptxas_log(name)) as f:
            log = f.read()
        regs = [int(x) for x in re.findall(r'Used (\d+) registers', log)]
        spills = sum(int(x) for x in re.findall(r'(\d+) bytes spill stores', log))
        print(f'build: {name}.cu: {len(regs)} kernel instantiations, at most {max(regs)} registers '
              f'a thread, {spills} bytes of spill stores in all (ptxas -v)')
    ch = Checks()
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    t0 = time.perf_counter()
    check_poisson(ch, gen, quick)
    check_transfer(ch, gen, quick)
    check_advect(ch, gen, quick)
    check_interp(ch, gen, quick)
    torch.cuda.synchronize()
    print(f'checks: {time.perf_counter() - t0:.1f} s, {sum(ch.passed.values())} passed, {len(ch.failed)} failed')
    if ch.failed:
        raise RuntimeError(f'kernel checks failed: {ch.failed}')
    if quick:
        return 0
    by_path = {}
    for tag, dims, N, per_phase, required in PATHS:
        by_path[tag] = run_slice(tag, dims, N, per_phase, required)
        torch.cuda.empty_cache()
    cpu_vs_card('fused', 3, 64, False)
    cpu_vs_card('per-phase', 3, 64, True)
    cpu_vs_card('per-phase-2d', 2, 256, True)
    if '--profile' in argv:
        for tag, dims, N, per_phase, _ in PATHS:
            profile_slice(tag, dims, N, per_phase)
    rows = []
    for name, (source, replaces) in KERNELS.items():
        rows.append(dict(name=name, route='cuda', source=source, replaces=replaces,
                         launches=int(by_path[COUNTED_ON[name]].get(name, 0)), launches_path=COUNTED_ON[name],
                         launches_by_path={tag: int(c.get(name, 0)) for tag, c in by_path.items()},
                         max_abs_err=ch.max_err[name], checks_passed=ch.passed[name], **ch.timing[name]))
    print(f'card: {card}')
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

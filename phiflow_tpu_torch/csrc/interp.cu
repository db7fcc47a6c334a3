// K6 window_interp_3d and K7 window_interp_2d — replace
// phiflow_tpu/ops/interp.py::window_interp_3d and ::window_interp_2d, the
// bounded window-shift interpolation of the per-phase advection path: a grid
// interpolated linearly at its own lattice displaced by a per-cell
// displacement that is scaled, optionally negated, and clipped to +-K cells.
//
//   out(c) = sum over s in [-K, K]^D of prod_a max(0, 1 - |d_a - s_a|) * grid(c + s)
//   d_a    = clip(scale_a * disp_a(c), -K, K)        (the sign sits in scale_a)
//
// and, when asked, the MacCormack bounds lo / up: min / max of grid(c + s)
// over the s with |d_a - s_a| < 1 on every axis.
//
// The TPU kernel sums all (2K+1)^D rolled windows because it has no gather.
// Of those taps at most 2^D carry weight: s_a = floor(d_a), floor(d_a) + 1. So
// here one thread computes one output cell: it reads its D displacements,
// scales and clips them in registers, and gathers the 2^D corners with the
// tent weight and the corner test of the window sum itself (window.cuh), so
// an integer displacement (0 from rest, +-K at the clip) counts one corner
// per axis, as the TPU kernel does. The cost does not depend on K.
//
// The grid is read either as a padded array (K cells of halo on every side,
// the TPU kernel's input) or in its raw layout with its halo described by a
// mode (constant, edge, wrap) and resolved by index; either way the
// zero-weight upper corner of d_a = +K is resolved, never read out of bounds.
//
// Bound: ~10 flops per corner against D + 1 streamed arrays in and 1 or 3
// out; the gathered corners of neighbouring cells overlap and come from the
// caches. The distinct bytes set the floor: bound by device-memory bytes.
// What this version does about it is to keep the instruction count down, which
// is what held its first form back: the taps' raw indices are resolved once
// per axis (2·D resolves, not D·2^D), element offsets are 32-bit wherever the
// arrays allow, and the extrema are a template parameter. The 2D and the 3D
// kernel are one template.
#include "window.cuh"

struct InterpArgs {
    Src grid;              // the interpolated array; a padded one has shift = -K
    const float *disp[3];  // per-axis displacement arrays, output-shaped
    float scale[3];        // displacement units -> cells, sign included
    float *out, *out_lo, *out_up;
    int o[3];  // output shape (entries 0..D-1)
    int K;     // displacement clip in cells
    int extrema;
};

template <int D, typename Idx, bool EXTREMA>
__global__ void window_interp_kernel(const InterpArgs a) {
    int o[D];
    o[D - 1] = blockIdx.x * blockDim.x + threadIdx.x;
    o[D - 2] = blockIdx.y;
    if constexpr (D == 3) o[0] = blockIdx.z;
    if (o[D - 1] >= a.o[D - 1]) return;
    Idx q = 0;
#pragma unroll
    for (int e = 0; e < D; ++e) q = q * a.o[e] + o[e];
    // per axis: the two taps' weights and corner flags, and their raw indices
    // resolved once (2 per axis, not once per corner)
    float wt[D][2];
    bool hit[D][2], outside[D][2];
    int r[D][2];
#pragma unroll
    for (int e = 0; e < D; ++e) {
        const float d = clip_cells(a.scale[e], __ldg(a.disp[e] + q), a.K);
        const int base = o[e] + window_taps(d, wt[e], hit[e]) - a.grid.shift[e];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            outside[e][c] = false;
            r[e][c] = resolve(base + c, a.grid.n[e], a.grid.mode, outside[e][c]);
            if (outside[e][c]) r[e][c] = 0;  // not read; keeps the offset below inside the array
        }
    }
    float val = 0.f, lo = 3.4e38f, up = -3.4e38f;
#pragma unroll
    for (int corner = 0; corner < (1 << D); ++corner) {
        Idx g = 0;
        float w = 1.f;
        bool h = true, out = false;
#pragma unroll
        for (int e = 0; e < D; ++e) {
            const int c = (corner >> (D - 1 - e)) & 1;
            g = g * a.grid.n[e] + r[e][c];
            w *= wt[e][c];
            h = h && hit[e][c];
            out = out || outside[e][c];
        }
        const float v = out ? a.grid.c : __ldg(a.grid.p + g);
        val += w * v;
        if (EXTREMA && h) {
            lo = fminf(lo, v);
            up = fmaxf(up, v);
        }
    }
    a.out[q] = val;
    if (EXTREMA) {
        a.out_lo[q] = lo;
        a.out_up[q] = up;
    }
}

// 32-bit element offsets where both the grid and the output have fewer than
// 2^31 elements (64-bit integer multiplies cost several instructions each)
template <int D>
static int launch(const InterpArgs &a, dim3 grid, int block, cudaStream_t stream) {
    long long n_grid = 1, n_out = 1;
    for (int e = 0; e < D; ++e) {
        n_grid *= a.grid.n[e];
        n_out *= a.o[e];
    }
    const bool small = n_grid < (1LL << 31) && n_out < (1LL << 31);
    if (small && a.extrema) window_interp_kernel<D, int, true><<<grid, block, 0, stream>>>(a);
    else if (small) window_interp_kernel<D, int, false><<<grid, block, 0, stream>>>(a);
    else if (a.extrema) window_interp_kernel<D, long long, true><<<grid, block, 0, stream>>>(a);
    else window_interp_kernel<D, long long, false><<<grid, block, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" int window_interp_3d(const InterpArgs *a, int bx, void *stream) {
    const dim3 grid((a->o[2] + bx - 1) / bx, a->o[1], a->o[0]);
    return launch<3>(*a, grid, bx, (cudaStream_t)stream);
}

extern "C" int window_interp_2d(const InterpArgs *a, int bx, void *stream) {
    const dim3 grid((a->o[1] + bx - 1) / bx, a->o[0], 1);
    return launch<2>(*a, grid, bx, (cudaStream_t)stream);
}

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
// arrays allow, and the extrema are a template parameter. K6 (D = 3) runs this
// template; K7 has a kernel of its own, four outputs a thread, below.
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

// ---------------------------------------------------------------------------
// K7 on its own: the same lookup for a 2D grid, four outputs a thread. The
// one-thread-a-cell gather above reached 1.69x its bound at 4096^2 and stayed
// behind torch's grid_sample on the device. Here a warp owns 128 outputs of a
// row, four neighbouring ones a lane, and a block eight rows: displacements
// are read and results written as float4 where the rows allow it (VEC), and a
// block whose taps all lie inside the grid (every block but the border ones)
// addresses its corners directly, without resolving the halo. A form that
// staged the block's grid tile in shared memory first (cp.async, 4- or
// 16-byte) was measured slower on the H100: the gathered corners of
// neighbouring outputs already come from L1, and the staging's load-wait-
// compute phases left the memory idle (PERF.md, section 6).
// ---------------------------------------------------------------------------
#define K7_THREADS 256
#define K7_TX 128  // a warp's row of outputs: four a lane
#define K7_TY 8    // a block's rows: one a warp

template <bool EXTREMA, bool VEC, typename Idx>
__global__ void __launch_bounds__(K7_THREADS) window_interp_2d_kernel(const InterpArgs a) {
    const int K = a.K, O0 = a.o[0], O1 = a.o[1];
    const int lane = threadIdx.x & 31, row = blockIdx.y * K7_TY + (threadIdx.x >> 5);
    const int c0 = blockIdx.x * K7_TX, col = c0 + 4 * lane;
    if (row >= O0 || col >= O1) return;
    const Src &g = a.grid;
    const int n0 = g.n[0], n1 = g.n[1];
    // every tap of the block: rows r0 - K .. r0 + K7_TY + K, columns c0 - K .. c0 + K7_TX + K (logical)
    const int r0 = blockIdx.y * K7_TY;
    const bool interior = r0 - K - g.shift[0] >= 0 && r0 + K7_TY + K - g.shift[0] < n0 &&
                          c0 - K - g.shift[1] >= 0 && c0 + K7_TX + K - g.shift[1] < n1;
    const Idx q = (Idx)row * O1 + col;
    float d[2][4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        if (VEC) {
            const float4 v = __ldg(reinterpret_cast<const float4 *>(a.disp[e] + q));
            d[e][0] = v.x, d[e][1] = v.y, d[e][2] = v.z, d[e][3] = v.w;
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) d[e][k] = col + k < O1 ? __ldg(a.disp[e] + q + k) : 0.f;
        }
    }
    float val[4], lo[4], up[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        float wt[2][2];
        bool hit[2][2];
        const int br = row + window_taps(clip_cells(a.scale[0], d[0][k], K), wt[0], hit[0]) - g.shift[0];
        const int bc = col + k + window_taps(clip_cells(a.scale[1], d[1][k], K), wt[1], hit[1]) - g.shift[1];
        float v[4];
        if (interior) {
            const float *p = g.p + (Idx)br * n1 + bc;
            v[0] = __ldg(p), v[1] = __ldg(p + 1), v[2] = __ldg(p + n1), v[3] = __ldg(p + n1 + 1);
        } else {  // the halo resolved once per axis: two rows, two columns
            bool out_r[2] = {false, false}, out_c[2] = {false, false};
            const int rr[2] = {resolve(br, n0, g.mode, out_r[0]), resolve(br + 1, n0, g.mode, out_r[1])};
            const int cc[2] = {resolve(bc, n1, g.mode, out_c[0]), resolve(bc + 1, n1, g.mode, out_c[1])};
#pragma unroll
            for (int corner = 0; corner < 4; ++corner) {
                const int cy = corner >> 1, cx = corner & 1;
                v[corner] = (out_r[cy] || out_c[cx]) ? g.c : __ldg(g.p + (Idx)rr[cy] * n1 + cc[cx]);
            }
        }
        val[k] = 0.f, lo[k] = 3.4e38f, up[k] = -3.4e38f;
#pragma unroll
        for (int corner = 0; corner < 4; ++corner) {
            const int cy = corner >> 1, cx = corner & 1;
            val[k] += wt[0][cy] * wt[1][cx] * v[corner];
            if (EXTREMA && hit[0][cy] && hit[1][cx]) {
                lo[k] = fminf(lo[k], v[corner]);
                up[k] = fmaxf(up[k], v[corner]);
            }
        }
    }
    if (VEC) {
        *reinterpret_cast<float4 *>(a.out + q) = make_float4(val[0], val[1], val[2], val[3]);
        if (EXTREMA) {
            *reinterpret_cast<float4 *>(a.out_lo + q) = make_float4(lo[0], lo[1], lo[2], lo[3]);
            *reinterpret_cast<float4 *>(a.out_up + q) = make_float4(up[0], up[1], up[2], up[3]);
        }
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (col + k >= O1) break;
            a.out[q + k] = val[k];
            if (EXTREMA) {
                a.out_lo[q + k] = lo[k];
                a.out_up[q + k] = up[k];
            }
        }
    }
}

template <bool EXTREMA, bool VEC>
static void launch_2d(const InterpArgs &a, bool small, dim3 grid, cudaStream_t s) {
    if (small) window_interp_2d_kernel<EXTREMA, VEC, int><<<grid, K7_THREADS, 0, s>>>(a);
    else window_interp_2d_kernel<EXTREMA, VEC, long long><<<grid, K7_THREADS, 0, s>>>(a);
}

// vec: the rows hold a multiple of 4 outputs and every displacement and
// output array is 16-byte aligned (the wrapper checks)
extern "C" int window_interp_2d(const InterpArgs *a, int vec, void *stream) {
    const dim3 grid((a->o[1] + K7_TX - 1) / K7_TX, (a->o[0] + K7_TY - 1) / K7_TY, 1);
    const bool small = (long long)a->grid.n[0] * a->grid.n[1] < (1LL << 31) && (long long)a->o[0] * a->o[1] < (1LL << 31);
    cudaStream_t s = (cudaStream_t)stream;
    if (a->extrema && vec) launch_2d<true, true>(*a, small, grid, s);
    else if (a->extrema) launch_2d<true, false>(*a, small, grid, s);
    else if (vec) launch_2d<false, true>(*a, small, grid, s);
    else launch_2d<false, false>(*a, small, grid, s);
    return (int)cudaGetLastError();
}

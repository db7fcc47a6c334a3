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
// here a thread reads its displacements, scales and clips them in registers,
// and gathers the 2^D corners with the tent weight and the corner test of the
// window sum itself (window.cuh), so an integer displacement (0 from rest, +-K
// at the clip) counts one corner per axis, as the TPU kernel does. The cost
// does not depend on K.
//
// The grid is read either as a padded array (K cells of halo on every side,
// the TPU kernel's input) or in its raw layout with its halo described by a
// mode (constant, edge, wrap) and resolved by index; either way the
// zero-weight upper corner of d_a = +K is resolved, never read out of bounds.
//
// Bound: ~10 flops per corner against D + 1 streamed arrays in and 1 or 3
// out; the gathered corners of neighbouring cells overlap and come from the
// caches. The distinct bytes set the floor: bound by device-memory bytes.
// What keeps a gather from it is the instructions and transactions an output
// costs. So (K7 since PR 5, K6 the same kernel in 3D) a warp owns 128 outputs
// of a row along the last axis, four neighbouring ones a lane, and a block
// eight rows of one plane: displacements are read and results written as
// float4 where the rows allow it (VEC), and a block whose taps all lie inside
// the grid (every block but the border ones) addresses its corners directly,
// without resolving the halo; a border block resolves each axis' two taps
// once per output (2·D resolves, not D·2^D). Element offsets are 32-bit
// wherever the arrays allow, and the extrema are a template parameter. A form
// of K7 that staged the block's grid tile in shared memory first (cp.async, 4-
// or 16-byte) was measured slower on the H100: the gathered corners of
// neighbouring outputs already come from L1, and the staging's load-wait-
// compute phases left the memory idle (PERF.md, section 6).
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

#define WI_THREADS 256
#define WI_TX 128  // a warp's row of outputs along the last axis: four a lane
#define WI_TY 8    // a block's rows (the axis before the last): one a warp

template <int D, bool EXTREMA, bool VEC, typename Idx>
__global__ void __launch_bounds__(WI_THREADS) window_interp_kernel(const InterpArgs a) {
    const int K = a.K, lane = threadIdx.x & 31;
    const int r0 = blockIdx.y * WI_TY, c0 = blockIdx.x * WI_TX;
    int o[D];  // the thread's first output
    if constexpr (D == 3) o[0] = blockIdx.z;
    o[D - 2] = r0 + (threadIdx.x >> 5);
    o[D - 1] = c0 + 4 * lane;
    const int n_out = a.o[D - 1];
    if (o[D - 2] >= a.o[D - 2] || o[D - 1] >= n_out) return;
    const Src &g = a.grid;
    // every tap of the block: rows r0 - K .. r0 + WI_TY + K, columns c0 - K .. c0 + WI_TX + K (3D: planes
    // o0 - K .. o0 + 1 + K), logical
    bool interior = r0 - K - g.shift[D - 2] >= 0 && r0 + WI_TY + K - g.shift[D - 2] < g.n[D - 2] &&
                    c0 - K - g.shift[D - 1] >= 0 && c0 + WI_TX + K - g.shift[D - 1] < g.n[D - 1];
    if constexpr (D == 3) interior = interior && o[0] - K - g.shift[0] >= 0 && o[0] + 1 + K - g.shift[0] < g.n[0];
    Idx q = 0, stride[D];  // the first output's offset; the raw grid's strides
#pragma unroll
    for (int e = 0; e < D; ++e) q = q * a.o[e] + o[e];
    stride[D - 1] = 1;
#pragma unroll
    for (int e = D - 2; e >= 0; --e) stride[e] = stride[e + 1] * g.n[e + 1];
    float d[D][4];
#pragma unroll
    for (int e = 0; e < D; ++e) {
        if (VEC) {
            const float4 v = __ldg(reinterpret_cast<const float4 *>(a.disp[e] + q));
            d[e][0] = v.x, d[e][1] = v.y, d[e][2] = v.z, d[e][3] = v.w;
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) d[e][k] = o[D - 1] + k < n_out ? __ldg(a.disp[e] + q + k) : 0.f;
        }
    }
    float val[4], lo[4], up[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        float wt[D][2];
        bool hit[D][2];
        int base[D];  // the lower tap's raw index per axis
#pragma unroll
        for (int e = 0; e < D; ++e)
            base[e] = o[e] + (e == D - 1 ? k : 0) +
                      window_taps(clip_cells(a.scale[e], d[e][k], K), wt[e], hit[e]) - g.shift[e];
        float v[1 << D];
        if (interior) {
            Idx off = 0;
#pragma unroll
            for (int e = 0; e < D; ++e) off += (Idx)base[e] * stride[e];
            const float *p = g.p + off;
#pragma unroll
            for (int corner = 0; corner < (1 << D); ++corner) {
                Idx co = 0;
#pragma unroll
                for (int e = 0; e < D; ++e) co += ((corner >> (D - 1 - e)) & 1) ? stride[e] : 0;
                v[corner] = __ldg(p + co);
            }
        } else {  // the halo resolved once per axis: two taps each
            bool out[D][2];
            Idx r[D][2];
#pragma unroll
            for (int e = 0; e < D; ++e) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    out[e][c] = false;
                    const int l = resolve(base[e] + c, g.n[e], g.mode, out[e][c]);
                    r[e][c] = out[e][c] ? 0 : (Idx)l * stride[e];  // an index past a constant halo is not read
                }
            }
#pragma unroll
            for (int corner = 0; corner < (1 << D); ++corner) {
                Idx off = 0;
                bool outside = false;
#pragma unroll
                for (int e = 0; e < D; ++e) {
                    const int c = (corner >> (D - 1 - e)) & 1;
                    off += r[e][c];
                    outside = outside || out[e][c];
                }
                v[corner] = outside ? g.c : __ldg(g.p + off);
            }
        }
        val[k] = 0.f, lo[k] = 3.4e38f, up[k] = -3.4e38f;
#pragma unroll
        for (int corner = 0; corner < (1 << D); ++corner) {
            float w = wt[0][corner >> (D - 1)];
            bool h = hit[0][corner >> (D - 1)];
#pragma unroll
            for (int e = 1; e < D; ++e) {
                const int c = (corner >> (D - 1 - e)) & 1;
                w *= wt[e][c];
                h = h && hit[e][c];
            }
            val[k] += w * v[corner];
            if (EXTREMA && h) {
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
            if (o[D - 1] + k >= n_out) break;
            a.out[q + k] = val[k];
            if (EXTREMA) {
                a.out_lo[q + k] = lo[k];
                a.out_up[q + k] = up[k];
            }
        }
    }
}

template <int D, bool EXTREMA, bool VEC>
static void launch(const InterpArgs &a, bool small, dim3 grid, cudaStream_t s) {
    if (small) window_interp_kernel<D, EXTREMA, VEC, int><<<grid, WI_THREADS, 0, s>>>(a);
    else window_interp_kernel<D, EXTREMA, VEC, long long><<<grid, WI_THREADS, 0, s>>>(a);
}

template <int D>
static int launch_d(const InterpArgs &a, int vec, cudaStream_t s) {
    const dim3 grid((a.o[D - 1] + WI_TX - 1) / WI_TX, (a.o[D - 2] + WI_TY - 1) / WI_TY, D == 3 ? a.o[0] : 1);
    // 32-bit element offsets where both the grid and the output have fewer than 2^31 elements (64-bit integer
    // multiplies cost several instructions each)
    long long n_grid = 1, n_out = 1;
    for (int e = 0; e < D; ++e) {
        n_grid *= a.grid.n[e];
        n_out *= a.o[e];
    }
    const bool small = n_grid < (1LL << 31) && n_out < (1LL << 31);
    if (a.extrema && vec) launch<D, true, true>(a, small, grid, s);
    else if (a.extrema) launch<D, true, false>(a, small, grid, s);
    else if (vec) launch<D, false, true>(a, small, grid, s);
    else launch<D, false, false>(a, small, grid, s);
    return (int)cudaGetLastError();
}

// K6 (dims 3) and K7 (dims 2). vec: the rows hold a multiple of 4 outputs and every displacement and output array
// is 16-byte aligned (the wrapper checks)
extern "C" int window_interp(const InterpArgs *a, int dims, int vec, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dims == 3) return launch_d<3>(*a, vec, s);
    if (dims == 2) return launch_d<2>(*a, vec, s);
    return (int)cudaErrorInvalidValue;
}

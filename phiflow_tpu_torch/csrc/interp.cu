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
//
// K6T / K7T window_interp_grad — the vector-Jacobian product of the same
// function, the backward of `ops/interp.py::_WindowInterp`. The TPU kernels
// have none: the JAX package differentiates the window sum of
// phiflow_tpu/math/_nd.py:584-622 with XLA's AD, and this kernel computes that
// derivative, with JAX's rules at the kinks: |x|' = +1 at 0, the derivative of
// max(0, 1 - |d - s|) halved where 1 - |d - s| = 0, the clip's derivative 0.5
// at exactly +-K and 0 beyond, and a tie of the min / max chain split in half
// at each step in the window sum's tap order (axis 0 fastest). So at an
// integer d the taps s = d - 1 and s = d + 1, which carry no weight, still
// carry half a slope; only taps inside [-K, K] exist. One thread an output
// cell: it recomputes d and, per axis, the up to three taps with a weight or
// a slope (four candidates floor(d) - 1 .. floor(d) + 2 cover float rounding),
//   d_grid[tap] += g * w(tap)              (atomicAdd; the halo resolved as the
//                                            forward does: a constant halo drops
//                                            it, edge / wrap / padded go to the
//                                            cell read)
//   d_disp_a    = g * scale_a * clip'_a * sum_taps grid(tap) * dw_a(tap) * prod_{e!=a} w_e(tap)
// and the upstream gradients of lo / up go to the taps that carry the min / max.
// Bound: the same streamed bytes as the forward plus the gradients; the
// atomics make d_grid's sums depend on their order at float32 rounding. A
// simple kernel: a gather form without atomics is later work.
//
// Batches: both kernels take nb entries in one launch, the outputs (and the
// upstream gradients) one after the other, each input at its own entry stride:
// the grid's and the displacements' (0 for an input shared by every entry,
// which is read in place, never expanded). The forward folds the entry into
// the grid's z axis (K6: each entry's planes in turn), the backward into its
// one axis of output cells; a thread offsets its pointers by its entry's first
// element (64-bit) and computes as in an unbatched launch, so an entry's
// outputs are those of its own launch, bit for bit. K6T / K7T's atomics land in
// the entry's own d_grid (at the grid's stride: a shared grid sums over the
// entries); each entry writes its own d_disp, which the wrapper sums over the
// batch for a shared displacement.
#include "window.cuh"

struct InterpArgs {
    Src grid;              // the interpolated array; a padded one has shift = -K
    const float *disp[3];  // per-axis displacement arrays, output-shaped
    float scale[3];        // displacement units -> cells, sign included
    float *out, *out_lo, *out_up;
    int o[3];  // output shape (entries 0..D-1)
    int K;     // displacement clip in cells
    int extrema;
    int nb;                        // entries of the batch (1: one grid)
    long long grid_stride;         // elements from one entry's grid to the next (0: shared)
    long long disp_stride;         // elements from one entry's displacements to the next (0: shared)
};

#define WI_THREADS 256
#define WI_TX 128  // a warp's row of outputs along the last axis: four a lane
#define WI_TY 8    // a block's rows (the axis before the last): one a warp

template <int D, bool EXTREMA, bool VEC, typename Idx>
__global__ void __launch_bounds__(WI_THREADS) window_interp_kernel(const InterpArgs a) {
    const int K = a.K, lane = threadIdx.x & 31;
    const int r0 = blockIdx.y * WI_TY, c0 = blockIdx.x * WI_TX;
    int o[D];  // the thread's first output
    long long entry;
    if constexpr (D == 3) {
        entry = blockIdx.z / a.o[0];
        o[0] = blockIdx.z - (int)entry * a.o[0];
    } else {
        entry = blockIdx.z;
    }
    o[D - 2] = r0 + (threadIdx.x >> 5);
    o[D - 1] = c0 + 4 * lane;
    const int n_out = a.o[D - 1];
    if (o[D - 2] >= a.o[D - 2] || o[D - 1] >= n_out) return;
    Src g = a.grid;
    g.p += entry * a.grid_stride;
    long long entry_out = entry;  // the entry's first output
#pragma unroll
    for (int e = 0; e < D; ++e) entry_out *= a.o[e];
    const float *disp[D];
#pragma unroll
    for (int e = 0; e < D; ++e) disp[e] = a.disp[e] + entry * a.disp_stride;
    float *const out = a.out + entry_out;
    float *const out_lo = EXTREMA ? a.out_lo + entry_out : nullptr;
    float *const out_up = EXTREMA ? a.out_up + entry_out : nullptr;
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
            const float4 v = __ldg(reinterpret_cast<const float4 *>(disp[e] + q));
            d[e][0] = v.x, d[e][1] = v.y, d[e][2] = v.z, d[e][3] = v.w;
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) d[e][k] = o[D - 1] + k < n_out ? __ldg(disp[e] + q + k) : 0.f;
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
        *reinterpret_cast<float4 *>(out + q) = make_float4(val[0], val[1], val[2], val[3]);
        if (EXTREMA) {
            *reinterpret_cast<float4 *>(out_lo + q) = make_float4(lo[0], lo[1], lo[2], lo[3]);
            *reinterpret_cast<float4 *>(out_up + q) = make_float4(up[0], up[1], up[2], up[3]);
        }
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (o[D - 1] + k >= n_out) break;
            out[q + k] = val[k];
            if (EXTREMA) {
                out_lo[q + k] = lo[k];
                out_up[q + k] = up[k];
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
    const long long planes = (long long)a.nb * (D == 3 ? a.o[0] : 1);
    if (a.nb < 1 || planes > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((a.o[D - 1] + WI_TX - 1) / WI_TX, (a.o[D - 2] + WI_TY - 1) / WI_TY, (unsigned)planes);
    // 32-bit element offsets within an entry where both its grid and its output have fewer than 2^31 elements
    // (64-bit integer multiplies cost several instructions each); the entry's offset is added once, in 64 bits
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

struct InterpGradArgs {
    Src grid;  // the forward's grid (a padded one has shift = -K)
    const float *disp[3];
    float scale[3];
    const float *g_out, *g_lo, *g_up;  // upstream gradients, output-shaped; null where absent
    float *d_grid;                      // the grid's gradient, its raw shape, zeroed by the caller; or null
    float *d_disp[3];                   // the displacements' gradients, one per entry; null where not asked
    int o[3];
    int K;
    int nb;                 // entries of the batch
    long long grid_stride;  // elements from one entry's grid (and d_grid) to the next (0: shared)
    long long disp_stride;  // elements from one entry's displacements to the next (0: shared)
};

#define WG_THREADS 256

// d(max(a, b))/da under JAX's rule: 1 above, 1/2 at a tie, 0 below
__device__ __forceinline__ float above(float a, float b) { return a > b ? 1.f : (a == b ? 0.5f : 0.f); }

template <int D, bool EXTREMA>
__global__ void __launch_bounds__(WG_THREADS) window_interp_grad_kernel(const InterpGradArgs a) {
    long long n_out = 1;
#pragma unroll
    for (int e = 0; e < D; ++e) n_out *= a.o[e];
    const long long qb = (long long)blockIdx.x * WG_THREADS + threadIdx.x;  // over the batch's outputs
    if (qb >= n_out * a.nb) return;
    const long long entry = qb / n_out, q = qb - entry * n_out, eo = entry * n_out;
    Src g = a.grid;
    g.p += entry * a.grid_stride;
    float *const d_grid = a.d_grid ? a.d_grid + entry * a.grid_stride : nullptr;
    const float *disp[D];
#pragma unroll
    for (int e = 0; e < D; ++e) disp[e] = a.disp[e] + entry * a.disp_stride;
    int o[D];
    long long rest = q;
#pragma unroll
    for (int e = D - 1; e >= 0; --e) {
        o[e] = (int)(rest % a.o[e]);
        rest /= a.o[e];
    }
    const float kf = (float)a.K;
    const float go = a.g_out ? a.g_out[eo + q] : 0.f;
    // per axis: the taps with a weight or a slope, ascending; their weights, slopes and logical indices
    float w[D][3], dw[D][3], dclip[D];
    int tap[D][3], nt[D];
#pragma unroll
    for (int e = 0; e < D; ++e) {
        const float x = a.scale[e] * __ldg(disp[e] + q);
        const float m = fmaxf(x, -kf);
        const float d = fminf(m, kf);  // the forward's clip_cells, in the same two steps
        dclip[e] = above(x, -kf) * above(kf, m);
        nt[e] = 0;
        if (d != d) continue;  // NaN: no tap
        const int f = (int)floorf(d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int s = f - 1 + j;
            const float t = d - (float)s;
            const float dist = t >= 0.f ? t : -t;
            const float one_m = 1.f - dist;
            if (s < -a.K || s > a.K || one_m < 0.f) continue;
            if (nt[e] < 3) {
                w[e][nt[e]] = fmaxf(0.f, one_m);
                dw[e][nt[e]] = -(one_m > 0.f ? 1.f : 0.5f) * (t >= 0.f ? 1.f : -1.f);
                tap[e][nt[e]] = o[e] + s;
                ++nt[e];
            }
        }
    }
    float gd[D];
#pragma unroll
    for (int e = 0; e < D; ++e) gd[e] = 0.f;
    float hv[1 << D];  // the taps with weight (|d - s| < 1 on every axis), in the window sum's order
    long long hoff[1 << D];
    bool hout[1 << D];
    int nh = 0;
    constexpr int N3 = D == 3 ? 27 : 9;
    for (int c = 0; c < N3; ++c) {  // mixed radix 3, axis 0 fastest: the TPU window sum's tap order
        int j[D];
        bool skip = false;
        int cc = c;
#pragma unroll
        for (int e = 0; e < D; ++e) {
            j[e] = cc % 3;
            cc /= 3;
            skip = skip || j[e] >= nt[e];
        }
        if (skip) continue;
        float W = 1.f, dfac[D];
        bool need = false;
#pragma unroll
        for (int e = 0; e < D; ++e) W *= w[e][j[e]];
#pragma unroll
        for (int e = 0; e < D; ++e) {
            float p = dw[e][j[e]];
#pragma unroll
            for (int f = 0; f < D; ++f)
                if (f != e) p *= w[f][j[f]];
            dfac[e] = p;
            need = need || p != 0.f;
        }
        if (!need && W == 0.f) continue;
        bool outside = false;
        long long off = 0;
#pragma unroll
        for (int e = 0; e < D; ++e) off = off * g.n[e] + resolve(tap[e][j[e]] - g.shift[e], g.n[e], g.mode, outside);
        const float v = outside ? g.c : __ldg(g.p + off);
        if (W != 0.f) {
            if (d_grid && !outside && go != 0.f) atomicAdd(d_grid + off, go * W);
            if (EXTREMA && nh < (1 << D)) {
                hv[nh] = v, hoff[nh] = off, hout[nh] = outside;
                ++nh;
            }
        }
#pragma unroll
        for (int e = 0; e < D; ++e) gd[e] += v * dfac[e];
    }
#pragma unroll
    for (int e = 0; e < D; ++e)
        if (a.d_disp[e]) a.d_disp[e][eo + q] = go * a.scale[e] * dclip[e] * gd[e];
    if (EXTREMA && d_grid && nh > 0) {
        // lo = min(... min(min(BIG, v_0), v_1) ..., v_{nh-1}) and up alike: walk the chain back from the last
        // tap; a tap below (above) the running min (max) before it takes the rest, a tie half of it
        float pre_lo[1 << D], pre_up[1 << D], m_lo = 3.4e38f, m_up = -3.4e38f;
        for (int i = 0; i < nh; ++i) {
            pre_lo[i] = m_lo, pre_up[i] = m_up;
            m_lo = fminf(m_lo, hv[i]);
            m_up = fmaxf(m_up, hv[i]);
        }
        float G_lo = a.g_lo ? a.g_lo[eo + q] : 0.f, G_up = a.g_up ? a.g_up[eo + q] : 0.f;
        for (int i = nh - 1; i >= 0; --i) {
            const float s_lo = G_lo * above(pre_lo[i], hv[i]), s_up = G_up * above(hv[i], pre_up[i]);
            G_lo -= s_lo;
            G_up -= s_up;
            if (!hout[i] && s_lo + s_up != 0.f) atomicAdd(d_grid + hoff[i], s_lo + s_up);
        }
    }
}

template <int D>
static int launch_grad(const InterpGradArgs &a, int extrema, cudaStream_t s) {
    long long n_out = a.nb;
    for (int e = 0; e < D; ++e) n_out *= a.o[e];
    if (a.nb < 1) return (int)cudaErrorInvalidValue;
    if (n_out == 0) return 0;
    const unsigned blocks = (unsigned)((n_out + WG_THREADS - 1) / WG_THREADS);
    if (extrema) window_interp_grad_kernel<D, true><<<blocks, WG_THREADS, 0, s>>>(a);
    else window_interp_grad_kernel<D, false><<<blocks, WG_THREADS, 0, s>>>(a);
    return (int)cudaGetLastError();
}

// K6T (dims 3) and K7T (dims 2); extrema: lo / up were computed and their upstream gradients may be given
extern "C" int window_interp_grad(const InterpGradArgs *a, int dims, int extrema, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dims == 3) return launch_grad<3>(*a, extrema, s);
    if (dims == 2) return launch_grad<2>(*a, extrema, s);
    return (int)cudaErrorInvalidValue;
}

// K6 (dims 3) and K7 (dims 2). vec: the rows hold a multiple of 4 outputs and every displacement and output array
// is 16-byte aligned (the wrapper checks)
extern "C" int window_interp(const InterpArgs *a, int dims, int vec, void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dims == 3) return launch_d<3>(*a, vec, s);
    if (dims == 2) return launch_d<2>(*a, vec, s);
    return (int)cudaErrorInvalidValue;
}

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
// A NaN displacement gives a NaN result and lo / up of +-3.4e38, as the
// window sum's NaN weights and failed corner tests do (window.cuh).
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
// carry half a slope; only taps inside [-K, K] exist. Per output, from its d:
//   d_disp_a = g * scale_a * clip'_a * sum_taps grid(tap) * dw_a(tap) * prod_{e!=a} w_e(tap)
//   d_grid[cell] = sum over the (output, corner) pairs whose tap resolves to
//                  the cell of g * W(corner) + the corner's share of lo / up's
//                  upstream gradients (a constant halo drops a tap outside,
//                  edge / wrap / padded send it to the cell read)
// A displacement that is NaN (on any axis) makes every tent weight of its
// output NaN in the window sum, whose gradient JAX then takes: wherever the
// output's upstream gradient is given, d_grid is NaN at each of its (2K + 1)^D
// taps (folded back as the pad's VJP folds a tap: onto the edge cell, the
// wrapped cell, or dropped past a constant halo), its d_disp NaN on each axis
// whose displacement is finite and 0 on a NaN axis unless another axis is NaN
// too; without an upstream gradient of the output (lo / up only), both are 0
// there. The d_grid kernel gives such an output no taps, and the d_disp
// kernel, launched after it, stores the NaN into its taps: NaN absorbs every
// sum, so the bits do not depend on the order.
//
// Bound: the bytes — the grid, the displacements and the upstream gradients
// read once, d_grid and d_disp written once. Scattering d_grid with a float
// atomic per corner would make its sums depend on the atomics' order; here
// two kernels a call, neither with an atomic, write each result once, so the
// same inputs give bit-equal gradients from launch to launch; no memset.
//   d_disp: a gather per output with the forward's tiling (a warp a row of
//   128 outputs, four a lane), its corners and at most one extra half-slope
//   tap an axis unrolled at compile time.
//   d_grid: owner-computes. A block owns a tile of cells (in 3D 32 columns, 16
//   past K = 5, by as many rows as a 512-thread slot window holds with its
//   K-wide halo; in 2D 256 - 2K of a row) over `chunk` planes of axis 0 and
//   marches along them. At each plane every thread computes one slot — the
//   output at its window position, halo included: its floors packed a byte an
//   axis and its 2^D corner coefficients, g W plus the corner's share of lo /
//   up's gradients — into a ring of 2K + 2 slot planes in shared memory (one
//   barrier a plane; the next plane's inputs load during this one). Then each
//   owned cell sums the slots within K of it, planes, rows and columns
//   ascending: a slot counts where one byte-wise subtraction shows cell =
//   slot + floor + corner bit on every axis (every slot read, a miss adding
//   0); a cell on a clamped edge side also takes the taps clamped onto it
//   (at K = 1, on one side, in a second pass after the exact taps, so that
//   its warp runs the fast pass with the others). A
//   wrapped axis needs no case: the window's slots are the outputs of the
//   periodic extension, so each (output, corner) pair lands once. K = 1
//   unrolls at compile time. Where the ring does not fit in 227 KB (3D K > 4,
//   2D K > 17) the block keeps one slot plane and recomputes it for every
//   plane it serves, in the same order. `ops/interp.py::grad_plan` picks the
//   chunk; the C entry derives the ring, the shared bytes and the grid from
//   it, K and the shape (the plan mirrors them). What holds it (PERF.md,
//   section 6): in 3D the 27 candidates a cell checks and the ~250
//   instructions of an output's d_disp.
//   Past the window (3D K > 7, where 2K reaches its rows; 2D K > 32, past the
//   byte-packed offsets) d_grid takes the wide kernel: a thread a cell, which
//   reads the (2K + 1)^D outputs within K of it from global memory in a fixed
//   order, an output's floors tested an axis at a time; its cost grows with
//   (2K + 1)^D, the slot window's does not, and every K the forward takes has
//   a gradient. Empty outputs launch nothing.
//
// Batches: both kernels take nb entries in one launch, the outputs (and the
// upstream gradients) one after the other, each input at its own entry stride:
// the grid's and the displacements' (0 for an input shared by every entry,
// which is read in place, never expanded). The forward and the d_disp kernel
// fold the entry into the grid's z axis (3D: each entry's planes in turn), the
// d_grid kernel into the z axis of its blocks (each entry's chunks in turn); a
// thread offsets its pointers by its entry's first element (64-bit) and
// computes as in an unbatched launch, so an entry's outputs are those of its
// own launch, bit for bit. A shared grid (stride 0) has one d_grid: its blocks
// walk the entries in order, each cell's owner adding entry after entry. Each
// entry writes its own d_disp, which the wrapper sums over the batch for a
// shared displacement.
#include <algorithm>

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
    int *flag;  // two ints on the device, both 0 between calls: [0] raised by a non-finite grid cell, [1] the fix
                // kernel's count of finished blocks
    int *verdict;  // or null: the call's word, which its fix kernel sets to 1 where the grid held a NaN or an
                   // infinity (or the constant halo is not finite), else to 0; the backward of the same grid reads
                   // it in place of a test of its own (InterpGradArgs::verdict)
};

#define WI_THREADS 256

// The non-finite test of a call's grid (fault 3.13: the window sum reads every tap, so a NaN or an infinity at a
// tap of weight 0 still reaches the output, where the corner gather would not read it). Every cell is tested
// once by the first kernel of a call: the cells at a thread's own output positions where its corner gathers bring
// them into the caches, and (test_shell) a padded grid's halo shell, which no output's position reaches, spread
// over all the launch's threads. A hit raises flag[0]; the call's second kernel then recomputes the outputs whose
// window holds such a cell, and lowers the flag.
template <int D>
__device__ __forceinline__ void test_shell(const Src &g, const int (&o)[3], int K, long long entries,
                                           long long stride, int *flag) {
    if (g.shift[0] == 0) return;  // a raw grid: every cell is some output's own
    long long cnt[3] = {0, 0, 0}, per = 0;
#pragma unroll
    for (int a = 0; a < D; ++a) {
        long long c = 2 * K;
#pragma unroll
        for (int e = 0; e < D; ++e)
            if (e != a) c *= e < a ? o[e] : g.n[e];
        cnt[a] = c, per += c;
    }
    const long long T = (long long)gridDim.x * gridDim.y * gridDim.z * blockDim.x;
    const long long t0 = ((long long)(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * blockDim.x +
                         threadIdx.x;
    unsigned bad = 0;  // exponent_bits' maximum
    for (long long r = t0; r < per * entries; r += T) {
        const long long en = r / per;
        long long j = r - en * per;
        int a = 0;  // the slab: axes before a in the core, axis a in the halo, axes after it whole
        if (j >= cnt[0]) j -= cnt[0], a = 1;
        if (a == 1 && D == 3 && j >= cnt[1]) j -= cnt[1], a = 2;
        long long off = 0, mul = 1;
#pragma unroll
        for (int e = D - 1; e >= 0; --e) {
            const int ext = e < a ? o[e] : (e == a ? 2 * K : g.n[e]);
            const int v = (int)(j % ext);
            j /= ext;
            const int idx = e < a ? v + K : (e == a ? (v < K ? v : o[e] + v) : v);
            off += idx * mul;
            mul *= g.n[e];
        }
        bad = max(bad, exponent_bits(__ldg(g.p + en * stride + off)));
    }
    if (bad == 0x7f800000u) *flag = 1;
}
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
    test_shell<D>(a.grid, a.o, K, a.grid_stride ? a.nb : 1, a.grid_stride, a.flag);
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
    {  // the grid cells at the four outputs' own positions (test_shell's comment)
        Idx own = 0;
#pragma unroll
        for (int e = 0; e < D; ++e) own += (Idx)(o[e] - g.shift[e]) * stride[e];
        unsigned bad = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k)
            if (o[D - 1] + k < n_out) bad = max(bad, exponent_bits(__ldg(g.p + own + k)));
        if (bad == 0x7f800000u) *a.flag = 1;
    }
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
                lo[k] = min_nan(lo[k], v[corner]);
                up[k] = max_nan(up[k], v[corner]);
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

// Output n of a call (batch entries one after the other, each in row-major order): its entry and position.
template <int D>
__device__ __forceinline__ long long output_at(long long n, const int (&shape)[3], int (&o)[D]) {
    long long per = 1;
#pragma unroll
    for (int e = 0; e < D; ++e) per *= shape[e];
    const long long entry = n / per;
    long long rest = n - entry * per;
#pragma unroll
    for (int e = D - 1; e >= 0; --e) {
        o[e] = (int)(rest % shape[e]);
        rest /= shape[e];
    }
    return entry;
}

// The grid at logical position l, resolved as the window sum's pad resolves it.
template <int D>
__device__ __forceinline__ float tap_value(const Src &g, const int (&l)[D]) {
    long long off = 0;
    bool outside = false;
#pragma unroll
    for (int e = 0; e < D; ++e) off = off * g.n[e] + resolve(l[e] - g.shift[e], g.n[e], g.mode, outside);
    return outside ? g.c : __ldg(g.p + off);
}

#define FIX_THREADS 256

// K6 / K7's second kernel, launched after every forward: it returns at once unless the grid held a NaN or an
// infinity (test_shell's comment). Then every output recomputes its value as the window sum does, every tap of
// [-K, K]^D (axis 0 fastest) added as total + tap value * the product of the axes' tent weights (unfused, in that
// order): NaN where the window holds a NaN or an infinity at a tap of weight 0, +-inf or NaN as the weighted
// infinities sum. Every output, not only those whose window holds such a cell: at d = +K the corner gather also
// multiplies the cell past the window (s = K + 1) by its weight 0, which is NaN there where that cell is not
// finite. lo / up are the first kernel's: only corners with weight take part in them. A fixed grid of blocks
// strides over the outputs.
template <int D>
__global__ void __launch_bounds__(FIX_THREADS) window_interp_fix_kernel(const InterpArgs a) {
    const bool raised = fix_raised(a.flag, a.grid.mode == SRC_CONST && nonfinite(a.grid.c));
    if (a.verdict && blockIdx.x == 0 && threadIdx.x == 0) *a.verdict = raised;
    if (!raised) return;
    const int K = a.K, W = 2 * K + 1;
    int taps = 1;
#pragma unroll
    for (int e = 0; e < D; ++e) taps *= W;
    long long total = a.nb;
#pragma unroll
    for (int e = 0; e < D; ++e) total *= a.o[e];
    const long long per = total / a.nb;
    for (long long n = (long long)blockIdx.x * FIX_THREADS + threadIdx.x; n < total;
         n += (long long)gridDim.x * FIX_THREADS) {
        int o[D];
        const long long entry = output_at<D>(n, a.o, o);
        const long long q = n - entry * per;
        Src g = a.grid;
        g.p += entry * a.grid_stride;
        float d[D];
#pragma unroll
        for (int e = 0; e < D; ++e) d[e] = clip_cells(a.scale[e], __ldg(a.disp[e] + entry * a.disp_stride + q), K);
        float acc = 0.f;
#pragma unroll 1
        for (int t = 0; t < taps; ++t) {
            int l[D], rest = t;
            float w = 1.f;
#pragma unroll
            for (int e = 0; e < D; ++e) {
                const int s = rest % W - K;
                rest /= W;
                l[e] = o[e] + s;
                const float we = fmaxf(0.f, 1.f - fabsf(d[e] - (float)s));
                w = e == 0 ? (d[e] != d[e] ? d[e] : we) : __fmul_rn(w, d[e] != d[e] ? d[e] : we);
            }
            acc = __fadd_rn(acc, __fmul_rn(tap_value<D>(g, l), w));
        }
        a.out[n] = acc;
    }
    fix_done(a.flag);
}

// A fix kernel's launch: a block an SM at most, so that the launch that finds nothing to do (every finite call)
// costs the least, a call that needs it striding over its outputs; a programmatic dependent of the kernel before
// it in the stream (fix_raised).
template <typename Args>
static void launch_fix(void (*kernel)(const Args), const Args &a, long long work, cudaStream_t s) {
    static int sms = 0;
    if (!sms && cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) != cudaSuccess) sms = 132;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)std::max(1LL, std::min((long long)sms, (work + FIX_THREADS - 1) / FIX_THREADS)));
    cfg.blockDim = dim3(FIX_THREADS);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, kernel, a);
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
    if (!a.flag) return (int)cudaErrorInvalidValue;
    if (a.extrema && vec) launch<D, true, true>(a, small, grid, s);
    else if (a.extrema) launch<D, true, false>(a, small, grid, s);
    else if (vec) launch<D, false, true>(a, small, grid, s);
    else launch<D, false, false>(a, small, grid, s);
    launch_fix(window_interp_fix_kernel<D>, a, n_out * a.nb, s);
    return (int)cudaGetLastError();
}

struct InterpGradArgs {
    Src grid;  // the forward's grid (a padded one has shift = -K)
    const float *disp[3];
    float scale[3];
    const float *g_out, *g_lo, *g_up;  // upstream gradients, output-shaped; null where absent
    float *d_grid;                      // the grid's gradient, its raw shape (one entry where shared); or null
    float *d_disp[3];                   // the displacements' gradients, one per entry; null where not asked
    int o[3];
    int K;
    int nb;                 // entries of the batch
    long long grid_stride;  // elements from one entry's grid (and d_grid) to the next (0: shared)
    long long disp_stride;  // elements from one entry's displacements to the next (0: shared)
    int chunk;  // owned planes a block along axis 0 (ops/interp.py::grad_plan's pick)
    int ring;   // set by the C entry: slot planes held in shared memory, 2K + 2 or 1 (each recomputed for every
                // plane it serves)
    int *flag;  // as InterpArgs::flag, for d_disp's fix kernel
    const int *verdict;  // or null: the verdict of the forward call that read this grid (InterpArgs::verdict). Where
                         // it is given, d_disp's kernel is built without the grid's test and its fix kernel reads
                         // the word in place of the flag; where it is null (a call without that forward), d_disp
                         // tests every cell as the forward does
};

// A plane of slots, a thread a slot: in 3D a tile of 32 columns (16 for K > 5) with its K-wide halo, by as many
// rows as 512 threads hold (threads past the window idle); in 2D one row of 256.
#define WG_THREADS 512
__host__ __device__ inline int wg_cols(int D, int K) { return D == 3 ? (K <= 5 ? 32 : 16) + 2 * K : 256; }
__host__ __device__ inline int wg_threads(int D, int K) { return D == 3 ? WG_THREADS : 256; }
__host__ __device__ inline int wg_rows(int D, int K) { return D == 3 ? WG_THREADS / wg_cols(3, K) : 1; }
#define WG_NONE 0xffffffffu  // the floors of a slot with no output or no taps: matches no cell

// d(max(a, b))/da under JAX's rule: 1 above, 1/2 at a tie, 0 below
__device__ __forceinline__ float above(float a, float b) { return a > b ? 1.f : (a == b ? 0.5f : 0.f); }

// One output's window along one axis: the corners s = f and f + 1 (f = floor(d)) with their weights and slopes,
// and at most one more tap with a slope and no weight (s = f - 1 or f + 2 where |d - s| = 1 in float32: an integer
// d, or rounding next to one); only s in [-K, K] exist. JAX's rules at the kinks: |x|' = +1 at 0, the tent's slope
// halved where 1 - |d - s| = 0, the clip's derivative 1/2 at exactly +-K and 0 beyond. Each tap's tent is the
// window sum's own arithmetic: t = d - s, |t|, 1 - |t|.
struct AxisWindow {
    int f;
    float w[2], dw[2];  // the corners' weights and slopes (0 where s = f + 1 lies past K)
    float dwx;          // the extra tap's slope (0: none)
    int sx;             // its offset from f: -1 or +2
    float dclip;        // the clip's derivative
};

// false where the displacement is NaN: an output without taps
__device__ __forceinline__ bool axis_window(float x, int K, AxisWindow &a) {
    const float kf = (float)K;
    const float m = fmaxf(x, -kf);
    const float d = fminf(m, kf);  // the forward's clip_cells, in the same two steps
    a.dclip = above(x, -kf) * above(kf, m);
    const float ff = floorf(d);
    const int f = (int)ff;
    a.f = f;
    // s = f: t = d - f >= 0, always a tap (|f| <= K)
    const float one0 = 1.f - (d - ff);
    a.w[0] = fmaxf(0.f, one0);
    a.dw[0] = one0 > 0.f ? -1.f : -0.5f;
    // s = f + 1: t < 0, a tap where f < K
    const float one1 = 1.f - (ff + 1.f - d);
    const bool up = f < K && one1 >= 0.f;
    a.w[1] = up ? fmaxf(0.f, one1) : 0.f;
    a.dw[1] = up ? (one1 > 0.f ? 1.f : 0.5f) : 0.f;
    // s = f - 1 (t >= 1) or f + 2 (t <= -1): a tap only where |t| rounds to 1
    const bool lo = f > -K && 1.f - (d - (ff - 1.f)) == 0.f;
    const bool hi = f + 2 <= K && 1.f - (ff + 2.f - d) == 0.f;
    a.dwx = lo ? -0.5f : (hi ? 0.5f : 0.f);
    a.sx = lo ? -1 : 2;
    return x == x;
}

// The grid's value at raw indices r (resolved already: `out` past a constant halo).
template <int D, typename Idx>
__device__ __forceinline__ float grid_value(const Src &g, const int (&r)[D], const bool (&out)[D]) {
    Idx off = 0;
    bool outside = false;
#pragma unroll
    for (int e = 0; e < D; ++e) {
        off = off * g.n[e] + r[e];
        outside = outside || out[e];
    }
    return outside ? g.c : __ldg(g.p + off);
}

// d_grid at an output with a NaN displacement: NaN stored into every one of its (2K + 1)^D taps, each resolved
// as the forward resolves it (a tap past a constant halo dropped). Several outputs may store into one cell: the
// same NaN, in any order.
template <int D, typename Idx>
__device__ __forceinline__ void nan_taps(const Src &g, float *d_grid, const int (&o)[D], int K) {
    const int W = 2 * K + 1;
    int total = 1;
#pragma unroll
    for (int e = 0; e < D; ++e) total *= W;
#pragma unroll 1
    for (int t = 0; t < total; ++t) {
        int s[D], rest = t;
#pragma unroll
        for (int e = D - 1; e >= 0; --e) {
            s[e] = rest % W - K;
            rest /= W;
        }
        Idx off = 0;
        bool outside = false;
#pragma unroll
        for (int e = 0; e < D; ++e)
            off = off * g.n[e] + (Idx)resolve(o[e] + s[e] - g.shift[e], g.n[e], g.mode, outside);
        if (!outside) d_grid[off] = __int_as_float(0x7fffffff);
    }
}

// d_disp's test of the grid cells at its outputs' own positions o + 32 k (k < 4) along the last axis.
template <int D, typename Idx>
__device__ __forceinline__ void own_cells(const Src &g, const int (&o)[D], const Idx (&stride)[D], int n_out,
                                          int *flag) {
    Idx own = 0;
#pragma unroll
    for (int e = 0; e < D; ++e) own += (Idx)(o[e] - g.shift[e]) * stride[e];
    unsigned bad = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (o[D - 1] + 32 * k < n_out) bad = max(bad, exponent_bits(__ldg(g.p + own + 32 * k)));
    if (bad == 0x7f800000u) *flag = 1;
}

// K6T / K7T, d_disp: a gather per output with the forward's tiling (a warp a row of WI_TX outputs, four a lane:
// lane, lane + 32, lane + 64, lane + 96, each loaded and stored on its own, so that one output's values are live
// at a time), no shared memory and no barrier. Each output's corners and, per axis, its extra tap at the other
// axes' corners are unrolled at compile time; in 2D an output whose taps all lie inside the grid addresses them
// directly (in 3D the second path's registers cost more than the resolution saves).
template <int D, typename Idx, bool TEST>
__global__ void __launch_bounds__(WI_THREADS) window_interp_disp_grad_kernel(const InterpGradArgs a) {
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
    o[D - 1] = c0 + lane;
    const int n_out = a.o[D - 1];
    const bool test = TEST && a.d_disp[0];  // the grid's cells (TEST: the call has no forward's verdict)
    if (test) test_shell<D>(a.grid, a.o, K, a.grid_stride ? a.nb : 1, a.grid_stride, a.flag);
    if (o[D - 2] >= a.o[D - 2] || o[D - 1] >= n_out) return;
    Src g = a.grid;
    g.p += entry * a.grid_stride;
    long long entry_out = entry;  // the entry's first output
#pragma unroll
    for (int e = 0; e < D; ++e) entry_out *= a.o[e];
    Idx q = 0, stride[D];  // the first output's offset; the raw grid's strides
#pragma unroll
    for (int e = 0; e < D; ++e) q = q * a.o[e] + o[e];
    stride[D - 1] = 1;
#pragma unroll
    for (int e = D - 2; e >= 0; --e) stride[e] = stride[e + 1] * g.n[e + 1];
    if (D == 2 && test) own_cells(g, o, stride, n_out, a.flag);
    unsigned nan_outputs = 0;  // bit k: output k has a NaN displacement (its taps marked in d_grid after the loop)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (o[D - 1] + 32 * k >= n_out) break;
        const Idx qk = q + 32 * k;
        AxisWindow w[D];
        unsigned nan_axes = 0;  // bit e: axis e's displacement is NaN
#pragma unroll
        for (int e = 0; e < D; ++e)
            if (!axis_window(a.scale[e] * __ldg(a.disp[e] + entry * a.disp_stride + qk), K, w[e]))
                nan_axes |= 1u << e;
        const bool taps = nan_axes == 0;
        nan_outputs |= (unsigned)!taps << k;
        if (a.d_disp[0]) {  // (uniform) else the launch only marks the taps of NaN outputs in d_grid, below
            float gd[D];
#pragma unroll
            for (int e = 0; e < D; ++e) gd[e] = 0.f;
            {  // a NaN displacement reads at -K (axis_window's fmaxf); its result is replaced below
                // the values of the corners (0 where one lies past K) and, per axis e and corner b with bit e clear,
                // of the extra tap of axis e at b's other taps (0 where there is none)
                float v[1 << D], vx[D][1 << D];
                bool extra = false;  // an integer displacement (0 from rest) or one rounding next to it, in the warp
#pragma unroll
                for (int e = 0; e < D; ++e) extra = extra || w[e].dwx != 0.f;
                extra = __any_sync(__activemask(), extra);
                bool inside = D == 2;  // every tap s = f - 1 .. f + 2 of every axis inside the raw grid (2D only)
                int base[D];
#pragma unroll
                for (int e = 0; e < D; ++e) {
                    base[e] = o[e] + (e == D - 1 ? 32 * k : 0) + w[e].f - g.shift[e];
                    inside = inside && base[e] >= 1 && base[e] + 2 < g.n[e];
                }
                if (inside) {  // addressed directly
                    Idx at = 0;
#pragma unroll
                    for (int e = 0; e < D; ++e) at += (Idx)base[e] * stride[e];
#pragma unroll
                    for (int b = 0; b < (1 << D); ++b) {
                        Idx co = at;
                        bool exists = true;  // every tap of the corner lies in [-K, K]
#pragma unroll
                        for (int e = 0; e < D; ++e) {
                            if ((b >> e) & 1) co += stride[e], exists = exists && w[e].dw[1] != 0.f;
                        }
                        v[b] = exists ? __ldg(g.p + co) : 0.f;
                        if (extra) {
#pragma unroll
                            for (int e = 0; e < D; ++e)
                                if (!((b >> e) & 1))
                                    vx[e][b] = w[e].dwx != 0.f ? __ldg(g.p + co + w[e].sx * stride[e]) : 0.f;
                        }
                    }
                } else {  // each axis' three taps resolved once: a tap past a constant halo reads the constant
                    Idx off[D][3];
                    bool out[D][3];
#pragma unroll
                    for (int e = 0; e < D; ++e) {
#pragma unroll
                        for (int i = 0; i < 3; ++i) {
                            out[e][i] = false;
                            const int raw = base[e] + (i < 2 ? i : w[e].sx);
                            off[e][i] = (Idx)resolve(raw, g.n[e], g.mode, out[e][i]) * stride[e];
                        }
                    }
                    auto value = [&](const int (&c)[D]) {
                        Idx at = 0;
                        bool outside = false;
#pragma unroll
                        for (int e = 0; e < D; ++e) at += off[e][c[e]], outside = outside || out[e][c[e]];
                        return outside ? g.c : __ldg(g.p + at);
                    };
#pragma unroll
                    for (int b = 0; b < (1 << D); ++b) {
                        bool exists = true;
                        int c[D];
#pragma unroll
                        for (int e = 0; e < D; ++e) {
                            c[e] = (b >> e) & 1;
                            exists = exists && (c[e] == 0 || w[e].dw[1] != 0.f);
                        }
                        v[b] = exists ? value(c) : 0.f;
                        if (extra) {
#pragma unroll
                            for (int e = 0; e < D; ++e) {
                                if ((b >> e) & 1) continue;
                                int cx[D];
#pragma unroll
                                for (int m = 0; m < D; ++m) cx[m] = m == e ? 2 : c[m];
                                vx[e][b] = w[e].dwx != 0.f ? value(cx) : 0.f;
                            }
                        }
                    }
                }
                // gd_e = sum over the corners of dw_e * prod_{k != e} w_k * v: per axis e, the pairs of corners that
                // differ in bit e alone, their slopes' sum weighted by the other axes, with the axis' extra tap
#pragma unroll
                for (int e = 0; e < D; ++e) {
#pragma unroll
                    for (int b = 0; b < (1 << D); ++b) {
                        if ((b >> e) & 1) continue;
                        float others = 1.f;
#pragma unroll
                        for (int m = 0; m < D; ++m)
                            if (m != e) others *= w[m].w[(b >> m) & 1];
                        const float pair = w[e].dw[0] * v[b] + w[e].dw[1] * v[b | 1 << e];
                        gd[e] += others * (extra ? pair + w[e].dwx * vx[e][b] : pair);
                    }
                }
            }
            const float go = a.g_out ? __ldg(a.g_out + entry_out + qk) : 0.f;
#pragma unroll
            for (int e = 0; e < D; ++e)
                a.d_disp[e][entry_out + qk] = taps ? go * a.scale[e] * w[e].dclip * gd[e]
                                                   : (a.g_out && (nan_axes & ~(1u << e)) ? __int_as_float(0x7fffffff)
                                                                                         : 0.f);
        }
    }

    // the grid cells at the outputs' own positions (test_shell's comment): in 3D after the loop, where they cost it
    // no registers (before it, the loop spills), in 2D before it (above), where its corner gathers find them cached
    if (D == 3 && test) own_cells(g, o, stride, n_out, a.flag);
    if (nan_outputs && a.d_grid && a.g_out) {  // rare: outside the loop above, so that it costs that loop no registers
#pragma unroll 1
        for (int k = 0; k < 4; ++k) {
            if (!((nan_outputs >> k) & 1)) continue;
            int oc[D];
#pragma unroll
            for (int e = 0; e < D; ++e) oc[e] = o[e] + (e == D - 1 ? 32 * k : 0);
            nan_taps<D, Idx>(g, a.d_grid + entry * a.grid_stride, oc, K);
        }
    }
}

// d(max(a, b))/da as JAX's AD multiplies it in: 1 above, 1/2 at a tie, 0 below or at a NaN
__device__ __forceinline__ float slope_max(float a, float b) { return a > b ? 1.f : (a == b ? 0.5f : 0.f); }

// K6T / K7T's d_disp fix kernel, launched after the d_disp kernel: it returns at once unless the grid held a NaN or
// an infinity (the forward's verdict where the call has one, else the d_disp kernel's flag: test_shell's comment).
// Then every output takes the derivative JAX's AD gives the window sum, every tap of [-K, K]^D with the products
// that AD forms: per tap and axis a, g v times the other axes' tent weights times the tent's slope (1, 1/2 at its
// kink, 0 past it: multiplied, so 0 * inf and 0 * NaN are NaN), signed by d - s; the sum times the clip's
// derivative (multiplied too) and the scale. So an output whose window holds such a value has d_disp NaN or +-inf
// on every axis; the others get the gradient the first kernel gives, up to rounding. Without the outputs' upstream
// gradient (lo / up only) d_disp is 0. Every output, as the forward's fix kernel does: the first kernel's result is
// not used where the grid is not finite.
template <int D>
__global__ void __launch_bounds__(FIX_THREADS) window_interp_disp_fix_kernel(const InterpGradArgs a) {
    if (!fix_raised(a.verdict ? a.verdict : a.flag, a.grid.mode == SRC_CONST && nonfinite(a.grid.c))) return;
    const int K = a.K, W = 2 * K + 1;
    const float kf = (float)K;
    int taps = 1;
#pragma unroll
    for (int e = 0; e < D; ++e) taps *= W;
    long long total = a.nb;
#pragma unroll
    for (int e = 0; e < D; ++e) total *= a.o[e];
    const long long per = total / a.nb;
    for (long long n = (long long)blockIdx.x * FIX_THREADS + threadIdx.x; n < total;
         n += (long long)gridDim.x * FIX_THREADS) {
        int o[D];
        const long long entry = output_at<D>(n, a.o, o);
        const long long q = n - entry * per;
        Src g = a.grid;
        g.p += entry * a.grid_stride;
        float x[D], d[D], dclip[D], acc[D];
#pragma unroll
        for (int e = 0; e < D; ++e) {
            x[e] = a.scale[e] * __ldg(a.disp[e] + entry * a.disp_stride + q);
            const float m = max_nan(x[e], -kf);
            d[e] = min_nan(m, kf);
            dclip[e] = slope_max(kf, m) * slope_max(x[e], -kf);
            acc[e] = 0.f;
        }
        const float go = a.g_out ? __ldg(a.g_out + n) : 0.f;
#pragma unroll 1
        for (int t = 0; t < taps; ++t) {
            int l[D], rest = t;
            float w[D], slope[D];
#pragma unroll
            for (int e = 0; e < D; ++e) {
                const int s = rest % W - K;
                rest /= W;
                l[e] = o[e] + s;
                const float u = 1.f - fabsf(d[e] - (float)s);
                w[e] = max_nan(0.f, u);
                slope[e] = (u > 0.f ? 1.f : (u == 0.f ? 0.5f : 0.f)) * (d[e] - (float)s >= 0.f ? -1.f : 1.f);
            }
            const float gv = __fmul_rn(go, tap_value<D>(g, l));
#pragma unroll
            for (int e = 0; e < D; ++e) {
                float term = gv;
#pragma unroll
                for (int f = D - 1; f >= 0; --f)
                    if (f != e) term = __fmul_rn(term, w[f]);
                acc[e] = __fadd_rn(acc[e], __fmul_rn(term, slope[e]));
            }
        }
#pragma unroll
        for (int e = 0; e < D; ++e) a.d_disp[e][n] = a.g_out ? __fmul_rn(__fmul_rn(acc[e], dclip[e]), a.scale[e]) : 0.f;
    }
    fix_done(a.flag);
}

// An output's coefficients on its 2^D corners (bit e of a corner: axis e): g W plus, with the extrema, the corner's
// share of lo / up's upstream gradients. pos: the output's logical position, its corners at pos + f + bit; interior:
// every tap lies inside the raw grid (none resolved); taps false (a NaN displacement): no grid value read.
template <int D, bool EXTREMA, typename Idx>
__device__ __forceinline__ void corner_coefs(const Src &g, const AxisWindow (&w)[D], const int (&pos)[D],
                                             bool interior, bool taps, float go, float glo, float gup,
                                             float (&coef)[1 << D]) {
    constexpr int NC = 1 << D;
    float W[NC];
#pragma unroll
    for (int b = 0; b < NC; ++b) {
        W[b] = 1.f;
#pragma unroll
        for (int e = 0; e < D; ++e) W[b] *= w[e].w[(b >> e) & 1];
        coef[b] = go * W[b];
    }
    if (!EXTREMA) return;
    // the corners' values (those with weight), each axis' two taps resolved once
    int r[D][2];
    bool out[D][2];
#pragma unroll
    for (int e = 0; e < D; ++e) {
        const int base = pos[e] + w[e].f - g.shift[e];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            out[e][i] = false;
            r[e][i] = interior ? base + i : resolve(base + i, g.n[e], g.mode, out[e][i]);
        }
    }
    float v[NC];
#pragma unroll
    for (int b = 0; b < NC; ++b) {
        int rb[D];
        bool ob[D];
#pragma unroll
        for (int e = 0; e < D; ++e) rb[e] = r[e][(b >> e) & 1], ob[e] = out[e][(b >> e) & 1];
        v[b] = taps && W[b] != 0.f ? grid_value<D, Idx>(g, rb, ob) : 0.f;
    }
    // lo = min(... min(min(BIG, v_0), v_1) ...) over the corners with weight, in the window sum's order (axis 0
    // fastest), and up alike: walk the chain back from the last; a corner below (above) the running min (max)
    // before it takes the rest, a tie half of it
    float pre_lo[NC], pre_up[NC], m_lo = 3.4e38f, m_up = -3.4e38f;
#pragma unroll
    for (int b = 0; b < NC; ++b) {
        pre_lo[b] = m_lo, pre_up[b] = m_up;
        m_lo = W[b] != 0.f ? min_nan(m_lo, v[b]) : m_lo;
        m_up = W[b] != 0.f ? max_nan(m_up, v[b]) : m_up;
    }
    // a NaN corner with weight makes lo and up NaN, and then JAX's min / max pass no gradient at all (their tie
    // test fails against NaN at every step of the chain): neither share reaches any corner
    float G_lo = m_lo != m_lo ? 0.f : glo, G_up = m_up != m_up ? 0.f : gup;
#pragma unroll
    for (int b = NC - 1; b >= 0; --b) {
        const bool hit = W[b] != 0.f;
        const float s_lo = hit ? G_lo * above(pre_lo[b], v[b]) : 0.f;
        const float s_up = hit ? G_up * above(v[b], pre_up[b]) : 0.f;
        G_lo -= s_lo;
        G_up -= s_up;
        coef[b] = hit ? coef[b] + (s_lo + s_up) : coef[b];
    }
}

// K6T / K7T, d_grid: owner-computes through shared memory (the comment at the top of this file), two blocks of 512
// threads an SM (64 registers at most). KT: the window's K at compile time (1, the paths' K), or 0 for any K (a.K;
// its loops are not unrolled).
template <int D, bool EXTREMA, int KT, typename Idx>
__global__ void __launch_bounds__(WG_THREADS, 2) window_interp_grid_grad_kernel(const InterpGradArgs a) {
    constexpr int NC = 1 << D;  // corners an output
    const int K = KT ? KT : a.K, R = a.ring, tid = threadIdx.x;
    const int SY = wg_rows(D, K), SZ = wg_cols(D, K);  // slot rows (axis 1 in 3D) and columns a plane
    const int NS = wg_threads(D, K);                   // slots a plane in shared memory: the block's threads
    const bool active = tid < SY * SZ;                 // a thread with a slot
    extern __shared__ uint2 wg_smem[];
    uint2 *const s_floor = wg_smem;  // [ring][NS]: the floors, packed, and the slot's corner 0 offset less its floors'
    float *const s_coef = reinterpret_cast<float *>(wg_smem + a.ring * NS);  // [ring][corner][NS]
    const Src g0 = a.grid;
    const int n0 = g0.n[0];
    const bool wrap = g0.mode == SRC_WRAP;
    // the block: owned raw planes [x0, x1) of axis 0; in-plane its tile, the slot window less K a side
    const int chunks = (n0 + a.chunk - 1) / a.chunk;
    const bool shared_grid = a.grid_stride == 0;
    const int e_first = shared_grid ? 0 : blockIdx.z / chunks;
    const int e_last = shared_grid ? a.nb : e_first + 1;
    const int xc = blockIdx.z - (shared_grid ? 0 : e_first * chunks);
    const int x0 = xc * a.chunk, x1 = min(x0 + a.chunk, n0);
    const int P0 = x0 + g0.shift[0], P1 = x1 + g0.shift[0];  // the owned planes' logical indices
    int loc[D], org[D], L[D], C[D];  // in-plane (e >= 1): slot position in the window, tile origin (raw), slot
                                     // logical index, its output's index
    bool cvalid = active, owner = active, at_lo[D], at_hi[D];
    if constexpr (D == 3) {
        loc[1] = tid / SZ, loc[2] = tid - loc[1] * SZ;
        org[1] = blockIdx.y * (SY - 2 * K), org[2] = blockIdx.x * (SZ - 2 * K);
    } else {
        loc[1] = tid;
        org[1] = blockIdx.x * (SZ - 2 * K);
    }
    const bool edge = g0.mode == SRC_EDGE && g0.shift[0] == 0;  // clamped taps (not a padded grid)
    bool interior = P0 - 2 * K - g0.shift[0] >= 0 && P1 - 1 + 2 * K - g0.shift[0] < n0;  // every tap read lies inside
#pragma unroll
    for (int e = 1; e < D; ++e) {
        const int S = e == D - 1 ? SZ : SY;
        L[e] = org[e] + g0.shift[e] - K + loc[e];
        C[e] = wrap ? ((L[e] % a.o[e]) + a.o[e]) % a.o[e] : L[e];
        cvalid = cvalid && (wrap || (L[e] >= 0 && L[e] < a.o[e]));
        const int raw = L[e] - g0.shift[e];
        owner = owner && loc[e] >= K && loc[e] < S - K && raw < g0.n[e];
        at_lo[e] = edge && raw == 0, at_hi[e] = edge && raw == g0.n[e] - 1;
        const int first = org[e] + g0.shift[e] - K, last = first + S - 1;  // the window's logical slots
        interior = interior && first - K - g0.shift[e] >= 0 && last + K - g0.shift[e] < g0.n[e];
    }
    long long n_out = 1;
#pragma unroll
    for (int e = 0; e < D; ++e) n_out *= a.o[e];
    const unsigned MASK = D == 3 ? 0xfefefeu : 0xfefeu, PAT = D == 3 ? 0x404040u : 0x4040u;
    const int self = tid;  // the thread's slot (and cell) in a plane: row-major, loc[1] * SZ + loc[2] in 3D

    for (int entry = e_first; entry < e_last; ++entry) {
        Src g = g0;
        g.p += entry * a.grid_stride;
        const float *disp[D];
#pragma unroll
        for (int e = 0; e < D; ++e) disp[e] = a.disp[e] + entry * a.disp_stride;
        const float *const g_out = a.g_out ? a.g_out + entry * n_out : nullptr;
        const float *const g_lo = EXTREMA && a.g_lo ? a.g_lo + entry * n_out : nullptr;
        const float *const g_up = EXTREMA && a.g_up ? a.g_up + entry * n_out : nullptr;

        // The streamed inputs of the thread's output at slot plane p, loaded a plane ahead of their use.
        struct Streamed {
            bool valid;
            float x[D], go, glo, gup;
        };
        auto fetch = [&](int p, Streamed &in) {
            int c0 = p;
            in.valid = cvalid;
            if (wrap) c0 = ((p % a.o[0]) + a.o[0]) % a.o[0];
            else in.valid = in.valid && p >= 0 && p < a.o[0];
            if (!in.valid) {
#pragma unroll
                for (int e = 0; e < D; ++e) in.x[e] = 0.f;
                return;
            }
            Idx q = c0;
#pragma unroll
            for (int e = 1; e < D; ++e) q = q * a.o[e] + C[e];
#pragma unroll
            for (int e = 0; e < D; ++e) in.x[e] = __ldg(disp[e] + q);
            in.go = g_out ? __ldg(g_out + q) : 0.f;
            in.glo = g_lo ? __ldg(g_lo + q) : 0.f;
            in.gup = g_up ? __ldg(g_up + q) : 0.f;
        };

        // Slot plane p (logical, axis 0) into ring entry ri: the thread's output's floors and, per corner, the
        // coefficient it gives the cell its tap resolves to: g W plus the corner's share of lo / up's gradients.
        auto slot = [&](int p, int ri, const Streamed &in) {
            unsigned F;
            float coef[NC];
            AxisWindow w[D];
            bool taps = in.valid;
#pragma unroll
            for (int e = 0; e < D; ++e) taps = axis_window(a.scale[e] * in.x[e], K, w[e]) && taps;
            {  // computed whatever `taps`: without taps the floors match no cell and the coefficients go unread
                F = 0;
#pragma unroll
                for (int e = 0; e < D; ++e) F |= (unsigned)(w[e].f + 64) << (8 * e);
                int pos[D];
                pos[0] = p;
#pragma unroll
                for (int e = 1; e < D; ++e) pos[e] = L[e];
                corner_coefs<D, EXTREMA, Idx>(g, w, pos, interior, taps, in.go, in.glo, in.gup, coef);
                if (!taps) F = WG_NONE;
            }
            // corner (t - f) of this slot lies at corner index sum_e (t_e - f_e) 2^e: its offset, less the
            // candidate's own share sum_e t_e 2^e NS, is (ri NC - sum_e f_e 2^e) NS + tid
            int fl = 0;
#pragma unroll
            for (int e = 0; e < D; ++e) fl += w[e].f << e;
            s_floor[ri * NS + tid] = make_uint2(F, (unsigned)((ri * NC - fl) * NS + tid));
#pragma unroll
            for (int b = 0; b < NC; ++b) s_coef[(ri * NC + b) * NS + tid] = coef[b];
        };

        // The contributions of slot plane p (ring entry ri) to the thread's cell at logical plane x: every slot
        // within K of the cell whose output has a corner resolving to it, in a fixed order (dy, dz ascending). A
        // byte an axis: (cell - slot) + 128 against floor + 64, so that cell = slot + floor + corner bit leaves 64
        // or 65 in every byte (no borrow for |offsets| <= 32).
        auto gather = [&](int x, int ri, int p, float &acc) {
            const uint2 *const fl = s_floor + ri * NS;
            const float *const cf = s_coef + ri * NC * NS;
            const unsigned T0 = (unsigned)(x - p + 128);
            // the clamped sides the cell lies on (an axis of one cell counts twice); es, lo_s: the axis and
            // the side of a single one
            int nside = 0, es = 0;
            bool lo_s = false;
#pragma unroll
            for (int e = 0; e < D; ++e) {
                nside += (int)at_lo[e] + (int)at_hi[e];
                if (at_lo[e] || at_hi[e]) es = e, lo_s = at_lo[e];
            }
            // K = 1 (the paths' K): a cell on one side takes the exact taps with the cells on none, then those
            // past its side; at run-time K that pass would spill, and a cell on any side takes the path below
            if (nside == 0 || (KT == 1 && nside == 1)) {  // the exact taps: branch-free, a miss adding 0
#pragma unroll
                for (int dy = D == 3 ? -K : 0; dy <= (D == 3 ? K : 0); ++dy) {
#pragma unroll
                    for (int dz = -K; dz <= K; ++dz) {
                        const int s = self + dy * SZ + dz;
                        const unsigned T = D == 3 ? T0 | (unsigned)(128 - dy) << 8 | (unsigned)(128 - dz) << 16
                                                  : T0 | (unsigned)(128 - dz) << 8;
                        const uint2 F = fl[s];
                        const unsigned diff = T - F.x;
                        const bool hit = (diff & MASK) == PAT;
                        // the corner t - f of slot s: the slot's stored offset plus t's share sum_e t_e 2^e NS (a
                        // miss reads the thread's own coefficient instead, in bounds, and adds 0)
                        const int tl = (x - p) + (D == 3 ? 2 * -dy + 4 * -dz : 2 * -dz);
                        const float c = s_coef[hit ? (int)F.y + tl * NS : tid];
                        acc += hit ? c : 0.f;
                    }
                }
                if (nside == 0) return;
                // one clamped side: then the taps past it, exact on every other axis; on axis es the corner bits
                // c < u at the low side, c > u at the high one (u: the bit an exact tap needs)
                const unsigned MASK_S = MASK & ~(0xffu << (8 * es)), PAT_S = PAT & ~(0xffu << (8 * es));
                const int wes = NS << es;  // a corner bit of axis es in coefficient indices
#pragma unroll 1
                for (int dy = D == 3 ? -K : 0; dy <= (D == 3 ? K : 0); ++dy) {
#pragma unroll 1
                    for (int dz = -K; dz <= K; ++dz) {
                        const int s = self + dy * SZ + dz;
                        const unsigned T = D == 3 ? T0 | (unsigned)(128 - dy) << 8 | (unsigned)(128 - dz) << 16
                                                  : T0 | (unsigned)(128 - dz) << 8;
                        const uint2 F = fl[s];
                        const unsigned diff = T - F.x;
                        if (F.x == WG_NONE || (diff & MASK_S) != PAT_S) continue;
                        const int u = (int)((diff >> (8 * es)) & 0xffu) - 64;
                        const int tl = (x - p) + (D == 3 ? 2 * -dy + 4 * -dz : 2 * -dz);
                        const int at = (int)F.y + tl * NS - u * wes;  // corner c of axis es at at + c wes
                        if (lo_s ? 0 < u : 0 > u) acc += s_coef[at];
                        if (lo_s ? 1 < u : 1 > u) acc += s_coef[at + wes];
                    }
                }
                return;
            }
            // a cell on clamped sides (K = 1: on two or more): every tap at or past them lands on it
            for (int dy = D == 3 ? -K : 0; dy <= (D == 3 ? K : 0); ++dy) {
                for (int dz = -K; dz <= K; ++dz) {
                    const int s = self + dy * SZ + dz;
                    const unsigned T = D == 3 ? T0 | (unsigned)(128 - dy) << 8 | (unsigned)(128 - dz) << 16
                                              : T0 | (unsigned)(128 - dz) << 8;
                    const unsigned F = fl[s].x;
                    if (F == WG_NONE) continue;
                    const unsigned diff = T - F;
                    bool ok[D][2];
#pragma unroll
                    for (int e = 0; e < D; ++e) {
                        const int u = (int)((diff >> (8 * e)) & 0xffu) - 64;  // the corner bit the cell needs
#pragma unroll
                        for (int c = 0; c < 2; ++c) ok[e][c] = (at_lo[e] || c >= u) && (at_hi[e] || c <= u);
                    }
#pragma unroll
                    for (int b = 0; b < NC; ++b) {
                        bool hit = true;
#pragma unroll
                        for (int e = 0; e < D; ++e) hit = hit && ok[e][(b >> e) & 1];
                        if (hit) acc += cf[b * NS + s];
                    }
                }
            }
        };

        auto store = [&](int x, float acc) {
            if (!owner) return;
            const int raw0 = x - g.shift[0];
            Idx off = raw0;
#pragma unroll
            for (int e = 1; e < D; ++e) off = off * g.n[e] + (L[e] - g.shift[e]);
            float *const dst = a.d_grid + entry * a.grid_stride + off;
            *dst = entry == e_first ? acc : *dst + acc;  // a shared grid: the entries in order
        };

        // Ring of 2K + 2: step i computes slot plane P0 - K + i, then (from the 2K-th step on) the cells of plane
        // x = P0 - K + i - K gather planes x - K .. x + K; the plane overwritten next was last read two steps ago,
        // so one barrier a step. Ring of 1: 2K + 1 steps a cell plane x, each computing and gathering plane
        // x - K + j, a barrier on either side. The same sums in the same order either way. The streamed inputs of
        // a step's slot are loaded during the step before.
        const int span = 2 * K + 1;
        const int steps = R > 1 ? P1 - P0 + 2 * K : (P1 - P0) * span;
        auto plane_of = [&](int i) { return R > 1 ? P0 - K + i : P0 + i / span - K + i % span; };
        Streamed next;
        fetch(plane_of(0), next);
        float acc = 0.f;
        for (int i = 0; i < steps; ++i) {
            const int j = R > 1 ? 0 : i % span;
            const int x = R > 1 ? P0 - 2 * K + i : P0 + i / span;
            const int p = R > 1 ? x + K : x - K + j;
            const Streamed in = next;
            if (i + 1 < steps) fetch(plane_of(i + 1), next);
            if (R == 1) __syncthreads();
            slot(p, R > 1 ? (p - P0 + K) % R : 0, in);
            __syncthreads();
            if (x >= P0 && owner) {
                if (j == 0) acc = 0.f;
                at_lo[0] = edge && x == 0, at_hi[0] = edge && x == n0 - 1;
                if (R > 1) {
                    int ri = (x - P0) % R;  // plane x - K's ring entry
#pragma unroll
                    for (int t = -K; t <= K; ++t) {
                        gather(x, ri, x + t, acc);
                        ri = ri + 1 == R ? 0 : ri + 1;
                    }
                } else {
                    gather(x, 0, p, acc);
                }
                if (R > 1 || j == span - 1) store(x, acc);
            }
        }
        __syncthreads();  // the next entry reuses the ring
    }
}

// K6T / K7T, d_grid past the slot window (3D K > 7, 2D K > 32): a thread a cell, a block 8 rows of 32 cells, no
// shared memory and no barrier. The cell reads from global memory the outputs within K of it, ascending (axis 0
// slowest): an output's floors are tested an axis at a time, its first miss ending it, and an output with a corner
// on the cell computes its coefficients and adds those of its corners on the cell in corner order (on a clamped
// edge side, every corner at or past the side). A shared grid's cells add the entries in order.
#define WW_TX 32
#define WW_TY 8
template <int D, bool EXTREMA, typename Idx>
__global__ void __launch_bounds__(WI_THREADS) window_interp_wide_grid_grad_kernel(const InterpGradArgs a) {
    constexpr int NC = 1 << D;
    const int K = a.K;
    const Src g0 = a.grid;
    int r[D];  // the cell's raw indices
    int entry;
    if constexpr (D == 3) {
        entry = blockIdx.z / g0.n[0];
        r[0] = blockIdx.z - entry * g0.n[0];
    } else {
        entry = blockIdx.z;
    }
    r[D - 2] = blockIdx.y * WW_TY + (threadIdx.x >> 5);
    r[D - 1] = blockIdx.x * WW_TX + (threadIdx.x & 31);
    if (r[D - 2] >= g0.n[D - 2] || r[D - 1] >= g0.n[D - 1]) return;
    const bool wrap = g0.mode == SRC_WRAP, edge = g0.mode == SRC_EDGE && g0.shift[0] == 0;
    int l[D];  // logical
    bool at_lo[D], at_hi[D];
    Idx cell = 0;
    long long n_out = 1;
#pragma unroll
    for (int e = 0; e < D; ++e) {
        l[e] = r[e] + g0.shift[e];
        at_lo[e] = edge && r[e] == 0, at_hi[e] = edge && r[e] == g0.n[e] - 1;
        cell = cell * g0.n[e] + r[e];
        n_out *= a.o[e];
    }
    const int e_first = a.grid_stride == 0 ? 0 : entry, e_last = a.grid_stride == 0 ? a.nb : entry + 1;
    for (int en = e_first; en < e_last; ++en) {
        Src g = g0;
        g.p += en * a.grid_stride;
        const long long d_off = en * a.disp_stride, o_off = en * n_out;
        float acc = 0.f;
        int j[D];  // the candidate output's logical indices, an odometer over l - K .. l + K (axis 0 slowest)
#pragma unroll
        for (int e = 0; e < D; ++e) j[e] = l[e] - K;
        int total = 1;
#pragma unroll
        for (int e = 0; e < D; ++e) total *= 2 * K + 1;
        for (int t = 0; t < total; ++t) {
            Idx q = 0;
            bool go = true;  // the output exists, has taps, and its floors put a corner on the cell so far
#pragma unroll
            for (int e = 0; e < D; ++e) {
                int c = j[e];
                if (wrap) c = ((c % a.o[e]) + a.o[e]) % a.o[e];
                else go = go && c >= 0 && c < a.o[e];
                q = q * a.o[e] + c;
            }
            AxisWindow w[D];
            bool ok[D][2];
#pragma unroll
            for (int e = 0; e < D; ++e) {
                if (go) {  // NaN: no taps
                    go = axis_window(a.scale[e] * __ldg(a.disp[e] + d_off + q), K, w[e]);
                    const int u = l[e] - j[e] - w[e].f;  // the corner bit the cell needs
#pragma unroll
                    for (int c = 0; c < 2; ++c) ok[e][c] = (at_lo[e] || c >= u) && (at_hi[e] || c <= u);
                    go = go && (ok[e][0] || ok[e][1]);
                }
            }
            if (go) {
                float coef[NC];
                corner_coefs<D, EXTREMA, Idx>(g, w, j, false, true, a.g_out ? __ldg(a.g_out + o_off + q) : 0.f,
                                              EXTREMA && a.g_lo ? __ldg(a.g_lo + o_off + q) : 0.f,
                                              EXTREMA && a.g_up ? __ldg(a.g_up + o_off + q) : 0.f, coef);
#pragma unroll
                for (int b = 0; b < NC; ++b) {
                    bool hit = true;
#pragma unroll
                    for (int e = 0; e < D; ++e) hit = hit && ok[e][(b >> e) & 1];
                    if (hit) acc += coef[b];
                }
            }
#pragma unroll
            for (int e = D - 1; e >= 0; --e) {  // the next candidate
                if (++j[e] <= l[e] + K) break;
                j[e] = l[e] - K;
            }
        }
        float *const dst = a.d_grid + en * a.grid_stride + cell;
        *dst = en == e_first ? acc : *dst + acc;  // a shared grid: the entries in order
    }
}

// The slot window's limits: the ring's bytes within the shared memory a block may take on Hopper (227 KB), and the
// K it holds (its byte-packed offsets take |K| <= 32)
#define WG_SMEM_LIMIT 232448

template <int D>
static bool tiled_route(int K) {
    return K >= 1 && K <= 32 && 2 * K < wg_cols(D, K) && (D == 2 || 2 * K < wg_rows(D, K));
}

template <int D, bool EXTREMA, int KT, typename Idx>
static int launch_grid_grad(const InterpGradArgs &a, dim3 grid, int smem, cudaStream_t s) {
    auto kernel = window_interp_grid_grad_kernel<D, EXTREMA, KT, Idx>;
    static bool opted_in = false;  // above 48 KB a kernel must opt in to its dynamic shared memory, once
    if (!opted_in) {
        const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM_LIMIT);
        if (e != cudaSuccess) return (int)e;
        opted_in = true;
    }
    kernel<<<grid, wg_threads(D, a.K), smem, s>>>(a);
    return (int)cudaGetLastError();
}

// d_grid's kernel: the slot window's (its ring, shared bytes and grid from K, the grid's shape and the chunk that
// ops/interp.py::grad_plan picked) or, past its K, the wide one
template <int D, bool EXTREMA, typename Idx>
static int launch_grid_grad_k(const InterpGradArgs &a, cudaStream_t s) {
    const int K = a.K;
    const int entries = a.grid_stride ? a.nb : 1;
    if (!tiled_route<D>(K)) {
        const long long gz = (long long)entries * (D == 3 ? a.grid.n[0] : 1);
        const long long gy = (a.grid.n[D - 2] + WW_TY - 1) / WW_TY;
        if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidValue;
        const dim3 grid((a.grid.n[D - 1] + WW_TX - 1) / WW_TX, (unsigned)gy, (unsigned)gz);
        window_interp_wide_grid_grad_kernel<D, EXTREMA, Idx><<<grid, WI_THREADS, 0, s>>>(a);
        return (int)cudaGetLastError();
    }
    if (a.chunk < 1) return (int)cudaErrorInvalidValue;
    const int SY = wg_rows(D, K), SZ = wg_cols(D, K), NS = wg_threads(D, K);
    const int plane = NS * 4 * (2 + (1 << D));  // bytes of a slot plane: floors, corner offset, coefficients
    InterpGradArgs b = a;
    b.ring = (2 * K + 2) * plane <= WG_SMEM_LIMIT ? 2 * K + 2 : 1;
    const long long gx = (a.grid.n[D - 1] + SZ - 2 * K - 1) / (SZ - 2 * K);
    const long long gy = D == 3 ? (a.grid.n[1] + SY - 2 * K - 1) / (SY - 2 * K) : 1;
    const long long gz = (long long)entries * ((a.grid.n[0] + a.chunk - 1) / a.chunk);
    if (gy > 65535 || gz > 65535 || gx > 2147483647LL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
    if (K == 1) return launch_grid_grad<D, EXTREMA, 1, Idx>(b, grid, b.ring * plane, s);
    return launch_grid_grad<D, EXTREMA, 0, Idx>(b, grid, b.ring * plane, s);
}

// The two kernels of one K6T / K7T call: d_grid's (where asked), then d_disp's (where asked, or to mark the NaN
// outputs' taps in d_grid). Empty outputs launch nothing (the wrapper fills the gradients).
template <int D>
static int launch_grad(const InterpGradArgs &a, int extrema, cudaStream_t s) {
    if (a.nb < 1 || a.K < 1) return (int)cudaErrorInvalidValue;
    long long n_grid = 1, n_out = 1;
    for (int e = 0; e < D; ++e) {
        n_grid *= a.grid.n[e];
        n_out *= a.o[e];
    }
    if (n_grid == 0 || n_out == 0) return 0;
    // 32-bit element offsets within an entry where its grid and its outputs have fewer than 2^31 elements
    const bool small = n_grid < (1LL << 31) && n_out < (1LL << 31);
    const long long planes = (long long)a.nb * (D == 3 ? a.o[0] : 1);
    if (planes > 65535) return (int)cudaErrorInvalidValue;
    if (a.d_grid) {
        const int e = extrema ? (small ? launch_grid_grad_k<D, true, int>(a, s)
                                       : launch_grid_grad_k<D, true, long long>(a, s))
                              : (small ? launch_grid_grad_k<D, false, int>(a, s)
                                       : launch_grid_grad_k<D, false, long long>(a, s));
        if (e != 0) return e;
    }
    // after d_grid's: d_disp, and the NaN of outputs with a NaN displacement stored into their taps in d_grid
    if (!a.d_disp[0] && !(a.d_grid && a.g_out)) return 0;
    if (a.d_disp[0] && !a.flag) return (int)cudaErrorInvalidValue;
    const dim3 g((a.o[D - 1] + WI_TX - 1) / WI_TX, (a.o[D - 2] + WI_TY - 1) / WI_TY, (unsigned)planes);
    // with the forward's verdict, an instantiation without the grid's test, which then costs it no registers
    if (a.verdict) {
        if (small) window_interp_disp_grad_kernel<D, int, false><<<g, WI_THREADS, 0, s>>>(a);
        else window_interp_disp_grad_kernel<D, long long, false><<<g, WI_THREADS, 0, s>>>(a);
    } else {
        if (small) window_interp_disp_grad_kernel<D, int, true><<<g, WI_THREADS, 0, s>>>(a);
        else window_interp_disp_grad_kernel<D, long long, true><<<g, WI_THREADS, 0, s>>>(a);
    }
    // then, for d_disp, the outputs whose window holds a NaN or an infinity of the grid (the fix kernel's comment)
    if (a.d_disp[0]) launch_fix(window_interp_disp_fix_kernel<D>, a, n_out * a.nb, s);
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

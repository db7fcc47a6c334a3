// K5 fused_advect — replaces phiflow_tpu/ops/advect3d.py::fused_advect_3d, the
// semi-Lagrangian advection of the 3D smoke step with displacements built
// in-kernel from the raw staggered (MAC) velocity.
//
// One launch computes every output (OutSpec of the Python wrapper) of a call,
// as the TPU kernel does: a step is three launches (the MacCormack forward
// pass with its extrema; the backward pass with the combine, clamp and
// inflow; the three velocity components with buoyancy). At an output point:
//   1. the displacement (dx, dy, dz) from the three velocity arrays: the own
//      face for the own component of a staggered output, the 4-point cross
//      average for the other components, the 2-point average at a cell centre
//      (phiflow_tpu/ops/advect3d.py:39-46, 280-314);
//   2. scaled by -dt/dx (sign folded in for the MacCormack backward pass) and
//      clipped to +-K cells;
//   3. the trilinear value of the advected array at point + displacement from
//      its 8 corners and, when asked, the MacCormack min/max over the corners
//      that carry weight (|d - s| < 1 on every axis, as the TPU window counts
//      them: the upper corner of an axis whose displacement is an integer is
//      left out);
//   4. in this order: MacCormack combine and clip, an added blocked operand,
//      the soft-sphere inflow (cell units). The buoyancy lift plane of the
//      result is a second small pass (advect_lift).
//
// Arrays are read in their raw layout; boundaries are resolved by index: an
// array's logical index l on an axis maps to raw index l - shift (shift 1 on
// the own axis of a closed-box face component, whose raw array holds the
// interior faces 1..N-1) and outside the raw extent the array is a constant,
// clamps to its edge (zero gradient) or wraps (periodic).
//
// Bound: device-memory bytes (each input read once, each output written once;
// a few dozen flops per point). The first form, one thread per point reading
// through the caches, was bound by instructions instead: every tap resolved
// three indices through the boundary mode and formed a 64-bit offset, and
// call 3 took three launches that each read all three velocity arrays. Here a
// block owns a tile of output points (t0 x t1 x 32, z contiguous) and first
// stages, with cp.async, every array the call reads into shared memory over
// the tile plus the halo its taps reach: an advected array (a slab) over
// [o - K, o + t + K + 1] on each axis (the corner window of a displacement
// clipped to +-K, one more for a staggered output's own axis), a velocity
// array read only for displacements over [o, o + t]. The boundary mode is
// resolved once per staged index, in per-axis tables; from then on every tap
// is an unconditional 32-bit shared-memory read. A source whose z rows are
// aligned is copied 16 bytes at a time: the staged z range starts and ends on
// a multiple of 4. The per-output work is templated on the output's staggered
// axis and on the extrema, so the displacement and corner loops carry no
// branch; the epilogue's options are uniform across the block. The tile is
// chosen by ops/advect3d.py::advect_plan to fit the call's staged arrays in
// shared memory for its K.
//
// A NaN or an infinity in an advected source (fault 3.13): the window sum
// reads every tap of [-K, K]^3, so such a value at a tap of weight 0 still
// reaches the output, where the corner gather would not read it. The kernel
// tests each output's own cell of its advected source (from shared memory, as
// the output is computed) and the source's cells that are no output's own
// (test_shells), and raises a device flag at a non-finite one; the fix kernel
// launched after it returns at once unless the flag is raised, and then
// computes every output again from the whole window (window.cuh, fix_raised).
// Scanning each block's staged slabs instead, its halo cells included, cost
// the step 7%.
#include <cuda_pipeline.h>

#include <algorithm>
#include <cmath>

#include "window.cuh"

#define ADV_MAX_SRC 5
#define ADV_MAX_OUT 4
#define ADV_THREADS 256
#define ADV_TZ 32  // tile extent along z (contiguous): one warp a row

struct Blk {  // an operand indexed by the output point (shape >= the output's)
    const float *p;
    int n1, n2;
};

struct Staged {  // a source's copy in shared memory
    int off;     // offset in floats; -1: not staged
    int tab;     // offset in ints of its three resolved-index tables
    int lo[3];   // staged index 0 = tile origin - lo, per axis
    int e[3];    // extent per axis (lo[2], e[2] whole groups of 4 where the tile allows)
};

struct OutArgs {
    int slab;        // the advected source
    int d_own;       // own axis of a staggered output, -1 for a centred one
    float scale[3];  // velocity units -> cells, sign included
    int extrema;
    float *out, *out_lo, *out_up;
    int o[3];  // output shape
    int combine;
    Blk c_field, c_lo, c_up;
    float c_half_strength;
    int add_blocked;
    Blk add;
    float add_scale;
    int add_ball;
    float ball[5];  // cx, cy, cz, radius (cells), rate
};

// The raw cells of an output's advected source outside the box [c, c + w) of its outputs' own cells: cnt0 with
// axis 0 outside the box, then cnt1 with axis 0 inside and axis 1 outside, the rest with axis 2 outside.
struct Shell {
    int c[3], w[3];
    long long cnt0, cnt1, total;
};

struct AdvectArgs {
    Src src[ADV_MAX_SRC];
    Staged st[ADV_MAX_SRC];
    OutArgs out[ADV_MAX_OUT];
    int n_src, n_out, K;
    int t[2];       // tile extent along x and y (powers of 2; z: ADV_TZ)
    int log2_t1;    // log2 t[1]
    int *flag;      // two ints on the device, 0 between calls (window.cuh, fix_raised)
    // set by the C entry:
    int tiles[3];                // the first kernel's grid (x, y, z): tiles along axes 2, 1 and 0
    int fix_always;              // an advected source's constant halo is NaN or +-inf
    Shell shell[ADV_MAX_OUT];    // per output, its advected source's cells that are no output's own (test_shells)
};

__device__ __forceinline__ float blk(const Blk &b, int o0, int o1, int o2) {
    return __ldg(b.p + ((long long)o0 * b.n1 + o1) * b.n2 + o2);
}

// The per-axis tables of a staged source: the raw index of each staged index
// (-1 outside a constant source).
__device__ __forceinline__ void stage_tables(const Src &src, const Staged &st, const int (&o0)[3], int *tabs) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        int *tab = tabs + st.tab + (a > 0 ? st.e[0] : 0) + (a > 1 ? st.e[1] : 0);
        for (int x = threadIdx.x; x < st.e[a]; x += ADV_THREADS) {
            const int raw = o0[a] - st.lo[a] + x - src.shift[a], n = src.n[a];
            int r;
            if (src.mode == SRC_WRAP) r = ((raw % n) + n) % n;
            else if (src.mode == SRC_EDGE) r = min(max(raw, 0), n - 1);
            else r = (raw >= 0 && raw < n) ? raw : -1;
            tab[x] = r;
        }
    }
}

// Copy a staged source in: 16 bytes at a time where its z rows allow it (raw
// z = logical z, rows of a multiple of 4 from a 16-byte aligned start, the
// block's z range inside the array), else element by element; the constant
// where a table says outside.
__device__ __forceinline__ void stage_copy(const Src &src, const Staged &st, const int *tabs, float *sm,
                                           const int (&o0)[3]) {
    const int z0 = o0[2] - st.lo[2];
    const bool vec = src.shift[2] == 0 && (src.n[2] & 3) == 0 && ((unsigned long long)src.p & 15) == 0 &&
                     ((z0 | st.e[2] | st.off) & 3) == 0 && z0 >= 0 && z0 + st.e[2] <= src.n[2];
    const int w = vec ? 4 : 1;  // floats a copy
    const int e0 = st.e[0], e1 = st.e[1], e2 = st.e[2] / w, total = e0 * e1 * e2;
    const int *t0 = tabs + st.tab, *t1 = t0 + e0, *t2 = t1 + e1;
    float *dst = sm + st.off;
    // (i, j, k) of this thread's flat index, advanced by ADV_THREADS with carries
    int k = threadIdx.x % e2, r = threadIdx.x / e2, j = r % e1, i = r / e1;
    const int dk = ADV_THREADS % e2, dr = ADV_THREADS / e2, dj = dr % e1, di = dr / e1;
    for (int idx = threadIdx.x; idx < total; idx += ADV_THREADS) {
        const int r0 = t0[i], r1 = t1[j];
        const long long row = ((long long)r0 * src.n[1] + r1) * src.n[2];
        if (vec) {
            float *d = dst + 4 * idx;
            if ((r0 | r1) < 0) d[0] = d[1] = d[2] = d[3] = src.c;
            else __pipeline_memcpy_async(d, src.p + row + z0 + 4 * k, 16);
        } else {
            const int r2 = t2[k];
            if ((r0 | r1 | r2) < 0) dst[idx] = src.c;
            else __pipeline_memcpy_async(dst + idx, src.p + row + r2, 4);
        }
        k += dk;
        if (k >= e2) {
            k -= e2;
            ++j;
        }
        j += dj;
        if (j >= e1) {
            j -= e1;
            ++i;
        }
        i += di;
    }
}

// The window sum over every tap of [-K, K]^3 around the staged index qw, unfused, in the twin's order (x innermost,
// then z, then y: ops/advect3d.py::_fused_advect_plain), the tent weights of the clipped displacement (d0, d1, d2)
// (NaN where it is). The fix kernel's; not inlined.
__device__ __noinline__ float window_sum_full(const float *fld, int qw, int fs0, int fs1, int K, float d0, float d1,
                                              float d2) {
    float acc = 0.f;
    for (int sy = -K; sy <= K; ++sy) {
        float z_acc = 0.f;
        for (int sz = -K; sz <= K; ++sz) {
            float x_acc = 0.f;
            for (int sx = -K; sx <= K; ++sx) {
                const float wx = d0 != d0 ? d0 : fmaxf(0.f, 1.f - fabsf(d0 - (float)sx));
                x_acc = __fadd_rn(x_acc, __fmul_rn(fld[qw + sx * fs0 + sy * fs1 + sz], wx));
            }
            const float wz = d2 != d2 ? d2 : fmaxf(0.f, 1.f - fabsf(d2 - (float)sz));
            z_acc = __fadd_rn(z_acc, __fmul_rn(x_acc, wz));
        }
        const float wy = d1 != d1 ? d1 : fmaxf(0.f, 1.f - fabsf(d1 - (float)sy));
        acc = __fadd_rn(acc, __fmul_rn(z_acc, wy));
    }
    return acc;
}

// One output over the block's tile. D: staggered axis (-1 centred), EX: extrema. The value is the trilinear sum of
// the 8 corners that carry weight; in the fix kernel (FIX) the window sum over every tap of [-K, K]^3 in the twin's
// order (x innermost, then z, then y: ops/advect3d.py::_fused_advect_plain), which carries a non-finite value at a
// tap of weight 0 into the output as 0 * NaN or 0 * inf. Returns the maximum of the exponent bits of the advected
// source at the outputs' own cells (the first kernel's test of fault 3.13; 0 in the fix kernel).
template <int D, bool EX, bool FIX>
__device__ __forceinline__ unsigned advect_tile(const AdvectArgs &a, const OutArgs &A, const float *sm,
                                                const int (&o0)[3]) {
    const int T0 = a.t[0], T1 = a.t[1], K = a.K;
    const Staged &F = a.st[A.slab];
    const float *fld = sm + F.off;
    const int fs1 = F.e[2], fs0 = F.e[1] * fs1;
    unsigned bad = 0;
    for (int p = threadIdx.x; p < T0 * T1 * ADV_TZ; p += ADV_THREADS) {
        const int kk = p % ADV_TZ, rr = p / ADV_TZ, jj = rr & (T1 - 1), ii = rr >> a.log2_t1;
        const int o[3] = {o0[0] + ii, o0[1] + jj, o0[2] + kk};
        if (o[0] >= A.o[0] || o[1] >= A.o[1] || o[2] >= A.o[2]) continue;
        // logical index relative to the tile origin
        const int l[3] = {ii + (D == 0), jj + (D == 1), kk + (D == 2)};
        float disp[3];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
            const Staged &S = a.st[e];
            const float *v = sm + S.off;
            const int s1 = S.e[2], s0 = S.e[1] * s1;
            const int se[3] = {s0, s1, 1};
            const int q = (l[0] + S.lo[0]) * s0 + (l[1] + S.lo[1]) * s1 + (l[2] + S.lo[2]);
            float u;
            if (D < 0) {
                u = (v[q] + v[q + se[e]]) * 0.5f;
            } else if (e == D) {
                u = v[q];
            } else {
                u = 0.f;
#pragma unroll
                for (int bb = 0; bb < 2; ++bb)       // e-axis offset
#pragma unroll
                    for (int aa = -1; aa <= 0; ++aa)  // d-axis offset
                        u += v[q + aa * se[D < 0 ? 0 : D] + bb * se[e]];
                u *= 0.25f;
            }
            disp[e] = clip_cells(A.scale[e], u, K);
        }
        int base[3];
        float wt[3][2];
        bool hit[3][2];
#pragma unroll
        for (int e = 0; e < 3; ++e) base[e] = l[e] + F.lo[e] + window_taps(disp[e], wt[e], hit[e]);
        const int qc = base[0] * fs0 + base[1] * fs1 + base[2];
        const int qw = (l[0] + F.lo[0]) * fs0 + (l[1] + F.lo[1]) * fs1 + (l[2] + F.lo[2]);  // the own cell
        const float center = fld[qw];
        if (!FIX) bad = max(bad, exponent_bits(center));
        float val = 0.f, lo = 3.4e38f, up = -3.4e38f;
#pragma unroll
        for (int cx = 0; cx < 2; ++cx)
#pragma unroll
            for (int cy = 0; cy < 2; ++cy)
#pragma unroll
                for (int cz = 0; cz < 2; ++cz) {
                    const float v = fld[qc + cx * fs0 + cy * fs1 + cz];
                    if (!FIX) val += wt[0][cx] * wt[1][cy] * wt[2][cz] * v;
                    if (EX && hit[0][cx] && hit[1][cy] && hit[2][cz]) {
                        lo = min_nan(lo, v);
                        up = max_nan(up, v);
                    }
                }
        if (FIX) val = window_sum_full(fld, qw, fs0, fs1, K, disp[0], disp[1], disp[2]);
        if (A.combine) {
            const float corrected = center + A.c_half_strength * (blk(A.c_field, o[0], o[1], o[2]) - val);
            val = clip_nan(corrected, blk(A.c_lo, o[0], o[1], o[2]), blk(A.c_up, o[0], o[1], o[2]));
        }
        if (A.add_blocked) val += A.add_scale * blk(A.add, o[0], o[1], o[2]);
        if (A.add_ball) {
            const float gx = (float)o[0] + 0.5f - A.ball[0];
            const float gy = (float)o[1] + 0.5f - A.ball[1];
            const float gz = (float)o[2] + 0.5f - A.ball[2];
            const float dist = sqrtf(gx * gx + gy * gy + gz * gz);
            const float frac = fminf(fmaxf(0.5f + (A.ball[3] - dist), 0.f), 1.f);
            val += A.ball[4] * frac;
        }
        const long long q = ((long long)o[0] * A.o[1] + o[1]) * A.o[2] + o[2];
        A.out[q] = val;
        if (EX) {
            A.out_lo[q] = lo;
            A.out_up[q] = up;
        }
    }
    return bad;
}

// The tile at origin o0: every staged source copied into shared memory, then every output (advect_tile).
template <bool FIX>
__device__ __forceinline__ unsigned advect_block(const AdvectArgs &a, float *sm, int *tabs, const int (&o0)[3]) {
    for (int s = 0; s < a.n_src; ++s)
        if (a.st[s].off >= 0) stage_tables(a.src[s], a.st[s], o0, tabs);
    __syncthreads();
    for (int s = 0; s < a.n_src; ++s)
        if (a.st[s].off >= 0) stage_copy(a.src[s], a.st[s], tabs, sm, o0);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    unsigned bad = 0;
    for (int j = 0; j < a.n_out; ++j) {
        const OutArgs &A = a.out[j];
        unsigned b = 0;
        switch (A.d_own * 2 + (A.extrema ? 1 : 0)) {
            case -2: b = advect_tile<-1, false, FIX>(a, A, sm, o0); break;
            case -1: b = advect_tile<-1, true, FIX>(a, A, sm, o0); break;
            case 0: b = advect_tile<0, false, FIX>(a, A, sm, o0); break;
            case 1: b = advect_tile<0, true, FIX>(a, A, sm, o0); break;
            case 2: b = advect_tile<1, false, FIX>(a, A, sm, o0); break;
            case 3: b = advect_tile<1, true, FIX>(a, A, sm, o0); break;
            case 4: b = advect_tile<2, false, FIX>(a, A, sm, o0); break;
            case 5: b = advect_tile<2, true, FIX>(a, A, sm, o0); break;
        }
        bad = max(bad, b);
    }
    return bad;
}

// Where a block's index tables start in shared memory: after every staged source.
__device__ __forceinline__ int *stage_tabs(const AdvectArgs &a, float *sm) {
    int tab_start = 0;
    for (int s = 0; s < a.n_src; ++s)
        if (a.st[s].off >= 0) tab_start = max(tab_start, a.st[s].off + a.st[s].e[0] * a.st[s].e[1] * a.st[s].e[2]);
    return reinterpret_cast<int *>(sm + tab_start);
}

// Fault 3.13's test of the advected sources' raw cells that no output's own cell is (advect_tile tests those): the
// cells outside the box of own cells (Shell, set by the C entry), spread over the launch's threads. Usually none (a
// centred output over its source's shape, a closed box's interior faces); a plane of a periodic face component.
__device__ __forceinline__ unsigned test_shells(const AdvectArgs &a) {
    unsigned bad = 0;
    for (int j = 0; j < a.n_out; ++j) {
        const Shell &h = a.shell[j];
        if (!h.total) continue;
        const Src &s = a.src[a.out[j].slab];
        const long long T = (long long)gridDim.x * gridDim.y * gridDim.z * ADV_THREADS;
        const long long t0 =
            (((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * ADV_THREADS + threadIdx.x;
        const long long n12 = (long long)s.n[1] * s.n[2];
        for (long long r = t0; r < h.total; r += T) {
            int x, y, z;
            if (r < h.cnt0) {  // axis 0 outside the box
                const long long i = r / n12, rest = r - i * n12;
                x = (int)i < h.c[0] ? (int)i : (int)i + h.w[0];
                y = (int)(rest / s.n[2]), z = (int)(rest % s.n[2]);
            } else if (r < h.cnt0 + h.cnt1) {  // axis 0 inside, axis 1 outside
                const long long rr = r - h.cnt0, per = (long long)(s.n[1] - h.w[1]) * s.n[2];
                const long long i = rr / per, rest = rr - i * per;
                const int yy = (int)(rest / s.n[2]);
                x = h.c[0] + (int)i, y = yy < h.c[1] ? yy : yy + h.w[1], z = (int)(rest % s.n[2]);
            } else {  // axes 0 and 1 inside, axis 2 outside
                const int out2 = s.n[2] - h.w[2];
                const long long rr = r - h.cnt0 - h.cnt1, per = (long long)h.w[1] * out2;
                const long long i = rr / per, rest = rr - i * per;
                const int zz = (int)(rest % out2);
                x = h.c[0] + (int)i, y = h.c[1] + (int)(rest / out2), z = zz < h.c[2] ? zz : zz + h.w[2];
            }
            bad = max(bad, exponent_bits(__ldg(s.p + ((long long)x * s.n[1] + y) * s.n[2] + z)));
        }
    }
    return bad;
}

__global__ void __launch_bounds__(ADV_THREADS) fused_advect_kernel(const __grid_constant__ AdvectArgs a) {
    extern __shared__ float sm[];
    const int o0[3] = {(int)blockIdx.z * a.t[0], (int)blockIdx.y * a.t[1], (int)blockIdx.x * ADV_TZ};
    const unsigned bad = max(test_shells(a), advect_block<false>(a, sm, stage_tabs(a, sm), o0));
    if (bad == 0x7f800000u) *a.flag = 1;
}

// K5's fix kernel (window.cuh, fix_raised), launched after every fused_advect_kernel: it returns at once unless an
// advected source held a NaN or an infinity. Then every output of the call is computed again, its value the window
// sum over every tap (advect_tile's FIX), not only the outputs whose window holds such a cell: at d = +K the corner
// gather also multiplies the cell past the window by its weight 0. A block an SM strides over the first kernel's
// tiles, with its shared memory.
__global__ void __launch_bounds__(ADV_THREADS) fused_advect_fix_kernel(const __grid_constant__ AdvectArgs a) {
    if (!fix_raised(a.flag, a.fix_always)) return;
    extern __shared__ float sm[];
    int *tabs = stage_tabs(a, sm);
    const long long n_tiles = (long long)a.tiles[0] * a.tiles[1] * a.tiles[2];
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int bx = (int)(t % a.tiles[0]), by = (int)(t / a.tiles[0] % a.tiles[1]),
                  bz = (int)(t / ((long long)a.tiles[0] * a.tiles[1]));
        const int o0[3] = {bz * a.t[0], by * a.t[1], bx * ADV_TZ};
        advect_block<true>(a, sm, tabs, o0);
        __syncthreads();  // the next tile's tables and copies overwrite this one's
    }
    fix_done(a.flag);
}

// lift[c] = half_scale * (val[c] + val[c + e_axis]), the neighbour wrapping
// at the end of the axis (the last row pairs with the first).
__global__ void advect_lift_kernel(const float *__restrict__ val, float *__restrict__ lift, int n0, int n1, int n2,
                                   int axis, float half_scale) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x, j = blockIdx.y, i = blockIdx.z;
    if (k >= n2) return;
    int m[3] = {i, j, k};
    const int n[3] = {n0, n1, n2};
    m[axis] = m[axis] + 1 == n[axis] ? 0 : m[axis] + 1;
    const long long q = ((long long)i * n1 + j) * n2 + k;
    const long long qn = ((long long)m[0] * n1 + m[1]) * n2 + m[2];
    lift[q] = half_scale * (val[q] + val[qn]);
}

// grid: tiles over the union of the outputs' shapes (u0, u1, u2); smem: the
// bytes of the staged arrays and their index tables, as the wrapper's plan
// counts them (checked here against the staged extents). Then the fix kernel,
// a programmatic dependent of the first (window.cuh, fix_raised).
extern "C" int fused_advect(const AdvectArgs *args, int u0, int u1, int u2, int smem, void *stream) {
    if (args->n_src > ADV_MAX_SRC || args->n_out > ADV_MAX_OUT || args->n_out < 1 || !args->flag)
        return (int)cudaErrorInvalidValue;
    long long need = 0;
    for (int s = 0; s < args->n_src; ++s)
        if (args->st[s].off >= 0) {
            const long long e = (long long)args->st[s].e[0] * args->st[s].e[1] * args->st[s].e[2];
            need += 4 * (e + args->st[s].e[0] + args->st[s].e[1] + args->st[s].e[2]);
        }
    if (need > smem) return (int)cudaErrorInvalidValue;
    static int sms = 0;  // and dynamic shared memory above 48 KB, opted in once
    if (!sms) {
        cudaError_t e = cudaFuncSetAttribute(fused_advect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(fused_advect_fix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
        if (e != cudaSuccess) return (int)e;
    }
    AdvectArgs a = *args;
    a.tiles[0] = (u2 + ADV_TZ - 1) / ADV_TZ, a.tiles[1] = (u1 + a.t[1] - 1) / a.t[1],
    a.tiles[2] = (u0 + a.t[0] - 1) / a.t[0];
    a.fix_always = 0;
    for (int j = 0; j < a.n_out; ++j) {
        const OutArgs &A = a.out[j];
        const Src &s = a.src[A.slab];
        a.fix_always |= s.mode == SRC_CONST && !std::isfinite(s.c);
        Shell &h = a.shell[j];
        for (int ax = 0; ax < 3; ++ax) {  // own cells: raw index o + (ax == d_own) - shift for o in [0, o[ax])
            const int first = (A.d_own == ax) - s.shift[ax];
            h.c[ax] = std::max(0, first);
            h.w[ax] = std::max(0, std::min(s.n[ax], first + A.o[ax]) - h.c[ax]);
        }
        h.cnt0 = (long long)(s.n[0] - h.w[0]) * s.n[1] * s.n[2];
        h.cnt1 = (long long)h.w[0] * (s.n[1] - h.w[1]) * s.n[2];
        h.total = h.cnt0 + h.cnt1 + (long long)h.w[0] * h.w[1] * (s.n[2] - h.w[2]);
    }
    const long long n_tiles = (long long)a.tiles[0] * a.tiles[1] * a.tiles[2];
    if (n_tiles == 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
    fused_advect_kernel<<<dim3(a.tiles[0], a.tiles[1], a.tiles[2]), ADV_THREADS, smem, st>>>(a);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(n_tiles < sms ? n_tiles : sms));
    cfg.blockDim = dim3(ADV_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, fused_advect_fix_kernel, a);
    return (int)cudaGetLastError();
}

extern "C" int advect_lift(const float *val, float *lift, int n0, int n1, int n2, int axis, float half_scale, int bx,
                           void *stream) {
    const dim3 grid((n2 + bx - 1) / bx, n1, n0);
    advect_lift_kernel<<<grid, bx, 0, (cudaStream_t)stream>>>(val, lift, n0, n1, n2, axis, half_scale);
    return (int)cudaGetLastError();
}

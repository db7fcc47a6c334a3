// The 7-point Poisson stencil of the pressure solve, with its three kernels:
//
//   K1 stencil_kernel    replaces phiflow_tpu/ops/poisson.py::_apply_pallas_3d
//                        (the CG matvec, with the fused <p, A p> partials), in
//                        the unmasked form and the masked one (K1m: obstacle
//                        coefficients, the free surface's active cells, or
//                        both), runs of cells marching along x
//   K2 smooth_kernel     replaces phiflow_tpu/ops/poisson.py::_jacobi2_pallas_3d
//                        (V-cycle smoothing: 1-3 sweeps in one launch, the
//                        intermediate sweeps kept in shared memory)
//   K3 residual_restrict_kernel replaces phiflow_tpu/ops/poisson.py::_residual_restrict_pallas_3d
//                        (restrict_mean(b - A u); the fine residual is never
//                        stored), runs of coarse cells marching along x
//
//   lap(c) = sum_d inv_d * (a-_d(c) p[c - e_d] + a+_d(c) p[c + e_d] + c0_d(c) p[c])
//
// with per-axis, per-side boundary modes: periodic (the neighbour wraps),
// neumann (the outer face flux is dropped: a = 0, c0 = -1) and ghost0 (the
// ghost cell holds 0: a = 0, c0 = -2) — the profiles of
// phiflow_tpu/ops/poisson.py::_unmasked_coeffs_1d, formed here from the global
// index.
//
// The masked form of K1 reads its coefficients from arrays instead
// (phiflow_tpu/ops/poisson.py::stage_masks): mA_d holds a-_d per cell, a+_d is
// mA_d one cell up along d (0 past a non-periodic last plane, by definition),
// c0 is the whole centre coefficient, 1/dx^2 included:
//
//   lap(c) = sum_d inv_d * (mA_d(c) p[c - e_d] + mA_d(c + e_d) p[c + e_d]) + c0(c) p[c]
//
// Independently, `active` marks the cells the system covers: where it is 0
// the result is p itself (an identity row), after the epilogue and before the
// <p, out> partial, so such a cell contributes p^2 to the dot.
//
// Bound: every kernel here does a few flops per byte, far below the card's
// ~20 flop/byte balance point in float32, so each is bound by device-memory
// bytes (inputs read once, outputs written once at best); on the card the
// loads and instructions a cell costs on the way decide how near each comes.
// K1 and K3 give a thread a run of z-neighbouring cells, 16 bytes of the
// operand (K1m: of each mask), marching along x with the planes x-1, x, x+1 of
// the run in registers, so a cell costs a share of one vector load of its own
// plane; the y neighbours are the neighbouring threads' runs (from L1), the z
// neighbours the neighbouring lanes' by shuffle (see `march` below). K2 would
// move every intermediate sweep through device memory that way (a float32
// write and read of the whole field a sweep), so it keeps them in shared
// memory instead: the smooth reads u and b once (plus a halo) and writes its
// result once, whatever its sweep count (see its kernel below). Storage is
// float32 or bfloat16; arithmetic is float32 in registers.
//
// Batches: every kernel here takes g.nb independent fields of the grid's shape,
// stored one after the other (a leading batch axis), in one launch. The entry
// is folded into the grid's slowest axis (blockIdx.z: the entry's x chunks, or
// K4's coarse planes, one entry after the other), so no block straddles two
// entries: a block offsets its pointers by its entry's first element (64-bit)
// and then runs as in an unbatched launch, and the per-block partials of a dot
// come out entry by entry, contiguous, for the wrapper to sum per entry. K1m's
// masks come at an entry stride of their own: 0 where one set of masks is
// shared by the batch (an obstacle geometry or free surface of every entry,
// read in place by each, never expanded), X Y Z where they carry the batch
// (JAX's poisson_apply takes either), so an entry computes exactly what its
// own unbatched launch computes.
#include "common.cuh"

#define MODE_PERIODIC 0
#define MODE_NEUMANN 1
#define MODE_GHOST0 2

#define EPI_MATVEC 0
#define EPI_RESIDUAL 1
#define EPI_JACOBI 2

struct Grid {
    int n[3];      // cells per axis (x, y, z); z is contiguous
    float inv[3];  // 1 / dx^2 per axis
    int lo[3];     // boundary mode of the lower side of each axis
    int hi[3];     // boundary mode of the upper side of each axis
    int nb;        // entries of the batch (1: one field)
};

// The entry of this block, where blockIdx.z runs over gridDim.z / nb slabs of each entry in turn, and the block's
// slab within its entry.
__device__ __forceinline__ int block_entry(int nb, int &slab) {
    const int per = gridDim.z / nb;
    const int e = blockIdx.z / per;
    slab = blockIdx.z - e * per;
    return e;
}

__device__ __forceinline__ int block_index() { return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; }

// The masked form's coefficient arrays (float32, an entry's shape); mA[0] is
// null for the boundary-profile coefficients, active null where every cell is.
struct Masks {
    const float *mA[3];
    const float *c0;
    const float *active;
    long long stride;  // elements from one entry's masks to the next (0: shared by the batch)
};

// ---------------------------------------------------------------------------
// K2: one smooth of 1-3 damped-Jacobi sweeps u <- u + w (b - A u) in one launch,
// the counterpart of phiflow_tpu/ops/poisson.py::_jacobi2_pallas_3d.
//
// Bound: device-memory bytes, u and b read once and the result written once,
// if the intermediate sweeps never reach device memory. Design: 2.5D temporal
// blocking. A block owns a TY x TZ tile of (y, z) outputs (16 x 64, or 16 x 16
// on a field narrower than 64 in z) and marches along x over a chunk of `cx`
// planes. Each plane t of u and b is staged into shared memory over the tile
// grown by S cells in y and z (S: the stencil sweeps of the launch); sweep s
// then computes plane t - s over the tile grown by S - s, reading a ring of
// three float32 planes of sweep s - 1, and the last sweep writes the output.
// A chunk starts S planes early and ends S planes late (the x halo), so no
// block reads another's results; the halo re-read comes from L2. Staged
// cells past a periodic side wrap; past a non-periodic side they are 0 and
// stay 0 through the sweeps, so only the centre coefficient carries the
// boundary. A thread owns the same quads of z-neighbouring cells in every
// plane and sweep (staged rows padded to whole quads), so a plane needs one
// barrier, a quad is read and written with 16-byte shared-memory accesses,
// and the next plane's loads are in flight while this plane's sweeps run.
// With zero_init the staged level is u0 = w b and u is not read. Optional
// per-block <out, b> partials from the float32 result. On the card the
// sweeps' instructions and latency, not the bytes, set the time (PERF.md).
// ---------------------------------------------------------------------------
namespace smooth {
constexpr int TY = 16, THREADS = 512;  // TZ, the tile's z width, is 64 (fields with Z >= 64) or 16
constexpr int MIN_BLOCKS = 2;  // blocks an SM: at most 64 registers a thread

template <int S, int TZ>
struct Geom {
    static constexpr int W = (TZ + 2 * S + 3) / 4 * 4;  // staged row pitch (z): the grown row padded to whole quads
    static constexpr int PL = W * (TY + 2 * S);    // floats a staged plane
    static constexpr int R = S + 1;                // b planes alive at once
    static constexpr int PLANES = 3 * S + R;       // S level rings of 3, then the b ring
    static constexpr int QUADS = (PL / 4 + THREADS - 1) / THREADS;  // a thread's quads of z-neighbours in a plane
    static constexpr int SMEM = 4 * PLANES * PL;   // bytes; the wrapper's plan must agree
};

// A raw position along an axis of n cells: true and its cell index where it
// holds a value (inside, or past a periodic side), false past a non-periodic side.
__device__ __forceinline__ bool resolve(int gi, int n, int lo, int hi, int &wi) {
    if (gi >= 0 && gi < n) {
        wi = gi;
        return true;
    }
    wi = ((gi % n) + n) % n;
    return gi < 0 ? lo == MODE_PERIODIC : hi == MODE_PERIODIC;
}

// The centre coefficient of the unmasked stencil at cell wi of an axis
// (axis_term's profile). The neighbour terms need none here: a neighbour past a
// non-periodic side is staged as 0, and every sweep keeps such cells at 0.
__device__ __forceinline__ float center_coef(int wi, int n, int lo, int hi) {
    float c0 = -2.f;
    if (wi == 0 && lo != MODE_PERIODIC) c0 = lo == MODE_GHOST0 ? -2.f : -1.f;
    if (wi == n - 1 && hi != MODE_PERIODIC) c0 = hi == MODE_GHOST0 ? -2.f : -1.f;
    return c0;
}

__device__ __forceinline__ int slot3(int p, int base) { return (p - base) % 3; }

// What a thread knows of each of its quads of z-neighbouring cells of a staged
// plane (the same quads at every plane and sweep), for each cell of a quad:
// its (y, z) offset in a field plane, or -1 past a non-periodic side; its
// ring, the cells it lies outside the output tile (it takes part in sweeps
// s <= S - ring; the row's padding and the plane's end lie in ring S + 1);
// the y and z share of its centre coefficient, inv_y c0_y + inv_z c0_z.
template <int N>
struct Quads {
    int off[N][4], ring[N][4];
    float c0yz[N][4];
};

__device__ __forceinline__ float4 lds4(const float *p) { return *reinterpret_cast<const float4 *>(p); }
__device__ __forceinline__ float el(const float4 &v, int e) { return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w; }

// Sweep s at plane p over the tile grown by H = S - s: into level s's ring
// (s < S) or to `out` with the dot's share (s == S). Each thread computes its
// own quads, so a cell's x neighbours of sweep s - 1 are the thread's own
// writes, and its y, z neighbours were written a plane, and a barrier, ago.
// A quad is read with 16-byte loads; all of a thread's quads are computed
// before any is stored, so their shared-memory loads are in flight together.
// A quad outside the sweep's tile is skipped, most often by a whole warp.
template <int S, int TZ, int s, typename TO>
__device__ __forceinline__ void sweep(float *smem, const Quads<Geom<S, TZ>::QUADS> &cl, int p, int x0, int y0,
                                      int z0, const Grid &g, float w, TO *__restrict__ out, float &contrib) {
    using G = Geom<S, TZ>;
    constexpr int H = S - s;
    const int base = x0 - S;  // the chunk's first staged plane
    const float *prev = smem + (s - 1) * 3 * G::PL;
    const float *pc_pl = prev + slot3(p, base) * G::PL;
    const float *xm_pl = prev + slot3(p - 1, base) * G::PL;
    const float *xp_pl = prev + slot3(p + 1, base) * G::PL;
    const float *b_pl = smem + (3 * S + (p - base) % G::R) * G::PL;
    int wx;
    const bool vx = resolve(p, g.n[0], g.lo[0], g.hi[0], wx);
    const float c0x = g.inv[0] * center_coef(wx, g.n[0], g.lo[0], g.hi[0]);
    float o[G::QUADS][4], bo[G::QUADS][4];
    bool in[G::QUADS];  // the quad takes part in this sweep
#pragma unroll
    for (int i = 0; i < G::QUADS; ++i) {
        const int li = 4 * (threadIdx.x + i * THREADS);
        in[i] = min(min(cl.ring[i][0], cl.ring[i][1]), min(cl.ring[i][2], cl.ring[i][3])) <= H;
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = bo[i][e] = 0.f;
        if (!in[i]) continue;
        const float4 pc = lds4(pc_pl + li), ym = lds4(pc_pl + li - G::W), yp = lds4(pc_pl + li + G::W);
        const float4 xm = lds4(xm_pl + li), xp = lds4(xp_pl + li), bq = lds4(b_pl + li);
        const float zm = pc_pl[li - 1], zp = pc_pl[li + 4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float c = el(pc, e), lo = e == 0 ? zm : el(pc, e - 1), hi = e == 3 ? zp : el(pc, e + 1);
            // the twin's form: the neighbour terms axis by axis, then the whole centre coefficient
            const float lap = g.inv[0] * (el(xm, e) + el(xp, e)) + g.inv[1] * (el(ym, e) + el(yp, e)) +
                              g.inv[2] * (lo + hi) + (c0x + cl.c0yz[i][e]) * c;
            const bool v = vx && cl.ring[i][e] <= H && cl.off[i][e] >= 0;
            bo[i][e] = el(bq, e);
            o[i][e] = v ? c + w * (bo[i][e] - lap) : 0.f;  // 0 past a non-periodic side
        }
    }
#pragma unroll
    for (int i = 0; i < G::QUADS; ++i) {
        if (!in[i]) continue;
        const int li = 4 * (threadIdx.x + i * THREADS);
        if (s < S) {
            *reinterpret_cast<float4 *>(smem + (s * 3 + slot3(p, base)) * G::PL + li) =
                make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
        } else {
            const int r = li / G::W, c = li - r * G::W, gy = y0 - S + r, gz = z0 - S + c;
            if (p >= g.n[0] || gy >= g.n[1]) continue;
            const long long q = ((long long)p * g.n[1] + gy) * g.n[2] + gz;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                if (cl.ring[i][e] == 0 && gz + e < g.n[2]) {  // an output of this block, inside the field
                    st(out, q + e, o[i][e]);
                    contrib += o[i][e] * bo[i][e];
                }
            }
        }
    }
}

template <int S, int TZ, typename TU, typename TB, typename TO>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) smooth_kernel(const TU *__restrict__ u, const TB *__restrict__ b,
                                                                     TO *__restrict__ out, float *__restrict__ partials,
                                                                     Grid g, float w, int zero_init, int cx) {
    using G = Geom<S, TZ>;
    extern __shared__ float smem[];
    int slab;
    const int entry = block_entry(g.nb, slab);
    const int z0 = blockIdx.x * TZ, y0 = blockIdx.y * TY, x0 = slab * cx;
    const int X = g.n[0], YZ = g.n[1] * g.n[2];
    const long long eoff = (long long)entry * X * YZ;  // the entry's first element
    if (!zero_init) u += eoff;
    b += eoff;
    out += eoff;
    Quads<G::QUADS> cl;
#pragma unroll
    for (int i = 0; i < G::QUADS; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int li = 4 * (threadIdx.x + i * THREADS) + e;
            const int r = li / G::W, c = li - r * G::W;
            const bool staged = li < G::PL && c < TZ + 2 * S;  // not the row's padding, not past the plane
            int wy, wz;
            const bool vy = resolve(y0 - S + r, g.n[1], g.lo[1], g.hi[1], wy);
            const bool vz = resolve(z0 - S + c, g.n[2], g.lo[2], g.hi[2], wz);
            cl.off[i][e] = staged && vy && vz ? wy * g.n[2] + wz : -1;
            cl.ring[i][e] = staged ? max(max(S - r, r - (S + TY - 1)), max(max(S - c, c - (S + TZ - 1)), 0)) : S + 1;
            cl.c0yz[i][e] = g.inv[1] * center_coef(wy, g.n[1], g.lo[1], g.hi[1]) +
                            g.inv[2] * center_coef(wz, g.n[2], g.lo[2], g.hi[2]);
        }
    }
    float ru[G::QUADS][4], rb[G::QUADS][4];  // the next plane, loaded while the sweeps of this one run
    auto fetch = [&](int t) {
        int wx;
        const bool vx = resolve(t, X, g.lo[0], g.hi[0], wx);
        const long long plane = (long long)wx * YZ;
        // every load unconditional (a cell past a non-periodic side reads its plane's first and takes 0), so
        // that they all issue together
#pragma unroll
        for (int i = 0; i < G::QUADS; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool v = vx && cl.off[i][e] >= 0;
                const long long q = plane + max(cl.off[i][e], 0);
                const float bv = ld(b, q);
                rb[i][e] = v ? bv : 0.f;
                if (zero_init) {
                    ru[i][e] = w * rb[i][e];
                } else {
                    const float uv = ld(u, q);
                    ru[i][e] = v ? uv : 0.f;
                }
            }
        }
    };
    float contrib = 0.f;
    const int t_end = min(x0 + cx, X) - 1 + S;  // the last output plane's x halo
    fetch(x0 - S);
    for (int t = x0 - S; t <= t_end; ++t) {
        if (S == 0) {  // u0 = w b alone: the staged cells are the outputs
#pragma unroll
            for (int i = 0; i < G::QUADS; ++i) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int li = 4 * (threadIdx.x + i * THREADS) + e, r = li / G::W, c = li - r * G::W;
                    if (li < G::PL && c < TZ && y0 + r < g.n[1] && z0 + c < g.n[2]) {
                        st(out, ((long long)t * g.n[1] + y0 + r) * g.n[2] + z0 + c, ru[i][e]);
                        contrib += ru[i][e] * rb[i][e];
                    }
                }
            }
            if (t < t_end) fetch(t + 1);
            continue;
        }
        // the one barrier of a plane: every y, z neighbour a sweep reads below was written before it, and
        // every plane overwritten below was last read before it
        __syncthreads();
        float *lev0 = smem + slot3(t, x0 - S) * G::PL;
        float *bpl = smem + (3 * S + (t - x0 + S) % G::R) * G::PL;
#pragma unroll
        for (int i = 0; i < G::QUADS; ++i) {
            const int li = 4 * (threadIdx.x + i * THREADS);
            if (li < G::PL) {
                *reinterpret_cast<float4 *>(lev0 + li) = make_float4(ru[i][0], ru[i][1], ru[i][2], ru[i][3]);
                *reinterpret_cast<float4 *>(bpl + li) = make_float4(rb[i][0], rb[i][1], rb[i][2], rb[i][3]);
            }
        }
        if (t < t_end) fetch(t + 1);
        // sweep s computes plane t - s once its chunk's first plane, x0 - S + s, has its x neighbours
        if constexpr (S >= 1)
            if (t >= x0 - S + 2) sweep<S, TZ, 1>(smem, cl, t - 1, x0, y0, z0, g, w, out, contrib);
        if constexpr (S >= 2)
            if (t >= x0 - S + 4) sweep<S, TZ, 2>(smem, cl, t - 2, x0, y0, z0, g, w, out, contrib);
        if constexpr (S >= 3)
            if (t >= x0 - S + 6) sweep<S, TZ, 3>(smem, cl, t - 3, x0, y0, z0, g, w, out, contrib);
    }
    if (partials != nullptr) {
        const float sum = block_sum(contrib);
        if (threadIdx.x == 0) partials[block_index()] = sum;
    }
}
}  // namespace smooth

// ---------------------------------------------------------------------------
// K1 (unmasked and masked) and K3: runs of cells marching along x.
//
// K1 computes out = A p | b - A p | p + w (b - A p) with optional per-block
// <p, out> partials, with the boundary-profile coefficients or (K1m) the
// coefficient arrays, and the active cells' identity rows or not; K3
// restrict_mean(b - A u) over 2 x 2 x 2 fine cells. All are bound by
// device-memory bytes (K1m: p, out and up to five float32 masks, b where the
// epilogue reads it), and how near they come depends on the loads and index
// arithmetic a cell costs: one thread a cell would spend seven 4-byte loads of
// p (K1m: and six of masks) and the per-axis boundary tests on every cell, and
// one thread a coarse cell would fetch each fine value of u about seven times.
//
// Design: a thread owns a run of z-neighbouring cells, 16 bytes of the
// operand (4 float32 or 8 bfloat16 cells; K1m: 4 cells in either dtype, 16
// bytes of each float32 mask; K3: the fine run of 2 fine rows under one run
// of coarse cells), and marches along x over a chunk of planes (K3: fine
// planes, two a coarse plane), keeping the runs of planes x-1, x, x+1 in
// registers: a plane costs one new vector load a run of each array it reads.
// The y neighbours are runs of the neighbouring rows, which the block's other
// threads load as their own (so they come from L1; K3's rows 2j and 2j+1 are
// each other's), the z neighbours at a run's two ends come from the lanes
// beside it by shuffle, and a scalar load at a warp's or a row's edge. K1m's
// upper coefficients come the same way: a+_x is mA_x's run of the next plane,
// which the march loads anyway and keeps as the next plane's a-_x; a+_y the
// next row's run of mA_y (L1); a+_z the next cell of the run, the last one's
// from the next lane. Boundaries resolve by global index: a neighbour past a
// periodic side wraps (a+ there is mA at plane, row or cell 0), one past a
// non-periodic side is 0 and never read (a+ there is 0 by definition; the
// profile's mode goes into the centre coefficient). A block is bx threads
// along z (a power of two <= 32, so a warp holds whole rows) by by rows; a
// thread past the field computes on the field's first run, joins the
// shuffles and the block sum, and stores nothing. Where a row is not a whole
// number of runs in every array read (or a pointer is not 16-byte aligned),
// the same threads take their values one at a time and mask the ragged tail
// (VEC = false). The launch geometry comes from the wrapper's plan
// (ops/poisson.py: stencil_plan, restrict_plan), which the C entries check
// against the kernel's layout.
// ---------------------------------------------------------------------------
namespace march {
constexpr int MAX_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// The offset of plane (or row) i of an axis of n, `stride` apart; -1 past a non-periodic side (i is at most one
// past either end).
__device__ __forceinline__ long long offset_or_none(int i, int n, int lo, int hi, long long stride) {
    if (i >= 0 && i < n) return i * stride;
    if (i < 0) return lo == MODE_PERIODIC ? (long long)(n - 1) * stride : -1;
    return hi == MODE_PERIODIC ? 0 : -1;
}

// N values of storage type T at p[row + k0 ...] as float32. VEC: N * sizeof(T) bytes (8, 16 or 32) in aligned
// vector loads. Otherwise one at a time: the cells k0 + i < n, the row's first cell at k0 + i == n when `wrap`
// (the periodic neighbour of the row's last cell), 0 past them. row < 0: all 0 (past a non-periodic side).
template <typename T, int N, bool VEC>
__device__ __forceinline__ void load_run(const T *__restrict__ p, long long row, int k0, int n, bool wrap,
                                         float (&f)[N]) {
    if (row < 0) {
#pragma unroll
        for (int i = 0; i < N; ++i) f[i] = 0.f;
        return;
    }
    if constexpr (VEC) {
        constexpr int W = N * (int)sizeof(T) / 4;  // 32-bit words
        const T *src = p + row + k0;
        uint32_t w[W];
        if constexpr (W == 2) {
            const uint2 h = *reinterpret_cast<const uint2 *>(src);
            w[0] = h.x;
            w[1] = h.y;
        } else {
#pragma unroll
            for (int i = 0; i < W / 4; ++i) {
                const uint4 r = reinterpret_cast<const uint4 *>(src)[i];
                w[4 * i] = r.x;
                w[4 * i + 1] = r.y;
                w[4 * i + 2] = r.z;
                w[4 * i + 3] = r.w;
            }
        }
        unpack<T>(w, f);
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) {
            const int k = k0 + i;
            f[i] = k < n ? ld(p, row + k) : (k == n && wrap) ? ld(p, row) : 0.f;
        }
    }
}

// N float32 values stored as T at p[q ...]: VEC in one 8- or 16-byte store, else the first `valid` one at a time.
template <typename T, int N, bool VEC>
__device__ __forceinline__ void store_run(T *__restrict__ p, long long q, int valid, const float (&f)[N]) {
    if constexpr (VEC) {
        constexpr int W = N * (int)sizeof(T) / 4;
        static_assert(W == 2 || W == 4, "a run is stored in one 8- or 16-byte store");
        uint32_t w[W];
        pack<T>(f, w);
        if constexpr (W == 2)
            *reinterpret_cast<uint2 *>(p + q) = make_uint2(w[0], w[1]);
        else
            *reinterpret_cast<uint4 *>(p + q) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i)
            if (i < valid) st(p, q + i, f[i]);
    }
}

// Where a thread's run of one row finds its z neighbours: the left one (cell k0 - 1, or the row's last where
// periodic) from lane - 1 when that lane holds the run before it in the same row, else at `ql` (-1: 0, past a
// non-periodic side); the right one (k0 + N, or the row's first) likewise from lane + 1 or at `qr`.
struct ZEnds {
    long long ql, qr;  // offsets within a plane, or -1
    bool shl, shr;     // from the neighbouring lane
};

__device__ __forceinline__ ZEnds z_ends(long long row, int k0, int N, const Grid &g) {
    const int Z = g.n[2], kl = k0 - 1, kr = k0 + N;
    ZEnds e;
    e.ql = kl >= 0 ? row + kl : g.lo[2] == MODE_PERIODIC ? row + Z - 1 : -1;
    e.qr = kr < Z ? row + kr : (kr == Z && g.hi[2] == MODE_PERIODIC) ? row : -1;
    e.shl = kl >= 0 && threadIdx.x > 0;
    e.shr = kr < Z && threadIdx.x + 1 < blockDim.x;
    return e;
}

// The right z neighbour of a run in the plane at `pl`, `first` being the run's first value: every lane of the
// warp must call it.
template <typename T>
__device__ __forceinline__ float z_right(const T *__restrict__ p, long long pl, const ZEnds &e, float first) {
    const float dn = __shfl_down_sync(FULL, first, 1);
    return e.shr ? dn : e.qr >= 0 ? ld(p, pl + e.qr) : 0.f;
}

// Both z neighbours of a run in the plane at `pl`: every lane of the warp must call it.
template <typename T>
__device__ __forceinline__ void z_neighbours(const T *__restrict__ p, long long pl, const ZEnds &e, float first,
                                             float last, float &zl, float &zr) {
    const float up = __shfl_up_sync(FULL, last, 1);
    zl = e.shl ? up : e.ql >= 0 ? ld(p, pl + e.ql) : 0.f;
    zr = z_right(p, pl, e, first);
}

// K1's forms: the coefficients of the boundary profiles (0) or of the arrays mA, c0 (FORM_COEFFS), with the
// active cells' identity rows (FORM_ACTIVE) or without.
constexpr int FORM_ACTIVE = 1, FORM_COEFFS = 2;

// The cells of a thread's run: 16 bytes of p unmasked, 16 bytes of each float32 mask masked.
template <int FORM, typename TP>
__host__ __device__ constexpr int run_cells() { return FORM ? 4 : 16 / (int)sizeof(TP); }

// K1: a thread's run of V cells at (j, k0 ...) over planes [x0, x0 + cx).
template <int EPI, int FORM, typename TP, typename TB, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS) stencil_kernel(const TP *__restrict__ p, const TB *__restrict__ b,
                                                              TP *__restrict__ out, float *__restrict__ partials,
                                                              Grid g, float w, Masks m, int cx) {
    constexpr bool COEFFS = FORM & FORM_COEFFS, ACTIVE = FORM & FORM_ACTIVE;
    constexpr int V = run_cells<FORM, TP>();
    const int X = g.n[0], Y = g.n[1], Z = g.n[2];
    const long long YZ = (long long)Y * Z;
    int slab;
    const long long entry = block_entry(g.nb, slab);
    const long long eoff = entry * (X * YZ);  // the entry's first element
    p += eoff;
    b += eoff;
    out += eoff;
    Masks mk = m;  // the entry's masks
    if constexpr (COEFFS) {
#pragma unroll
        for (int d = 0; d < 3; ++d) mk.mA[d] += entry * m.stride;
        mk.c0 += entry * m.stride;
    }
    if constexpr (ACTIVE) mk.active += entry * m.stride;
    const int k = (blockIdx.x * blockDim.x + threadIdx.x) * V, j = blockIdx.y * blockDim.y + threadIdx.y;
    const bool live = j < Y && k < Z;
    const int jj = live ? j : 0, k0 = live ? k : 0;
    const long long row = (long long)jj * Z;
    const long long rym = offset_or_none(jj - 1, Y, g.lo[1], g.hi[1], Z);
    const long long ryp = offset_or_none(jj + 1, Y, g.lo[1], g.hi[1], Z);
    const ZEnds ze = z_ends(row, k0, V, g);
    const bool wrap_z = g.hi[2] == MODE_PERIODIC;
    // the profiles' centre coefficient, its y and z shares cell by cell
    const float cy = g.inv[1] * smooth::center_coef(jj, Y, g.lo[1], g.hi[1]);
    float cyz[V];
#pragma unroll
    for (int e = 0; e < V; ++e) cyz[e] = cy + g.inv[2] * smooth::center_coef(k0 + e, Z, g.lo[2], g.hi[2]);
    const int x0 = slab * cx, x1 = min(x0 + cx, X);
    float pm[V], pc[V], pn[V];
    float ax[V], axn[V];  // COEFFS: mA_x at planes i and i + 1, a-_x and a+_x of plane i
    const long long plm = offset_or_none(x0 - 1, X, g.lo[0], g.hi[0], YZ);
    load_run<TP, V, VEC>(p, plm < 0 ? -1 : plm + row, k0, Z, wrap_z, pm);
    load_run<TP, V, VEC>(p, (long long)x0 * YZ + row, k0, Z, wrap_z, pc);
    if constexpr (COEFFS) load_run<float, V, VEC>(mk.mA[0], (long long)x0 * YZ + row, k0, Z, false, ax);
    float contrib = 0.f;
    for (int i = x0; i < x1; ++i) {
        const long long pl = (long long)i * YZ, pln = offset_or_none(i + 1, X, g.lo[0], g.hi[0], YZ);
        float ym[V], yp[V], bv[V], ay[V], ayp[V], az[V], c0[V], act[V];
        load_run<TP, V, VEC>(p, pln < 0 ? -1 : pln + row, k0, Z, wrap_z, pn);
        load_run<TP, V, VEC>(p, rym < 0 ? -1 : pl + rym, k0, Z, wrap_z, ym);
        load_run<TP, V, VEC>(p, ryp < 0 ? -1 : pl + ryp, k0, Z, wrap_z, yp);
        if (EPI != EPI_MATVEC) load_run<TB, V, VEC>(b, pl + row, k0, Z, false, bv);
        if constexpr (COEFFS) {
            load_run<float, V, VEC>(mk.mA[0], pln < 0 ? -1 : pln + row, k0, Z, false, axn);
            load_run<float, V, VEC>(mk.mA[1], pl + row, k0, Z, false, ay);
            load_run<float, V, VEC>(mk.mA[1], ryp < 0 ? -1 : pl + ryp, k0, Z, false, ayp);
            load_run<float, V, VEC>(mk.mA[2], pl + row, k0, Z, wrap_z, az);
            load_run<float, V, VEC>(mk.c0, pl + row, k0, Z, false, c0);
        }
        if constexpr (ACTIVE) load_run<float, V, VEC>(mk.active, pl + row, k0, Z, false, act);
        float zl, zr, azr = 0.f;  // azr: a+_z of the run's last cell, mA_z one cell past the run
        z_neighbours(p, pl, ze, pc[0], pc[V - 1], zl, zr);
        if constexpr (COEFFS) azr = z_right(mk.mA[2], pl, ze, az[0]);
        const float cx0 = g.inv[0] * smooth::center_coef(i, X, g.lo[0], g.hi[0]);
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
            const float lo = e == 0 ? zl : pc[e - 1], hi = e == V - 1 ? zr : pc[e + 1];
            // the twin's form: the neighbour terms axis by axis, then the whole centre coefficient
            float lap;
            if constexpr (COEFFS)
                lap = g.inv[0] * (ax[e] * pm[e] + axn[e] * pn[e]) + g.inv[1] * (ay[e] * ym[e] + ayp[e] * yp[e]) +
                      g.inv[2] * (az[e] * lo + (e == V - 1 ? azr : az[e + 1]) * hi) + c0[e] * pc[e];
            else
                lap = g.inv[0] * (pm[e] + pn[e]) + g.inv[1] * (ym[e] + yp[e]) + g.inv[2] * (lo + hi) +
                      (cx0 + cyz[e]) * pc[e];
            if (EPI == EPI_MATVEC) o[e] = lap;
            else if (EPI == EPI_RESIDUAL) o[e] = bv[e] - lap;
            else o[e] = pc[e] + w * (bv[e] - lap);
            if constexpr (ACTIVE)
                if (act[e] == 0.f) o[e] = pc[e];  // an identity row, before the dot
        }
        if (live) {
            store_run<TP, V, VEC>(out, pl + row + k0, Z - k0, o);
#pragma unroll
            for (int e = 0; e < V; ++e)
                if (VEC || k0 + e < Z) contrib += pc[e] * o[e];
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
            pm[e] = pc[e];
            pc[e] = pn[e];
            if constexpr (COEFFS) ax[e] = axn[e];
        }
    }
    if (partials != nullptr) {
        const float sum = block_sum(contrib);
        if (threadIdx.x == 0 && threadIdx.y == 0) partials[block_index()] = sum;
    }
}

// K3: a thread's run of RC coarse cells at (jc, kc0 ...) over coarse planes [xc0, xc0 + cx): the fine rows 2 jc
// and 2 jc + 1, F = 2 RC fine cells each, two fine planes a coarse plane.
template <typename TU, typename TB, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS) residual_restrict_kernel(const TU *__restrict__ u,
                                                                        const TB *__restrict__ b,
                                                                        TU *__restrict__ out, Grid g, int cx) {
    constexpr int F = 16 / sizeof(TU), RC = F / 2;
    const int X = g.n[0], Y = g.n[1], Z = g.n[2], Yc = Y / 2, Zc = Z / 2;
    const long long YZ = (long long)Y * Z;
    int slab;
    const long long entry = block_entry(g.nb, slab);
    u += entry * (X * YZ);
    b += entry * (X * YZ);
    out += entry * (X * YZ / 8);  // the coarse entry
    const int kc = (blockIdx.x * blockDim.x + threadIdx.x) * RC, jc = blockIdx.y * blockDim.y + threadIdx.y;
    const bool live = jc < Yc && kc < Zc;
    const int jcc = live ? jc : 0, kc0 = live ? kc : 0, k0 = 2 * kc0;
    const long long row[2] = {(long long)(2 * jcc) * Z, (long long)(2 * jcc + 1) * Z};
    // row 2 jc's lower y neighbour and row 2 jc + 1's upper one; the rows are each other's other neighbour
    const long long rym = offset_or_none(2 * jcc - 1, Y, g.lo[1], g.hi[1], Z);
    const long long ryp = offset_or_none(2 * jcc + 2, Y, g.lo[1], g.hi[1], Z);
    const ZEnds ze[2] = {z_ends(row[0], k0, F, g), z_ends(row[1], k0, F, g)};
    const bool wrap_z = g.hi[2] == MODE_PERIODIC;
    const float cy[2] = {g.inv[1] * smooth::center_coef(2 * jcc, Y, g.lo[1], g.hi[1]),
                         g.inv[1] * smooth::center_coef(2 * jcc + 1, Y, g.lo[1], g.hi[1])};
    float cz[F];
#pragma unroll
    for (int e = 0; e < F; ++e) cz[e] = g.inv[2] * smooth::center_coef(k0 + e, Z, g.lo[2], g.hi[2]);
    const int f0 = 2 * slab * cx, f1 = min(f0 + 2 * cx, X);
    float qm[2][F], qc[2][F], qn[2][F];
    const long long plm = offset_or_none(f0 - 1, X, g.lo[0], g.hi[0], YZ);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        load_run<TU, F, VEC>(u, plm < 0 ? -1 : plm + row[r], k0, Z, wrap_z, qm[r]);
        load_run<TU, F, VEC>(u, (long long)f0 * YZ + row[r], k0, Z, wrap_z, qc[r]);
    }
    float acc[RC];
#pragma unroll
    for (int e = 0; e < RC; ++e) acc[e] = 0.f;
    for (int f = f0; f < f1; ++f) {
        const long long pl = (long long)f * YZ, pln = offset_or_none(f + 1, X, g.lo[0], g.hi[0], YZ);
        float ym[F], yp[F], bv[2][F];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            load_run<TU, F, VEC>(u, pln < 0 ? -1 : pln + row[r], k0, Z, wrap_z, qn[r]);
            load_run<TB, F, VEC>(b, pl + row[r], k0, Z, false, bv[r]);
        }
        load_run<TU, F, VEC>(u, rym < 0 ? -1 : pl + rym, k0, Z, wrap_z, ym);
        load_run<TU, F, VEC>(u, ryp < 0 ? -1 : pl + ryp, k0, Z, wrap_z, yp);
        float zl[2], zr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) z_neighbours(u, pl, ze[r], qc[r][0], qc[r][F - 1], zl[r], zr[r]);
        const float cx0 = g.inv[0] * smooth::center_coef(f, X, g.lo[0], g.hi[0]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int e = 0; e < F; ++e) {
                const float lo = e == 0 ? zl[r] : qc[r][e - 1], hi = e == F - 1 ? zr[r] : qc[r][e + 1];
                const float ylo = r == 0 ? ym[e] : qc[0][e], yhi = r == 0 ? qc[1][e] : yp[e];
                const float lap = g.inv[0] * (qm[r][e] + qn[r][e]) + g.inv[1] * (ylo + yhi) + g.inv[2] * (lo + hi) +
                                  (cx0 + cy[r] + cz[e]) * qc[r][e];
                acc[e / 2] += bv[r][e] - lap;
            }
        }
        if (f & 1) {  // the coarse plane's second fine plane: its mean is complete
            float o[RC];
#pragma unroll
            for (int e = 0; e < RC; ++e) {
                o[e] = acc[e] * 0.125f;
                acc[e] = 0.f;
            }
            if (live) store_run<TU, RC, VEC>(out, ((long long)(f >> 1) * Yc + jcc) * Zc + kc0, Zc - kc0, o);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
            for (int e = 0; e < F; ++e) {
                qm[r][e] = qc[r][e];
                qc[r][e] = qn[r][e];
            }
        }
    }
}
}  // namespace march

// ---------------------------------------------------------------------------
// C entry points. Each checks the wrapper's plan against its kernel's layout
// and refuses one that disagrees.
// ---------------------------------------------------------------------------

// The grid's z extent for nb entries of `slabs` slabs each (0 past the launch limit of 65535).
static unsigned batched_z(int nb, long long slabs) {
    const long long z = (long long)nb * slabs;
    return nb >= 1 && z <= 65535 ? (unsigned)z : 0u;
}

// The march kernels' launch geometry: blocks of bx (a power of two <= 32) by `by` threads, a whole number of warps
// and at most march::MAX_THREADS, `runs` runs a row along z, `rows` rows, `planes` planes in chunks of cx, for each
// of nb entries; the plan's block count must be the grid's. Returns the grid, or dim3(0) where the plan disagrees.
static dim3 march_grid(int runs, int rows, int planes, int bx, int by, int cx, int nb, long long blocks) {
    const int threads = bx * by;
    if (bx < 1 || bx > 32 || (bx & (bx - 1)) || by < 1 || threads % 32 || threads > march::MAX_THREADS || cx < 1)
        return dim3(0);
    const dim3 grid((runs + bx - 1) / bx, (rows + by - 1) / by, batched_z(nb, (planes + cx - 1) / cx));
    if (grid.z == 0 || (long long)grid.x * grid.y * grid.z != blocks) return dim3(0);
    return grid;
}

// The vector route needs every row of every array it reads or writes to start on a 16-byte boundary.
static bool rows_aligned(int Z, int itemsize, const void *ptr) {
    return (long long)Z * itemsize % 16 == 0 && (uintptr_t)ptr % 16 == 0;
}

template <int EPI, int FORM, typename TP, typename TB>
static int launch_stencil(const TP *p, const TB *b, TP *out, float *partials, const Grid &g, float w,
                          const Masks &m, int vector, int bx, int by, int cx, int blocks, cudaStream_t s) {
    constexpr int V = march::run_cells<FORM, TP>();
    const int Z = g.n[2];
    const dim3 grid = march_grid((Z + V - 1) / V, g.n[1], g.n[0], bx, by, cx, g.nb, blocks);
    if (grid.x == 0) return (int)cudaErrorInvalidValue;
    // every array's rows whole runs (V values: 8, 16 or 32 bytes) from a 16-byte aligned start
    bool aligned = Z % V == 0 && (uintptr_t)p % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                   (EPI == EPI_MATVEC || (uintptr_t)b % 16 == 0);
    const float *masks[] = {m.mA[0], m.mA[1], m.mA[2], m.c0, m.active};
    for (const float *a : masks) aligned = aligned && (uintptr_t)a % 16 == 0;
    if (vector && !aligned) return (int)cudaErrorInvalidValue;
    const dim3 block(bx, by);
    if (vector)
        march::stencil_kernel<EPI, FORM, TP, TB, true><<<grid, block, 0, s>>>(p, b, out, partials, g, w, m, cx);
    else
        march::stencil_kernel<EPI, FORM, TP, TB, false><<<grid, block, 0, s>>>(p, b, out, partials, g, w, m, cx);
    return (int)cudaGetLastError();
}

template <int FORM, typename TP, typename TB>
static int launch_form(int epilogue, const void *p, const void *b, void *out, float *partials, const Grid &g,
                       float w, const Masks &m, int vector, int bx, int by, int cx, int blocks, cudaStream_t s) {
    const TP *pp = (const TP *)p;
    TP *oo = (TP *)out;
    if (epilogue == EPI_MATVEC)  // b is not read: one instantiation a p dtype
        return launch_stencil<EPI_MATVEC, FORM, TP, TP>(pp, pp, oo, partials, g, w, m, vector, bx, by, cx, blocks, s);
    const TB *bb = (const TB *)b;
    if (epilogue == EPI_RESIDUAL)
        return launch_stencil<EPI_RESIDUAL, FORM>(pp, bb, oo, partials, g, w, m, vector, bx, by, cx, blocks, s);
    if (epilogue == EPI_JACOBI)
        return launch_stencil<EPI_JACOBI, FORM>(pp, bb, oo, partials, g, w, m, vector, bx, by, cx, blocks, s);
    return (int)cudaErrorInvalidValue;
}

// K1 in every form. mA_x, mA_y, mA_z and c0 come together (the coefficient arrays) or are all null (the boundary
// profiles); active may be null. `vector`, `bx`, `by`, `cx` and `blocks` (the partials' count) are the wrapper's
// plan. The masks have an entry's shape, at `mask_stride` elements from one entry's to the next: 0 (one set shared
// by the g.nb entries) or the entry's cell count.
extern "C" int stencil(const void *p, int p_dt, const void *b, int b_dt, const float *mA_x, const float *mA_y,
                       const float *mA_z, const float *c0, const float *active, long long mask_stride, void *out,
                       float *partials, const Grid *g, int epilogue, float w, int vector, int bx, int by, int cx,
                       int blocks, void *stream) {
    const bool any_coeff = mA_x != nullptr || mA_y != nullptr || mA_z != nullptr || c0 != nullptr;
    const bool all_coeff = mA_x != nullptr && mA_y != nullptr && mA_z != nullptr && c0 != nullptr;
    if (any_coeff != all_coeff) return (int)cudaErrorInvalidValue;
    const long long cells = (long long)g->n[0] * g->n[1] * g->n[2];
    if (mask_stride != 0 && (mask_stride != cells || !(any_coeff || active != nullptr)))
        return (int)cudaErrorInvalidValue;
    const int form = (all_coeff ? march::FORM_COEFFS : 0) | (active != nullptr ? march::FORM_ACTIVE : 0);
    const Masks m = {{mA_x, mA_y, mA_z}, c0, active, mask_stride};
    cudaStream_t s = (cudaStream_t)stream;
    if (epilogue == EPI_MATVEC) b_dt = p_dt;  // b is not read
    PTT_DT(p_dt, TP, PTT_DT(b_dt, TB, {
        switch (form) {
            case 0:
                return launch_form<0, TP, TB>(epilogue, p, b, out, partials, *g, w, m, vector, bx, by, cx, blocks, s);
            case march::FORM_ACTIVE:
                return launch_form<1, TP, TB>(epilogue, p, b, out, partials, *g, w, m, vector, bx, by, cx, blocks, s);
            case march::FORM_COEFFS:
                return launch_form<2, TP, TB>(epilogue, p, b, out, partials, *g, w, m, vector, bx, by, cx, blocks, s);
            default:
                return launch_form<3, TP, TB>(epilogue, p, b, out, partials, *g, w, m, vector, bx, by, cx, blocks, s);
        }
    }));
    return (int)cudaErrorInvalidValue;
}

template <int S, int TZ, typename TU, typename TB, typename TO>
static int launch_smooth(const void *u, const void *b, void *out, float *partials, const Grid &g, float w,
                         int zero_init, int cx, int smem, cudaStream_t s) {
    using namespace smooth;
    if (smem != Geom<S, TZ>::SMEM) return (int)cudaErrorInvalidValue;  // the wrapper's plan disagrees
    auto kernel = smooth_kernel<S, TZ, TU, TB, TO>;
    static bool opted_in = false;  // above 48 KB a kernel must opt in to its dynamic shared memory, once
    if (smem > 48 * 1024 && !opted_in) {
        const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        opted_in = true;
    }
    const dim3 grid((g.n[2] + TZ - 1) / TZ, (g.n[1] + TY - 1) / TY, batched_z(g.nb, (g.n[0] + cx - 1) / cx));
    if (grid.z == 0) return (int)cudaErrorInvalidValue;
    kernel<<<grid, THREADS, smem, s>>>((const TU *)u, (const TB *)b, (TO *)out, partials, g, w, zero_init, cx);
    return (int)cudaGetLastError();
}

template <int TZ, typename TU, typename TB, typename TO>
static int launch_smooth_s(int S, const void *u, const void *b, void *out, float *partials, const Grid &g, float w,
                           int zero_init, int cx, int smem, cudaStream_t s) {
    switch (S) {
        case 0: return launch_smooth<0, TZ, TU, TB, TO>(u, b, out, partials, g, w, zero_init, cx, smem, s);
        case 1: return launch_smooth<1, TZ, TU, TB, TO>(u, b, out, partials, g, w, zero_init, cx, smem, s);
        case 2: return launch_smooth<2, TZ, TU, TB, TO>(u, b, out, partials, g, w, zero_init, cx, smem, s);
        default: return launch_smooth<3, TZ, TU, TB, TO>(u, b, out, partials, g, w, zero_init, cx, smem, s);
    }
}

// One launch of K2: `sweeps` (1-3) sweeps, the first of them u0 = w b with
// zero_init. `tz`: the tile's z width (64 or 16); `cx`: x planes a block;
// `smem`: the plan's dynamic shared-memory bytes, checked against the
// kernel's own layout.
extern "C" int jacobi_smooth(const void *u, int u_dt, const void *b, int b_dt, void *out, int out_dt,
                             float *partials, const Grid *g, float w, int sweeps, int zero_init, int tz, int cx,
                             int smem, void *stream) {
    const int S = zero_init ? sweeps - 1 : sweeps;  // stencil sweeps
    if (sweeps < 1 || S > 3 || cx < 1 || (tz != 64 && tz != 16)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (zero_init) u_dt = PTT_F32;  // u is not read
    PTT_DT(u_dt, TU, PTT_DT(b_dt, TB, PTT_DT(out_dt, TO, {
        if (tz == 64) return launch_smooth_s<64, TU, TB, TO>(S, u, b, out, partials, *g, w, zero_init, cx, smem, s);
        return launch_smooth_s<16, TU, TB, TO>(S, u, b, out, partials, *g, w, zero_init, cx, smem, s);
    })));
    return (int)cudaErrorInvalidValue;
}

// K3. (X, Y, Z) in g: the fine shape, all even, of each of g.nb entries. `vector`, `bx`, `by`, `cx` (coarse planes
// a block) and `blocks` are the wrapper's plan.
extern "C" int residual_restrict(const void *u, int u_dt, const void *b, int b_dt, void *out, const Grid *g,
                                 int vector, int bx, int by, int cx, int blocks, void *stream) {
    const int X = g->n[0], Y = g->n[1], Z = g->n[2];
    if ((X | Y | Z) & 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    PTT_DT(u_dt, TU, PTT_DT(b_dt, TB, {
        constexpr int RC = 8 / sizeof(TU);  // coarse cells a run: 16 bytes of a fine row of u
        const dim3 grid = march_grid((Z / 2 + RC - 1) / RC, Y / 2, X / 2, bx, by, cx, g->nb, blocks);
        if (grid.x == 0) return (int)cudaErrorInvalidValue;
        const bool aligned = rows_aligned(Z, sizeof(TU), u) && rows_aligned(Z, sizeof(TB), b) &&
                             (uintptr_t)out % 8 == 0;
        if (vector && !aligned) return (int)cudaErrorInvalidValue;
        const dim3 block(bx, by);
        if (vector)
            march::residual_restrict_kernel<TU, TB, true><<<grid, block, 0, s>>>((const TU *)u, (const TB *)b,
                                                                                  (TU *)out, *g, cx);
        else
            march::residual_restrict_kernel<TU, TB, false><<<grid, block, 0, s>>>((const TU *)u, (const TB *)b,
                                                                                   (TU *)out, *g, cx);
        return (int)cudaGetLastError();
    }));
    return (int)cudaErrorInvalidValue;
}

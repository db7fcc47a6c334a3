// K8: particle-to-grid scatter of the FLIP step — per nearest cell the sum of
// the particles' values and their count — and the mean it feeds.
//
//   replaces phiflow_tpu/ops/p2g.py::_p2g_pallas (and the mean that
//   p2g_mean_3d forms from its sums and counts)
//
//   cell_a(p) = floor((pos[p][a] - lower[a]) * inv_dx[a])         (float32)
//   sums[cell]   += values[p]
//   counts[cell] += 1
//   mean[cell]    = counts > 0 ? sums / max(counts, 1) : base
//
// A particle outside the grid on any axis is dropped (discard) or kept at the
// border cell (clamp).
//
// The TPU kernel turns the scatter into one-hot matrix products because its
// scatter is serial; here the scatter is atomics in the L2. FLIP's particles
// lie cell by cell (`distribute_points`, never reordered), so a warp's 32
// particles fall into a handful of cells, and on a face grid each cell's
// particles split between two faces in no order of lanes. So the lanes of a
// warp with the same cell find each other (`__match_any_sync`: grouping by
// equality, not by adjacent runs), the group's count is the popcount of its
// mask (exact) and its sum is taken in increasing lane order by shuffles; the
// group's lowest lane issues one atomic for the sum and one for the count:
// two atomics a group instead of two a particle, a quarter as many or fewer
// in FLIP's order. A warp's positions are 384 contiguous bytes, read as three
// coalesced loads of 128 bytes and handed to the lanes through shared memory.
//
// Lanes past the last particle and dropped particles carry the cell -1: they
// match only each other, issue no atomic, and their values are never read, so
// a dropped particle adds nothing whatever its value (NaN and infinities
// included); a NaN value of a kept particle reaches only its own cell. The cell
// expression is kept uncontracted (__fsub_rn, __fmul_rn: no fused
// multiply-add), so a particle on a cell border lands in the cell the plain
// version computes; a NaN position goes to cell 0 and counts as outside.
// Counts are exact. The sums' atomics land in any order, so they agree with
// the plain version to float32 roundoff of a cell's addends.
//
// The mean is one elementwise launch after the scatter (float4 where the
// arrays allow), with an IEEE division, so it is bit-equal to the plain
// version's `where(counts > 0, sums / clamp(counts, 1), base)` of the same
// sums and counts.
//
// Bound: bytes. A particle is 16 bytes read (position and value); a cell is
// 8 bytes written for sums and counts, 4 for the mean (the counts it also
// writes are the residual the backward keeps). On top of
// that the call zeroes sums and counts first (a memset of 8 bytes a cell),
// which atomics cannot do without; in FLIP's order the atomics then no longer
// set the scatter's time.
#include "common.cuh"

struct P2GGrid {
    int n[3];         // cells per axis (x, y, z); z is contiguous
    float lower[3];   // position of the grid's lower corner
    float inv_dx[3];  // 1 / cell size, rounded to float32 by the wrapper
};

constexpr int P2G_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

// sums and counts must be zeroed first. Every lane of every warp runs to the
// end: the warp operations take the full mask.
__global__ void __launch_bounds__(P2G_THREADS)
    p2g_scatter_kernel(const float *__restrict__ pos, const float *__restrict__ values, float *__restrict__ sums,
                       float *__restrict__ counts, long long n_particles, P2GGrid g, int clamp) {
    __shared__ float staged[3 * P2G_THREADS];
    const int lane = threadIdx.x & 31;
    const long long first = (long long)blockIdx.x * P2G_THREADS + (threadIdx.x - lane);  // the warp's first particle
    const long long i = first + lane;
    float *warp_pos = staged + 3 * (threadIdx.x - lane);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const long long k = 3 * first + 32 * j + lane;
        warp_pos[32 * j + lane] = k < 3 * n_particles ? pos[k] : 0.f;
    }
    __syncwarp();

    long long cell = 0;
    bool inside = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        float c = floorf(__fmul_rn(__fsub_rn(warp_pos[3 * lane + a], g.lower[a]), g.inv_dx[a]));
        inside = inside && c >= 0.f && c < (float)g.n[a];
        c = fminf(fmaxf(c, 0.f), (float)(g.n[a] - 1));  // a NaN position goes to cell 0 (and is not inside)
        cell = cell * g.n[a] + (int)c;
    }
    const bool keep = i < n_particles && (clamp || inside);
    if (!keep) cell = -1;
    const float v = keep ? values[i] : 0.f;

    const unsigned group = __match_any_sync(FULL_MASK, cell);
    // the group's sum in increasing lane order; the loop runs as often as the
    // largest kept group has lanes, and every lane takes part in each shuffle
    unsigned rest = keep ? group : 0u;
    float sum = 0.f;
    while (__any_sync(FULL_MASK, rest != 0u)) {
        const float x = __shfl_sync(FULL_MASK, v, rest ? __ffs(rest) - 1 : lane);
        if (rest) {
            sum += x;
            rest &= rest - 1u;
        }
    }
    if (keep && lane == __ffs(group) - 1) {
        atomicAdd(sums + cell, sum);
        atomicAdd(counts + cell, (float)__popc(group));
    }
}

__device__ __forceinline__ float mean_or_base(float sum, float count, float base) {
    return count > 0.f ? __fdiv_rn(sum, fmaxf(count, 1.f)) : base;
}

// Four cells a thread: one float4 of each array where `vec` (the three arrays
// 16-byte aligned, so n_cells is a multiple of 4), else scalars.
__global__ void p2g_mean_kernel(const float *__restrict__ sums, const float *__restrict__ counts,
                                float *__restrict__ mean, long long n_cells, float base, int vec) {
    const long long c0 = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
    if (c0 >= n_cells) return;
    if (vec) {
        const float4 s = *reinterpret_cast<const float4 *>(sums + c0);
        const float4 n = *reinterpret_cast<const float4 *>(counts + c0);
        *reinterpret_cast<float4 *>(mean + c0) = make_float4(mean_or_base(s.x, n.x, base), mean_or_base(s.y, n.y, base),
                                                             mean_or_base(s.z, n.z, base), mean_or_base(s.w, n.w, base));
        return;
    }
    for (long long c = c0; c < c0 + 4 && c < n_cells; ++c) mean[c] = mean_or_base(sums[c], counts[c], base);
}

static long long cells_of(const P2GGrid &g) { return (long long)g.n[0] * g.n[1] * g.n[2]; }

static bool aligned16(const void *p) { return ((uintptr_t)p & 15u) == 0; }

// The sums and counts (planar, in sums_counts: sums, then counts, 2 x cells
// float32) of the particles: a memset and, for at least one particle, the
// scatter. Where `mean` is not null, then the mean per cell (base where no
// particle lies) into `mean`.
extern "C" int p2g_mean(const float *pos, const float *values, float *sums_counts, float *mean,
                        long long n_particles, const P2GGrid *g, int clamp, float base, void *stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const long long n_cells = cells_of(*g);
    cudaError_t e = cudaMemsetAsync(sums_counts, 0, 2 * n_cells * sizeof(float), s);
    if (e != cudaSuccess) return (int)e;
    const float *sums = sums_counts, *counts = sums_counts + n_cells;
    if (n_particles > 0) {
        const long long blocks = (n_particles + P2G_THREADS - 1) / P2G_THREADS;
        p2g_scatter_kernel<<<(unsigned)blocks, P2G_THREADS, 0, s>>>(pos, values, sums_counts, sums_counts + n_cells,
                                                                     n_particles, *g, clamp);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    if (mean == nullptr || n_cells <= 0) return (int)cudaSuccess;
    const long long n_threads = (n_cells + 3) / 4;
    const int vec = aligned16(sums) && aligned16(counts) && aligned16(mean);
    p2g_mean_kernel<<<(unsigned)((n_threads + 255) / 256), 256, 0, s>>>(sums, counts, mean, n_cells, base, vec);
    return (int)cudaGetLastError();
}

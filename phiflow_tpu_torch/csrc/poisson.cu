// The 7-point Poisson stencil of the pressure solve, with its three kernels:
//
//   K1 poisson_stencil   replaces phiflow_tpu/ops/poisson.py::_apply_pallas_3d
//                        (the CG matvec, with the fused <p, A p> partials), in
//                        its unmasked and its masked form (obstacle
//                        coefficients and the free surface's active cells)
//   K2 jacobi_sweep      replaces phiflow_tpu/ops/poisson.py::_jacobi2_pallas_3d
//                        (V-cycle smoothing; one launch per sweep here)
//   K3 residual_restrict replaces phiflow_tpu/ops/poisson.py::_residual_restrict_pallas_3d
//                        (restrict_mean(b - A u); the fine residual is never stored)
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
// bytes (inputs read once, outputs written once at best). The design is the
// simplest one that moves near-minimal bytes: one thread per output cell,
// threads of a block along the contiguous z axis so loads coalesce, and the
// six neighbour loads left to the L1/L2 caches instead of a shared-memory
// tile. Storage is float32 or bfloat16; arithmetic is float32 in registers.
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
};

// One axis' share of the stencil, inv_d excluded: a- p[c-1] + a+ p[c+1] + c0 pc.
// `load(q)` returns the operand at flat index q.
template <class Load>
__device__ __forceinline__ float axis_term(const Load &load, long long q, int c, int n, long long stride,
                                           int lo, int hi, float pc) {
    float am = 1.f, ap = 1.f, c0 = -2.f, pm = 0.f, pp = 0.f;
    if (c > 0) {
        pm = load(q - stride);
    } else if (lo == MODE_PERIODIC) {
        pm = load(q + (long long)(n - 1) * stride);
    } else {
        am = 0.f;
        c0 = lo == MODE_GHOST0 ? -2.f : -1.f;
    }
    if (c < n - 1) {
        pp = load(q + stride);
    } else if (hi == MODE_PERIODIC) {
        pp = load(q - (long long)(n - 1) * stride);
    } else {
        ap = 0.f;
        c0 = hi == MODE_GHOST0 ? -2.f : -1.f;
    }
    return am * pm + ap * pp + c0 * pc;
}

template <class Load>
__device__ __forceinline__ float laplace_at(const Load &load, const Grid &g, int i, int j, int k, long long q,
                                            float pc) {
    const long long sy = g.n[2], sx = (long long)g.n[1] * g.n[2];
    return g.inv[0] * axis_term(load, q, i, g.n[0], sx, g.lo[0], g.hi[0], pc) +
           g.inv[1] * axis_term(load, q, j, g.n[1], sy, g.lo[1], g.hi[1], pc) +
           g.inv[2] * axis_term(load, q, k, g.n[2], 1, g.lo[2], g.hi[2], pc);
}

__device__ __forceinline__ int block_index() { return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; }

// The masked form's coefficient arrays (float32, the field's shape); mA[0] is
// null for the boundary-profile coefficients, active null where every cell is.
struct Masks {
    const float *mA[3];
    const float *c0;
    const float *active;
};

// One axis' share of the masked stencil, inv_d excluded: a- p[c-1] + a+ p[c+1].
template <class Load>
__device__ __forceinline__ float masked_axis_term(const Load &load, const float *__restrict__ mA, long long q, int c,
                                                  int n, long long stride, int lo, int hi) {
    float lower = 0.f, upper = 0.f;
    if (c > 0) {
        lower = mA[q] * load(q - stride);
    } else if (lo == MODE_PERIODIC) {
        lower = mA[q] * load(q + (long long)(n - 1) * stride);
    }
    if (c < n - 1) {
        upper = mA[q + stride] * load(q + stride);
    } else if (hi == MODE_PERIODIC) {
        const long long first = q - (long long)(n - 1) * stride;
        upper = mA[first] * load(first);
    }
    return lower + upper;
}

// ---------------------------------------------------------------------------
// K1: out = A p | b - A p | p + w (b - A p); optional per-block <p, out> partials.
// MASKED = false is the unmasked kernel, which reads no mask; MASKED = true
// takes the coefficient arrays, the active cells, or both.
// ---------------------------------------------------------------------------
template <int EPI, bool MASKED, typename TP, typename TB>
__global__ void poisson_stencil_kernel(const TP *__restrict__ p, const TB *__restrict__ b, TP *__restrict__ out,
                                       float *__restrict__ partials, Grid g, float w, Masks m) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x, j = blockIdx.y, i = blockIdx.z;
    float contrib = 0.f;
    if (k < g.n[2]) {
        const long long q = ((long long)i * g.n[1] + j) * g.n[2] + k;
        auto load = [&](long long r) { return ld(p, r); };
        const float pc = ld(p, q);
        float lap;
        if (MASKED && m.mA[0] != nullptr) {
            const long long sy = g.n[2], sx = (long long)g.n[1] * g.n[2];
            lap = g.inv[0] * masked_axis_term(load, m.mA[0], q, i, g.n[0], sx, g.lo[0], g.hi[0]) +
                  g.inv[1] * masked_axis_term(load, m.mA[1], q, j, g.n[1], sy, g.lo[1], g.hi[1]) +
                  g.inv[2] * masked_axis_term(load, m.mA[2], q, k, g.n[2], 1, g.lo[2], g.hi[2]) + m.c0[q] * pc;
        } else {
            lap = laplace_at(load, g, i, j, k, q, pc);
        }
        float o;
        if (EPI == EPI_MATVEC) o = lap;
        else if (EPI == EPI_RESIDUAL) o = ld(b, q) - lap;
        else o = pc + w * (ld(b, q) - lap);
        if (MASKED && m.active != nullptr && m.active[q] == 0.f) o = pc;
        st(out, q, o);
        contrib = pc * o;
    }
    if (partials != nullptr) {
        const float s = block_sum(contrib);
        if (threadIdx.x == 0) partials[block_index()] = s;
    }
}

// ---------------------------------------------------------------------------
// K2: one damped-Jacobi sweep out = u + w (b - A u). With ZERO_INIT the sweep
// starts from u0 = w b formed in registers (u is not read), so a zero-init
// triple costs two launches. Optional per-block <out, b> partials.
// ---------------------------------------------------------------------------
template <bool ZERO_INIT, typename TU, typename TB, typename TO>
__global__ void jacobi_sweep_kernel(const TU *__restrict__ u, const TB *__restrict__ b, TO *__restrict__ out,
                                    float *__restrict__ partials, Grid g, float w) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x, j = blockIdx.y, i = blockIdx.z;
    float contrib = 0.f;
    if (k < g.n[2]) {
        const long long q = ((long long)i * g.n[1] + j) * g.n[2] + k;
        auto load = [&](long long r) { return ZERO_INIT ? w * ld(b, r) : ld(u, r); };
        const float bc = ld(b, q);
        const float uc = ZERO_INIT ? w * bc : ld(u, q);
        const float o = uc + w * (bc - laplace_at(load, g, i, j, k, q, uc));
        st(out, q, o);
        contrib = o * bc;
    }
    if (partials != nullptr) {
        const float s = block_sum(contrib);
        if (threadIdx.x == 0) partials[block_index()] = s;
    }
}

// ---------------------------------------------------------------------------
// K3: one thread per coarse cell — the eight fine residuals b - A u and their mean.
// ---------------------------------------------------------------------------
template <typename TU, typename TB>
__global__ void residual_restrict_kernel(const TU *__restrict__ u, const TB *__restrict__ b, TU *__restrict__ out,
                                         Grid g) {
    const int kc = blockIdx.x * blockDim.x + threadIdx.x, jc = blockIdx.y, ic = blockIdx.z;
    const int Zc = g.n[2] >> 1, Yc = g.n[1] >> 1;
    if (kc >= Zc) return;
    auto load = [&](long long r) { return ld(u, r); };
    float sum = 0.f;
    for (int di = 0; di < 2; ++di)
        for (int dj = 0; dj < 2; ++dj)
            for (int dk = 0; dk < 2; ++dk) {
                const int i = 2 * ic + di, j = 2 * jc + dj, k = 2 * kc + dk;
                const long long q = ((long long)i * g.n[1] + j) * g.n[2] + k;
                const float pc = ld(u, q);
                sum += ld(b, q) - laplace_at(load, g, i, j, k, q, pc);
            }
    st(out, ((long long)ic * Yc + jc) * Zc + kc, sum * 0.125f);
}

// ---------------------------------------------------------------------------
// C entry points. `bx` is the block size along z (a multiple of 32), chosen by
// the wrapper, which also sizes `partials` to the number of blocks.
// ---------------------------------------------------------------------------
static dim3 grid_of(int X, int Y, int Z, int bx) { return dim3((Z + bx - 1) / bx, Y, X); }

template <int EPI, typename TP, typename TB>
static void launch_stencil(dim3 grid, int bx, cudaStream_t s, const TP *p, const TB *b, TP *out, float *partials,
                           const Grid &g, float w, const Masks &m) {
    if (m.mA[0] != nullptr || m.active != nullptr)
        poisson_stencil_kernel<EPI, true, TP, TB><<<grid, bx, 0, s>>>(p, b, out, partials, g, w, m);
    else
        poisson_stencil_kernel<EPI, false, TP, TB><<<grid, bx, 0, s>>>(p, b, out, partials, g, w, m);
}

// mA_x, mA_y, mA_z and c0 come together or are all null; active may be null.
extern "C" int poisson_stencil(const void *p, int p_dt, const void *b, int b_dt, const float *mA_x,
                               const float *mA_y, const float *mA_z, const float *c0, const float *active,
                               void *out, float *partials, const Grid *g, int epilogue, float w, int bx,
                               void *stream) {
    const dim3 grid = grid_of(g->n[0], g->n[1], g->n[2], bx);
    cudaStream_t s = (cudaStream_t)stream;
    const bool any_coeff = mA_x != nullptr || mA_y != nullptr || mA_z != nullptr || c0 != nullptr;
    const bool all_coeff = mA_x != nullptr && mA_y != nullptr && mA_z != nullptr && c0 != nullptr;
    if (any_coeff != all_coeff) return (int)cudaErrorInvalidValue;
    const Masks m = {{mA_x, mA_y, mA_z}, c0, active};
    if (epilogue == EPI_MATVEC) b_dt = p_dt;  // b is not read
    PTT_DT(p_dt, TP, PTT_DT(b_dt, TB, {
        const TP *pp = (const TP *)p;
        const TB *bb = (const TB *)b;
        TP *oo = (TP *)out;
        if (epilogue == EPI_MATVEC)
            launch_stencil<EPI_MATVEC>(grid, bx, s, pp, bb, oo, partials, *g, w, m);
        else if (epilogue == EPI_RESIDUAL)
            launch_stencil<EPI_RESIDUAL>(grid, bx, s, pp, bb, oo, partials, *g, w, m);
        else if (epilogue == EPI_JACOBI)
            launch_stencil<EPI_JACOBI>(grid, bx, s, pp, bb, oo, partials, *g, w, m);
        else
            return (int)cudaErrorInvalidValue;
    }));
    return (int)cudaGetLastError();
}

extern "C" int jacobi_sweep(const void *u, int u_dt, const void *b, int b_dt, void *out, int out_dt,
                            float *partials, const Grid *g, float w, int zero_init, int bx, void *stream) {
    const dim3 grid = grid_of(g->n[0], g->n[1], g->n[2], bx);
    cudaStream_t s = (cudaStream_t)stream;
    if (zero_init) u_dt = PTT_F32;  // u is not read
    PTT_DT(u_dt, TU, PTT_DT(b_dt, TB, PTT_DT(out_dt, TO, {
        if (zero_init)
            jacobi_sweep_kernel<true, TU, TB, TO><<<grid, bx, 0, s>>>(
                nullptr, (const TB *)b, (TO *)out, partials, *g, w);
        else
            jacobi_sweep_kernel<false, TU, TB, TO><<<grid, bx, 0, s>>>(
                (const TU *)u, (const TB *)b, (TO *)out, partials, *g, w);
    })));
    return (int)cudaGetLastError();
}

extern "C" int residual_restrict(const void *u, int u_dt, const void *b, int b_dt, void *out, const Grid *g,
                                 int bx, void *stream) {
    if ((g->n[0] | g->n[1] | g->n[2]) & 1) return (int)cudaErrorInvalidValue;
    const dim3 grid = grid_of(g->n[0] / 2, g->n[1] / 2, g->n[2] / 2, bx);
    cudaStream_t s = (cudaStream_t)stream;
    PTT_DT(u_dt, TU, PTT_DT(b_dt, TB, {
        residual_restrict_kernel<TU, TB><<<grid, bx, 0, s>>>((const TU *)u, (const TB *)b, (TU *)out, *g);
    }));
    return (int)cudaGetLastError();
}

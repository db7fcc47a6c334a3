// K8: particle-to-grid scatter of the FLIP step — per nearest cell the sum of
// the particles' values and their count, in one pass.
//
//   replaces phiflow_tpu/ops/p2g.py::_p2g_pallas
//
//   cell_a(p) = floor((pos[p][a] - lower[a]) * inv_dx[a])         (float32)
//   sums[cell]   += values[p]
//   counts[cell] += 1
//
// A particle outside the grid on any axis is dropped (discard) or kept at the
// border cell (clamp). The mean and the fill value of empty cells are formed by
// the wrapper from sums and counts, as in the JAX package.
//
// The TPU kernel turns the scatter into one-hot matrix products because its
// scatter is serial; here the scatter is what the card does well. One thread
// per particle computes its cell and does two float atomicAdd. The cell
// expression is kept uncontracted (__fsub_rn, __fmul_rn: no fused
// multiply-add), so a particle on a cell border lands in the cell the plain
// version computes. Counts are exact; the sums' order of addition changes from
// run to run, so they agree with the plain version to float32 roundoff of the
// handful of addends a cell receives.
//
// Bound: bytes. A particle is 16 bytes read (position and value) for two
// atomics; a cell is 8 bytes written. No arithmetic to speak of.
#include "common.cuh"

struct P2GGrid {
    int n[3];         // cells per axis (x, y, z); z is contiguous
    float lower[3];   // position of the grid's lower corner
    float inv_dx[3];  // 1 / cell size, rounded to float32 by the wrapper
};

__global__ void p2g_kernel(const float *__restrict__ pos, const float *__restrict__ values,
                           float *__restrict__ sums, float *__restrict__ counts, long long n_particles,
                           P2GGrid g, int clamp) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_particles) return;
    long long cell = 0;
    bool inside = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        float c = floorf(__fmul_rn(__fsub_rn(pos[3 * i + a], g.lower[a]), g.inv_dx[a]));
        inside = inside && c >= 0.f && c < (float)g.n[a];
        c = fminf(fmaxf(c, 0.f), (float)(g.n[a] - 1));  // a NaN position goes to cell 0 (and is not inside)
        cell = cell * g.n[a] + (int)c;
    }
    if (!clamp && !inside) return;
    atomicAdd(sums + cell, values[i]);
    atomicAdd(counts + cell, 1.f);
}

// sums and counts must be zeroed by the caller.
extern "C" int p2g_scatter(const float *pos, const float *values, float *sums, float *counts,
                           long long n_particles, const P2GGrid *g, int clamp, void *stream) {
    if (n_particles <= 0) return (int)cudaSuccess;
    const int threads = 256;
    const long long blocks = (n_particles + threads - 1) / threads;
    p2g_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(pos, values, sums, counts, n_particles, *g,
                                                                      clamp);
    return (int)cudaGetLastError();
}

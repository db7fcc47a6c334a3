// K4 prolong_add — replaces phiflow_tpu/ops/transfer.py::_prolong_add_pallas_3d,
// the V-cycle's upward transfer: out = u + nearest-2x-upsample(c), or the
// upsample alone when u is null.
//
// Bound: one add per fine cell against 2 (or 1) fine reads/writes and 1/8 of a
// coarse read per cell, so it is bound by device-memory bytes. One thread per
// fine cell, threads along the contiguous z axis; neighbouring thread pairs
// read the same coarse value, which the cache serves. The TPU kernel's MXU
// pairing matmul (an interleave along its lane axis) has no reason to exist
// here.
#include "common.cuh"

template <typename T>
__global__ void prolong_add_kernel(const T *__restrict__ c, const T *__restrict__ u, T *__restrict__ out, int X,
                                   int Y, int Z) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x, j = blockIdx.y, i = blockIdx.z;
    if (k >= Z) return;
    const long long q = ((long long)i * Y + j) * Z + k;
    const long long qc = ((long long)(i >> 1) * (Y >> 1) + (j >> 1)) * (Z >> 1) + (k >> 1);
    float v = ld(c, qc);
    if (u != nullptr) v = ld(u, q) + v;
    st(out, q, v);
}

// X, Y, Z: the fine shape (all even). u may be null. `bx`: block size along z.
extern "C" int prolong_add(const void *c, const void *u, void *out, int dt, int X, int Y, int Z, int bx,
                           void *stream) {
    if ((X | Y | Z) & 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((Z + bx - 1) / bx, Y, X);
    PTT_DT(dt, T, {
        prolong_add_kernel<T><<<grid, bx, 0, (cudaStream_t)stream>>>((const T *)c, (const T *)u, (T *)out, X, Y, Z);
    });
    return (int)cudaGetLastError();
}

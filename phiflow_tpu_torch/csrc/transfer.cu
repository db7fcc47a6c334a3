// K4 prolong_add — the counterpart of phiflow_tpu/ops/transfer.py::_prolong_add_pallas_3d,
// the V-cycle's upward transfer: out = u + nearest-2x-upsample(c), or the
// upsample alone when u is null. Arithmetic float32, stored in c's dtype.
//
// Bound: one add per fine cell against a fine read and write (or the write
// alone) and 1/8 of a coarse read a cell, so it is bound by device-memory
// bytes. Design: a thread takes a run of coarse values along z once and writes
// the 2 (x) x 2 (y) fine rows that share them, 16 bytes a row (8 bfloat16 or
// 4 float32 values from 4 or 2 coarse ones), with 16-byte loads of u; threads
// of a block run along z, so each warp's loads and stores are contiguous. Each
// coarse value is read once and each fine value once, with no shared memory.
// Where a fine row is not a whole number of 16-byte groups (or a pointer is not
// aligned to them), the same threads take their values one at a time and mask
// the ragged tail. The TPU kernel's MXU pairing matmul (an interleave along
// its lane axis) has no reason to exist here. A batch of nb fields (a leading
// axis) is one launch: blockIdx.z runs over the coarse planes of each entry in
// turn, and a block offsets its pointers by its entry's first element.
#include "common.cuh"

template <typename T, bool VEC>
__global__ void prolong_add_kernel(const T *__restrict__ c, const T *__restrict__ u, T *__restrict__ out, int X,
                                   int Y, int Z) {
    constexpr int N = 16 / sizeof(T);  // fine values a run: 16 bytes of a row
    const int run = blockIdx.x * blockDim.x + threadIdx.x;
    const int Xc = X >> 1, Yc = Y >> 1, Zc = Z >> 1;
    const long long entry = blockIdx.z / Xc;
    const int jc = blockIdx.y * blockDim.y + threadIdx.y, ic = blockIdx.z - (int)entry * Xc;
    c += entry * ((long long)Xc * Yc * Zc);
    out += entry * ((long long)X * Y * Z);
    if (u != nullptr) u += entry * ((long long)X * Y * Z);
    const int k0 = run * N;  // the run's first fine z
    if (jc >= Yc || k0 >= Z) return;
    const long long qc = ((long long)ic * Yc + jc) * Zc + (k0 >> 1);
    float cv[N / 2];
    if (VEC) {
        const uint2 h = *reinterpret_cast<const uint2 *>(c + qc);
        const uint32_t w[2] = {h.x, h.y};
        unpack<T>(w, cv);
    } else {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) cv[i] = k0 + 2 * i < Z ? ld(c, qc + i) : 0.f;
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) {
        const long long q = ((long long)(2 * ic + (d >> 1)) * Y + 2 * jc + (d & 1)) * Z + k0;
        float f[N];
#pragma unroll
        for (int i = 0; i < N; ++i) f[i] = cv[i >> 1];
        if (VEC) {
            if (u != nullptr) {
                const uint4 r = *reinterpret_cast<const uint4 *>(u + q);
                const uint32_t w[4] = {r.x, r.y, r.z, r.w};
                float uf[N];
                unpack<T>(w, uf);
#pragma unroll
                for (int i = 0; i < N; ++i) f[i] = uf[i] + f[i];
            }
            uint32_t w[4];
            pack<T>(f, w);
            *reinterpret_cast<uint4 *>(out + q) = make_uint4(w[0], w[1], w[2], w[3]);
        } else {
#pragma unroll
            for (int i = 0; i < N; ++i) {
                if (k0 + i < Z) st(out, q + i, u != nullptr ? ld(u, q + i) + f[i] : f[i]);
            }
        }
    }
}

template <typename T>
static int launch_prolong(const void *c, const void *u, void *out, int nb, int X, int Y, int Z, cudaStream_t s) {
    constexpr int N = 16 / sizeof(T);
    const int runs = (Z + N - 1) / N;
    int bx = 1;
    while (bx < runs && bx < 32) bx <<= 1;
    const int by = 128 / bx;
    const long long planes = (long long)nb * (X / 2);
    if (nb < 1 || planes > 65535) return (int)cudaErrorInvalidValue;
    const dim3 block(bx, by), grid((runs + bx - 1) / bx, (Y / 2 + by - 1) / by, (unsigned)planes);
    const bool aligned = Z % N == 0 && ((uintptr_t)c % 8 | (uintptr_t)u % 16 | (uintptr_t)out % 16) == 0;
    if (aligned)
        prolong_add_kernel<T, true><<<grid, block, 0, s>>>((const T *)c, (const T *)u, (T *)out, X, Y, Z);
    else
        prolong_add_kernel<T, false><<<grid, block, 0, s>>>((const T *)c, (const T *)u, (T *)out, X, Y, Z);
    return (int)cudaGetLastError();
}

// X, Y, Z: the fine shape (all even) of each of nb entries. u may be null.
extern "C" int prolong_add(const void *c, const void *u, void *out, int dt, int nb, int X, int Y, int Z,
                           void *stream) {
    if ((X | Y | Z) & 1) return (int)cudaErrorInvalidValue;
    PTT_DT(dt, T, return launch_prolong<T>(c, u, out, nb, X, Y, Z, (cudaStream_t)stream));
    return (int)cudaErrorInvalidValue;
}

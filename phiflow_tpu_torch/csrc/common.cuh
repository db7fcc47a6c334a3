// Shared helpers of the port's CUDA kernels: typed loads and stores (float32
// or bfloat16 storage, float32 arithmetic), 32-bit words of storage as float32
// values and back, the dtype dispatch of the C entry points, and a block-wide
// sum. Each kernel library (one .so per .cu file) includes this header once.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

// dtype codes passed by the Python wrappers
#define PTT_F32 0
#define PTT_BF16 1

extern "C" const char *ptt_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

__device__ __forceinline__ float ld(const float *p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16 *p, long long i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void st(float *p, long long i, float v) { p[i] = v; }
// round to nearest even, the rounding of XLA's f32 -> bf16 convert
__device__ __forceinline__ void st(__nv_bfloat16 *p, long long i, float v) { p[i] = __float2bfloat16_rn(v); }

// 32-bit words of storage type T as float32 values (2 a word for bfloat16,
// whose float32 value is its bits in the upper half) and back, rounding to
// nearest even as `st` does.
template <typename T, int W>
__device__ __forceinline__ void unpack(const uint32_t (&w)[W], float *f) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
        if constexpr (sizeof(T) == 4) {
            f[i] = __uint_as_float(w[i]);
        } else {
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
}

template <typename T, int W>
__device__ __forceinline__ void pack(const float *f, uint32_t (&w)[W]) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
        if constexpr (sizeof(T) == 4) {
            w[i] = __float_as_uint(f[i]);
        } else {
            w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i])) |
                   (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])) << 16;
        }
    }
}

// Run the statement(s) with T bound to the storage type of dtype `code`.
#define PTT_DT(code, T, ...)                                 \
    do {                                                     \
        if ((code) == PTT_F32) {                             \
            using T = float;                                 \
            __VA_ARGS__;                                     \
        } else if ((code) == PTT_BF16) {                     \
            using T = __nv_bfloat16;                         \
            __VA_ARGS__;                                     \
        } else {                                             \
            return (int)cudaErrorInvalidValue;               \
        }                                                    \
    } while (0)

// Sum of v over a block whose size is a multiple of 32 (at most 1024; 1-D,
// or 2-D / 3-D with threads numbered x fastest). Every thread of the block must
// call it; the result is valid in thread (0, 0, 0).
__device__ __forceinline__ float block_sum(float v) {
    __shared__ float warp_sums[32];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int tid = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
        const int n_warps = (blockDim.x * blockDim.y * blockDim.z) >> 5;
        v = lane < n_warps ? warp_sums[lane] : 0.f;
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    }
    return v;
}

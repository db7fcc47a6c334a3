// Shared helpers of the port's CUDA kernels: typed loads and stores (float32
// or bfloat16 storage, float32 arithmetic), the dtype dispatch of the C entry
// points, and a block-wide sum. Each kernel library (one .so per .cu file)
// includes this header once.
#pragma once

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

// Sum of v over a 1-D block whose size is a multiple of 32 (at most 1024).
// Every thread of the block must call it; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
    __shared__ float warp_sums[32];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) {
        const int n_warps = blockDim.x >> 5;
        v = lane < n_warps ? warp_sums[lane] : 0.f;
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    }
    return v;
}

// Shared by the advection kernels (advect3d.cu: K5; interp.cu: K6 and K7):
// how an array is read past its extent, and the linear-interpolation window of
// one displacement. All three kernels resolve boundaries and count corners
// with this one piece of arithmetic, so they agree with each other and with
// the TPU window sum on which corners carry weight.
#pragma once

#include "common.cuh"

#define SRC_CONST 0
#define SRC_EDGE 1
#define SRC_WRAP 2

// An array of up to three axes (a 2D array uses entries 0 and 1) addressed by
// logical indices: raw index = logical index - shift per axis. Outside the raw
// extent the array is the constant c, clamps to its edge (zero gradient) or
// wraps (periodic).
struct Src {
    const float *p;
    int n[3];      // raw shape
    int shift[3];  // raw index = logical index - shift
    int mode;      // SRC_CONST | SRC_EDGE | SRC_WRAP outside the raw extent
    float c;       // the constant of SRC_CONST
};

__device__ __forceinline__ int resolve(int l, int n, int mode, bool &outside) {
    if (mode == SRC_WRAP) return ((l % n) + n) % n;
    if (mode == SRC_EDGE) return min(max(l, 0), n - 1);
    if (l < 0 || l >= n) outside = true;
    return l;
}

__device__ __forceinline__ float fetch(const Src &s, int l0, int l1, int l2) {
    bool outside = false;
    const int r0 = resolve(l0 - s.shift[0], s.n[0], s.mode, outside);
    const int r1 = resolve(l1 - s.shift[1], s.n[1], s.mode, outside);
    const int r2 = resolve(l2 - s.shift[2], s.n[2], s.mode, outside);
    if (outside) return s.c;
    return __ldg(s.p + ((long long)r0 * s.n[1] + r1) * s.n[2] + r2);
}

// A velocity sample in cells: scaled (sign included), then clipped to +-K.
__device__ __forceinline__ float clip_cells(float scale, float v, int K) {
    const float kf = (float)K;
    return fminf(fmaxf(scale * v, -kf), kf);
}

// The two taps s = floor(d) and floor(d) + 1 of a displacement d along one
// axis, with the TPU window's tent weight max(0, 1 - |d - s|) and its corner
// test |d - s| < 1 written the same way, so both count the same corners in
// floating point: for an integer d the upper tap has weight 0 and is no corner.
// Returns floor(d) as the offset of the lower tap.
__device__ __forceinline__ int window_taps(float d, float (&wt)[2], bool (&hit)[2]) {
    const float f = floorf(d);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        const float dist = fabsf(d - (f + (float)c));
        wt[c] = fmaxf(0.f, 1.f - dist);
        hit[c] = dist < 1.f;
    }
    return (int)f;
}

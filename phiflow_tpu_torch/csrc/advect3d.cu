// K5 fused_advect — replaces phiflow_tpu/ops/advect3d.py::fused_advect_3d, the
// semi-Lagrangian advection of the 3D smoke step with displacements built
// in-kernel from the raw staggered (MAC) velocity.
//
// One launch computes one output (one OutSpec of the Python wrapper), one
// thread per output point:
//   1. the displacement (dx, dy, dz) at the point, from the three velocity
//      arrays: the own face for the own component of a staggered output, the
//      4-point cross average for the other components, the 2-point average at
//      a cell centre (phiflow_tpu/ops/advect3d.py:39-46, 280-314);
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
// clamps to its edge (zero gradient) or wraps (periodic). Clipped
// displacements of exactly +-K thus never read outside the arrays.
//
// Bound: a few dozen flops per point against ~16 gathered loads, mostly cache
// hits; the distinct bytes (each input read once, each output written once)
// set the floor, so the kernel is bound by device-memory bytes. This first
// version leaves the neighbour reuse to the L1/L2 caches.
#include "window.cuh"

struct Blk {  // an operand indexed by the output point (shape >= the output's)
    const float *p;
    int n1, n2;
};

struct AdvectArgs {
    Src vel[3];  // the velocity components x, y, z
    Src fld;     // the advected array
    float *out, *out_lo, *out_up;
    int o[3];      // output shape
    int ds[3];     // logical index = output index + ds
    int d_own;     // own axis of a staggered output, -1 for a centred one
    int K;         // displacement clip in cells
    float scale[3];  // velocity units -> cells, sign included
    int extrema;
    int combine;
    Blk c_field, c_lo, c_up;
    float c_half_strength;
    int add_blocked;
    Blk add;
    float add_scale;
    int add_ball;
    float ball[5];  // cx, cy, cz, radius (cells), rate
};

__device__ __forceinline__ float blk(const Blk &b, int o0, int o1, int o2) {
    return __ldg(b.p + ((long long)o0 * b.n1 + o1) * b.n2 + o2);
}

__global__ void fused_advect_kernel(const AdvectArgs a) {
    const int o2 = blockIdx.x * blockDim.x + threadIdx.x, o1 = blockIdx.y, o0 = blockIdx.z;
    if (o2 >= a.o[2]) return;
    const int l[3] = {o0 + a.ds[0], o1 + a.ds[1], o2 + a.ds[2]};
    const int d = a.d_own;
    float disp[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
        float v;
        if (d >= 0 && e == d) {
            v = fetch(a.vel[e], l[0], l[1], l[2]);
        } else if (d >= 0) {
            v = 0.f;
            for (int bb = 0; bb < 2; ++bb)       // e-axis offset
                for (int aa = -1; aa <= 0; ++aa) {  // d-axis offset
                    int m[3] = {l[0], l[1], l[2]};
                    m[d] += aa;
                    m[e] += bb;
                    v += fetch(a.vel[e], m[0], m[1], m[2]);
                }
            v *= 0.25f;
        } else {
            int m[3] = {l[0], l[1], l[2]};
            m[e] += 1;
            v = (fetch(a.vel[e], l[0], l[1], l[2]) + fetch(a.vel[e], m[0], m[1], m[2])) * 0.5f;
        }
        disp[e] = clip_cells(a.scale[e], v, a.K);
    }
    // corners s = floor(d) and floor(d) + 1 per axis (window.cuh)
    int base[3];
    float wt[3][2];
    bool hit[3][2];
#pragma unroll
    for (int e = 0; e < 3; ++e) base[e] = l[e] + window_taps(disp[e], wt[e], hit[e]);
    float val = 0.f, lo = 3.4e38f, up = -3.4e38f;
#pragma unroll
    for (int cx = 0; cx < 2; ++cx)
#pragma unroll
        for (int cy = 0; cy < 2; ++cy)
#pragma unroll
            for (int cz = 0; cz < 2; ++cz) {
                const float v = fetch(a.fld, base[0] + cx, base[1] + cy, base[2] + cz);
                val += wt[0][cx] * wt[1][cy] * wt[2][cz] * v;
                if (a.extrema && hit[0][cx] && hit[1][cy] && hit[2][cz]) {
                    lo = fminf(lo, v);
                    up = fmaxf(up, v);
                }
            }
    if (a.combine) {
        const float center = fetch(a.fld, l[0], l[1], l[2]);
        const float corrected = center + a.c_half_strength * (blk(a.c_field, o0, o1, o2) - val);
        val = fminf(fmaxf(corrected, blk(a.c_lo, o0, o1, o2)), blk(a.c_up, o0, o1, o2));
    }
    if (a.add_blocked) val += a.add_scale * blk(a.add, o0, o1, o2);
    if (a.add_ball) {
        const float gx = (float)o0 + 0.5f - a.ball[0];
        const float gy = (float)o1 + 0.5f - a.ball[1];
        const float gz = (float)o2 + 0.5f - a.ball[2];
        const float dist = sqrtf(gx * gx + gy * gy + gz * gz);
        const float frac = fminf(fmaxf(0.5f + (a.ball[3] - dist), 0.f), 1.f);
        val += a.ball[4] * frac;
    }
    const long long q = ((long long)o0 * a.o[1] + o1) * a.o[2] + o2;
    a.out[q] = val;
    if (a.extrema) {
        a.out_lo[q] = lo;
        a.out_up[q] = up;
    }
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

extern "C" int fused_advect(const AdvectArgs *a, int bx, void *stream) {
    const dim3 grid((a->o[2] + bx - 1) / bx, a->o[1], a->o[0]);
    fused_advect_kernel<<<grid, bx, 0, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" int advect_lift(const float *val, float *lift, int n0, int n1, int n2, int axis, float half_scale, int bx,
                           void *stream) {
    const dim3 grid((n2 + bx - 1) / bx, n1, n0);
    advect_lift_kernel<<<grid, bx, 0, (cudaStream_t)stream>>>(val, lift, n0, n1, n2, axis, half_scale);
    return (int)cudaGetLastError();
}

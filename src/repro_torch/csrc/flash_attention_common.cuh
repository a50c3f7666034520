// Helpers shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the mask, quad reductions, bf16 packing, the
// re-packing of wgmma accumulators into A fragments, and the staging of
// f32 row tiles into shared memory.  The bf16 kernels' wgmma, TMA and
// mbarrier helpers are in hopper.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa {

// the finite mask value of the TPU kernels (kernel.py:24)
constexpr float NEG_INF = -1e30f;

// Whether query `q` may attend to key `k`: the TPU kernels' mask, k < S
// (the ragged edge of the keys), causal and window.  Query rows at or past
// S are the caller's to mask or to leave unwritten.
__device__ __forceinline__ bool kept(int q, int k, int S, int causal,
                                     int window) {
    bool ok = k < S;
    if (causal) ok = ok && q >= k;
    if (window > 0) ok = ok && (q - k) < window;
    return ok;
}

// Key tiles [lo, hi) of `bk` keys that hold a key some query of
// [q0, q0 + nq) sees.  Params: a kernel's parameters (S, causal, window).
template <class Params>
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int nq,
                                          int bk, int& lo, int& hi) {
    hi = (p.S + bk - 1) / bk;
    if (p.causal) hi = min(hi, (min(q0 + nq, p.S) - 1) / bk + 1);
    lo = 0;
    if (p.window > 0) {
        const int k_min = q0 - p.window + 1;   // smallest key q0 sees
        if (k_min > 0) lo = k_min / bk;
    }
}

// Whether every pair of queries [q0, q0 + nq) and keys [k0, k0 + nk) is
// kept (no mask needed).
template <class Params>
__device__ __forceinline__ bool pairs_full(const Params& p, int q0, int nq,
                                           int k0, int nk) {
    return q0 + nq <= p.S && k0 + nk <= p.S
        && (!p.causal || q0 >= k0 + nk - 1)
        && (p.window <= 0 || q0 + nq - 1 - k0 < p.window);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x in the low half
    return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 A fragments of k-steps [0, NR / 8) from an m64nN accumulator
// (NR = N / 2 registers): columns [16k, 16k + 16) are k-step k (the layout
// note of hopper.cuh's wgmma wrappers).
template <int NR>
__device__ __forceinline__ void to_frags(const float (&c)[NR],
                                         uint32_t (&a)[NR / 8][4]) {
#pragma unroll
    for (int k = 0; k < NR / 8; ++k) {
        a[k][0] = pack_f32(c[8 * k], c[8 * k + 1]);
        a[k][1] = pack_f32(c[8 * k + 2], c[8 * k + 3]);
        a[k][2] = pack_f32(c[8 * k + 4], c[8 * k + 5]);
        a[k][3] = pack_f32(c[8 * k + 6], c[8 * k + 7]);
    }
}

// Copy rows [r0, r0 + rows) of a row-major [S, D] f32 matrix into a shared
// tile with row stride D + 4 floats, 16 bytes a thread; rows at or past S
// are zero.
template <int D, int THREADS>
__device__ __forceinline__ void stage_f32(float* tile, const float* src,
                                          int r0, int rows, int S) {
    constexpr int CPR = D / 4;
    constexpr int LD = D + 4;
    for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
        const int row = i / CPR, ch = i % CPR;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r0 + row < S)
            x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + row) * D
                                                 + ch * 4);
        *reinterpret_cast<float4*>(&tile[row * LD + ch * 4]) = x;
    }
}

}  // namespace fa

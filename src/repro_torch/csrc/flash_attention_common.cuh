// Helpers shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the mask, quad reductions, bf16 packing, the
// mma.sync m16n8k16 product of the forward (row-major A, column-major B,
// f32 accumulation) and the staging of f32 row tiles into shared memory.
// The bf16 backward's wgmma, TMA and mbarrier helpers are in hopper.cuh.
//
// Fragment layout of one m16n8k16 product, per lane (g = lane / 4,
// t = lane % 4; pairs pack the lower column into the low 16 bits):
//   A 16x16: a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//            a2 (row g, cols 2t+8..2t+9), a3 (row g+8, cols 2t+8..2t+9);
//   B 16x8:  b0 (rows 2t..2t+1, col g), b1 (rows 2t+8..2t+9, col g);
//   C 16x8:  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols).
// So the C tiles of two neighbouring 8-column tiles are, packed pairwise,
// the A fragment of one 16-deep step: a product's output feeds the next
// product from registers.

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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo)
        | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b for one 16x8x16 tile (row-major A, column-major B).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// mbarriers, TMA tile loads through a tensor map, wgmma with its shared-
// memory descriptors and fences, setmaxnreg, ex2.approx, and the panel
// layout of bf16 tiles with their descriptors.  Raw PTX through inline
// asm; the host side encodes tensor maps through the driver entry point
// that the CUDA runtime hands out, so nothing links against libcuda.
//
// Shared-memory tiles.  A bf16 tile of R rows and D columns lies in D / PW
// panels of PW = min(D, 64) columns, panel after panel, each R rows of PW * 2
// bytes: one TMA box per panel, with TMA's 128-byte swizzle at PW 64 and its
// 64-byte swizzle at PW 32, so that one row of a panel is one swizzle span.
// Panels start 1024-byte aligned.  wgmma reads such a panel two ways:
// * K-major (the row is the product's depth): 16 columns a k-step, the
//   start address moved 32 bytes within the row; 8-row groups SBO = 8 rows
//   apart (LBO unused);
// * MN-major (the row is the depth, the columns the product's N; the
//   transposed operand): 16 rows a k-step; 8-row groups SBO apart; the
//   panel is one swizzle atom wide, so the instruction's N is PW (LBO, the
//   stride between atoms along N, is unused).

#pragma once

#include <cuda.h>            // CUtensorMap and its enums; no driver library
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// A wait on an mbarrier that lasts this long means a broken ring: trap, so
// that the launch fails instead of hanging the card.
constexpr uint64_t WATCHDOG_NS = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t globaltimer() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// After the inits, before any other thread uses the barriers.
__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("{\n.reg .b64 state;\n"
                 "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// Arrive and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Add `bytes` to the transactions the phase waits for, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
    uint32_t ok;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.b32 %0, 1, 0, p;\n}\n"
                 : "=r"(ok) : "r"(addr), "r"(parity) : "memory");
    return ok != 0;
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier
// is in phase 0, so a wait on parity 1 passes at once: a producer waits on
// its empty barriers with its phase bit flipped.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    if (mbar_try_wait(addr, parity)) return;
    const uint64_t t0 = globaltimer();
    while (!mbar_try_wait(addr, parity))
        if (globaltimer() - t0 > WATCHDOG_NS) __trap();
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Copy the box at coordinates (c0 innermost, c1, c2) of `map` into shared
// memory at `dst`; completion is counted in bytes on `bar`.  Elements out
// of the tensor's bounds arrive as zeros and count all the same.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];"
        :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// Order this thread's earlier generic-proxy accesses to shared memory before
// its later async-proxy ones (a TMA copy into a buffer that was just read).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a bf16 operand in shared memory at `p` (see the note at the
// top): LBO and SBO in bytes, `swizzle` 128 or 64 bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
        | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
        | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
        | ((uint64_t)(swizzle == 128 ? 1 : 2) << 62);
}

// Before the first wgmma of a batch whose registers (accumulators, A
// fragments) other instructions wrote.
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most N committed batches are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across this point (after a wgmma_wait, before the registers are read).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// Accumulator of m64nNk16 (f32), per thread of the warpgroup (warp w,
// lane = 4g + t): d[4j + e] is row 16w + g + 8 (e >= 2), column 8j + 2t +
// (e & 1).  The A fragment of m64k16 in registers has the same rows:
// a[0] (row g, columns 2t, 2t+1), a[1] (row g+8, same), a[2] (row g,
// columns 2t+8, 2t+9), a[3] (row g+8, same), pairs packed low column
// first; so accumulator columns [16k, 16k+16) re-pack into the A fragment
// of k-step k without a shuffle.
// `accumulate` 0: d = A B; 1: d += A B.

// d (+)= A B, m64n32k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, m64n32k16, A from registers (the m64k16 fragment), B
// from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
}

// d (+)= A B, m64n64k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, m64n128k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, m64n64k16, A from registers (the m64k16 fragment), B
// from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
}

// ---------------------------------------------------------------------------
// bf16 tiles in panels (the note at the top)
// ---------------------------------------------------------------------------

// A bf16 tile of R rows and D columns: D / PW panels of R rows of PW
// columns, each one TMA box.
template <int D>
struct Panels {
    static constexpr int PW = D < 64 ? D : 64;   // columns a panel
    static constexpr int NP = D / PW;            // panels
    static constexpr int SWIZZLE = PW * 2;       // bytes: one row of a panel
    static constexpr int SBO = 8 * SWIZZLE;      // 8 rows of a panel
};

// K-major descriptor of rows [r0, r0 + 64) of a tile of R rows at k-step
// ks (columns [16 ks, 16 ks + 16)).
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor(const __nv_bfloat16* tile, int r0,
                                           int ks) {
    using P = Panels<D>;
    const int col = ks * 16;
    const __nv_bfloat16* at = tile + (col / P::PW) * R * P::PW + r0 * P::PW
        + col % P::PW;
    return smem_desc(at, 16, P::SBO, P::SWIZZLE);
}

// MN-major descriptor of rows [16 kk, 16 kk + 16) (the depth) and panel pn
// (N = PW columns) of a tile of R rows.
template <int D, int R>
__device__ __forceinline__ uint64_t mnmajor(const __nv_bfloat16* tile, int kk,
                                            int pn) {
    using P = Panels<D>;
    const __nv_bfloat16* at = tile + pn * R * P::PW + kk * 16 * P::PW;
    return smem_desc(at, P::SBO, P::SBO, P::SWIZZLE);
}

// TMA of rows [r0, r0 + R) of matrix `m` of `map` into a tile of R rows.
template <int D, int R>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int r0, int m) {
    using P = Panels<D>;
#pragma unroll
    for (int pn = 0; pn < P::NP; ++pn)
        tma_load_3d(tile + pn * R * P::PW, map, bar, pn * P::PW, r0, m);
}

// The first 1024-byte aligned address at or after p (panels start there).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// the special-function unit
// ---------------------------------------------------------------------------

// 2^x on the special-function unit: at most 2 ulp of f32 off (PTX ISA,
// ex2.approx); subnormal results flush to 0, and -1e30 gives 0.
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// ---------------------------------------------------------------------------
// setmaxnreg: a producer warpgroup hands registers to the consumers
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(R));
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled lookup_encode_tiled() {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
        return nullptr;
    return reinterpret_cast<EncodeTiled>(fn);
}

// A 3-D tensor map over a contiguous bf16 [n, rows, cols] array (cols 32,
// 64, 128 or 256) whose box is one panel of `box_rows` rows of one matrix:
// [min(cols, 64), box_rows, 1], swizzled as the note at the top says.
// Rows past `rows` fall outside the map and load as zeros, never as the
// next matrix's rows.
inline cudaError_t tensor_map_bf16(CUtensorMap* map, const void* base, int n,
                                   int rows, int cols, int box_rows) {
    static const EncodeTiled encode = lookup_encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const int box_cols = cols < 64 ? cols : 64;
    const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                                (cuuint64_t)n};
    const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                   (cuuint64_t)rows * cols * 2};
    const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
    const cuuint32_t steps[3] = {1, 1, 1};
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
        dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
        box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 3-D tensor map over 8-byte elements (complex64 moved as 64-bit words):
// extents dims[0] (contiguous), dims[1], dims[2], byte strides strides[0]
// of dim 1 and strides[1] of dim 2, box `box`, no swizzle.  Boxes land in
// shared memory dense, dim 0 fastest; elements out of bounds load as zeros.
inline cudaError_t tensor_map_c64(CUtensorMap* map, const void* base,
                                  const cuuint64_t (&dims)[3],
                                  const cuuint64_t (&strides)[2],
                                  const cuuint32_t (&box)[3]) {
    static const EncodeTiled encode = lookup_encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint32_t steps[3] = {1, 1, 1};
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, 3, const_cast<void*>(base),
        dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper

// ssd_scan: the Mamba-2 SSD (state-space duality) chunked scan, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan/kernel.py:75,
// body `_ssd_kernel`, pallas_call at :101).  For x [B,S,H,P], dt [B,S,H] (f32),
// a [H] (f32) and b, c [B,S,G,N] (x, b, c all f32 or all bf16; head h reads
// group h / (H/G)) it computes, per chunk of L rows and head h, in f32:
//   cum   = cumsum(dt * a_h)                                        [L]
//   y     = ((C B^T) o exp(cum_i - cum_j) o (j <= i) o dt_j) x      (intra)
//         + (C o exp(cum)_i) state                                  (inter)
//   state = exp(cum_L) state + (B o exp(cum_L - cum) dt)^T x
// and writes y [B,S,H,P] (contiguous, x's dtype) and the final state
// [B,H,N,P] (contiguous, f32).  x, dt, b and c are read in place through
// their strides (the model hands over slices of the convolution's output);
// x, b and c need a unit stride along P and N.
//
// What bounds it on this card.  At the main path's shape (mamba2-130m
// prefill, B 4, S 2048, H 24, P 64, G 1, N 128, L 128, f32 operands) the
// arithmetic is 8.20 GFLOP (C B^T once per (b, group, chunk) over the causal
// triangle, M x over the same pairs, and the L N P inter and state products
// per (b, h, chunk)), against 112 MB that must move once (34 us at
// 3.35 TB/s).  The reference's 1e-4 bar rules out one TF32 product (10-bit
// mantissas: 5e-4 in y), not a split one: each f32 operand v is split as
// hi = rna(v), lo = rna(v - hi), and lo_a hi_b + hi_a lo_b + hi_a hi_b
// accumulate in f32 on the tensor cores (~5e-7 in y).  At 495 TFLOP/s TF32
// over 3 products that is 50 us; bf16 operands are exact in TF32, so a
// product with one needs 2 and C B^T in bf16 needs 1 (33 us).
//
// What this design does about it: Mamba-2's chunked form
// (arXiv:2405.21060 section 6) in four launches (one C call, ssd_scan), so
// that the sequential chain over chunks is a short elementwise pass and
// everything else runs chunk-parallel over the whole card:
// * ssd_cb_kernel, one block per (b, chunk, group, pair of row tiles q and
//   Lp/16 - 1 - q): cb = C B^T over the causal triangle's 8-column tiles,
//   once for all H/G heads of the group, into a scratch
//   cb [B, nc, G, Lp, Lp]; mma.sync m16n8k8 (the smallest product);
// * ssd_chunk_state_kernel, pass A, one block per (b, chunk, head, 64
//   columns of P): cum = cumsum(dt a_h) by one warp (kept in a scratch cum
//   [B, H, nc, Lp]), w = exp(cum_L - cum) dt, and the chunk's own state
//   S_k = B^T (x o w) [N, P] into a scratch states [B, nc, H, N, P];
// * ssd_state_pass_kernel, pass B, one thread per 4 state elements of a
//   (b, h): walks the chunks in order, writes the state entering chunk k
//   over S_k, then h = exp(cum_L) h + S_k; the last h is the final state;
// * ssd_chunk_scan_kernel, pass C, one block per (b, chunk, head, 64
//   columns): y = exp(cum_i) (C h_k) + M x, M = cb o exp(cum_i - cum_j) o
//   dt_j, masked (entries j > i are 0); its decays come from small
//   tables instead of an exponential per entry (E per row and tile, F per
//   column below the diagonal 8-column tiles, D on them).
// Passes A and C run their products on wgmma m64n64k8 (TF32, f32
// accumulators), one warpgroup per 64 rows: the A operand (B^T, C, M) goes
// from global memory (L2: the heads of a group share it) into registers,
// AHEAD pairs of k-steps ahead, and is split there; the B operand (x o w,
// h_k, x) arrives by cp.async and is split once per block into hi and lo
// tiles in shared memory, in the only layout TF32 wgmma reads (K-major:
// the products that contract over the chunk's rows get their tiles
// transposed while they are split).  A block takes 100-115 KB of shared
// memory, so two share an SM.  A ragged tail
// (S not a multiple of L) is masked: rows at or past S stage x = 0,
// dt = 0, b = c = 0, so they add nothing and decay nothing, and y is not
// written there.  The TPU kernel reads past the end (ROADMAP C).
//
// Precision: expf (no fast math: build without --use_fast_math); the
// split rounds to nearest on the integer view, bit for bit what
// cvt.rna.tf32.f32 gives for finite values (raw f32 bits handed to a TF32
// product would be truncated, not rounded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

// Mirrored field by field by kernel.py's `_Args` (ctypes); outside the
// anonymous namespace, so that the C entry points that take it keep
// external linkage.
struct SsdArgs {
    const void* x;
    const float* dt;
    const float* a;
    const void* b;
    const void* c;
    void* y;            // [B, S, H, P], x's dtype
    float* state;       // [B, H, N, P]
    float* cum;         // scratch [B, H, nc, Lp]
    float* cb;          // scratch [B, nc, G, Lp, Lp]
    float* states;      // scratch [B, nc, H, N, P]
    int dtype;          // 0 float32, 1 bfloat16 (x, b, c and y)
    int B, S, H, P, G, N, L, nc, Lp, Np;
    long long sxb, sxs, sxh;    // x strides in elements (unit stride along P)
    long long sdb, sds, sdh;    // dt strides
    long long sbb, sbs, sbg;    // b strides (unit stride along N)
    long long scb, scs, scg;    // c strides
};

namespace {

constexpr int THREADS = 256;
constexpr int MAX_L = 128;
constexpr int MAX_N = 128;
constexpr int PB = 64;          // columns of P a block of pass A or C takes

// What a launch adds: whether x, b, c rows may be copied 16 bytes at a time.
struct Params : SsdArgs {
    int vec_x, vec_b, vec_c;
};

__host__ __device__ constexpr int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

// Row stride (elements) of the cb kernel's shared-memory tiles, chosen so
// that a warp's fragment loads (lane (g, t) reads row g, column t) hit 32
// distinct banks.  bf16 packs two columns a bank.
template <bool BF>
__host__ __device__ constexpr int stride_ra(int cols) {
    return BF ? round_up(cols, 64) + 8 : round_up(cols, 32) + 4;
}

template <bool BF>
using elem_t = typename std::conditional<BF, __nv_bfloat16, float>::type;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
    return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store2(float* o, float u, float v) {
    *reinterpret_cast<float2*>(o) = make_float2(u, v);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float u, float v) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(u, v);
}

// ---------------------------------------------------------------------------
// Staging: cp.async into shared memory
// ---------------------------------------------------------------------------

// 16 bytes, or 16 zero bytes when !fill (the source is then not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool fill) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(fill ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dst [rows][ds] <- src rows < rv and columns < cv (row stride gs), zero
// elsewhere up to `cols` columns.  cols and cv are multiples of 16 bytes'
// worth of elements where vec; src rows then start 16-byte aligned.
template <typename T>
__device__ void stage(T* dst, int ds, const T* src, long long gs, int rows,
                      int rv, int cols, int cv, bool vec) {
    if (vec) {
        constexpr int E = 16 / sizeof(T);
        const int cpr = cols / E;
        for (int e = threadIdx.x; e < rows * cpr; e += THREADS) {
            const int r = e / cpr, q = (e - r * cpr) * E;
            const bool in = r < rv && q < cv;
            cp16(dst + r * ds + q, in ? src + r * gs + q : src, in);
        }
    } else {
        for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
            const int r = e / cols, q = e - r * cols;
            dst[r * ds + q] = r < rv && q < cv ? src[r * gs + q] : zero<T>();
        }
    }
}

// ---------------------------------------------------------------------------
// Split-TF32 products: mma.sync m16n8k8, f32 accumulation
// ---------------------------------------------------------------------------

struct FragA { uint32_t hi[4], lo[4]; };    // rows g, g+8 by columns t, t+4
struct FragB { uint32_t hi[2], lo[2]; };    // depth t, t+4 by column g

// Round to nearest, ties away from zero, to TF32's 10 mantissa bits, on
// the integer view: the same bits as cvt.rna.tf32.f32 for finite values,
// in two integer operations.
__device__ __forceinline__ uint32_t to_tf32(float v) {
    return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// EXACT: v came from bf16, so it is a TF32 value already and lo is 0.
template <bool EXACT>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    if (EXACT) {
        hi = __float_as_uint(v);
        lo = 0u;
    } else {
        hi = to_tf32(v);
        lo = to_tf32(v - __uint_as_float(hi));
    }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b: the small products first, each only where its lo part exists.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_split(float (&d)[4], const FragA& a,
                                          const FragB& b) {
    if (!A_EXACT) mma(d, a.lo, b.hi);
    if (!B_EXACT) mma(d, a.hi, b.lo);
    mma(d, a.hi, b.hi);
}

// ---------------------------------------------------------------------------
// Split-TF32 products on wgmma: m64n64k8, A from registers, B from shared
// memory
// ---------------------------------------------------------------------------

// Depth of the B tiles that wgmma reads (rows of P by KT columns of the
// contraction, zero past N or L), and their layout: TF32 has only K-major
// B, here without swizzle, in cores of 8 rows by 4 values (128 bytes);
// K-adjacent cores 128 bytes apart, 8-row groups KT / 4 cores apart.
constexpr int KT = 128;
constexpr int TILE = 64 * KT;                       // floats of a B tile

// Descriptor of the depth k0 .. k0 + 7 of a tile (k0 a multiple of 8).
__device__ __forceinline__ uint64_t tile_desc(const float* tile, int k0) {
    const uint32_t lbo = 128, sbo = 128 * (KT / 4);
    return (uint64_t)((hopper::smem_addr(tile + 8 * k0) & 0x3FFFF) >> 4)
        | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
        | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);  // layout 0: no swizzle
}

// d += A B for 64 rows (16 a warp: the m16n8k8 A fragment) by 64 columns,
// depth 8.  Accumulator of thread (warp w of the warpgroup, lane 4g + t):
// d[4j + e] is row 16w + g + 8 (e >= 2), column 8j + 2t + (e & 1).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// The contraction's order within each pair of k-steps: depth slot k of the
// tiles (slot s = k % 8 of k-step k / 8) holds index depth(k), so that a
// thread's four A values of a k-step pair are four consecutive indices
// (one 16-byte load a row): 16 (k / 16) + 4 t + 2 l + h for slot t + 4 h
// of k-step 2 (k / 16) + l.
__device__ __forceinline__ int depth(int k) {
    return (k & ~15) | ((k & 3) << 2) | ((k >> 2) & 2) | ((k >> 2) & 1);
}

// Raw B operands: [KT][raw_stride] (rows the contraction's index, columns
// the tile's 64 rows), staged by stage(): 16-byte rows, and a fragment's
// four depth indices (4 rows apart) in two bank groups.  RS bounds both.
template <typename T>
__host__ __device__ constexpr int raw_stride() {
    return sizeof(T) == 4 ? 64 + 4 : 64 + 8;
}
constexpr int RS = raw_stride<float>();             // bounds every raw row

// hi (and, unless B_EXACT, lo) tile [64][KT] from a raw [KT][RS] tile:
// element (row q, slot k) is raw[depth(k)][q] * scale(depth(k)), split; a
// warp writes whole cores.
template <bool B_EXACT, typename T, typename W>
__device__ __forceinline__ void split_tile(float* hi, float* lo,
                                           const T* raw, W scale) {
#pragma unroll 4
    for (int e = threadIdx.x; e < TILE; e += THREADS) {
        const int core = e >> 5, l = e & 31;
        const int q = 8 * (core / (KT / 4)) + (l >> 2);
        const int d = depth(4 * (core % (KT / 4)) + (l & 3));
        uint32_t h, w;
        split<B_EXACT>(to_f(raw[d * raw_stride<T>() + q]) * scale(d), h,
                       w);
        hi[e] = __uint_as_float(h);
        if (!B_EXACT) lo[e] = __uint_as_float(w);
    }
}

constexpr int AHEAD = 4;    // k-step pairs whose A values are in flight

// acc += A B over KS k-steps of depth 8 (KS even).  a_pair(kp, v) gives
// the A values of k-steps 2 kp and 2 kp + 1: v[r][c] is fragment row g + 8r
// at index 16 kp + 4 t + c (see depth()); they are split in registers,
// loaded AHEAD pairs ahead (from global memory: that hides its latency).
// B is the staged pair of tiles.  Two k-steps' split fragments alternate,
// so that none is rewritten while a wgmma that reads it may be in flight.
template <int KS, bool A_EXACT, bool B_EXACT, typename AP>
__device__ __forceinline__ void wgmma_split_loop(float (&acc)[32],
                                                 const float* bhi,
                                                 const float* blo,
                                                 AP a_pair) {
    float pre[AHEAD][2][4];
#pragma unroll
    for (int kp = 0; kp < AHEAD && 2 * kp < KS; ++kp) a_pair(kp, pre[kp]);
    FragA fa[2];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        FragA& f = fa[ks & 1];
        const int kp = ks >> 1, l = ks & 1;
        float (&v)[2][4] = pre[kp % AHEAD];
        split<A_EXACT>(v[0][2 * l], f.hi[0], f.lo[0]);
        split<A_EXACT>(v[1][2 * l], f.hi[1], f.lo[1]);
        split<A_EXACT>(v[0][2 * l + 1], f.hi[2], f.lo[2]);
        split<A_EXACT>(v[1][2 * l + 1], f.hi[3], f.lo[3]);
        if (l == 1 && 2 * (kp + AHEAD) < KS) a_pair(kp + AHEAD, v);
        hopper::wgmma_fence();
        if (!A_EXACT) wgmma_tf32(acc, f.lo, tile_desc(bhi, 8 * ks));
        if (!B_EXACT) wgmma_tf32(acc, f.hi, tile_desc(blo, 8 * ks));
        wgmma_tf32(acc, f.hi, tile_desc(bhi, 8 * ks));
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
}

// Four consecutive values from global memory (zero where !in): one load
// where the row is 16-byte aligned (vec), else one each.
template <typename T>
__device__ __forceinline__ void load4(const T* src, bool in, bool vec,
                                      float (&o)[4]) {
    if (!in) {
        o[0] = o[1] = o[2] = o[3] = 0.f;
    } else if (vec && sizeof(T) == 4) {
        const float4 v = *reinterpret_cast<const float4*>(src);
        o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    } else if (vec) {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        o[0] = __uint_as_float(v.x << 16);
        o[1] = __uint_as_float(v.x & 0xffff0000u);
        o[2] = __uint_as_float(v.y << 16);
        o[3] = __uint_as_float(v.y & 0xffff0000u);
    } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = to_f(src[c]);
    }
}

// cum = cumsum(dt * a_h) over Lp <= 128 rows by one warp (4 rows a lane);
// ws = exp(cum_L - cum) dt where ws is given.  Rows past the chunk's end
// have dt = 0, so cum there is cum_L.
__device__ void chunk_cum(const float* dts, float* cums, float* ws,
                          float a_h, int Lp) {
    const int lane = threadIdx.x & 31;
    float v[4], run = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int j = 4 * lane + u;
        run += (j < Lp ? dts[j] : 0.f) * a_h;
        v[u] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
    }
    const float base = incl - run;
    const float cum_last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int j = 4 * lane + u;
        if (j < Lp) {
            const float cj = base + v[u];
            cums[j] = cj;
            if (ws) ws[j] = expf(cum_last - cj) * dts[j];
        }
    }
}

// ---------------------------------------------------------------------------
// cb = C B^T, once per (b, chunk, group)
// ---------------------------------------------------------------------------

// Row tiles of 16 rows a chunk has, and the blocks that share them out in
// pairs q, Lp/16 - 1 - q (the causal triangle's work is even across pairs).
__host__ __device__ constexpr int cb_pairs(int Lp) {
    return (Lp / 16 + 1) / 2;
}

template <bool BF>
size_t cb_smem(int Lp, int Np) {
    return sizeof(elem_t<BF>) * (size_t)(32 + Lp) * stride_ra<BF>(Np);
}

// One block per (b, chunk, group, pair of row tiles).  Warp w takes the
// pair's upper tile (w even) or lower one (w odd) and every fourth of its
// 8-column tiles up to the diagonal, from w / 2 on; entries above the
// diagonal outside those tiles are not written (pass C never reads them).
template <bool BF>
__global__ void __launch_bounds__(THREADS, 2) ssd_cb_kernel(Params p) {
    using T = elem_t<BF>;
    const int Lp = p.Lp, Np = p.Np, SC = stride_ra<BF>(Np);
    const int pairs = cb_pairs(Lp);
    const int q = blockIdx.x % pairs;
    int rest = blockIdx.x / pairs;
    const int g = rest % p.G;
    rest /= p.G;
    const int k = rest % p.nc, b = rest / p.nc;
    const int t0 = k * p.L, valid = min(p.L, p.S - t0);
    const int mA = q, mB = Lp / 16 - 1 - q;

    extern __shared__ float4 smem4[];
    T* Cs = reinterpret_cast<T*>(smem4);            // [32][SC]: mA, mB rows
    T* Bs = Cs + 32 * SC;                           // [16 mB + 16][SC]
    const T* cg = static_cast<const T*>(p.c) + b * p.scb + t0 * p.scs
                  + g * p.scg;
    stage(Cs, SC, cg + 16 * mA * p.scs, p.scs, 16, valid - 16 * mA, Np, p.N,
          p.vec_c);
    stage(Cs + 16 * SC, SC, cg + 16 * mB * p.scs, p.scs, 16,
          valid - 16 * mB, Np, p.N, p.vec_c);
    stage(Bs, SC, static_cast<const T*>(p.b) + b * p.sbb + t0 * p.sbs
          + g * p.sbg, p.sbs, 16 * mB + 16, valid, Np, p.N, p.vec_b);
    cp_wait_all();
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
    if ((warp & 1) && mB == mA) return;            // the middle tile once
    const int m = (warp & 1) ? mB : mA;
    const int ntiles = 2 * m + 2;                   // columns 0..16m+15
    const int nt0 = warp >> 1;
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;

    for (int k0 = 0; k0 < Np; k0 += 8) {
        FragA fa;
        const T* c0 = Cs + (16 * (warp & 1) + gq) * SC + k0 + tq;
        split<BF>(to_f(c0[0]), fa.hi[0], fa.lo[0]);
        split<BF>(to_f(c0[8 * SC]), fa.hi[1], fa.lo[1]);
        split<BF>(to_f(c0[4]), fa.hi[2], fa.lo[2]);
        split<BF>(to_f(c0[8 * SC + 4]), fa.hi[3], fa.lo[3]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int nt = nt0 + 4 * u;
            if (nt >= ntiles) break;
            FragB fb;
            const T* b0 = Bs + (8 * nt + gq) * SC + k0 + tq;
            split<BF>(to_f(b0[0]), fb.hi[0], fb.lo[0]);
            split<BF>(to_f(b0[4]), fb.hi[1], fb.lo[1]);
            mma_split<BF, BF>(acc[u], fa, fb);
        }
    }

    float* out = p.cb + (((long long)b * p.nc + k) * p.G + g) * Lp * Lp
                 + (16 * m + gq) * Lp;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int nt = nt0 + 4 * u;
        if (nt >= ntiles) break;
        const int j = 8 * nt + 2 * tq;
        store2(out + j, acc[u][0], acc[u][1]);
        store2(out + 8 * Lp + j, acc[u][2], acc[u][3]);
    }
}

// ---------------------------------------------------------------------------
// Pass A: cum, and the chunk's own state S_k = B^T (x o w)
// ---------------------------------------------------------------------------

size_t state_smem(int Lp) {
    return sizeof(float) * (2 * (size_t)TILE + (size_t)KT * RS
                            + 3 * (size_t)Lp);
}

// Warpgroup wg takes the state's rows n = 64 wg .. 64 wg + 63, a thread's
// fragment rows g and g + 8 being rows 2g and 2g + 1 of its warp's 16 (so
// that they are adjacent in B): A = B^T from global memory into
// registers, B = (x o w) split into two tiles.
template <bool BF>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_state_kernel(Params p) {
    using T = elem_t<BF>;
    const int slices = (p.P + PB - 1) / PB;
    const int ps = blockIdx.x % slices;
    int rest = blockIdx.x / slices;
    const int h = rest % p.H;
    rest /= p.H;
    const int k = rest % p.nc, b = rest / p.nc;
    const int g = h / (p.H / p.G);
    const int t0 = k * p.L, valid = min(p.L, p.S - t0);
    const int p0 = ps * PB, PC = min(PB, p.P - p0);
    const int Lp = p.Lp;

    extern __shared__ float4 smem4[];
    float* xw_hi = reinterpret_cast<float*>(smem4);  // [64][KT] cores
    float* xw_lo = xw_hi + TILE;
    T* raw = reinterpret_cast<T*>(xw_lo + TILE);    // [KT][RS]: x
    float* dts = reinterpret_cast<float*>(xw_lo + TILE + KT * RS);
    float* cums = dts + Lp;
    float* ws = cums + Lp;

    stage(raw, raw_stride<T>(), static_cast<const T*>(p.x) + b * p.sxb
          + t0 * p.sxs + h * p.sxh + p0, p.sxs, KT, valid, 64, PC,
          p.vec_x);
    for (int j = threadIdx.x; j < Lp; j += THREADS)
        dts[j] = j < valid ? p.dt[b * p.sdb + (t0 + j) * p.sds + h * p.sdh]
                           : 0.f;
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0) {
        chunk_cum(dts, cums, ws, p.a[h], Lp);
        if (ps == 0) {
            __syncwarp();
            float* cg = p.cum + (((long long)b * p.H + h) * p.nc + k) * Lp;
            for (int j = lane; j < Lp; j += 32) cg[j] = cums[j];
        }
    }
    cp_wait_all();
    __syncthreads();
    split_tile<false>(xw_hi, xw_lo, raw, [&](int j) {
        return j < Lp ? ws[j] : 0.f;
    });
    hopper::fence_proxy_async();
    __syncthreads();

    const int gq = lane >> 2, tq = lane & 3;
    const int n0 = 16 * warp + 2 * gq;              // rows n0, n0 + 1
    const T* bg = static_cast<const T*>(p.b) + b * p.sbb + t0 * p.sbs
                  + g * p.sbg;
    const bool pairs = p.vec_b && n0 + 1 < p.N;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    // B^T[n][j] = B[j][n]: rows n0 and n0 + 1 adjacent, j = 16 kp + 4t + c
    wgmma_split_loop<KT / 8, BF, false>(acc, xw_hi, xw_lo, [&](
            int kp, float (&v)[2][4]) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int j = 16 * kp + 4 * tq + c;
            const T* src = bg + j * p.sbs + n0;
            if (j >= valid || n0 >= p.N) {
                v[0][c] = v[1][c] = 0.f;
            } else if (pairs && sizeof(T) == 4) {
                const float2 u = *reinterpret_cast<const float2*>(src);
                v[0][c] = u.x;
                v[1][c] = u.y;
            } else if (pairs) {
                const uint32_t u = *reinterpret_cast<const uint32_t*>(src);
                v[0][c] = __uint_as_float(u << 16);
                v[1][c] = __uint_as_float(u & 0xffff0000u);
            } else {
                v[0][c] = to_f(src[0]);
                v[1][c] = n0 + 1 < p.N ? to_f(src[1]) : 0.f;
            }
        }
    });

    float* out = p.states + (((long long)b * p.nc + k) * p.H + h)
                                * p.N * p.P + p0 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int n = n0 + half;
        if (n >= p.N) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (8 * j < PC)
                store2(out + (long long)n * p.P + 8 * j, acc[4 * j + 2 * half],
                       acc[4 * j + 2 * half + 1]);
    }
}

// ---------------------------------------------------------------------------
// Pass B: the chain over chunks
// ---------------------------------------------------------------------------

constexpr int CHAIN_BATCH = 8;      // chunks whose loads are in flight at once

// One thread per 4 consecutive state elements of one (b, h).
__global__ void __launch_bounds__(THREADS) ssd_state_pass_kernel(Params p) {
    const long long np4 = (long long)p.N * p.P / 4;
    const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (e >= (long long)p.B * p.H * np4) return;
    const long long bh = e / np4, r = e - bh * np4;
    const int h = (int)(bh % p.H), b = (int)(bh / p.H);
    const long long step = (long long)p.H * np4;    // float4s a chunk
    float4* s = reinterpret_cast<float4*>(p.states)
                + ((long long)b * p.nc * p.H + h) * np4 + r;
    const float* cl = p.cum + bh * p.nc * p.Lp + p.Lp - 1;
    float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < p.nc; k0 += CHAIN_BATCH) {
        float4 own[CHAIN_BATCH];
        float cum[CHAIN_BATCH];
#pragma unroll
        for (int u = 0; u < CHAIN_BATCH; ++u)
            if (k0 + u < p.nc) {
                own[u] = s[(k0 + u) * step];
                cum[u] = cl[(long long)(k0 + u) * p.Lp];
            }
#pragma unroll
        for (int u = 0; u < CHAIN_BATCH; ++u)
            if (k0 + u < p.nc) {
                s[(k0 + u) * step] = hv;            // the state entering k
                const float cum_L = cum[u];
                const float decay = expf(cum_L);
                hv.x = fmaf(decay, hv.x, own[u].x);
                hv.y = fmaf(decay, hv.y, own[u].y);
                hv.z = fmaf(decay, hv.z, own[u].z);
                hv.w = fmaf(decay, hv.w, own[u].w);
            }
    }
    reinterpret_cast<float4*>(p.state)[bh * np4 + r] = hv;
}

// ---------------------------------------------------------------------------
// Pass C: y = exp(cum_i) (C h_k) + (cb o exp(cum_i - cum_j) o dt_j) x
// ---------------------------------------------------------------------------

// Row stride of the decay table E [Lp][Lp/8]: odd, so that the 8 rows a
// fragment reads fall in 8 banks.
__host__ __device__ constexpr int stride_e(int Lp) { return Lp / 8 + 1; }

// Two split B tiles (h_k^T, then x^T), the raw tile they are split from,
// then cum, dt and the decay tables F [Lp], E [Lp][stride_e] and D [Lp][8].
size_t scan_smem(int Lp) {
    return sizeof(float) * (2 * (size_t)TILE + (size_t)KT * RS
                            + (size_t)Lp * (3 + stride_e(Lp) + 8));
}

// Warpgroup wg takes the chunk's rows 64 wg .. 64 wg + 63.  A (C, then M)
// comes from global memory into registers, B (h_k, then x) is split into
// two tiles; both products accumulate into one set of registers.
template <bool BF>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_scan_kernel(Params p) {
    using T = elem_t<BF>;
    const int slices = (p.P + PB - 1) / PB;
    const int ps = blockIdx.x % slices;
    int rest = blockIdx.x / slices;
    const int h = rest % p.H;
    rest /= p.H;
    const int k = rest % p.nc, b = rest / p.nc;
    const int g = h / (p.H / p.G);
    const int t0 = k * p.L, valid = min(p.L, p.S - t0);
    const int p0 = ps * PB, PC = min(PB, p.P - p0);
    const int Lp = p.Lp, ES = stride_e(Lp);

    extern __shared__ float4 smem4[];
    float* b_hi = reinterpret_cast<float*>(smem4);   // [64][KT] cores
    float* b_lo = b_hi + TILE;
    float* raw = b_lo + TILE;                        // [KT][RS]: h_k, x
    float* cums = raw + KT * RS;
    float* dts = cums + Lp;
    float* Fs = dts + Lp;                            // [Lp]
    float* Es = Fs + Lp;                             // [Lp][ES]
    float* Ds = Es + Lp * ES;                        // [Lp][8]

    const float* cg = p.cum + (((long long)b * p.H + h) * p.nc + k) * Lp;
    for (int j = threadIdx.x; j < Lp; j += THREADS) {
        cums[j] = cg[j];
        dts[j] = j < valid ? p.dt[b * p.sdb + (t0 + j) * p.sds + h * p.sdh]
                           : 0.f;
    }
    const float* hk = p.states + (((long long)b * p.nc + k) * p.H + h)
                                     * p.N * p.P + p0;
    stage(raw, RS, hk, (long long)p.P, KT, p.N, 64, PC, true);
    cp_wait_all();
    __syncthreads();
    split_tile<false>(b_hi, b_lo, raw, [](int) { return 1.f; });
    hopper::fence_proxy_async();
    __syncthreads();
    // x's copy flies while the inter product runs
    T* raw_x = reinterpret_cast<T*>(raw);
    stage(raw_x, raw_stride<T>(), static_cast<const T*>(p.x) + b * p.sxb
          + t0 * p.sxs + h * p.sxh + p0, p.sxs, KT, valid, 64, PC,
          p.vec_x);

    // the decays of M below the diagonal 8-column tiles: exp(cum_i -
    // cum_j) dt_j = E[i][j / 8] F[j] with E[i][s] = exp(cum_i - cum_r) and
    // F[j] = exp(cum_r - cum_j) dt_j, r = 8 s + 7 the last column of j's
    // tile, so j <= r < i: where cum is monotone along the chunk (dt >= 0,
    // one sign of a_h) the two exponents have one sign, and their product
    // overflows only where exp(cum_i - cum_j) does.  On the diagonal tiles
    // (r >= i) D[i][j % 8] holds exp(cum_i - cum_j) dt_j itself.  Read
    // after the next barrier.
    for (int j = threadIdx.x; j < Lp; j += THREADS)
        Fs[j] = expf(cums[j | 7] - cums[j]) * dts[j];
    for (int e = threadIdx.x; e < Lp * (Lp / 8); e += THREADS) {
        const int i = e / (Lp / 8), t8 = e - i * (Lp / 8);
        if (8 * t8 + 7 < i) Es[i * ES + t8] = expf(cums[i] - cums[8 * t8 + 7]);
    }
    for (int e = threadIdx.x; e < Lp * 8; e += THREADS) {
        const int i = e >> 3, j = (i & ~7) | (e & 7);
        Ds[e] = j <= i ? expf(cums[i] - cums[j]) * dts[j] : 0.f;
    }

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const int wg = warp >> 2;
    const int i0 = 16 * warp + gq;                  // rows i0, i0 + 8
    const T* cgl = static_cast<const T*>(p.c) + b * p.scb + t0 * p.scs
                   + g * p.scg;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;

    // inter: C h_k, depth n = 16 kp + 4t + c
    wgmma_split_loop<KT / 8, BF, false>(acc, b_hi, b_lo, [&](
            int kp, float (&v)[2][4]) {
        const int n = 16 * kp + 4 * tq;
        load4(cgl + i0 * p.scs + n, i0 < valid && n < p.N, p.vec_c, v[0]);
        load4(cgl + (i0 + 8) * p.scs + n, i0 + 8 < valid && n < p.N,
              p.vec_c, v[1]);
    });
    cp_wait_all();
    __syncthreads();                                // h_k's tiles read out
    {
        const float e0 = i0 < Lp ? expf(cums[i0]) : 0.f;
        const float e1 = i0 + 8 < Lp ? expf(cums[i0 + 8]) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            acc[4 * j] *= e0;
            acc[4 * j + 1] *= e0;
            acc[4 * j + 2] *= e1;
            acc[4 * j + 3] *= e1;
        }
    }
    split_tile<BF>(b_hi, b_lo, raw_x, [](int) { return 1.f; });
    hopper::fence_proxy_async();
    __syncthreads();

    // intra: M x, depth j; M built from cb in registers, masked before the
    // exponent (entries j > i are 0; their decays are never computed).
    // Warpgroup 0's rows end at 63, so its depth does too.
    const float* cbg = p.cb + (((long long)b * p.nc + k) * p.G + g) * Lp * Lp;
    auto m_pair = [&](int kp, float (&v)[2][4]) {
        const int j = 16 * kp + 4 * tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int i = i0 + 8 * r;
            load4(cbg + i * Lp + j, j <= i && i < Lp, true, v[r]);
            const bool diag = (j >> 3) == (i >> 3);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float d = 0.f;
                if (j + c <= i && i < Lp)
                    d = diag ? Ds[i * 8 + ((j + c) & 7)]
                             : Es[i * ES + (j >> 3)] * Fs[j + c];
                v[r][c] *= d;
            }
        }
    };
    if (wg == 0)
        wgmma_split_loop<KT / 16, false, BF>(acc, b_hi, b_lo, m_pair);
    else
        wgmma_split_loop<KT / 8, false, BF>(acc, b_hi, b_lo, m_pair);

    // y for the chunk's rows below S
    T* yg = static_cast<T*>(p.y) + ((long long)b * p.S + t0) * p.H * p.P
            + (long long)h * p.P + p0 + 2 * tq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int i = i0 + 8 * half;
        if (i >= valid) continue;
        T* row = yg + (long long)i * p.H * p.P;
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (8 * j < PC)
                store2(row + 8 * j, acc[4 * j + 2 * half],
                       acc[4 * j + 2 * half + 1]);
    }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool rows_aligned(const void* base, size_t esize, long long s0, long long s1,
                  long long s2, int cols) {
    return reinterpret_cast<uintptr_t>(base) % 16 == 0
        && (s0 * (long long)esize) % 16 == 0
        && (s1 * (long long)esize) % 16 == 0
        && (s2 * (long long)esize) % 16 == 0
        && (cols * esize) % 16 == 0;
}

// Refuses what the kernels do not take; fills the copy flags.
bool prepare(const SsdArgs* a, Params* p) {
    if (a == nullptr) return false;
    const SsdArgs& v = *a;
    if (v.B < 1 || v.S < 1 || v.H < 1 || v.G < 1 || v.H % v.G != 0
        || v.L < 1 || v.L > MAX_L || v.N < 4 || v.N > MAX_N || v.N % 4 != 0
        || v.P < 16 || v.P % 16 != 0 || (v.dtype != 0 && v.dtype != 1)
        || v.nc != (v.S + v.L - 1) / v.L || v.Lp != round_up(v.L, 16)
        || v.Np != round_up(v.N, 16)
        || (long long)v.B * v.nc * v.H * ((v.P + PB - 1) / PB) > 0x7fffffffLL
        || (long long)v.B * v.H * v.N * v.P / 4 / THREADS >= 0x7fffffffLL)
        return false;
    static_cast<SsdArgs&>(*p) = v;
    const size_t es = v.dtype == 1 ? 2 : 4;
    p->vec_x = rows_aligned(v.x, es, v.sxb, v.sxs, v.sxh, 16);
    p->vec_b = rows_aligned(v.b, es, v.sbb, v.sbs, v.sbg, v.N);
    p->vec_c = rows_aligned(v.c, es, v.scb, v.scs, v.scg, v.N);
    return true;
}

template <typename K>
cudaError_t launch(K kern, long long blocks, size_t smem, const Params& p,
                   void* stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kern<<<(unsigned)blocks, THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
}

}  // namespace

// The four launches of one scan, in this order, on `stream`.  Returns 0
// or the CUDA error of the first launch that failed; `launched` gets the
// number of launches made.
extern "C" int ssd_scan(const SsdArgs* a, void* stream, int* launched) {
    *launched = 0;
    Params p;
    if (!prepare(a, &p)) return (int)cudaErrorInvalidValue;
    const bool bf = p.dtype == 1;
    const long long per_chunk = (long long)p.B * p.nc * p.H
                                * ((p.P + PB - 1) / PB);
    const long long chain = (long long)p.B * p.H * p.N * p.P / 4;
    cudaError_t e = bf
        ? launch(ssd_cb_kernel<true>, (long long)p.B * p.nc * p.G
                 * cb_pairs(p.Lp), cb_smem<true>(p.Lp, p.Np), p, stream)
        : launch(ssd_cb_kernel<false>, (long long)p.B * p.nc * p.G
                 * cb_pairs(p.Lp), cb_smem<false>(p.Lp, p.Np), p, stream);
    if (e != cudaSuccess) return (int)e;
    ++*launched;
    e = launch(bf ? ssd_chunk_state_kernel<true>
                  : ssd_chunk_state_kernel<false>,
               per_chunk, state_smem(p.Lp), p, stream);
    if (e != cudaSuccess) return (int)e;
    ++*launched;
    e = launch(ssd_state_pass_kernel, (chain + THREADS - 1) / THREADS, 0, p,
               stream);
    if (e != cudaSuccess) return (int)e;
    ++*launched;
    e = launch(bf ? ssd_chunk_scan_kernel<true>
                  : ssd_chunk_scan_kernel<false>,
               per_chunk, scan_smem(p.Lp), p, stream);
    if (e != cudaSuccess) return (int)e;
    ++*launched;
    return 0;
}

// Dynamic shared memory of a launch (pass 0 cb, 1 chunk state, 2 the
// chain, 3 chunk scan), for reports of a build.
extern "C" long long ssd_smem_bytes(int pass, int bf16, int Lp, int Np,
                                    int P) {
    switch (pass) {
        case 0: return (long long)(bf16 ? cb_smem<true>(Lp, Np)
                                        : cb_smem<false>(Lp, Np));
        case 1: return (long long)state_smem(Lp);
        case 2: return 0;
        case 3: return (long long)scan_smem(Lp);
        default: return -1;
    }
}

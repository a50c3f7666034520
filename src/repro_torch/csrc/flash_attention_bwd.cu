// flash_attention_bwd: the two backward passes of flash attention, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of `flash_attention_bwd` (src/repro/kernels/
// flash_attention/kernel.py:250): the dK/dV pass (`_bwd_dkv_kernel`, :142,
// pallas_call at :272) and the dQ pass (`_bwd_dq_kernel`, :198, pallas_call
// at :303).  For q, dO [B,H,S,D], k, v [B,Hkv,S,D] (f32 or bf16,
// contiguous), the forward's lse [B,H,S] and delta = rowsum(dO * o)
// [B,H,S] (both f32; the wrapper computes delta with torch, as the JAX
// package computes it outside its pallas_calls, kernel.py:266):
//   s = (q k^T) * scale, soft-capped as c*tanh(s/c) when softcap c > 0;
//   P = exp(s - lse) where the pair is kept (k < S, q < S, causal, window),
//       else 0;
//   dV = P^T dO;  dP = dO V^T;  dS = P (dP - delta) (1 - t^2 under the
//   soft-cap, t = tanh(s/c));  dK = dS^T Q * scale;  dQ = dS K * scale.
// dQ is written in q's dtype, dK and dV in k's.  GQA: one dK/dV block loops
// over the query heads of its kv head's group and sums them in f32
// registers, so it writes [B,Hkv,S,D] directly: no per-head f32 scratch
// (the TPU kernel writes [B,H,S,D] f32 and sums the groups outside), no
// atomics, and the group sum is rounded once, as in JAX.
//
// What bounds them on this card.  At the training path's shape (llama3.2-1b:
// B 4, H 32, Hkv 8, S 2048, D 64, bf16, causal) the dK/dV pass does four
// products over the 268.6 M kept (q, k) pairs (S^T, dP^T, dV, dK: 8*D flops
// a pair, 137.5 GFLOP, 139 us at the data sheet's 989 TFLOP/s bf16) and the
// dQ pass three (S, dP, dQ: 6*D flops, 103.1 GFLOP, 104 us), against about
// 100 MB that each must move once (31 us at 3.35 TB/s).  Both are bound by
// operations, so only the tensor cores can approach the bound.
//
// What this design does about it (a simple kernel that is right first):
// * bf16, dK/dV: one block of 4 warps per (b, kv head, 64-key tile); each
//   warp owns 16 keys.  K and V are staged once in shared memory (rows
//   padded by 16 bytes).  A loop over the group's query heads and, inside
//   it, over the query tiles of the causal/window band (64 queries at
//   D <= 64, 32 at D = 128) stages Q, dO, lse and delta, then computes the
//   products transposed, keys as rows: S^T = K Q^T and dP^T = V dO^T with
//   mma.sync m16n8k16 (bf16 operands, f32 accumulation), forms P^T and
//   dS^T in the accumulators, and re-packs them as A fragments for
//   dV += P^T dO and dK += dS^T Q.  Computing S^T instead of S puts P^T
//   and dS^T where the next products need them, so no transpose goes
//   through shared memory.  dK and dV stay in f32 registers for the whole
//   loop.
// * bf16, dQ: one block of 4 warps per (b, head, 64-query tile); Q and dO
//   stay in registers as A fragments; a loop over the key tiles of the band
//   (64 keys at D <= 64, 32 at D = 128) stages K and V, computes S = Q K^T
//   and dP = dO V^T, forms dS and accumulates dQ += dS K in f32 registers.
// * Rounding: the re-packed P^T and dS^T are rounded to bf16 before their
//   products, as FlashAttention-2 does; the TPU kernel keeps them in f32.
//   The plain version's `round_p=True` does the same, so chip_smoke.py
//   shows that rounding's share of the error (PERF.md).
// * f32: FMA on the CUDA cores, four threads per key (dK/dV) or query row
//   (dQ), each holding a quarter of D; tiles of 32 rows.  The JAX bar in f32
//   (relative gradient error below 5e-4, tests/test_kernels.py:53-71) rules
//   out TF32 and bf16 tensor cores.
// * Tiles wholly outside the causal/window band are skipped in both passes
//   (the TPU kernels visit them and mask them to 0); dK/dV blocks run
//   first-key-tile first and dQ blocks last-query-tile first, the longest
//   first under the causal mask.  Ragged S (not a multiple of the tile) is
//   masked here; the TPU kernels shrank their blocks to divide S.
// wgmma, TMA, warp specialisation and a ring of stages are later work.
//
// Precision: expf/tanhf (no fast math: build without --use_fast_math).

#include "flash_attention_common.cuh"

namespace {

using fa::kept;
using fa::load_a;
using fa::load_b_cols;
using fa::load_b_rows;
using fa::mma_bf16;
using fa::pack_f32;

constexpr int THREADS = 128;    // 4 warps
constexpr int BKV = 64;         // keys per bf16 dK/dV block (16 a warp)
constexpr int BQ_DQ = 64;       // queries per bf16 dQ block (16 a warp)
constexpr int TPR = 4;          // f32: threads per key or query row
constexpr int ROWS_F32 = THREADS / TPR;   // f32: rows per block and tile

struct Params {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const float* lse;
    const float* delta;
    void* dq;
    void* dk;
    void* dv;
    int H, Hkv, S;
    float scale;
    int causal;
    int window;                 // <= 0: none
    float softcap;              // <= 0: none
};

// P of one (query, key) pair from its raw score q.k; `dcap` gets the
// soft-cap's derivative (1 where there is none).
__device__ __forceinline__ float prob(const Params& p, float s, float lse,
                                      int q, int k, float& dcap) {
    dcap = 1.f;
    if (q >= p.S || !kept(q, k, p.S, p.causal, p.window)) return 0.f;
    float x = s * p.scale;
    if (p.softcap > 0.f) {
        const float t = tanhf(x / p.softcap);
        x = p.softcap * t;
        dcap = 1.f - t * t;
    }
    return expf(x - lse);
}

// Query tiles [lo, hi) of `bq` rows that hold a query some key of
// [k0, k0 + bk) is seen by.
__device__ __forceinline__ void query_tiles(const Params& p, int k0, int bk,
                                            int bq, int& lo, int& hi) {
    const int k_last = min(k0 + bk, p.S) - 1;
    lo = p.causal ? k0 / bq : 0;
    hi = (p.S + bq - 1) / bq;
    if (p.window > 0) hi = min(hi, (k_last + p.window - 1) / bq + 1);
}

// Key tiles [lo, hi) of `bk` keys that hold a key some query of
// [q0, q0 + bq) sees.
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int bq,
                                          int bk, int& lo, int& hi) {
    hi = (p.S + bk - 1) / bk;
    if (p.causal) hi = min(hi, (min(q0 + bq, p.S) - 1) / bk + 1);
    lo = 0;
    if (p.window > 0) {
        const int k_min = q0 - p.window + 1;   // smallest key q0 sees
        if (k_min > 0) lo = k_min / bk;
    }
}

template <int D>
__host__ __device__ constexpr int dkv_bq() { return D > 64 ? 32 : 64; }

template <int D>
constexpr size_t dkv_smem() {
    return (size_t)(2 * BKV + 2 * dkv_bq<D>()) * (D + 8) * 2
        + 2 * dkv_bq<D>() * sizeof(float);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, f32 accumulation
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkv_bf16(Params p) {
    constexpr int BQ = dkv_bq<D>();  // queries per tile
    constexpr int LD = D + 8;       // shared row stride, elements (+16 B)
    constexpr int KS = D / 16;      // k-steps over D
    constexpr int NT = BQ / 8;      // 8-query column tiles of S^T
    constexpr int DT = D / 8;       // 8-wide column tiles of dK, dV
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Vs = Ks + BKV * LD;
    __nv_bfloat16* Qs = Vs + BKV * LD;
    __nv_bfloat16* dOs = Qs + BQ * LD;
    float* lse_s = reinterpret_cast<float*>(dOs + BQ * LD);
    float* delta_s = lse_s + BQ;

    const int S = p.S;
    const int bkv = blockIdx.x;                       // b * Hkv + kv head
    const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
    const int group = p.H / p.Hkv;
    const int k0 = blockIdx.y * BKV;
    const size_t kv_off = (size_t)bkv * S * D;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;            // fragment row, column pair
    const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;

    fa::stage_bf16<D, THREADS>(
        Ks, static_cast<const __nv_bfloat16*>(p.k) + kv_off, k0, BKV, S);
    fa::stage_bf16<D, THREADS>(
        Vs, static_cast<const __nv_bfloat16*>(p.v) + kv_off, k0, BKV, S);

    float dk[DT][4], dv[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

    int lo, hi;
    query_tiles(p, k0, BKV, BQ, lo, hi);
    for (int hh = 0; hh < group; ++hh) {
        const size_t bh = (size_t)b * p.H + kvh * group + hh;
        const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + bh * S * D;
        const __nv_bfloat16* dout =
            static_cast<const __nv_bfloat16*>(p.dout) + bh * S * D;
        const float* lse = p.lse + bh * S;
        const float* delta = p.delta + bh * S;
        for (int qt = lo; qt < hi; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();                          // tiles free to overwrite
            fa::stage_bf16<D, THREADS>(Qs, q, q0, BQ, S);
            fa::stage_bf16<D, THREADS>(dOs, dout, q0, BQ, S);
            for (int i = threadIdx.x; i < BQ; i += THREADS) {
                const bool in = q0 + i < S;
                lse_s[i] = in ? lse[q0 + i] : 0.f;
                delta_s[i] = in ? delta[q0 + i] : 0.f;
            }
            __syncthreads();

            // S^T = K Q^T and dP^T = V dO^T over this warp's 16 keys: element
            // e of tile nt is key (e < 2 ? kr0 : kr1), query q0 + nt*8 + 2t +
            // (e & 1)
            float s[NT][4], dp[NT][4];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                uint32_t ka[4], va[4];
                load_a(ka, Ks, LD, warp * 16, ks * 16, g, t);
                load_a(va, Vs, LD, warp * 16, ks * 16, g, t);
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    uint32_t b0, b1;
                    load_b_rows(b0, b1, Qs, LD, nt * 8, ks * 16, g, t);
                    mma_bf16(s[nt], ka, b0, b1);
                    load_b_rows(b0, b1, dOs, LD, nt * 8, ks * 16, g, t);
                    mma_bf16(dp[nt], va, b0, b1);
                }
            }

            // P^T into s, dS^T into dp
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qi = nt * 8 + 2 * t + (e & 1);
                    float dcap;
                    const float pr = prob(p, s[nt][e], lse_s[qi], q0 + qi,
                                          e < 2 ? kr0 : kr1, dcap);
                    s[nt][e] = pr;
                    dp[nt][e] = pr * (dp[nt][e] - delta_s[qi]) * dcap;
                }
            }

            // dV += P^T dO, dK += dS^T Q: the accumulators of query tiles 2j,
            // 2j+1 are the A fragment of k-step j
#pragma unroll
            for (int j = 0; j < BQ / 16; ++j) {
                uint32_t pa[4], da[4];
                pa[0] = pack_f32(s[2 * j][0], s[2 * j][1]);
                pa[1] = pack_f32(s[2 * j][2], s[2 * j][3]);
                pa[2] = pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]);
                pa[3] = pack_f32(s[2 * j + 1][2], s[2 * j + 1][3]);
                da[0] = pack_f32(dp[2 * j][0], dp[2 * j][1]);
                da[1] = pack_f32(dp[2 * j][2], dp[2 * j][3]);
                da[2] = pack_f32(dp[2 * j + 1][0], dp[2 * j + 1][1]);
                da[3] = pack_f32(dp[2 * j + 1][2], dp[2 * j + 1][3]);
#pragma unroll
                for (int dt = 0; dt < DT; ++dt) {
                    uint32_t b0, b1;
                    load_b_cols(b0, b1, dOs, LD, 16 * j, dt * 8, g, t);
                    mma_bf16(dv[dt], pa, b0, b1);
                    load_b_cols(b0, b1, Qs, LD, 16 * j, dt * 8, g, t);
                    mma_bf16(dk[dt], da, b0, b1);
                }
            }
        }
    }

    __nv_bfloat16* dko = static_cast<__nv_bfloat16*>(p.dk) + kv_off;
    __nv_bfloat16* dvo = static_cast<__nv_bfloat16*>(p.dv) + kv_off;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
        const int c = dt * 8 + 2 * t;
        if (kr0 < S) {
            *reinterpret_cast<uint32_t*>(dko + (size_t)kr0 * D + c) =
                pack_f32(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
            *reinterpret_cast<uint32_t*>(dvo + (size_t)kr0 * D + c) =
                pack_f32(dv[dt][0], dv[dt][1]);
        }
        if (kr1 < S) {
            *reinterpret_cast<uint32_t*>(dko + (size_t)kr1 * D + c) =
                pack_f32(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
            *reinterpret_cast<uint32_t*>(dvo + (size_t)kr1 * D + c) =
                pack_f32(dv[dt][2], dv[dt][3]);
        }
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_bf16(Params p) {
    constexpr int BK = D > 64 ? 32 : 64;   // keys per tile
    constexpr int LD = D + 8;
    constexpr int KS = D / 16;
    constexpr int NT = BK / 8;      // 8-key column tiles of S
    constexpr int DT = D / 8;       // 8-wide column tiles of dQ
    __shared__ __align__(16) __nv_bfloat16 Ks[BK * LD];
    __shared__ __align__(16) __nv_bfloat16 Vs[BK * LD];

    const int S = p.S;
    const int bh = blockIdx.x;                        // b * H + h
    const int b = bh / p.H, h = bh % p.H;
    const int kvh = h / (p.H / p.Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ_DQ;
    const size_t kv_off = ((size_t)b * p.Hkv + kvh) * S * D;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * S * D;
    const __nv_bfloat16* dout =
        static_cast<const __nv_bfloat16*>(p.dout) + (size_t)bh * S * D;
    const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_off;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

    uint32_t qa[KS][4], oa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        const int c = ks * 16 + 2 * t;
        qa[ks][0] = r0 < S ? fa::ld32(q + (size_t)r0 * D + c) : 0u;
        qa[ks][1] = r1 < S ? fa::ld32(q + (size_t)r1 * D + c) : 0u;
        qa[ks][2] = r0 < S ? fa::ld32(q + (size_t)r0 * D + c + 8) : 0u;
        qa[ks][3] = r1 < S ? fa::ld32(q + (size_t)r1 * D + c + 8) : 0u;
        oa[ks][0] = r0 < S ? fa::ld32(dout + (size_t)r0 * D + c) : 0u;
        oa[ks][1] = r1 < S ? fa::ld32(dout + (size_t)r1 * D + c) : 0u;
        oa[ks][2] = r0 < S ? fa::ld32(dout + (size_t)r0 * D + c + 8) : 0u;
        oa[ks][3] = r1 < S ? fa::ld32(dout + (size_t)r1 * D + c + 8) : 0u;
    }
    const float* lse = p.lse + (size_t)bh * S;
    const float* delta = p.delta + (size_t)bh * S;
    const float lse0 = r0 < S ? lse[r0] : 0.f, lse1 = r1 < S ? lse[r1] : 0.f;
    const float dl0 = r0 < S ? delta[r0] : 0.f;
    const float dl1 = r1 < S ? delta[r1] : 0.f;

    float acc[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
        acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

    int lo, hi;
    key_tiles(p, q0, BQ_DQ, BK, lo, hi);
    for (int kt = lo; kt < hi; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();
        fa::stage_bf16<D, THREADS>(Ks, k, k0, BK, S);
        fa::stage_bf16<D, THREADS>(Vs, v, k0, BK, S);
        __syncthreads();

        // S = Q K^T and dP = dO V^T: element e of tile nt is row (e < 2 ? r0
        // : r1), key k0 + nt*8 + 2t + (e & 1)
        float s[NT][4], dp[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                uint32_t b0, b1;
                load_b_rows(b0, b1, Ks, LD, nt * 8, ks * 16, g, t);
                mma_bf16(s[nt], qa[ks], b0, b1);
                load_b_rows(b0, b1, Vs, LD, nt * 8, ks * 16, g, t);
                mma_bf16(dp[nt], oa[ks], b0, b1);
            }
        }

        // dS into dp
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = k0 + nt * 8 + 2 * t + (e & 1);
                float dcap;
                const float pr = prob(p, s[nt][e], e < 2 ? lse0 : lse1,
                                      e < 2 ? r0 : r1, col, dcap);
                dp[nt][e] = pr * (dp[nt][e] - (e < 2 ? dl0 : dl1)) * dcap;
            }
        }

        // dQ += dS K
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
            uint32_t a[4];
            a[0] = pack_f32(dp[2 * j][0], dp[2 * j][1]);
            a[1] = pack_f32(dp[2 * j][2], dp[2 * j][3]);
            a[2] = pack_f32(dp[2 * j + 1][0], dp[2 * j + 1][1]);
            a[3] = pack_f32(dp[2 * j + 1][2], dp[2 * j + 1][3]);
#pragma unroll
            for (int dt = 0; dt < DT; ++dt) {
                uint32_t b0, b1;
                load_b_cols(b0, b1, Ks, LD, 16 * j, dt * 8, g, t);
                mma_bf16(acc[dt], a, b0, b1);
            }
        }
    }

    __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(p.dq) + (size_t)bh * S * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
        const int c = dt * 8 + 2 * t;
        if (r0 < S)
            *reinterpret_cast<uint32_t*>(dq + (size_t)r0 * D + c) =
                pack_f32(acc[dt][0] * p.scale, acc[dt][1] * p.scale);
        if (r1 < S)
            *reinterpret_cast<uint32_t*>(dq + (size_t)r1 * D + c) =
                pack_f32(acc[dt][2] * p.scale, acc[dt][3] * p.scale);
    }
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

// The sum over the TPR = 4 neighbouring lanes that share a row.
__device__ __forceinline__ float row_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkv_f32(Params p) {
    constexpr int BQ = ROWS_F32;    // queries per tile
    constexpr int HD = D / TPR;     // the quarter of D each thread holds
    constexpr int LD = D + 4;       // shared row stride, floats (+16 B)
    __shared__ __align__(16) float Qs[BQ * LD];
    __shared__ __align__(16) float dOs[BQ * LD];
    __shared__ float lse_s[BQ];
    __shared__ float delta_s[BQ];

    const int S = p.S;
    const int bkv = blockIdx.x;
    const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
    const int group = p.H / p.Hkv;
    const int k0 = blockIdx.y * ROWS_F32;
    const size_t kv_off = (size_t)bkv * S * D;
    const int key = k0 + threadIdx.x / TPR;
    const int part = (threadIdx.x % TPR) * HD;

    float kq[HD], vq[HD], dk[HD], dv[HD];
    {
        const float* k = static_cast<const float*>(p.k) + kv_off;
        const float* v = static_cast<const float*>(p.v) + kv_off;
#pragma unroll
        for (int i = 0; i < HD; ++i) {
            kq[i] = key < S ? k[(size_t)key * D + part + i] : 0.f;
            vq[i] = key < S ? v[(size_t)key * D + part + i] : 0.f;
            dk[i] = dv[i] = 0.f;
        }
    }

    int lo, hi;
    query_tiles(p, k0, ROWS_F32, BQ, lo, hi);
    for (int hh = 0; hh < group; ++hh) {
        const size_t bh = (size_t)b * p.H + kvh * group + hh;
        const float* q = static_cast<const float*>(p.q) + bh * S * D;
        const float* dout = static_cast<const float*>(p.dout) + bh * S * D;
        const float* lse = p.lse + bh * S;
        const float* delta = p.delta + bh * S;
        for (int qt = lo; qt < hi; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();
            fa::stage_f32<D, THREADS>(Qs, q, q0, BQ, S);
            fa::stage_f32<D, THREADS>(dOs, dout, q0, BQ, S);
            for (int i = threadIdx.x; i < BQ; i += THREADS) {
                const bool in = q0 + i < S;
                lse_s[i] = in ? lse[q0 + i] : 0.f;
                delta_s[i] = in ? delta[q0 + i] : 0.f;
            }
            __syncthreads();
            for (int j = 0; j < BQ; ++j) {
                const float* qr = &Qs[j * LD + part];
                const float* gr = &dOs[j * LD + part];
                float s = 0.f, dpv = 0.f;
#pragma unroll
                for (int i = 0; i < HD; ++i) {
                    s = fmaf(kq[i], qr[i], s);
                    dpv = fmaf(vq[i], gr[i], dpv);
                }
                s = row_sum(s);
                dpv = row_sum(dpv);
                float dcap;
                const float pr = prob(p, s, lse_s[j], q0 + j, key, dcap);
                const float ds = pr * (dpv - delta_s[j]) * dcap;
#pragma unroll
                for (int i = 0; i < HD; ++i) {
                    dv[i] = fmaf(pr, gr[i], dv[i]);
                    dk[i] = fmaf(ds, qr[i], dk[i]);
                }
            }
        }
    }
    if (key < S) {
        float* dko = static_cast<float*>(p.dk) + kv_off + (size_t)key * D + part;
        float* dvo = static_cast<float*>(p.dv) + kv_off + (size_t)key * D + part;
#pragma unroll
        for (int i = 0; i < HD; ++i) {
            dko[i] = dk[i] * p.scale;
            dvo[i] = dv[i];
        }
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dq_f32(Params p) {
    constexpr int BK = ROWS_F32;    // keys per tile
    constexpr int HD = D / TPR;
    constexpr int LD = D + 4;
    __shared__ __align__(16) float Ks[BK * LD];
    __shared__ __align__(16) float Vs[BK * LD];

    const int S = p.S;
    const int bh = blockIdx.x;
    const int b = bh / p.H, h = bh % p.H;
    const int kvh = h / (p.H / p.Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS_F32;
    const size_t kv_off = ((size_t)b * p.Hkv + kvh) * S * D;
    const float* k = static_cast<const float*>(p.k) + kv_off;
    const float* v = static_cast<const float*>(p.v) + kv_off;
    const int row = q0 + threadIdx.x / TPR;
    const int part = (threadIdx.x % TPR) * HD;

    float qh[HD], oh[HD], acc[HD];
    {
        const float* q = static_cast<const float*>(p.q) + (size_t)bh * S * D;
        const float* dout = static_cast<const float*>(p.dout) + (size_t)bh * S * D;
#pragma unroll
        for (int i = 0; i < HD; ++i) {
            qh[i] = row < S ? q[(size_t)row * D + part + i] : 0.f;
            oh[i] = row < S ? dout[(size_t)row * D + part + i] : 0.f;
            acc[i] = 0.f;
        }
    }
    const float lse = row < S ? p.lse[(size_t)bh * S + row] : 0.f;
    const float dl = row < S ? p.delta[(size_t)bh * S + row] : 0.f;

    int lo, hi;
    key_tiles(p, q0, ROWS_F32, BK, lo, hi);
    for (int kt = lo; kt < hi; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();
        fa::stage_f32<D, THREADS>(Ks, k, k0, BK, S);
        fa::stage_f32<D, THREADS>(Vs, v, k0, BK, S);
        __syncthreads();
        for (int j = 0; j < BK; ++j) {
            const float* kr = &Ks[j * LD + part];
            const float* vr = &Vs[j * LD + part];
            float s = 0.f, dpv = 0.f;
#pragma unroll
            for (int i = 0; i < HD; ++i) {
                s = fmaf(qh[i], kr[i], s);
                dpv = fmaf(oh[i], vr[i], dpv);
            }
            s = row_sum(s);
            dpv = row_sum(dpv);
            float dcap;
            const float pr = prob(p, s, lse, row, k0 + j, dcap);
            const float ds = pr * (dpv - dl) * dcap;
#pragma unroll
            for (int i = 0; i < HD; ++i) acc[i] = fmaf(ds, kr[i], acc[i]);
        }
    }
    if (row < S) {
        float* dq = static_cast<float*>(p.dq) + (size_t)bh * S * D
            + (size_t)row * D + part;
#pragma unroll
        for (int i = 0; i < HD; ++i) dq[i] = acc[i] * p.scale;
    }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const Params& p,
                   cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
    }
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

bool bad_shape(int B, int H, int Hkv, int S) {
    return B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1
        || (long long)B * H > 0x7fffffffLL
        || (S + ROWS_F32 - 1) / ROWS_F32 > 65535;
}

}  // namespace

// dK, dV [B,Hkv,S,D] (k's dtype) from q, dO [B,H,S,D], k, v [B,Hkv,S,D],
// lse and delta [B,H,S] (f32), all contiguous and 16-byte aligned.  dtype:
// 0 f32, 1 bf16.  window <= 0 and softcap <= 0 mean none.  Launches on
// `stream` and returns the CUDA error code of the launch (0 = success).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int dtype, int B,
                                       int H, int Hkv, int S, int D,
                                       int causal, int window, float softcap,
                                       float scale, void* stream) {
    if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
    Params p{q, k, v, dout, static_cast<const float*>(lse),
             static_cast<const float*>(delta), nullptr, dk, dv, H, Hkv, S,
             scale, causal, window, softcap};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        const dim3 grid((unsigned)(B * Hkv), (unsigned)((S + BKV - 1) / BKV));
        switch (D) {
            case 32: return (int)launch(fa_bwd_dkv_bf16<32>, grid, dkv_smem<32>(), p, s);
            case 64: return (int)launch(fa_bwd_dkv_bf16<64>, grid, dkv_smem<64>(), p, s);
            case 128: return (int)launch(fa_bwd_dkv_bf16<128>, grid, dkv_smem<128>(), p, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (dtype == 0) {
        const dim3 grid((unsigned)(B * Hkv),
                        (unsigned)((S + ROWS_F32 - 1) / ROWS_F32));
        switch (D) {
            case 32: return (int)launch(fa_bwd_dkv_f32<32>, grid, 0, p, s);
            case 64: return (int)launch(fa_bwd_dkv_f32<64>, grid, 0, p, s);
            case 128: return (int)launch(fa_bwd_dkv_f32<128>, grid, 0, p, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaErrorInvalidValue;
}

// dQ [B,H,S,D] (q's dtype) from the same inputs.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int dtype, int B, int H,
                                      int Hkv, int S, int D, int causal,
                                      int window, float softcap, float scale,
                                      void* stream) {
    if (bad_shape(B, H, Hkv, S)) return (int)cudaErrorInvalidValue;
    Params p{q, k, v, dout, static_cast<const float*>(lse),
             static_cast<const float*>(delta), dq, nullptr, nullptr, H, Hkv,
             S, scale, causal, window, softcap};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        const dim3 grid((unsigned)(B * H), (unsigned)((S + BQ_DQ - 1) / BQ_DQ));
        switch (D) {
            case 32: return (int)launch(fa_bwd_dq_bf16<32>, grid, 0, p, s);
            case 64: return (int)launch(fa_bwd_dq_bf16<64>, grid, 0, p, s);
            case 128: return (int)launch(fa_bwd_dq_bf16<128>, grid, 0, p, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (dtype == 0) {
        const dim3 grid((unsigned)(B * H),
                        (unsigned)((S + ROWS_F32 - 1) / ROWS_F32));
        switch (D) {
            case 32: return (int)launch(fa_bwd_dq_f32<32>, grid, 0, p, s);
            case 64: return (int)launch(fa_bwd_dq_f32<64>, grid, 0, p, s);
            case 128: return (int)launch(fa_bwd_dq_f32<128>, grid, 0, p, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaErrorInvalidValue;
}

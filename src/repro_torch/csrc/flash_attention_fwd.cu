// flash_attention_fwd: online-softmax attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_fwd` (src/repro/kernels/
// flash_attention/kernel.py:90, body `_fwd_kernel`, pallas_call at :111).
// It computes, for q [B,H,S,D] and k, v [B,Hkv,S,D] (f32 or bf16, contiguous):
//   s = (q*scale) k^T, soft-capped as softcap*tanh(s/softcap) when softcap > 0;
//   masked to the finite -1e30 where k_pos >= S, where q_pos < k_pos (causal)
//   and where q_pos - k_pos >= window (window > 0);
//   o = softmax(s) v in q's dtype, lse = m + log(max(l, 1e-30)) in f32 [B,H,S].
// GQA reads kv head h / (H/Hkv) in place: K and V are never replicated.
//
// What bounds it on this card.  At the main path's shape (llama3.2-1b
// prefill: B 4, H 32, Hkv 8, S 2048, D 64, bf16, causal) the two products
// over the causal half of the score square need 2*B*H*S^2*D = 68.7 GFLOP
// (69 us at the data sheet's 989 TFLOP/s bf16), against 85 MB that must
// move once (q, k, v, o and lse: 25 us at 3.35 TB/s).  So it is bound by
// operations, and only the tensor cores can approach the bound.
//
// What this design does about it (a simple kernel that is right first):
// * bf16: one block of 4 warps per (64-query tile, b*H + h); each warp owns
//   16 query rows.  Q stays in registers as mma.sync m16n8k16 A fragments.
//   A loop over 64-key tiles (the TPU grid's sequential minor axis becomes
//   this loop) stages K and V in shared memory (rows padded by 16 bytes, so
//   fragment loads are free of bank conflicts), computes S = Q K^T and
//   O += P V with mma.sync (bf16 operands, f32 accumulation), and keeps the
//   online-softmax state (m, l) and O in f32 registers.  P is re-packed from
//   the S accumulators into A fragments without touching shared memory.
//   That rounds P to bf16 before P V, as FlashAttention-2 does, where the
//   TPU kernel keeps P in f32 (it casts V to f32, so P.astype(v.dtype) is
//   f32); l sums the unrounded P.  PERF.md gives this rounding's measured
//   share of the error against the f32-P plain version.
// * f32: the same tiling on the CUDA cores (FMA), two threads per query row
//   each holding half of D; the JAX bar in f32 (2e-5) rules out TF32 and
//   bf16 tensor cores.
// * Key tiles wholly outside the causal or window band of the block's rows
//   are skipped; the TPU kernel visits them, but a fully masked tile's
//   contribution is wiped by alpha = exp(-1e30 - m) = 0 once a row meets an
//   unmasked key, so the result is the same.  Query tiles run longest first.
// * Ragged S (not a multiple of 64) is masked here; the TPU kernel shrank
//   its blocks to divide S instead (`_pick_block`).
// wgmma, TMA, warp specialisation and a ring of K/V stages are later work.
//
// Precision: expf/logf/tanhf (no fast math: build without --use_fast_math).

#include "flash_attention_common.cuh"

namespace {

using fa::ld32;
using fa::mma_bf16;
using fa::NEG_INF;
using fa::pack_bf16;
using fa::pack_f32;
using fa::quad_max;
using fa::quad_sum;

constexpr int BQ = 64;          // query rows per block
constexpr int THREADS = 128;    // 4 warps

struct Params {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    float* lse;
    int H, Hkv, S;
    float scale;
    int causal;
    int window;                 // <= 0: none
    float softcap;              // <= 0: none
};

// Key tiles [lo, hi) that hold a key some row of [q0, q0 + BQ) may see.
__device__ __forceinline__ void key_tiles(const Params& p, int q0, int bk,
                                          int& lo, int& hi) {
    hi = (p.S + bk - 1) / bk;
    if (p.causal) {
        const int q_last = min(q0 + BQ, p.S) - 1;
        hi = min(hi, q_last / bk + 1);
    }
    lo = 0;
    if (p.window > 0) {
        const int k_min = q0 - p.window + 1;   // smallest key row q0 sees
        if (k_min > 0) lo = k_min / bk;
    }
}

// Scale, soft-cap and mask one score.
__device__ __forceinline__ float score(const Params& p, float x, int row,
                                       int col) {
    x *= p.scale;
    if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
    return fa::kept(row, col, p.S, p.causal, p.window) ? x : NEG_INF;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, f32 accumulation
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd_bf16(Params p) {
    constexpr int BK = 64;          // keys per tile
    constexpr int LD = D + 8;       // shared row stride, elements (+16 B)
    constexpr int KS = D / 16;      // k-steps of Q K^T
    constexpr int NT = BK / 8;      // 8-key column tiles of S
    constexpr int DT = D / 8;       // 8-wide column tiles of O
    constexpr int CPR = D / 8;      // 16-byte chunks per row
    __shared__ __align__(16) __nv_bfloat16 Ks[BK * LD];
    __shared__ __align__(16) __nv_bfloat16 Vs[BK * LD];

    const int S = p.S;
    const int bh = blockIdx.x;                        // b * H + h
    const int b = bh / p.H, h = bh % p.H;
    const int kvh = h / (p.H / p.Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    const size_t kv_off = ((size_t)b * p.Hkv + kvh) * S * D;
    const __nv_bfloat16* q =
        static_cast<const __nv_bfloat16*>(p.q) + (size_t)bh * S * D;
    const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + kv_off;
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + kv_off;
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + (size_t)bh * S * D;
    float* lse = p.lse + (size_t)bh * S;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;            // fragment row, column pair
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;

    uint32_t qa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        const int c = ks * 16 + 2 * t;
        qa[ks][0] = r0 < S ? ld32(q + (size_t)r0 * D + c) : 0u;
        qa[ks][1] = r1 < S ? ld32(q + (size_t)r1 * D + c) : 0u;
        qa[ks][2] = r0 < S ? ld32(q + (size_t)r0 * D + c + 8) : 0u;
        qa[ks][3] = r1 < S ? ld32(q + (size_t)r1 * D + c + 8) : 0u;
    }

    float acc[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
        acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

    int lo, hi;
    key_tiles(p, q0, BK, lo, hi);
    for (int kt = lo; kt < hi; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();                              // tiles free to overwrite
        for (int i = threadIdx.x; i < BK * CPR; i += THREADS) {
            const int row = i / CPR, ch = i % CPR;
            uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
            if (k0 + row < S) {
                kx = *reinterpret_cast<const uint4*>(k + (size_t)(k0 + row) * D + ch * 8);
                vx = *reinterpret_cast<const uint4*>(v + (size_t)(k0 + row) * D + ch * 8);
            }
            *reinterpret_cast<uint4*>(&Ks[row * LD + ch * 8]) = kx;
            *reinterpret_cast<uint4*>(&Vs[row * LD + ch * 8]) = vx;
        }
        __syncthreads();

        // S = Q K^T: element e of tile nt is row (e < 2 ? r0 : r1), key
        // k0 + nt*8 + 2t + (e & 1)
        float s[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) {
                const __nv_bfloat16* kp = &Ks[(nt * 8 + g) * LD + ks * 16 + 2 * t];
                mma_bf16(s[nt], qa[ks], ld32(kp), ld32(kp + 8));
            }
        }

        float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = k0 + nt * 8 + 2 * t + (e & 1);
                const float x = score(p, s[nt][e], e < 2 ? r0 : r1, col);
                s[nt][e] = x;
                if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
            }
        }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            s[nt][0] = expf(s[nt][0] - mn0);
            s[nt][1] = expf(s[nt][1] - mn0);
            s[nt][2] = expf(s[nt][2] - mn1);
            s[nt][3] = expf(s[nt][3] - mn1);
            ps0 += s[nt][0] + s[nt][1];
            ps1 += s[nt][2] + s[nt][3];
        }
        l0 = l0 * al0 + ps0;                          // this thread's columns
        l1 = l1 * al1 + ps1;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
            acc[dt][0] *= al0;
            acc[dt][1] *= al0;
            acc[dt][2] *= al1;
            acc[dt][3] *= al1;
        }

        // O += P V: the S accumulators of column tiles 2j, 2j+1 are the A
        // fragment of k-step j; B[key][d] is V's row-major tile
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
            uint32_t a[4];
            a[0] = pack_f32(s[2 * j][0], s[2 * j][1]);
            a[1] = pack_f32(s[2 * j][2], s[2 * j][3]);
            a[2] = pack_f32(s[2 * j + 1][0], s[2 * j + 1][1]);
            a[3] = pack_f32(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
            for (int dt = 0; dt < DT; ++dt) {
                const __nv_bfloat16* vp = &Vs[(16 * j + 2 * t) * LD + dt * 8 + g];
                mma_bf16(acc[dt], a, pack_bf16(vp[0], vp[LD]),
                         pack_bf16(vp[8 * LD], vp[9 * LD]));
            }
        }
    }

    l0 = fmaxf(quad_sum(l0), 1e-30f);
    l1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
        const int c = dt * 8 + 2 * t;
        if (r0 < S)
            *reinterpret_cast<uint32_t*>(o + (size_t)r0 * D + c) =
                pack_f32(acc[dt][0] / l0, acc[dt][1] / l0);
        if (r1 < S)
            *reinterpret_cast<uint32_t*>(o + (size_t)r1 * D + c) =
                pack_f32(acc[dt][2] / l1, acc[dt][3] / l1);
    }
    if (t == 0) {
        if (r0 < S) lse[r0] = m0 + logf(l0);
        if (r1 < S) lse[r1] = m1 + logf(l1);
    }
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_fwd_f32(Params p) {
    constexpr int BK = 32;          // keys per tile
    constexpr int HD = D / 2;       // the half of D each thread holds
    constexpr int LD = D + 4;       // shared row stride, floats (+16 B)
    constexpr int CPR = D / 4;      // 16-byte chunks per row
    __shared__ __align__(16) float Ks[BK * LD];
    __shared__ __align__(16) float Vs[BK * LD];

    const int S = p.S;
    const int bh = blockIdx.x;
    const int b = bh / p.H, h = bh % p.H;
    const int kvh = h / (p.H / p.Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    const size_t kv_off = ((size_t)b * p.Hkv + kvh) * S * D;
    const float* q = static_cast<const float*>(p.q) + (size_t)bh * S * D;
    const float* k = static_cast<const float*>(p.k) + kv_off;
    const float* v = static_cast<const float*>(p.v) + kv_off;
    float* o = static_cast<float*>(p.o) + (size_t)bh * S * D;
    float* lse = p.lse + (size_t)bh * S;

    const int row = q0 + (threadIdx.x >> 1);          // partner: threadIdx ^ 1
    const int half = threadIdx.x & 1;
    float qh[HD], acc[HD];
#pragma unroll
    for (int i = 0; i < HD; ++i) {
        qh[i] = row < S ? q[(size_t)row * D + half * HD + i] * p.scale : 0.f;
        acc[i] = 0.f;
    }
    float m = NEG_INF, l = 0.f;
    // the scale is already in qh: score() must not apply it again
    Params pm = p;
    pm.scale = 1.f;

    int lo, hi;
    key_tiles(p, q0, BK, lo, hi);
    for (int kt = lo; kt < hi; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();
        for (int i = threadIdx.x; i < BK * CPR; i += THREADS) {
            const int r = i / CPR, ch = i % CPR;
            float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
            if (k0 + r < S) {
                kx = *reinterpret_cast<const float4*>(k + (size_t)(k0 + r) * D + ch * 4);
                vx = *reinterpret_cast<const float4*>(v + (size_t)(k0 + r) * D + ch * 4);
            }
            *reinterpret_cast<float4*>(&Ks[r * LD + ch * 4]) = kx;
            *reinterpret_cast<float4*>(&Vs[r * LD + ch * 4]) = vx;
        }
        __syncthreads();

        float s[BK];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            const float* kr = &Ks[j * LD + half * HD];
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < HD; ++i) part = fmaf(qh[i], kr[i], part);
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            s[j] = score(pm, part, row, k0 + j);
            mx = fmaxf(mx, s[j]);
        }
        const float mn = fmaxf(m, mx);
        const float al = expf(m - mn);
        m = mn;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            s[j] = expf(s[j] - mn);
            ps += s[j];
        }
        l = l * al + ps;
#pragma unroll
        for (int i = 0; i < HD; ++i) acc[i] *= al;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            const float* vr = &Vs[j * LD + half * HD];
#pragma unroll
            for (int i = 0; i < HD; ++i) acc[i] = fmaf(s[j], vr[i], acc[i]);
        }
    }

    if (row < S) {
        l = fmaxf(l, 1e-30f);
#pragma unroll
        for (int i = 0; i < HD; ++i) o[(size_t)row * D + half * HD + i] = acc[i] / l;
        if (half == 0) lse[row] = m + logf(l);
    }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int B, cudaStream_t stream) {
    const dim3 grid((unsigned)(B * p.H), (unsigned)((p.S + BQ - 1) / BQ));
    kernel<<<grid, THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

// o [B,H,S,D] (q's dtype) and lse [B,H,S] (f32) from q [B,H,S,D] and
// k, v [B,Hkv,S,D], all contiguous and 16-byte aligned.  dtype: 0 f32,
// 1 bf16.  window <= 0 and softcap <= 0 mean none.  Launches on `stream`
// and returns the CUDA error code of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int dtype, int B, int H,
                                   int Hkv, int S, int D, int causal,
                                   int window, float softcap, float scale,
                                   void* stream) {
    if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1
        || (long long)B * H > 0x7fffffffLL || (S + BQ - 1) / BQ > 65535)
        return (int)cudaErrorInvalidValue;
    Params p{q, k, v, o, static_cast<float*>(lse), H, Hkv, S, scale, causal,
             window, softcap};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        switch (D) {
            case 32: return (int)launch(fa_fwd_bf16<32>, p, B, s);
            case 64: return (int)launch(fa_fwd_bf16<64>, p, B, s);
            case 128: return (int)launch(fa_fwd_bf16<128>, p, B, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (dtype == 0) {
        switch (D) {
            case 32: return (int)launch(fa_fwd_f32<32>, p, B, s);
            case 64: return (int)launch(fa_fwd_f32<64>, p, B, s);
            case 128: return (int)launch(fa_fwd_f32<128>, p, B, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaErrorInvalidValue;
}

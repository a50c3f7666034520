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
// operations, and only wgmma reaches the tensor cores' full rate.
//
// The bf16 design (wgmma, TMA, an mbarrier ring; helpers in hopper.cuh):
// * Warp roles.  A block has 3 warpgroups: warpgroup 0 is the producer (one
//   warp issues every TMA load; setmaxnreg drops the group to 24
//   registers), warpgroups 1 and 2 are consumers of 64 rows each (one
//   wgmma M; setmaxnreg raises them to 240 registers).
// * dK/dV: one block per (b, kv head, 128-key tile).  K and V arrive once by
//   TMA and stay in shared memory.  A ring of STAGES stages holds per query
//   tile Q and dO (TMA) and the tile's lse and delta (copied by the
//   producer warp's lanes, which arrive on the same barrier); the ring walks
//   the group's query heads and, inside, the query tiles of the causal/
//   window band.  Each consumer computes S^T = K Q^T and dP^T = V dO^T
//   (wgmma, both operands K-major descriptors), forms P^T and dS^T in the
//   accumulators, re-packs them as bf16 A fragments in registers (the
//   accumulator layout is the A layout) and computes dV += P^T dO and
//   dK += dS^T Q with B read through MN-major (transposed) descriptors of
//   the dO and Q tiles: no transpose goes through shared memory.  dK and dV
//   stay in f32 registers for the whole loop, written once at the end.
// * dQ: one block per (b, head, 128-query tile).  Q and dO arrive once by
//   TMA and stay in shared memory as wgmma A operands; lse and delta stay
//   in registers.  A ring of K/V stages of 64 keys walks the band's key
//   tiles: S = Q K^T and dP = dO V^T from descriptors, dS in registers,
//   dQ += dS K with B = K through an MN-major descriptor.
// * Within a consumer the products run in batches that overlap its own
//   arithmetic: P^T (P) forms while dP^T (dP) is still in flight, and in
//   dK/dV dS^T forms while dV += P^T dO is.  Under a soft-cap dS needs the
//   score's tanh, so both wait for the two first products and form
//   together.
// * Stages are released by every consumer thread's arrival on the stage's
//   empty barrier after its products have completed; the producer refills
//   a stage when its empty barrier's phase completes.
// * Tensor maps are 3-D ([B*H or B*Hkv, S, D]), so rows past S of one head
//   load as zeros, never as the next head's rows: ragged S needs no
//   padding.
// * Tiles by D, from the -Xptxas -v report: D <= 64 keeps 64-query stages
//   in dK/dV (dK and dV 2 x 32 registers a thread, S^T and dP^T 2 x 32);
//   at D = 128 dK and dV take 128 registers a thread, so the dK/dV stages
//   hold 32 queries (S^T and dP^T 2 x 16), and the kernel still spills
//   about 500 bytes there.  dK/dV spills 24-56 bytes at D 32 and 64: the
//   producer warp's, in its 24 registers, off the products' path.  ptxas
//   serialises the dK/dV kernel's wgmma at every D (its C7514 note: a
//   non-wgmma instruction reads an accumulator inside a pipeline stage).
//   Products over D >= 128 run as N = 64 wgmmas, one per panel.
// * D = 256 (gemma2-9b): dK and dV of 64 keys at full D would take 256
//   registers a thread, and K, V and three stages of Q, dO 290 KB.  So the
//   D of dK/dV splits over two blocks (blockIdx.z): each recomputes S^T and
//   dP^T at full D and accumulates one 128-column half of dK and dV (128
//   registers), with K and V (128 KB) and two stages of 32 queries (64
//   KB).  The dQ kernel keeps dQ whole (128 registers) and streams two
//   stages of 32 keys.  A simple tiling that is right: no ported
//   configuration trains at D 256 on one card.
// * Rounding: the re-packed P^T and dS^T are rounded to bf16 before their
//   products, as FlashAttention-2 does; the TPU kernel keeps them in f32.
//   The plain version's `round_p=True` does the same, so chip_smoke.py
//   shows that rounding's share of the error (PERF.md).
// * Tiles wholly outside the band are not loaded; a consumer whose 64 rows
//   see nothing of a loaded tile skips its products, and tiles wholly
//   inside the band skip the mask.  dK/dV blocks run first-key-tile first
//   and dQ blocks last-query-tile first, the longest first under the
//   causal mask.
// * f32: FMA on the CUDA cores, four threads per key (dK/dV) or query row
//   (dQ), each holding a quarter of D, tiles of 32 rows; at D 256 eight
//   threads a row and tiles of 16 rows.  The JAX bar in f32
//   (relative gradient error below 5e-4, tests/test_kernels.py:53-71) rules
//   out TF32 and bf16 tensor cores.
//
// Precision: expf/tanhf (no fast math: build without --use_fast_math).

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace {

using fa::kept;
using fa::key_tiles;
using fa::pack_f32;
using fa::pairs_full;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;    // f32: 4 warps

// f32: threads per key or query row, and rows per block and tile
template <int D>
struct F32Rows {
    static constexpr int TPR = D > 128 ? 8 : 4;
    static constexpr int ROWS = THREADS / TPR;
};
constexpr int MIN_ROWS_F32 = THREADS / 8;

// bf16: a producer warpgroup and NC consumer warpgroups of 64 rows each
constexpr int WG = 128;
constexpr int NC = 2;
constexpr int THREADS_WG = WG * (NC + 1);
constexpr int ROWS_WG = 64;                // a consumer's rows, wgmma's M
constexpr int BKV = NC * ROWS_WG;          // keys per dK/dV block
constexpr int BQ_DQ = NC * ROWS_WG;        // queries per dQ block
constexpr int REGS_PRODUCER = 24, REGS_CONSUMER = 240;

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
// soft-cap's derivative (1 where there is none).  MASK false: the caller
// knows the pair is kept.
template <bool MASK = true>
__device__ __forceinline__ float prob(const Params& p, float s, float lse,
                                      int q, int k, float& dcap) {
    dcap = 1.f;
    if (MASK && (q >= p.S || !kept(q, k, p.S, p.causal, p.window)))
        return 0.f;
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

// Whether no pair of queries [q0, q0 + nq) and keys [k0, k0 + nk) is kept
// (fa::pairs_full: whether every pair is).
__device__ __forceinline__ bool pairs_dead(const Params& p, int q0, int nq,
                                           int k0, int nk) {
    return q0 >= p.S || k0 >= p.S || (p.causal && q0 + nq - 1 < k0)
        || (p.window > 0 && q0 - (k0 + nk - 1) >= p.window);
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, an mbarrier ring
// ---------------------------------------------------------------------------

using hopper::kmajor;
using hopper::load_tile;
using hopper::mnmajor;
using fa::to_frags;

// Shared memory of the dK/dV kernel: K, V, STAGES x (Q, dO), STAGES x (lse,
// delta), the barriers; 1024 bytes of slack for the alignment.  A block
// writes DO of the D columns of dK and dV (D / DO blocks share a key tile).
template <int D>
struct DkvSmem {
    static constexpr int BQ = D > 64 ? 32 : 64;    // queries a stage
    static constexpr int STAGES = D > 128 ? 2 : 3;
    static constexpr int DO = D > 128 ? 128 : D;   // dK/dV columns a block
    static constexpr int KV = BKV * D * 2;         // bytes of K (and of V)
    static constexpr int QT = BQ * D * 2;          // bytes of Q (and of dO)
    static constexpr int STAGE = 2 * QT;
    static constexpr int OFF_STAGES = 2 * KV;
    static constexpr int OFF_STATS = OFF_STAGES + STAGES * STAGE;
    static constexpr int OFF_BARS = OFF_STATS + STAGES * 2 * BQ * 4;
    static constexpr int BYTES = OFF_BARS + (2 * STAGES + 1) * 8 + 1024;
};

// P^T and dS^T of a dK/dV consumer: s and dp hold S^T and dP^T (rows keys
// kr0, kr0 + 8; columns queries q0 + 8j + 2t + (e & 1)); ls and dl the
// stage's lse and delta.
template <bool MASK, int NR>
__device__ __forceinline__ void dkv_probs(const Params& p, float (&s)[NR],
                                          float (&dp)[NR], const float* ls,
                                          const float* dl, int q0, int kr0,
                                          int t) {
#pragma unroll
    for (int j = 0; j < NR / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int qi = 8 * j + 2 * t + (e & 1);
            float dcap;
            const float pr = prob<MASK>(p, s[4 * j + e], ls[qi], q0 + qi,
                                        e < 2 ? kr0 : kr0 + 8, dcap);
            s[4 * j + e] = pr;
            dp[4 * j + e] = pr * (dp[4 * j + e] - dl[qi]) * dcap;
        }
    }
}

// Without a soft-cap, P^T alone (into s), so that it overlaps the dP^T
// product still in flight ...
template <bool MASK, int NR>
__device__ __forceinline__ void dkv_p(const Params& p, float (&s)[NR],
                                      const float* ls, int q0, int kr0,
                                      int t) {
#pragma unroll
    for (int j = 0; j < NR / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int qi = 8 * j + 2 * t + (e & 1);
            float dcap;
            s[4 * j + e] = prob<MASK>(p, s[4 * j + e], ls[qi], q0 + qi,
                                      e < 2 ? kr0 : kr0 + 8, dcap);
        }
    }
}

// ... and then dS^T = P^T (dP^T - delta) (into dp).
template <int NR>
__device__ __forceinline__ void dkv_ds(const float (&s)[NR], float (&dp)[NR],
                                       const float* dl, int t) {
#pragma unroll
    for (int j = 0; j < NR / 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = s[4 * j + e]
                * (dp[4 * j + e] - dl[8 * j + 2 * t + (e & 1)]);
}

template <int D>
__global__ void __launch_bounds__(THREADS_WG, 1)
fa_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_do, Params p) {
    using L = DkvSmem<D>;
    using P = hopper::Panels<D>;
    constexpr int BQ = L::BQ, STAGES = L::STAGES;
    constexpr int NPO = L::DO / P::PW;                // panels of dK/dV a block
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = hopper::align1024(smem_raw);
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = reinterpret_cast<bf16*>(smem + L::KV);
    float* stats = reinterpret_cast<float*>(smem + L::OFF_STATS);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::OFF_BARS);
    uint64_t* empty = full + STAGES;
    uint64_t* kv_full = empty + STAGES;

    const int S = p.S;
    const int bkv = blockIdx.x;                       // b * Hkv + kv head
    const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
    const int group = p.H / p.Hkv;
    const int k0 = blockIdx.y * BKV;
    const int c0 = blockIdx.z * NPO;                  // first panel of dK/dV
    int lo, hi;
    query_tiles(p, k0, BKV, BQ, lo, hi);

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            hopper::mbar_init(&full[s], 32);          // the producer's lanes
            hopper::mbar_init(&empty[s], NC * WG);    // every consumer thread
        }
        hopper::mbar_init(kv_full, 1);
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (threadIdx.x < WG) {
        // ---- producer --------------------------------------------------
        hopper::regs_dec<REGS_PRODUCER>();
        if (threadIdx.x >= 32) return;
        const int lane = threadIdx.x;
        if (lane == 0) {
            hopper::mbar_arrive_expect_tx(kv_full, 2 * L::KV);
            load_tile<D, BKV>(Ks, &tm_k, kv_full, k0, bkv);
            load_tile<D, BKV>(Vs, &tm_v, kv_full, k0, bkv);
        }
        int stage = 0;
        uint32_t phase = 0;
        for (int hh = 0; hh < group; ++hh) {
            const int bh = b * p.H + kvh * group + hh;
            const float* lse = p.lse + (size_t)bh * S;
            const float* delta = p.delta + (size_t)bh * S;
            for (int qt = lo; qt < hi; ++qt) {
                const int q0 = qt * BQ;
                hopper::mbar_wait(&empty[stage], phase ^ 1);
                bf16* Qs = reinterpret_cast<bf16*>(
                    smem + L::OFF_STAGES + stage * L::STAGE);
                if (lane == 0) {
                    hopper::mbar_expect_tx(&full[stage], L::STAGE);
                    load_tile<D, BQ>(Qs, &tm_q, &full[stage], q0, bh);
                    load_tile<D, BQ>(Qs + BQ * D, &tm_do, &full[stage], q0,
                                     bh);
                }
                float* st = stats + stage * 2 * BQ;
                for (int i = lane; i < BQ; i += 32) {
                    const bool in = q0 + i < S;
                    st[i] = in ? lse[q0 + i] : 0.f;
                    st[BQ + i] = in ? delta[q0 + i] : 0.f;
                }
                hopper::mbar_arrive(&full[stage]);
                if (++stage == STAGES) {
                    stage = 0;
                    phase ^= 1;
                }
            }
        }
        return;
    }

    // ---- consumers ---------------------------------------------------------
    hopper::regs_inc<REGS_CONSUMER>();
    const int cw = threadIdx.x / WG - 1;              // consumer index
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kw0 = k0 + cw * ROWS_WG;                // this consumer's keys
    const int kr0 = kw0 + (tid >> 5) * 16 + g;        // this thread's rows
    const int kr1 = kr0 + 8;

    float dk[NPO][P::PW / 2], dv[NPO][P::PW / 2];
#pragma unroll
    for (int pn = 0; pn < NPO; ++pn)
#pragma unroll
        for (int i = 0; i < P::PW / 2; ++i) dk[pn][i] = dv[pn][i] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int hh = 0; hh < group; ++hh) {
        for (int qt = lo; qt < hi; ++qt) {
            const int q0 = qt * BQ;
            hopper::mbar_wait(&full[stage], phase);
            if (!pairs_dead(p, q0, BQ, kw0, ROWS_WG)) {
                const bf16* Qs = reinterpret_cast<const bf16*>(
                    smem + L::OFF_STAGES + stage * L::STAGE);
                const bf16* dOs = Qs + BQ * D;
                const float* ls = stats + stage * 2 * BQ;

                // S^T = K Q^T, dP^T = V dO^T: two batches, so that P^T
                // forms while dP^T is still in flight
                float s[BQ / 2], dp[BQ / 2];
                hopper::wgmma_fence();
#pragma unroll
                for (int ks = 0; ks < D / 16; ++ks)
                    hopper::wgmma_ss(s, kmajor<D, BKV>(Ks, cw * ROWS_WG, ks),
                                     kmajor<D, BQ>(Qs, 0, ks), ks > 0);
                hopper::wgmma_commit();
#pragma unroll
                for (int ks = 0; ks < D / 16; ++ks)
                    hopper::wgmma_ss(dp, kmajor<D, BKV>(Vs, cw * ROWS_WG, ks),
                                     kmajor<D, BQ>(dOs, 0, ks), ks > 0);
                hopper::wgmma_commit();
                const bool capped = p.softcap > 0.f;
                const bool full = pairs_full(p, q0, BQ, kw0, ROWS_WG);
                if (capped) {
                    // the soft-cap's derivative needs the score: both at once
                    hopper::wgmma_wait<0>();
                    hopper::fence_regs(s);
                    hopper::fence_regs(dp);
                    if (full)
                        dkv_probs<false>(p, s, dp, ls, ls + BQ, q0, kr0, t);
                    else
                        dkv_probs<true>(p, s, dp, ls, ls + BQ, q0, kr0, t);
                } else {
                    hopper::wgmma_wait<1>();
                    hopper::fence_regs(s);
                    if (full)
                        dkv_p<false>(p, s, ls, q0, kr0, t);
                    else
                        dkv_p<true>(p, s, ls, q0, kr0, t);
                }

                // dV += P^T dO (in flight while dS^T forms), dK += dS^T Q
                uint32_t pa[BQ / 16][4], da[BQ / 16][4];
                to_frags(s, pa);
                hopper::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
                    for (int pn = 0; pn < NPO; ++pn) {
                        const uint64_t bo = mnmajor<D, BQ>(dOs, kk, c0 + pn);
                        hopper::wgmma_rs(dv[pn], pa[kk], bo, 1);
                    }
                }
                hopper::wgmma_commit();
                if (!capped) {
                    hopper::wgmma_wait<1>();
                    hopper::fence_regs(dp);
                    dkv_ds(s, dp, ls + BQ, t);
                }
                to_frags(dp, da);
                hopper::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
                    for (int pn = 0; pn < NPO; ++pn) {
                        const uint64_t bq = mnmajor<D, BQ>(Qs, kk, c0 + pn);
                        hopper::wgmma_rs(dk[pn], da[kk], bq, 1);
                    }
                }
                hopper::wgmma_commit();
                hopper::wgmma_wait<0>();
#pragma unroll
                for (int pn = 0; pn < NPO; ++pn) {
                    hopper::fence_regs(dk[pn]);
                    hopper::fence_regs(dv[pn]);
                }
            }
            hopper::mbar_arrive(&empty[stage]);
            if (++stage == STAGES) {
                stage = 0;
                phase ^= 1;
            }
        }
    }

    const size_t kv_off = (size_t)bkv * S * D;
    bf16* dko = static_cast<bf16*>(p.dk) + kv_off;
    bf16* dvo = static_cast<bf16*>(p.dv) + kv_off;
#pragma unroll
    for (int pn = 0; pn < NPO; ++pn) {
#pragma unroll
        for (int j = 0; j < P::PW / 8; ++j) {
            const int c = (c0 + pn) * P::PW + 8 * j + 2 * t;
            const float* k4 = &dk[pn][4 * j];
            const float* v4 = &dv[pn][4 * j];
            if (kr0 < S) {
                *reinterpret_cast<uint32_t*>(dko + (size_t)kr0 * D + c) =
                    pack_f32(k4[0] * p.scale, k4[1] * p.scale);
                *reinterpret_cast<uint32_t*>(dvo + (size_t)kr0 * D + c) =
                    pack_f32(v4[0], v4[1]);
            }
            if (kr1 < S) {
                *reinterpret_cast<uint32_t*>(dko + (size_t)kr1 * D + c) =
                    pack_f32(k4[2] * p.scale, k4[3] * p.scale);
                *reinterpret_cast<uint32_t*>(dvo + (size_t)kr1 * D + c) =
                    pack_f32(v4[2], v4[3]);
            }
        }
    }
}

// Shared memory of the dQ kernel: Q, dO, STAGES x (K, V), the barriers.
template <int D>
struct DqSmem {
    static constexpr int BK = D > 128 ? 32 : 64;   // keys a stage
    static constexpr int STAGES = D > 128 ? 2 : 3;
    static constexpr int QT = BQ_DQ * D * 2;       // bytes of Q (and of dO)
    static constexpr int KV = BK * D * 2;          // bytes of K (and of V)
    static constexpr int STAGE = 2 * KV;
    static constexpr int OFF_STAGES = 2 * QT;
    static constexpr int OFF_BARS = OFF_STAGES + STAGES * STAGE;
    static constexpr int BYTES = OFF_BARS + (2 * STAGES + 1) * 8 + 1024;
};

// dS of a dQ consumer: s and dp hold S and dP (rows queries qr0, qr0 + 8;
// columns keys k0 + 8j + 2t + (e & 1)).
template <bool MASK, int NR>
__device__ __forceinline__ void dq_probs(const Params& p, const float (&s)[NR],
                                         float (&dp)[NR], float lse0,
                                         float lse1, float dl0, float dl1,
                                         int qr0, int k0, int t) {
#pragma unroll
    for (int j = 0; j < NR / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float dcap;
            const float pr = prob<MASK>(p, s[4 * j + e], e < 2 ? lse0 : lse1,
                                        e < 2 ? qr0 : qr0 + 8,
                                        k0 + 8 * j + 2 * t + (e & 1), dcap);
            dp[4 * j + e] = pr * (dp[4 * j + e] - (e < 2 ? dl0 : dl1)) * dcap;
        }
    }
}

// Without a soft-cap, P alone (into s) while the dP product runs, then
// dS = P (dP - delta) (into dp).
template <bool MASK, int NR>
__device__ __forceinline__ void dq_p(const Params& p, float (&s)[NR],
                                     float lse0, float lse1, int qr0, int k0,
                                     int t) {
#pragma unroll
    for (int j = 0; j < NR / 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float dcap;
            s[4 * j + e] = prob<MASK>(p, s[4 * j + e], e < 2 ? lse0 : lse1,
                                      e < 2 ? qr0 : qr0 + 8,
                                      k0 + 8 * j + 2 * t + (e & 1), dcap);
        }
    }
}

template <int NR>
__device__ __forceinline__ void dq_ds(const float (&s)[NR], float (&dp)[NR],
                                      float dl0, float dl1) {
#pragma unroll
    for (int i = 0; i < NR; ++i)
        dp[i] = s[i] * (dp[i] - ((i & 3) < 2 ? dl0 : dl1));
}

template <int D>
__global__ void __launch_bounds__(THREADS_WG, 1)
fa_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do, Params p) {
    using L = DqSmem<D>;
    using P = hopper::Panels<D>;
    constexpr int BK = L::BK, STAGES = L::STAGES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = hopper::align1024(smem_raw);
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* dOs = reinterpret_cast<bf16*>(smem + L::QT);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::OFF_BARS);
    uint64_t* empty = full + STAGES;
    uint64_t* q_full = empty + STAGES;

    const int S = p.S;
    const int bh = blockIdx.x;                        // b * H + h
    const int b = bh / p.H, h = bh % p.H;
    const int bkv = b * p.Hkv + h / (p.H / p.Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ_DQ;
    int lo, hi;
    key_tiles(p, q0, BQ_DQ, BK, lo, hi);

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            hopper::mbar_init(&full[s], 1);
            hopper::mbar_init(&empty[s], NC * WG);
        }
        hopper::mbar_init(q_full, 1);
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (threadIdx.x < WG) {
        // ---- producer --------------------------------------------------
        hopper::regs_dec<REGS_PRODUCER>();
        if (threadIdx.x != 0) return;
        hopper::mbar_arrive_expect_tx(q_full, 2 * L::QT);
        load_tile<D, BQ_DQ>(Qs, &tm_q, q_full, q0, bh);
        load_tile<D, BQ_DQ>(dOs, &tm_do, q_full, q0, bh);
        int stage = 0;
        uint32_t phase = 0;
        for (int kt = lo; kt < hi; ++kt) {
            hopper::mbar_wait(&empty[stage], phase ^ 1);
            bf16* Ks = reinterpret_cast<bf16*>(
                smem + L::OFF_STAGES + stage * L::STAGE);
            hopper::mbar_arrive_expect_tx(&full[stage], L::STAGE);
            load_tile<D, BK>(Ks, &tm_k, &full[stage], kt * BK, bkv);
            load_tile<D, BK>(Ks + BK * D, &tm_v, &full[stage], kt * BK, bkv);
            if (++stage == STAGES) {
                stage = 0;
                phase ^= 1;
            }
        }
        return;
    }

    // ---- consumers ---------------------------------------------------------
    hopper::regs_inc<REGS_CONSUMER>();
    const int cw = threadIdx.x / WG - 1;
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw0 = q0 + cw * ROWS_WG;                // this consumer's queries
    const int qr0 = qw0 + (tid >> 5) * 16 + g;        // this thread's rows
    const int qr1 = qr0 + 8;
    const float* lse = p.lse + (size_t)bh * S;
    const float* delta = p.delta + (size_t)bh * S;
    const float lse0 = qr0 < S ? lse[qr0] : 0.f;
    const float lse1 = qr1 < S ? lse[qr1] : 0.f;
    const float dl0 = qr0 < S ? delta[qr0] : 0.f;
    const float dl1 = qr1 < S ? delta[qr1] : 0.f;

    float dq[P::NP][P::PW / 2];
#pragma unroll
    for (int pn = 0; pn < P::NP; ++pn)
#pragma unroll
        for (int i = 0; i < P::PW / 2; ++i) dq[pn][i] = 0.f;

    hopper::mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = lo; kt < hi; ++kt) {
        const int k0 = kt * BK;
        hopper::mbar_wait(&full[stage], phase);
        if (!pairs_dead(p, qw0, ROWS_WG, k0, BK)) {
            const bf16* Ks = reinterpret_cast<const bf16*>(
                smem + L::OFF_STAGES + stage * L::STAGE);
            const bf16* Vs = Ks + BK * D;

            // S = Q K^T, dP = dO V^T: two batches, so that P forms while dP
            // is still in flight
            float s[BK / 2], dp[BK / 2];
            hopper::wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks)
                hopper::wgmma_ss(s, kmajor<D, BQ_DQ>(Qs, cw * ROWS_WG, ks),
                                 kmajor<D, BK>(Ks, 0, ks), ks > 0);
            hopper::wgmma_commit();
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks)
                hopper::wgmma_ss(dp, kmajor<D, BQ_DQ>(dOs, cw * ROWS_WG, ks),
                                 kmajor<D, BK>(Vs, 0, ks), ks > 0);
            hopper::wgmma_commit();
            const bool full = pairs_full(p, qw0, ROWS_WG, k0, BK);
            if (p.softcap > 0.f) {
                // the soft-cap's derivative needs the score: both at once
                hopper::wgmma_wait<0>();
                hopper::fence_regs(s);
                hopper::fence_regs(dp);
                if (full)
                    dq_probs<false>(p, s, dp, lse0, lse1, dl0, dl1, qr0, k0, t);
                else
                    dq_probs<true>(p, s, dp, lse0, lse1, dl0, dl1, qr0, k0, t);
            } else {
                hopper::wgmma_wait<1>();
                hopper::fence_regs(s);
                if (full)
                    dq_p<false>(p, s, lse0, lse1, qr0, k0, t);
                else
                    dq_p<true>(p, s, lse0, lse1, qr0, k0, t);
                hopper::wgmma_wait<0>();
                hopper::fence_regs(dp);
                dq_ds(s, dp, dl0, dl1);
            }
            uint32_t da[BK / 16][4];
            to_frags(dp, da);

            // dQ += dS K
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
                for (int pn = 0; pn < P::NP; ++pn) {
                    const uint64_t bk = mnmajor<D, BK>(Ks, kk, pn);
                    hopper::wgmma_rs(dq[pn], da[kk], bk, 1);
                }
            }
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
#pragma unroll
            for (int pn = 0; pn < P::NP; ++pn) hopper::fence_regs(dq[pn]);
        }
        hopper::mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
        }
    }

    bf16* dqo = static_cast<bf16*>(p.dq) + (size_t)bh * S * D;
#pragma unroll
    for (int pn = 0; pn < P::NP; ++pn) {
#pragma unroll
        for (int j = 0; j < P::PW / 8; ++j) {
            const int c = pn * P::PW + 8 * j + 2 * t;
            const float* q4 = &dq[pn][4 * j];
            if (qr0 < S)
                *reinterpret_cast<uint32_t*>(dqo + (size_t)qr0 * D + c) =
                    pack_f32(q4[0] * p.scale, q4[1] * p.scale);
            if (qr1 < S)
                *reinterpret_cast<uint32_t*>(dqo + (size_t)qr1 * D + c) =
                    pack_f32(q4[2] * p.scale, q4[3] * p.scale);
        }
    }
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

// The sum over the TPR neighbouring lanes that share a row.
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
    for (int m = 1; m < TPR; m <<= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
    return x;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_bwd_dkv_f32(Params p) {
    constexpr int TPR = F32Rows<D>::TPR;
    constexpr int ROWS = F32Rows<D>::ROWS;
    constexpr int BQ = ROWS;        // queries per tile
    constexpr int HD = D / TPR;     // the part of D each thread holds
    constexpr int LD = D + 4;       // shared row stride, floats (+16 B)
    __shared__ __align__(16) float Qs[BQ * LD];
    __shared__ __align__(16) float dOs[BQ * LD];
    __shared__ float lse_s[BQ];
    __shared__ float delta_s[BQ];

    const int S = p.S;
    const int bkv = blockIdx.x;
    const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
    const int group = p.H / p.Hkv;
    const int k0 = blockIdx.y * ROWS;
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
    query_tiles(p, k0, ROWS, BQ, lo, hi);
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
                s = row_sum<TPR>(s);
                dpv = row_sum<TPR>(dpv);
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
    constexpr int TPR = F32Rows<D>::TPR;
    constexpr int ROWS = F32Rows<D>::ROWS;
    constexpr int BK = ROWS;        // keys per tile
    constexpr int HD = D / TPR;
    constexpr int LD = D + 4;
    __shared__ __align__(16) float Ks[BK * LD];
    __shared__ __align__(16) float Vs[BK * LD];

    const int S = p.S;
    const int bh = blockIdx.x;
    const int b = bh / p.H, h = bh % p.H;
    const int kvh = h / (p.H / p.Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
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
    key_tiles(p, q0, ROWS, BK, lo, hi);
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
            s = row_sum<TPR>(s);
            dpv = row_sum<TPR>(dpv);
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

// Launch a bf16 kernel with tensor maps of q, dO (boxes of `q_rows` rows)
// and k, v (boxes of `kv_rows` rows).
template <int D, typename Kernel>
cudaError_t launch_bf16(Kernel kernel, dim3 grid, int smem, int B,
                        int q_rows, int kv_rows, const Params& p,
                        cudaStream_t stream) {
    CUtensorMap tq, tk, tv, tdo;
    cudaError_t e;
    if ((e = hopper::tensor_map_bf16(&tq, p.q, B * p.H, p.S, D, q_rows))
        || (e = hopper::tensor_map_bf16(&tdo, p.dout, B * p.H, p.S, D,
                                        q_rows))
        || (e = hopper::tensor_map_bf16(&tk, p.k, B * p.Hkv, p.S, D,
                                        kv_rows))
        || (e = hopper::tensor_map_bf16(&tv, p.v, B * p.Hkv, p.S, D,
                                        kv_rows))
        || (e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
        return e;
    kernel<<<grid, THREADS_WG, smem, stream>>>(tq, tk, tv, tdo, p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(int B, const Params& p, cudaStream_t stream) {
    using L = DkvSmem<D>;
    const dim3 grid((unsigned)(B * p.Hkv), (unsigned)((p.S + BKV - 1) / BKV),
                    (unsigned)(D / L::DO));
    return launch_bf16<D>(fa_bwd_dkv_bf16<D>, grid, L::BYTES, B, L::BQ, BKV,
                          p, stream);
}

template <int D>
cudaError_t launch_dq_bf16(int B, const Params& p, cudaStream_t stream) {
    using L = DqSmem<D>;
    const dim3 grid((unsigned)(B * p.H),
                    (unsigned)((p.S + BQ_DQ - 1) / BQ_DQ));
    return launch_bf16<D>(fa_bwd_dq_bf16<D>, grid, L::BYTES, B, BQ_DQ, L::BK,
                          p, stream);
}

// An f32 kernel over grid (B * heads, row tiles of F32Rows<D>::ROWS).
template <int D, typename Kernel>
cudaError_t launch_f32(Kernel kernel, int B, int heads, const Params& p,
                       cudaStream_t stream) {
    constexpr int ROWS = F32Rows<D>::ROWS;
    const dim3 grid((unsigned)(B * heads), (unsigned)((p.S + ROWS - 1) / ROWS));
    return launch(kernel, grid, 0, p, stream);
}

bool bad_shape(int B, int H, int Hkv, int S) {
    return B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || S < 1
        || (long long)B * H > 0x7fffffffLL
        || (S + MIN_ROWS_F32 - 1) / MIN_ROWS_F32 > 65535;
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
        switch (D) {
            case 32: return (int)launch_dkv_bf16<32>(B, p, s);
            case 64: return (int)launch_dkv_bf16<64>(B, p, s);
            case 128: return (int)launch_dkv_bf16<128>(B, p, s);
            case 256: return (int)launch_dkv_bf16<256>(B, p, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (dtype == 0) {
        switch (D) {
            case 32: return (int)launch_f32<32>(fa_bwd_dkv_f32<32>, B, Hkv, p, s);
            case 64: return (int)launch_f32<64>(fa_bwd_dkv_f32<64>, B, Hkv, p, s);
            case 128:
                return (int)launch_f32<128>(fa_bwd_dkv_f32<128>, B, Hkv, p, s);
            case 256:
                return (int)launch_f32<256>(fa_bwd_dkv_f32<256>, B, Hkv, p, s);
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
        switch (D) {
            case 32: return (int)launch_dq_bf16<32>(B, p, s);
            case 64: return (int)launch_dq_bf16<64>(B, p, s);
            case 128: return (int)launch_dq_bf16<128>(B, p, s);
            case 256: return (int)launch_dq_bf16<256>(B, p, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (dtype == 0) {
        switch (D) {
            case 32: return (int)launch_f32<32>(fa_bwd_dq_f32<32>, B, H, p, s);
            case 64: return (int)launch_f32<64>(fa_bwd_dq_f32<64>, B, H, p, s);
            case 128: return (int)launch_f32<128>(fa_bwd_dq_f32<128>, B, H, p, s);
            case 256: return (int)launch_f32<256>(fa_bwd_dq_f32<256>, B, H, p, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory a bf16 launch of pass 0 (dK/dV) or 1 (dQ)
// requests at head dim D; 0 where none is built.
extern "C" int flash_attention_bwd_smem_bytes(int pass, int D) {
    switch (D) {
        case 32: return pass ? DqSmem<32>::BYTES : DkvSmem<32>::BYTES;
        case 64: return pass ? DqSmem<64>::BYTES : DkvSmem<64>::BYTES;
        case 128: return pass ? DqSmem<128>::BYTES : DkvSmem<128>::BYTES;
        case 256: return pass ? DqSmem<256>::BYTES : DkvSmem<256>::BYTES;
        default: return 0;
    }
}

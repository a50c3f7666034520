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
// over the 268.6 M kept (q, k) pairs need 4 D flops a pair, 68.7 GFLOP (69
// us at the data sheet's 989 TFLOP/s bf16), against 85 MB that must move
// once (q, k, v, o and lse: 25 us at 3.35 TB/s): bound by operations.  The
// exp is a second floor: one a kept pair, and the special-function unit
// issues 16 a clock a multiprocessor, 268.6 M / (132 x 16) = 127 k clocks,
// about 70 us at 1.8 GHz.  At D 64 the exps cost as much as the products,
// so a kernel that runs them one after the other cannot beat about twice
// the bound: the design overlaps them.
//
// The bf16 design (wgmma, TMA, mbarrier rings; helpers in hopper.cuh):
// * Roles.  One block of 3 warpgroups per (128-query tile, b*H + h):
//   warpgroup 0 is the producer (one thread issues every TMA load;
//   setmaxnreg drops the group to 24 registers), warpgroups 1 and 2 are
//   consumers of 64 query rows each (one wgmma M; setmaxnreg 240).
// * Loads.  The block's Q tile arrives once by TMA; K and V tiles of BK
//   keys stream through two mbarrier rings of 3 stages each (K and V
//   apart, so that K is released as soon as S = Q K^T has read it, and
//   the next K loads while this V is still in use).  Each consumer warp
//   releases a stage with one arrival once its wgmma reads are done.  3-D tensor maps
//   ([B*H or B*Hkv, S, D]) load rows past S as zeros, never as the next
//   head's rows: ragged S needs no padding.
// * S = Q K^T: wgmma m64nBKk16, Q and K both K-major from shared memory,
//   f32 accumulators.  Mask, soft-cap and the online max and sum run in
//   registers.  O += P V: P is re-packed from the S accumulators into bf16
//   A fragments in registers (the accumulator layout is the A layout) and
//   V is read through MN-major descriptors; D >= 128 runs as D / 64 N-64
//   products, D 32 as one N-32 product with the 64-byte swizzle.
// * The overlap (FlashAttention-3's intra-warpgroup pipelining): at key
//   tile j a consumer issues S_j = Q K_j^T and then O += P_{j-1} V_{j-1}
//   before it waits for S_j, so that the softmax of tile j (its exps) runs
//   while the tensor cores still work on P_{j-1} V_{j-1}; only then is O
//   rescaled by exp(m_{j-1} - m_j).  The two consumers also interleave each
//   other's softmax with their products on the multiprocessor's schedulers.
// * exp as ex2.approx: log2(e) is folded into the scale, so a kept pair
//   costs one FFMA and one MUFU.EX2 (at most 2 ulp of f32, far inside the
//   bf16 bar; chip_smoke.py (b) prints the error against the plain
//   version); m is kept in the base-2 domain and lse = m ln 2 + log(l).
//   tanh of the soft-cap stays tanhf.
// * Causal and window work: key tiles wholly outside the band of the
//   block's 128 rows are not loaded; a consumer waits for and releases the
//   tiles outside its own 64 rows' band without computing, and tiles
//   wholly inside the band skip the mask.  The TPU kernel visits every key
//   tile, but a fully masked tile's contribution is wiped by
//   alpha = exp(-1e30 - m) = 0 once a row meets an unmasked key, so the
//   result is the same.  Query tiles run longest first.
// * Rounding: P is rounded to bf16 before P V, as FlashAttention-2 does,
//   where the TPU kernel keeps P in f32 (it casts V to f32, so
//   P.astype(v.dtype) is f32); l sums the unrounded P.  The plain version's
//   `round_p=True` does the same, so chip_smoke.py shows that rounding's
//   share of the error.
// * Tiles by D: Q is 128 x D (16-64 KB).  BK is 128 keys up to D 64
//   (half the per-tile work of max, rescale and barriers of 64-key tiles),
//   64 at D 128 and 32 at D 256, where O takes 128 f32 registers a
//   consumer thread and S and P must fit beside it.
// * f32: the CUDA cores (FMA), two threads per query row each holding half
//   of D (four at D 256); the JAX bar in f32 (2e-5) rules out TF32 and bf16
//   tensor cores.  expf/logf/tanhf (no fast math: build without
//   --use_fast_math).

#include "flash_attention_common.cuh"
#include "hopper.cuh"

namespace {

using fa::key_tiles;
using fa::NEG_INF;
using fa::pack_f32;
using fa::pairs_full;
using fa::quad_max;
using fa::quad_sum;
using fa::to_frags;
using hopper::kmajor;
using hopper::load_tile;
using hopper::mnmajor;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int BQ = 64;          // f32: query rows per block

// bf16: a producer warpgroup and NC consumer warpgroups of 64 rows each
constexpr int WG = 128;
constexpr int NC = 2;
constexpr int THREADS_WG = WG * (NC + 1);
constexpr int ROWS_WG = 64;                // a consumer's rows, wgmma's M
constexpr int BQ_WG = NC * ROWS_WG;        // query rows per bf16 block
constexpr int REGS_PRODUCER = 24, REGS_CONSUMER = 240;

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

// Scale, soft-cap and mask one score.
__device__ __forceinline__ float score(const Params& p, float x, int row,
                                       int col) {
    x *= p.scale;
    if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
    return fa::kept(row, col, p.S, p.causal, p.window) ? x : NEG_INF;
}

// ---------------------------------------------------------------------------
// bf16: wgmma, TMA, mbarrier rings
// ---------------------------------------------------------------------------

// The bf16 kernel's shared memory: Q, STAGES x K, STAGES x V, the
// barriers; 1024 bytes of slack for the alignment.
template <int D>
struct FwdSmem {
    // keys a stage: 128 (one N-128 S product) up to D 64; at D 256 32, so
    // that O (128 registers), S and P fit a consumer thread's 240
    static constexpr int BK = D <= 64 ? 128 : D <= 128 ? 64 : 32;
    static constexpr int STAGES = 3;
    static constexpr int QT = BQ_WG * D * 2;       // bytes of Q
    static constexpr int KT = BK * D * 2;          // bytes of a K (or V) tile
    static constexpr int OFF_K = QT;
    static constexpr int OFF_V = OFF_K + STAGES * KT;
    static constexpr int OFF_BARS = OFF_V + STAGES * KT;
    static constexpr int BYTES = OFF_BARS + (4 * STAGES + 1) * 8 + 1024;
};

// The online softmax of one key tile in a consumer's registers.  s holds
// S = Q K^T (rows r0 and r0 + 8, columns k0 + 8j + 2t + (e & 1)); on return
// it holds P = 2^(x - m_new) with x the scaled, capped and masked score in
// the base-2 domain; m0, m1 are the rows' new maxima, al0, al1 the factors
// exp(m_old - m_new) that rescale O and l, ps0, ps1 this thread's share of
// the rows' sums of P.  MASK false: every pair of the tile is kept.  Maxima
// and sums run in NA independent chains a row: a consumer warp shares its
// scheduler with one other, so little else hides a dependent chain.
template <bool MASK, int NR>
__device__ __forceinline__ void softmax_tile(const Params& p, float (&s)[NR],
                                             int r0, int k0, int t,
                                             float& m0, float& m1,
                                             float& al0, float& al1,
                                             float& ps0, float& ps1) {
    constexpr int NA = NR / 4 < 4 ? NR / 4 : 4;
    const float sl2 = p.scale * LOG2E;
    // no mask, no cap and a positive scale: max(x) = max(s) * sl2
    const bool plain = !MASK && p.softcap <= 0.f && p.scale > 0.f;
    float mx[2][NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) mx[0][a] = mx[1][a] = NEG_INF;
    if (plain) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            float& m = mx[(i & 3) >> 1][(i >> 2) % NA];
            m = fmaxf(m, s[i]);
        }
    } else {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            const int e = i & 3;
            float x = s[i] * p.scale;
            if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
            x *= LOG2E;
            if (MASK && !fa::kept(e < 2 ? r0 : r0 + 8,
                                  k0 + 8 * (i >> 2) + 2 * t + (e & 1), p.S,
                                  p.causal, p.window))
                x = NEG_INF;
            s[i] = x;
            float& m = mx[e >> 1][(i >> 2) % NA];
            m = fmaxf(m, x);
        }
    }
#pragma unroll
    for (int a = 1; a < NA; ++a) {
        mx[0][0] = fmaxf(mx[0][0], mx[0][a]);
        mx[1][0] = fmaxf(mx[1][0], mx[1][a]);
    }
    if (plain) {
        mx[0][0] *= sl2;
        mx[1][0] *= sl2;
    }
    const float mn0 = fmaxf(m0, quad_max(mx[0][0]));
    const float mn1 = fmaxf(m1, quad_max(mx[1][0]));
    al0 = hopper::ex2(m0 - mn0);
    al1 = hopper::ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P, and this thread's row sums in NA chains a row
    const float scale = plain ? sl2 : 1.f;
    float ps[2][NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) ps[0][a] = ps[1][a] = 0.f;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
        const int r = (i & 3) >> 1;
        s[i] = hopper::ex2(fmaf(s[i], scale, r ? -mn1 : -mn0));
        ps[r][(i >> 2) % NA] += s[i];
    }
#pragma unroll
    for (int a = 1; a < NA; ++a) {
        ps[0][0] += ps[0][a];
        ps[1][0] += ps[1][a];
    }
    ps0 = ps[0][0];
    ps1 = ps[1][0];
}

template <int D>
__global__ void __launch_bounds__(THREADS_WG, 1)
fa_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, Params p) {
    using L = FwdSmem<D>;
    using P = hopper::Panels<D>;
    constexpr int BK = L::BK, STAGES = L::STAGES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = hopper::align1024(smem_raw);
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Kring = reinterpret_cast<bf16*>(smem + L::OFF_K);
    bf16* Vring = reinterpret_cast<bf16*>(smem + L::OFF_V);
    uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + L::OFF_BARS);
    uint64_t* k_empty = k_full + STAGES;
    uint64_t* v_full = k_empty + STAGES;
    uint64_t* v_empty = v_full + STAGES;
    uint64_t* q_full = v_empty + STAGES;

    const int S = p.S;
    const int bh = blockIdx.x;                        // b * H + h
    const int b = bh / p.H, h = bh % p.H;
    const int bkv = b * p.Hkv + h / (p.H / p.Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ_WG;
    int lo, hi;
    key_tiles(p, q0, BQ_WG, BK, lo, hi);

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            hopper::mbar_init(&k_full[s], 1);
            hopper::mbar_init(&k_empty[s], NC * WG / 32);  // every consumer warp
            hopper::mbar_init(&v_full[s], 1);
            hopper::mbar_init(&v_empty[s], NC * WG / 32);
        }
        hopper::mbar_init(q_full, 1);
        hopper::fence_barrier_init();
    }
    __syncthreads();

    if (threadIdx.x < WG) {
        // ---- producer ------------------------------------------------------
        hopper::regs_dec<REGS_PRODUCER>();
        if (threadIdx.x != 0) return;
        hopper::mbar_arrive_expect_tx(q_full, L::QT);
        load_tile<D, BQ_WG>(Qs, &tm_q, q_full, q0, bh);
        int stage = 0;
        uint32_t phase = 0;
        for (int kt = lo; kt < hi; ++kt) {
            hopper::mbar_wait(&k_empty[stage], phase ^ 1);
            hopper::mbar_arrive_expect_tx(&k_full[stage], L::KT);
            load_tile<D, BK>(Kring + stage * BK * D, &tm_k, &k_full[stage],
                             kt * BK, bkv);
            hopper::mbar_wait(&v_empty[stage], phase ^ 1);
            hopper::mbar_arrive_expect_tx(&v_full[stage], L::KT);
            load_tile<D, BK>(Vring + stage * BK * D, &tm_v, &v_full[stage],
                             kt * BK, bkv);
            if (++stage == STAGES) {
                stage = 0;
                phase ^= 1;
            }
        }
        return;
    }

    // ---- consumers -----------------------------------------------------------
    hopper::regs_inc<REGS_CONSUMER>();
    // consumer index, warp-uniform as far as the compiler can tell
    const int cw = __shfl_sync(0xffffffffu, threadIdx.x / WG - 1, 0);
    const int tid = threadIdx.x % WG;
    const int lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qw0 = q0 + cw * ROWS_WG;                // this consumer's rows
    const int qr0 = qw0 + (tid >> 5) * 16 + g;        // this thread's rows
    const int qr1 = qr0 + 8;
    // this consumer's key tiles [clo, chi) within the block's [lo, hi)
    int clo, chi;
    key_tiles(p, qw0, ROWS_WG, BK, clo, chi);
    clo = max(clo, lo);
    chi = qw0 < S ? max(min(chi, hi), clo) : clo;

    float o[P::NP][P::PW / 2];
#pragma unroll
    for (int pn = 0; pn < P::NP; ++pn)
#pragma unroll
        for (int i = 0; i < P::PW / 2; ++i) o[pn][i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
    int stage = 0;
    uint32_t phase = 0;
    auto advance = [&]() {
        if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
        }
    };
    // A warp releases a stage once its reads are done (after its wgmma
    // wait): one arrival a warp.
    auto release = [&](uint64_t* bar) {
        if (lane == 0) hopper::mbar_arrive(bar);
    };
    // Wait for a tile's K and V and release them unused.
    auto skip = [&]() {
        hopper::mbar_wait(&k_full[stage], phase);
        release(&k_empty[stage]);
        hopper::mbar_wait(&v_full[stage], phase);
        release(&v_empty[stage]);
        advance();
    };
    // S = Q K^T of the K tile in `stage`, issued and committed.
    auto issue_s = [&]() {
        const bf16* Ks = Kring + stage * BK * D;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
            hopper::wgmma_ss(s, kmajor<D, BQ_WG>(Qs, cw * ROWS_WG, ks),
                             kmajor<D, BK>(Ks, 0, ks), ks > 0);
        hopper::wgmma_commit();
    };
    // The softmax of key tile kt (S complete in s): P in s, the factors
    // that rescale O and l in al0, al1, this thread's sums in ps0, ps1.
    float al0, al1, ps0, ps1;
    auto softmax = [&](int kt) {
        const int k0 = kt * BK;
        if (pairs_full(p, qw0, ROWS_WG, k0, BK))
            softmax_tile<false>(p, s, qr0, k0, t, m0, m1, al0, al1, ps0, ps1);
        else
            softmax_tile<true>(p, s, qr0, k0, t, m0, m1, al0, al1, ps0, ps1);
    };
    // O and l rescaled to the new maxima, P packed for the P V product.
    auto rescale = [&]() {
        l0 = l0 * al0 + ps0;                          // this thread's columns
        l1 = l1 * al1 + ps1;
#pragma unroll
        for (int pn = 0; pn < P::NP; ++pn) {
#pragma unroll
            for (int i = 0; i < P::PW / 2; ++i)
                o[pn][i] *= (i & 3) < 2 ? al0 : al1;
        }
        to_frags(s, pa);
    };

    hopper::mbar_wait(q_full, 0);
    for (int kt = lo; kt < clo; ++kt) skip();
    int pstage = 0;                                   // the last P's stage
    if (clo < chi) {
        // the first tile: S alone
        hopper::mbar_wait(&k_full[stage], phase);
        hopper::wgmma_fence();
        issue_s();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        release(&k_empty[stage]);
        softmax(clo);
        rescale();
        pstage = stage;
        advance();
    }
    // Tile kt: S_kt = Q K_kt^T and then O += P V of tile kt - 1 are issued
    // before the first is waited for, so that the softmax of tile kt runs
    // while the second is still in flight.
    for (int kt = clo + 1; kt < chi; ++kt) {
        hopper::mbar_wait(&k_full[stage], phase);
        hopper::mbar_wait(&v_full[pstage], phase ^ (stage < pstage));
        const bf16* Vs = Vring + pstage * BK * D;
        hopper::wgmma_fence();
        issue_s();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
            for (int pn = 0; pn < P::NP; ++pn) {
                const uint64_t bv = mnmajor<D, BK>(Vs, kk, pn);
                hopper::wgmma_rs(o[pn], pa[kk], bv, 1);
            }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
        release(&k_empty[stage]);
        softmax(kt);
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int pn = 0; pn < P::NP; ++pn) hopper::fence_regs(o[pn]);
        release(&v_empty[pstage]);
        rescale();
        pstage = stage;
        advance();
    }
    if (clo < chi) {
        // the last tile's P V
        hopper::mbar_wait(&v_full[pstage], phase ^ (stage < pstage));
        const bf16* Vs = Vring + pstage * BK * D;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
            for (int pn = 0; pn < P::NP; ++pn)
                hopper::wgmma_rs(o[pn], pa[kk],
                                 mnmajor<D, BK>(Vs, kk, pn), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int pn = 0; pn < P::NP; ++pn) hopper::fence_regs(o[pn]);
        release(&v_empty[pstage]);
    }
    for (int kt = chi; kt < hi; ++kt) skip();

    l0 = fmaxf(quad_sum(l0), 1e-30f);
    l1 = fmaxf(quad_sum(l1), 1e-30f);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    bf16* out = static_cast<bf16*>(p.o) + (size_t)bh * S * D;
#pragma unroll
    for (int pn = 0; pn < P::NP; ++pn) {
#pragma unroll
        for (int j = 0; j < P::PW / 8; ++j) {
            const int c = pn * P::PW + 8 * j + 2 * t;
            const float* o4 = &o[pn][4 * j];
            if (qr0 < S)
                *reinterpret_cast<uint32_t*>(out + (size_t)qr0 * D + c) =
                    pack_f32(o4[0] * inv0, o4[1] * inv0);
            if (qr1 < S)
                *reinterpret_cast<uint32_t*>(out + (size_t)qr1 * D + c) =
                    pack_f32(o4[2] * inv1, o4[3] * inv1);
        }
    }
    if (t == 0) {
        float* lse = p.lse + (size_t)bh * S;
        if (qr0 < S) lse[qr0] = m0 * LN2 + logf(l0);
        if (qr1 < S) lse[qr1] = m1 * LN2 + logf(l1);
    }
}

// ---------------------------------------------------------------------------
// f32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

// f32 tiling: TPR threads a query row (64 rows a block), BK keys a tile.
template <int D>
struct F32Tile {
    static constexpr int TPR = D > 128 ? 4 : 2;
    static constexpr int THREADS = BQ * TPR;
    static constexpr int BK = D > 128 ? 16 : 32;
};

template <int D>
__global__ void __launch_bounds__(F32Tile<D>::THREADS)
fa_fwd_f32(Params p) {
    constexpr int TPR = F32Tile<D>::TPR;
    constexpr int THREADS = F32Tile<D>::THREADS;
    constexpr int BK = F32Tile<D>::BK;  // keys per tile
    constexpr int HD = D / TPR;         // the part of D each thread holds
    constexpr int LD = D + 4;           // shared row stride, floats (+16 B)
    constexpr int CPR = D / 4;          // 16-byte chunks per row
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

    const int row = q0 + threadIdx.x / TPR;           // partners: same row
    const int part = (threadIdx.x % TPR) * HD;
    float qh[HD], acc[HD];
#pragma unroll
    for (int i = 0; i < HD; ++i) {
        qh[i] = row < S ? q[(size_t)row * D + part + i] * p.scale : 0.f;
        acc[i] = 0.f;
    }
    float m = NEG_INF, l = 0.f;
    // the scale is already in qh: score() must not apply it again
    Params pm = p;
    pm.scale = 1.f;

    int lo, hi;
    key_tiles(p, q0, BQ, BK, lo, hi);
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
            const float* kr = &Ks[j * LD + part];
            float dot = 0.f;
#pragma unroll
            for (int i = 0; i < HD; ++i) dot = fmaf(qh[i], kr[i], dot);
#pragma unroll
            for (int m2 = 1; m2 < TPR; m2 <<= 1)
                dot += __shfl_xor_sync(0xffffffffu, dot, m2);
            s[j] = score(pm, dot, row, k0 + j);
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
            const float* vr = &Vs[j * LD + part];
#pragma unroll
            for (int i = 0; i < HD; ++i) acc[i] = fmaf(s[j], vr[i], acc[i]);
        }
    }

    if (row < S) {
        l = fmaxf(l, 1e-30f);
#pragma unroll
        for (int i = 0; i < HD; ++i) o[(size_t)row * D + part + i] = acc[i] / l;
        if (part == 0) lse[row] = m + logf(l);
    }
}

template <int D>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
    const dim3 grid((unsigned)(B * p.H), (unsigned)((p.S + BQ - 1) / BQ));
    fa_fwd_f32<D><<<grid, F32Tile<D>::THREADS, 0, stream>>>(p);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
    using L = FwdSmem<D>;
    CUtensorMap tq, tk, tv;
    cudaError_t e;
    if ((e = hopper::tensor_map_bf16(&tq, p.q, B * p.H, p.S, D, BQ_WG))
        || (e = hopper::tensor_map_bf16(&tk, p.k, B * p.Hkv, p.S, D, L::BK))
        || (e = hopper::tensor_map_bf16(&tv, p.v, B * p.Hkv, p.S, D, L::BK))
        || (e = cudaFuncSetAttribute(
                fa_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                L::BYTES)))
        return e;
    const dim3 grid((unsigned)(B * p.H), (unsigned)((p.S + BQ_WG - 1) / BQ_WG));
    fa_fwd_bf16<D><<<grid, THREADS_WG, L::BYTES, stream>>>(tq, tk, tv, p);
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
            case 32: return (int)launch_bf16<32>(p, B, s);
            case 64: return (int)launch_bf16<64>(p, B, s);
            case 128: return (int)launch_bf16<128>(p, B, s);
            case 256: return (int)launch_bf16<256>(p, B, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (dtype == 0) {
        switch (D) {
            case 32: return (int)launch_f32<32>(p, B, s);
            case 64: return (int)launch_f32<64>(p, B, s);
            case 128: return (int)launch_f32<128>(p, B, s);
            case 256: return (int)launch_f32<256>(p, B, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory a bf16 launch requests at head dim D; 0
// where none is built.
extern "C" int flash_attention_fwd_smem_bytes(int D) {
    switch (D) {
        case 32: return FwdSmem<32>::BYTES;
        case 64: return FwdSmem<64>::BYTES;
        case 128: return FwdSmem<128>::BYTES;
        case 256: return FwdSmem<256>::BYTES;
        default: return 0;
    }
}

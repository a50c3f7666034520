// fft_stage: batched complex64 FFT along the last axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fft_planes` (src/repro/kernels/fft_stage/kernel.py:64,
// body `_fft_body`/`_fft_kernel`): a batched radix-2 Stockham FFT with no
// bit-reversal pass, natural-order output, the inverse scaled by 1/n.  The TPU
// design keeps a whole row in VMEM and runs all log2(n) stages there.  On the
// H100 a block has at most 227 KB of shared memory, while the rows of the main
// path (the BSP FFT at N = 2^24 over p = 8 processes) are 2^21 points, 16 MiB
// each.
//
// What bounds it on this card: bytes.  One (8, 2^21) transform must read and
// write 2^24 complex64 values (268 MB, 80 us at 3.35 TB/s); its 5 n log2 n
// flops (1.76 GFLOP, 26 us at 67 TFLOP/s fp32) are a third of that.  Every
// extra trip of the row through device memory costs another 80 us.
//
// What this design does about it: a four-step split that moves each row
// through device memory as few times as shared memory allows.  With
// n = T_1 * ... * T_P (P <= 3, each T_q <= 2^11; one pass up to 2^12):
//
//   * a "col" pass views each row as [S, T, A] (row-major) and, for every s
//     and every inner index a, takes the T-point DFT along the middle axis,
//     multiplies output k by w_{T*A}^{a*k}, and writes it back in the same
//     layout.  The first pass has S = 1, A = n / T_1: it is the four-step's
//     column pass, Y[k2, j1] = w_n^{j1 k2} sum_{j2} x[j1 + N1 j2] w_N2^{j2 k2}
//     with N2 = T and N1 = A.  A middle pass (P = 3) does the same to each of
//     the S = T_1 contiguous rows of length A = n / T_1 that the first pass
//     left;
//   * the last, "row" pass takes the T_P-point DFT of each contiguous run of
//     T_P points and writes output k of sequence (d1, dm) (the sequence index
//     is d1 * M + dm, M = T_2 when P = 3 else 1) to X[d1 + R1 dm + S k], with
//     R1 = T_1 (P = 3) or S (P <= 2) and S = n / T_P: for P = 2 that is the
//     four-step's X[k2 + N2 k1].  The inverse's 1/n is applied in this store.
//
// At (8, 2^21) that is two passes (T = 2^10 col, then 2^11 row) instead of
// the six radix-16 passes of the first port: 537 MB through device memory
// instead of 1.61 GB.
//
// A tile is C sequences of T points, C * T = 8192 (64 KB).  A col pass reads
// and writes runs of C consecutive complex64 values (C = 8 at T = 2^10, C = 4
// at 2^11: one 32-byte sector at least); a row pass reads whole sequences and
// writes runs of C.  Each pass is one persistent launch, one 512-thread block
// an SM: thread 0 keeps the next tiles' TMA copies (cp.async.bulk.tensor on a
// 3-D tensor map, `mbarrier` completion) in flight in a two-buffer ring while
// the block transforms the tile before them.  The T-point DFT runs as
// Stockham stages of radix 16 (the first takes the remainder radix 2, 4 or
// 8): each thread holds 16 points, does the butterflies in registers
// (`dft_regs`), and the threads exchange through shared memory between
// stages (a 2^11-point DFT is three register stages and two exchanges).  The
// first stage reads the staged tile and writes a padded work buffer (one slot
// every 16 points, and a sequence stride chosen by C, so that neither the
// exchanges nor the runs of C conflict on banks); the second writes back into
// the staged tile's buffer, swizzled; the last writes device memory straight
// from registers.  No stage writes what it reads, so a tile takes two
// barriers.  T is a template parameter (one kernel per pass kind and T), so
// every shared-memory offset of a thread's points is an immediate.  Shared
// memory (128 KB ring, 68 KB work buffer, 16 KB table of w_T, 2 KB table of
// the second stage's twiddles) holds one block an SM.  Measured on the card
// (scripts/fft_anatomy.py), the copies through device memory alone then take
// about as long as the whole pass.  A col pass may run in place (its tiles
// are disjoint), so three passes need one scratch buffer.
//
// Precision: the products stay f32 FMAs.  Tensor cores do not serve: TF32
// keeps 10 mantissa bits against a 1e-5 bar, and the kernel is bound by bytes
// anyway.  Twiddles w_q^e come from sincospif of the exact fraction 2e/q (q a
// power of two, 2/q built from exponent bits): (float)e is exact while
// e < 2^24, so for every n <= 2^24 (the epilogue's a * k < n) the fraction is
// exact; above that it is rounded once, to 2^-24 of it.  The stages inside a
// tile read their twiddles from two tables each block fills once; the col
// epilogue's w^{a k}, k = m l + kk, is w^{a kk} times the powers of w^{a l}
// by repeated products (`chirp`, at most 15); the in-register DFT uses the
// exact table of exp(-i pi e / 8) (`w16`).  No fast-math intrinsics: build
// without --use_fast_math.

#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TILE = 8192;   // points a tile holds: C sequences of T
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may use
constexpr int PTS = 16;      // points a thread holds through one stage

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(sgn * i * pi * e / 8) for e in [0, 8); sgn = -1 forward, +1 inverse.
__device__ __forceinline__ float2 w16(int e, float sgn) {
    const float c1 = 0.92387953251128673848f;   // cos(pi/8)
    const float s1 = 0.38268343236508977173f;   // sin(pi/8)
    const float h = 0.70710678118654752440f;    // cos(pi/4)
    float c, s;
    switch (e) {
        case 0: c = 1.0f; s = 0.0f; break;
        case 1: c = c1;   s = s1;   break;
        case 2: c = h;    s = h;    break;
        case 3: c = s1;   s = c1;   break;
        case 4: c = 0.0f; s = 1.0f; break;
        case 5: c = -s1;  s = c1;   break;
        case 6: c = -h;   s = h;    break;
        default: c = -c1; s = s1;   break;
    }
    return make_float2(c, sgn * s);
}

// In-register T = 2^LOG point DFT, as LOG radix-2 Stockham stages (the same
// stage algebra as the TPU kernel's `_fft_body`, on T registers).  Stage S
// is a template parameter so every array index is a compile-time constant
// and the arrays stay in registers.
template <int LOG, int S = 0>
__device__ __forceinline__ void dft_regs(float2 (&v)[1 << LOG], float sgn) {
    if constexpr (S < LOG) {
        constexpr int T = 1 << LOG;
        constexpr int l = 1 << S;    // sub-transform length before the stage
        constexpr int d = T / (2 * l);
        float2 u[T];
#pragma unroll
        for (int r = 0; r < d; ++r) {
#pragma unroll
            for (int kk = 0; kk < l; ++kk) {
                const float2 a = v[r * l + kk];
                const float2 b = cmul(v[r * l + kk + T / 2],
                                      w16(kk * (8 / l), sgn));
                u[r * 2 * l + kk] = make_float2(a.x + b.x, a.y + b.y);
                u[r * 2 * l + l + kk] = make_float2(a.x - b.x, a.y - b.y);
            }
        }
#pragma unroll
        for (int i = 0; i < T; ++i) v[i] = u[i];
        dft_regs<LOG, S + 1>(v, sgn);
    }
}

// w_q^e = exp(sgn * 2 pi i e / q) for 0 <= e < q = 2^lq: sincospif of the
// fraction 2e/q (see the note at the top on exactness), 2/q built from its
// exponent bits (no division).
__device__ __forceinline__ float2 twiddle(long long e, int lq, float sgn) {
    float s, c;
    sincospif((float)e * __int_as_float((128 - lq) << 23), &s, &c);
    return make_float2(c, sgn * s);
}

// v[i] *= w0 * w^i for i < R: the powers by repeated products, so that
// only two twiddles are live.
template <int R>
__device__ __forceinline__ void chirp(float2 (&v)[R], float2 w0, float2 w) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
        v[i] = cmul(v[i], w0);
        if (i + 1 < R) w0 = cmul(w0, w);
    }
}

// log2 of the radix of a T-point DFT's first stage: log2 T mod 4, or 4;
// every later stage is radix 16.
__host__ __device__ constexpr int first_log_r(int log_t) {
    return (log_t & 3) ? (log_t & 3) : 4;
}

// The shared-memory slot of point j of a sequence: one pad slot every 16.
__device__ __forceinline__ int pad(int j) { return j + (j >> 4); }

// The slot of point j + i * STEP: the slot of j plus a constant when STEP
// is a multiple of 16 (an immediate offset once i is unrolled).
template <int STEP>
__device__ __forceinline__ int pad_at(int j, int i) {
    if constexpr (STEP % 16 == 0) return pad(j) + i * (STEP + STEP / 16);
    else return pad(j + i * STEP);
}

// Where point j of sequence c of a T-point tile lies once the second of
// three stages has written it back into the staged tile's buffer: [C][T]
// with j's low bits XORed by c * 16 / C, so that the c of a half-warp and
// its aligned runs of consecutive j fall on different banks.
template <int LT>
__device__ __forceinline__ int swz(int c, int j) {
    constexpr int LC = 13 - LT;
    static_assert(LC <= 4, "C <= 16");
    return j ^ ((c << (4 - LC)) & 15);
}

// Entries of the table of w_T^e the last of three stages reads: all T, or
// the first half (w_T^{e + T/2} = -w_T^e) where all would not fit.
__host__ __device__ constexpr int tw_entries(int log_t) {
    return log_t <= 11 ? 1 << log_t : 1 << (log_t - 1);
}

// One pass over the rows, as the wrapper's pass plan gives it.
struct Pass {
    float2* out;
    long long batch, n;
    long long s;        // col: S of the [S, T, A] view; row: n / T
    long long a;        // col: A, the stride of the transformed axis
    int log_a;          // col: log2 A
    long long tiles;    // tiles of C sequences in the pass
    int seq;            // work-buffer slots a sequence takes
    int log_r1, log_m;  // row: R1 and M of the output index
    float sgn, scale;
};

// Sequence c of a row pass's tile that starts at sequence sigma0: where its
// output goes, or false past the last row.
__device__ __forceinline__ bool row_out(const Pass& p, long long sigma0, int c,
                                        long long& out0) {
    const long long sigma = sigma0 + c;
    const long long d1 = sigma & ((1LL << p.log_r1) - 1);
    const long long q = sigma >> p.log_r1;
    const long long dm = q & ((1LL << p.log_m) - 1);
    const long long row = q >> p.log_m;
    out0 = row * p.n + d1 + (dm << p.log_r1);
    return row < p.batch;
}

// TMA boxes: at most 256 points along a dimension.
__device__ __forceinline__ int box_log(int log_e) {
    return log_e < 8 ? log_e : 8;
}

// One thread asks TMA for tile `t` into `dst`, completion on `bar`.  A col
// tile is rows j < T of the C inner indices from a0 of slab rs of the map
// [S * batch][T][A], in boxes of up to 256 rows; a row tile is the C
// sequences from sigma0 of the map [batch * R1][M][T] (sequence (row, dm,
// d1) is at (row * R1 + d1, dm)), in boxes of up to 256 whole sequences, or
// of 256 points of one sequence when T > 256.  Not inlined: only thread 0
// runs it, and its loop stays out of the other threads' registers.
template <bool COL>
__device__ __noinline__ void load_tile(const CUtensorMap* map, float2* dst,
                                       uint64_t* bar, long long t, int log_t,
                                       int log_c, int log_a, int log_r1,
                                       int log_m) {
    hopper::mbar_arrive_expect_tx(bar, (uint32_t)(8u << (log_t + log_c)));
    const int lb = box_log(log_t);
    if constexpr (COL) {
        const int lper = log_a - log_c;              // tiles a slab
        const int rs = (int)(t >> lper);
        const int a0 = (int)((t & ((1LL << lper) - 1)) << log_c);
        for (int b = 0; b < (1 << (log_t - lb)); ++b)
            hopper::tma_load_3d(dst + (b << (lb + log_c)), map, bar, a0,
                                b << lb, rs);
    } else {
        const long long sigma0 = t << log_c;
        const int d1 = (int)(sigma0 & ((1LL << log_r1) - 1));
        const long long q = sigma0 >> log_r1;
        const int dm = (int)(q & ((1LL << log_m) - 1));
        const int z0 = (int)(((q >> log_m) << log_r1) + d1);
        // box (B, 1, Z): B points of Z sequences
        const int lz = log_t > 8 ? 0 : box_log(log_c);
        const int lnb = log_t - lb;                  // boxes a sequence
        for (int i = 0; i < (1 << (log_c - lz + lnb)); ++i) {
            const int b = i & ((1 << lnb) - 1), z = i >> lnb;
            hopper::tma_load_3d(dst + ((z << (lz + log_t)) + (b << lb)), map,
                                bar, b << lb, dm, z0 + (z << lz));
        }
    }
}

// One radix-R Stockham stage of the tile's C T-point DFTs (R = 2^LOGR,
// T = 2^LT, l = 2^LL).  Before it, each sequence viewed as [T/l, l] holds in
// row rho the l-point DFT of its points rho :: T/l.  Group g = r*l + kk
// (kk < l) takes points g + i*T/R (i < R), twiddles point i by w_{lR}^{i kk},
// does the R-point DFT, and writes output m to r*l*R + m*l + kk.  The first
// stage reads the staged tile (a col tile is [T][C], a row tile [C][T]) and
// writes the padded work buffer; the second reads the work buffer and, with
// a third to come, writes the staged tile's buffer back, swizzled (SW); the
// last writes device memory.  No stage writes what it reads, so a thread
// takes its groups one at a time.  Threads take (sequence c, group g) with c
// fastest, so that device memory sees runs of C; a row pass's first stage
// takes g fastest, so that it reads along the staged rows.  T, C and the
// stage are compile-time, so the shared-memory offsets of a group's points
// are immediates.
template <int LOGR, int LL, bool FIRST, bool LAST, bool COL, int LT>
__device__ __forceinline__ void stage(const Pass& p, float2* staged,
                                      float2* work, const float2* tw,
                                      const float2* tw2, long long base,
                                      long long off) {
    constexpr int NT = TILE / PTS;
    constexpr int LC = 13 - LT;          // C = 2^LC sequences a tile
    constexpr int R = 1 << LOGR;
    constexpr int U = PTS / R;           // groups a thread takes
    constexpr int LG = LT - LOGR;        // T / R groups a sequence
    constexpr int G = 1 << LG;
    constexpr int l = 1 << LL;
    static_assert((1 << (LT + LC)) == TILE && LL + LOGR <= LT, "tile shape");
    // unit u of this thread is sequence c, group g
    const auto unit = [&](int u, int& c, int& g) {
        const int i = threadIdx.x + NT * u;
        if constexpr (!COL && FIRST) {
            g = i & (G - 1);
            c = i >> LG;
        } else {
            c = i & ((1 << LC) - 1);
            g = i >> LC;
        }
    };
    const auto compute = [&](int u, float2 (&v)[R]) {
        int c, g;
        unit(u, c, g);
        if constexpr (FIRST) {
            const float2* src = staged
                + (COL ? (g << LC) + c : (c << LT) + g);
#pragma unroll
            for (int i = 0; i < R; ++i) v[i] = src[i * (COL ? G << LC : G)];
        } else if constexpr (LAST && LT > 8) {
            // the third stage: the second's output, swizzled
            const float2* src = staged + (c << LT);
#pragma unroll
            for (int i = 0; i < R; ++i) v[i] = src[swz<LT>(c, g + i * G)];
        } else {
            const float2* src = work + c * p.seq;
#pragma unroll
            for (int i = 0; i < R; ++i) v[i] = src[pad_at<G>(g, i)];
        }
        if constexpr (LL > 0) {
            const int kk = g & (l - 1);
            if constexpr (LL == first_log_r(LT)) {
                // the second stage: w_{lR}^{i kk} at [i l + kk]
                const float2* w = tw2 + kk;
#pragma unroll
                for (int i = 1; i < R; ++i) v[i] = cmul(v[i], w[i << LL]);
            } else {
                // the last of three stages (lR = T): w_T^{i kk}
                static_assert(LL + LOGR == LT, "three stages at most");
#pragma unroll
                for (int i = 1; i < R; ++i) {
                    if constexpr (tw_entries(LT) == (1 << LT)) {
                        v[i] = cmul(v[i], tw[i * kk]);
                    } else {
                        const int e = i * kk, half = 1 << (LT - 1);
                        const float2 w = tw[e & (half - 1)];
                        v[i] = cmul(v[i], e & half ? make_float2(-w.x, -w.y)
                                                   : w);
                    }
                }
            }
        }
        dft_regs<LOGR>(v, p.sgn);
        if constexpr (COL && LAST) {
            // l * R == T: g = kk < l, and output m is point k = m*l + g,
            // times w_{TA}^{a k}
            const long long a = off + c;
            const int lq = p.log_a + LT;
            const float2 w0 = twiddle(a * g, lq, p.sgn);
            chirp<R>(v, w0, twiddle(a << LL, lq, p.sgn));
        }
    };
    const auto store = [&](int u, const float2 (&v)[R]) {
        int c, g;
        unit(u, c, g);
        if constexpr (LAST) {
            if constexpr (COL) {
                float2* dst = p.out + (base + off + c + g * p.a);
                const long long step = p.a << LL;       // l rows
#pragma unroll
                for (int m = 0; m < R; ++m) dst[m * step] = v[m];
            } else {
                long long out0;
                if (row_out(p, off, c, out0)) {
                    float2* dst = p.out + (out0 + g * p.s);
                    const long long step = p.s << LL;
#pragma unroll
                    for (int m = 0; m < R; ++m)
                        dst[m * step] = make_float2(v[m].x * p.scale,
                                                    v[m].y * p.scale);
                }
            }
        } else if constexpr (FIRST) {
            float2* dst = work + c * p.seq;
            const int r = g >> LL, kk = g & (l - 1);
#pragma unroll
            for (int m = 0; m < R; ++m)
                dst[pad_at<l>(((r << LOGR) << LL) + kk, m)] = v[m];
        } else {
            float2* dst = staged + (c << LT);
            const int r = g >> LL, kk = g & (l - 1);
#pragma unroll
            for (int m = 0; m < R; ++m)
                dst[swz<LT>(c, (((r << LOGR) + m) << LL) + kk)] = v[m];
        }
    };
#pragma unroll
    for (int u = 0; u < U; ++u) {
        float2 v[R];
        compute(u, v);
        store(u, v);
    }
}

// Shared memory of a block: two staging tiles (the TMA ring), the padded
// work buffer, the table of w_T^e, the second stage's table of w_{16 l}^{i
// kk} (16 l <= 256 entries), and the ring's barriers (two full, two empty).
constexpr int TW2 = 256;
__host__ __device__ constexpr size_t smem_bytes(int seq, int log_c, int log_t) {
    return 2 * TILE * sizeof(float2)
        + (((size_t)seq << log_c) * sizeof(float2) + 127) / 128 * 128
        + ((size_t)tw_entries(log_t) * sizeof(float2) + 127) / 128 * 128
        + TW2 * sizeof(float2) + 4 * 8;
}

// One pass, persistent: block b takes tiles b, b + grid, ...  Thread 0 keeps
// the next tiles' TMA copies in flight: tile k lands in staging buffer k % 2,
// and the copy of tile k + 2 starts into the same buffer once tile k is done
// with it: after the first stage (one or two stages), or after the third
// (which reads the second's output there) while the other threads go on to
// tile k + 1.  Two barriers a tile.  A col tile is C consecutive inner
// indices a of one [T, A] slab (base = the slab's first point, off = the
// first a); a row tile is C consecutive sequences (off = the first one's
// index).
template <bool COL, int LT>
__global__ void __launch_bounds__(TILE / PTS, 1)
four_step_pass(const __grid_constant__ CUtensorMap map, Pass p) {
    constexpr int NT = TILE / PTS, LC = 13 - LT;
    constexpr int L0 = first_log_r(LT), STAGES = (LT + 3) / 4;
    extern __shared__ __align__(128) unsigned char smem[];
    float2* ring = reinterpret_cast<float2*>(smem);
    float2* work = ring + 2 * TILE;
    float2* tw = work + (((p.seq << LC) + 15) & ~15);
    float2* tw2 = tw + ((tw_entries(LT) + 15) & ~15);
    uint64_t* full = reinterpret_cast<uint64_t*>(
        smem + smem_bytes(p.seq, LC, LT) - 4 * 8);
    uint64_t* empty = full + 2;
    for (int e = threadIdx.x; e < tw_entries(LT); e += NT)
        tw[e] = twiddle(e, LT, p.sgn);
    for (int e = threadIdx.x; e < (16 << L0); e += NT)
        tw2[e] = twiddle((e >> L0) * (e & ((1 << L0) - 1)), L0 + 4, p.sgn);
    if (threadIdx.x == 0) {
        hopper::mbar_init(&full[0], 1);
        hopper::mbar_init(&full[1], 1);
        hopper::mbar_init(&empty[0], NT);
        hopper::mbar_init(&empty[1], NT);
        hopper::fence_barrier_init();
        for (int k = 0; k < 2; ++k) {
            const long long t = blockIdx.x + (long long)k * gridDim.x;
            if (t < p.tiles)
                load_tile<COL>(&map, ring + k * TILE, &full[k], t, LT, LC,
                               p.log_a, p.log_r1, p.log_m);
        }
    }
    __syncthreads();
    int k = 0;
    for (long long t = blockIdx.x; t < p.tiles; t += gridDim.x, ++k) {
        const int b = k & 1;
        long long base = 0, off;
        if constexpr (COL) {
            const int lper = p.log_a - LC;          // tiles a slab
            base = (t >> lper) << (p.log_a + LT);
            off = (t & ((1LL << lper) - 1)) << LC;
        } else {
            off = t << LC;
        }
        hopper::mbar_wait(&full[b], (k >> 1) & 1);
        float2* in = ring + b * TILE;
        stage<L0, 0, true, STAGES == 1, COL, LT>(p, in, work, tw, tw2, base,
                                                 off);
        __syncthreads();   // the work buffer is written (the tile is read)
        const long long next = t + 2LL * gridDim.x;
        if constexpr (STAGES < 3) {
            // the staged tile is read: start the copy of tile k + 2 into
            // its buffer
            if (threadIdx.x == 0 && next < p.tiles) {
                hopper::fence_proxy_async();
                load_tile<COL>(&map, in, &full[b], next, LT, LC, p.log_a,
                               p.log_r1, p.log_m);
            }
        }
        if constexpr (STAGES == 2) {
            stage<4, L0, false, true, COL, LT>(p, in, work, tw, tw2, base,
                                               off);
            __syncthreads();   // the work buffer is read: the next tile's
                               // first stage may write it
        }
        if constexpr (STAGES == 3) {
            stage<4, L0, false, false, COL, LT>(p, in, work, tw, tw2, base,
                                                off);
            __syncthreads();   // the staged buffer is written (and the work
                               // buffer read)
            stage<4, L0 + 4, false, true, COL, LT>(p, in, work, tw, tw2, base,
                                                   off);
            // the staged buffer is read once every thread has arrived:
            // thread 0 waits for that before the copy of tile k + 2 goes
            // into it, while the others go on to tile k + 1
            hopper::mbar_arrive(&empty[b]);
            if (threadIdx.x == 0 && next < p.tiles) {
                hopper::mbar_wait(&empty[b], (k >> 1) & 1);
                hopper::fence_proxy_async();
                load_tile<COL>(&map, in, &full[b], next, LT, LC, p.log_a,
                               p.log_r1, p.log_m);
            }
        }
    }
}

template <bool COL, int LT>
cudaError_t launch(const CUtensorMap& map, const Pass& p, cudaStream_t stream) {
    // per device, once: the SM count (the persistent grid) and the largest
    // dynamic shared memory a block of this kernel may ask for
    static int sms[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (sms[dev] == 0) {
        int count = 0;
        e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                   dev);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                four_step_pass<COL, LT>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (e != cudaSuccess) return e;
        sms[dev] = count;
    }
    const long long grid = p.tiles < sms[dev] ? p.tiles : sms[dev];
    four_step_pass<COL, LT><<<(unsigned)grid, TILE / PTS,
                              smem_bytes(p.seq, 13 - LT, LT), stream>>>(map,
                                                                        p);
    return cudaGetLastError();
}

// The kernel of a T = 2^log_t pass (log_t 1 ... 12).
template <bool COL>
cudaError_t launch_t(int log_t, const CUtensorMap& map, const Pass& p,
                     cudaStream_t stream) {
    switch (log_t) {
        case 1: return launch<COL, 1>(map, p, stream);
        case 2: return launch<COL, 2>(map, p, stream);
        case 3: return launch<COL, 3>(map, p, stream);
        case 4: return launch<COL, 4>(map, p, stream);
        case 5: return launch<COL, 5>(map, p, stream);
        case 6: return launch<COL, 6>(map, p, stream);
        case 7: return launch<COL, 7>(map, p, stream);
        case 8: return launch<COL, 8>(map, p, stream);
        case 9: return launch<COL, 9>(map, p, stream);
        case 10: return launch<COL, 10>(map, p, stream);
        case 11: return launch<COL, 11>(map, p, stream);
        case 12: return launch<COL, 12>(map, p, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// One pass of the wrapper's plan (`kernel.py` `pass_plan`) over `batch` rows
// of `n` complex64 values (interleaved re/im, 16-byte aligned), reading `in`
// and writing `out` (the same buffer only for a col pass).  col != 0: the
// [s, 2^log_t, a] col pass; else the row pass of 2^log_t-point sequences
// with s = n / 2^log_t and the output digits R1 = 2^log_r1, M = 2^log_m.  A
// tile holds 2^log_c sequences (TILE points), each `seq` slots of the work
// buffer.  `scale` multiplies the row pass's outputs.  Returns the CUDA error
// code of the launch: 0 = success; cudaErrorInvalidValue for arguments the
// plan cannot give or a tensor map that cannot be encoded.
extern "C" int fft_stage_pass(const void* in, void* out, long long batch,
                              long long n, int col, int log_t, long long s,
                              long long a, int log_r1, int log_m, int log_c,
                              int seq, int inverse, float scale,
                              void* stream) {
    Pass p;
    p.out = static_cast<float2*>(out);
    p.batch = batch;
    p.n = n;
    p.s = s;
    p.a = col ? a : 1;
    p.log_a = 63 - __builtin_clzll((unsigned long long)p.a);
    p.seq = seq;
    p.log_r1 = col ? 0 : log_r1;
    p.log_m = col ? 0 : log_m;
    p.sgn = inverse ? 1.0f : -1.0f;
    p.scale = scale;
    const long long t = 1LL << log_t, c = 1LL << log_c;
    const bool staged = log_t > 4;                 // more than one stage
    if (batch <= 0 || log_t < 1 || log_t > 12 || log_c < 0 || s < 1
        || (t << log_c) != TILE
        || (staged && seq < t + t / 16)
        || smem_bytes(seq, log_c, log_t) > SMEM_LIMIT
        || ((uintptr_t)in | (uintptr_t)out) % 16 != 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    CUtensorMap map;
    const cuuint32_t lb = log_t < 8 ? log_t : 8;
    if (col) {
        if ((a & (a - 1)) != 0 || a < c || c > 256 || s * t * a != n)
            return (int)cudaErrorInvalidValue;
        p.tiles = batch * s * (a / c);
        const cuuint64_t dims[3] = {(cuuint64_t)a, (cuuint64_t)t,
                                    (cuuint64_t)(s * batch)};
        const cuuint64_t strides[2] = {(cuuint64_t)a * 8,
                                       (cuuint64_t)(t * a * 8)};
        const cuuint32_t box[3] = {(cuuint32_t)c, 1u << lb, 1};
        const cudaError_t e = hopper::tensor_map_c64(&map, in, dims, strides,
                                                     box);
        return e != cudaSuccess ? (int)e
                                : (int)launch_t<true>(log_t, map, p, st);
    }
    const long long r1 = 1LL << log_r1, m = 1LL << log_m;
    if (s * t != n || r1 * m != s || (s > 1 && r1 < c))
        return (int)cudaErrorInvalidValue;
    p.tiles = (batch * s + c - 1) / c;
    const cuuint64_t dims[3] = {(cuuint64_t)t, (cuuint64_t)m,
                                (cuuint64_t)(batch * r1)};
    const cuuint64_t strides[2] = {(cuuint64_t)t * 8, (cuuint64_t)(m * t * 8)};
    const cuuint32_t box[3] = {
        1u << lb, 1, log_t > 8 ? 1u : 1u << (log_c < 8 ? log_c : 8)};
    const cudaError_t e = hopper::tensor_map_c64(&map, in, dims, strides, box);
    return e != cudaSuccess ? (int)e : (int)launch_t<false>(log_t, map, p, st);
}

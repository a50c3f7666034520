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
// arithmetic is about 9.9 GFLOP: C B^T once per (b, group, chunk) and three
// L x L x P / L x N x P products per (b, h, chunk) (148 us at the data
// sheet's 67 TFLOP/s f32), against about 113 MB that must move once (x, dt,
// b, c read; y, state written: 34 us at 3.35 TB/s).  It is bound by
// operations, and in f32: the reference's 1e-4 bar rules out bf16 and TF32
// tensor-core operands (10-bit mantissas), so the products run on the CUDA
// cores as FMAs.
//
// What this design does about it (a simple kernel that is right first):
// * One block of 256 threads per (b, h, slice of PB columns of P).  The
//   TPU grid's sequential chunk axis becomes a loop inside the block; the
//   [N, PB] state is carried across it in registers (4 rows x PB/8 columns
//   a thread) and never goes through device memory between chunks.
//   Columns of y and of the state are independent, so P may be split over
//   blocks (the wrapper picks PB in 16/32/64 so the grid fills the card);
//   each slice recomputes C B^T and the decays.
// * Per chunk the block stages C, B (row stride N + 4 floats, so the float4
//   fragment loads below are free of bank conflicts), x, dt and the state in
//   shared memory, one warp scans cum, and the products run as register
//   microtiles: rows tr + 32k (k < 4) by 4 columns of a 32-wide strip of M,
//   or by PB/8 columns of y and the state.
// * M = (C B^T) o decay is built in strips of 32 key columns and consumed
//   at once (y += M_strip x_strip), so the L x L matrix never exists whole
//   (full-width staging of C, B, x, M and the state would take 256 KB of the
//   227 KB a block may use).  Row slots wholly above a strip (causally
//   masked) are skipped.  The mask is applied before the exponent: entries
//   j > i are 0, never exp(+large).
// * A ragged tail (S not a multiple of L) is masked: rows at or past S load
//   x = 0, dt = 0, b = c = 0, so they add nothing and decay nothing, and y
//   is not written there.  The TPU kernel reads past the end (ROADMAP C).
// C B^T is recomputed for every head of a group (24x at the main shape);
// sharing it, the two-pass SSD (chunk states in parallel, then a scan over
// chunks) and 3xTF32 tensor-core products are later work.
//
// Precision: expf (no fast math: build without --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int SLOTS = 4;        // row slots: rows tr + 32k, k < SLOTS
constexpr int JS = 32;          // strip width of M
constexpr int MS = JS + 4;      // row stride of the M strip in shared memory
constexpr int MAX_L = 32 * SLOTS;
constexpr int MAX_N = 32 * SLOTS;

struct Params {
    const void* x;
    const float* dt;
    const float* a;
    const void* b;
    const void* c;
    void* y;
    float* state;
    int S, H, P, G, N, L, splits;
    long long sxb, sxs, sxh;    // x strides in elements (unit stride along P)
    long long sdb, sds, sdh;    // dt strides
    long long sbb, sbs, sbg;    // b strides (unit stride along N)
    long long scb, scs, scg;    // c strides
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
    *o = __float2bfloat16(v);
}

// CPT consecutive floats from shared memory (16-byte or 8-byte aligned).
template <int CPT>
__device__ __forceinline__ void load_cols(const float* src, float* dst) {
    if constexpr (CPT % 4 == 0) {
#pragma unroll
        for (int q = 0; q < CPT; q += 4) {
            const float4 v = *reinterpret_cast<const float4*>(src + q);
            dst[q] = v.x; dst[q + 1] = v.y; dst[q + 2] = v.z; dst[q + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int q = 0; q < CPT; q += 2) {
            const float2 v = *reinterpret_cast<const float2*>(src + q);
            dst[q] = v.x; dst[q + 1] = v.y;
        }
    }
}

__device__ __forceinline__ float comp(const float4& v, int u) {
    return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// One block per (b, h, column slice); CPT = PB / 8 columns per thread.
template <typename T, int CPT>
__global__ void __launch_bounds__(THREADS, 1) ssd_kernel(Params p) {
    constexpr int PB = 8 * CPT;
    const int split = blockIdx.x % p.splits;
    const int bh = blockIdx.x / p.splits;
    const int h = bh % p.H;
    const int b = bh / p.H;
    const int g = h / (p.H / p.G);
    const int p0 = split * PB;
    const int L = p.L, N = p.N, NS = p.N + 4;
    const int Lp = (L + 31) & ~31;          // staged rows, zero past S

    extern __shared__ float4 smem4[];
    float* Cs = reinterpret_cast<float*>(smem4);    // [Lp][NS]
    float* Bs = Cs + Lp * NS;                       // [Lp][NS]
    float* xs = Bs + Lp * NS;                       // [Lp][PB]
    float* sts = xs + Lp * PB;                      // [N][PB]
    float* Ms = sts + N * PB;                       // [Lp][MS]
    float* dts = Ms + Lp * MS;                      // [Lp]
    float* cums = dts + Lp;                         // [Lp]
    float* ws = cums + Lp;                          // [Lp]

    const int t = threadIdx.x;
    const int warp = t >> 5, lane = t & 31;
    // a warp holds 8 consecutive rows by 4 consecutive column groups
    const int tr = (lane & 7) + 8 * (warp & 3);     // 0..31
    const int tc = (lane >> 3) + 4 * (warp >> 2);   // 0..7
    const int pc = tc * CPT;                        // first column of thread

    const T* xg = static_cast<const T*>(p.x) + b * p.sxb + h * p.sxh + p0;
    const float* dtg = p.dt + b * p.sdb + h * p.sdh;
    const T* bg = static_cast<const T*>(p.b) + b * p.sbb + g * p.sbg;
    const T* cg = static_cast<const T*>(p.c) + b * p.scb + g * p.scg;
    T* yg = static_cast<T*>(p.y) + ((long long)b * p.S * p.H + h) * p.P + p0;
    const float a_h = p.a[h];

    float st[SLOTS][CPT];           // state rows tr + 32k, columns pc + q
#pragma unroll
    for (int k = 0; k < SLOTS; ++k)
#pragma unroll
        for (int q = 0; q < CPT; ++q) st[k][q] = 0.f;

    const int nc = (p.S + L - 1) / L;
    for (int ck = 0; ck < nc; ++ck) {
        const int t0 = ck * L;
        const int valid = min(L, p.S - t0);

        // ---- stage the chunk (zero past S) and the carried state --------
        for (int e = t; e < Lp * N; e += THREADS) {
            const int j = e / N, n = e - j * N;
            float cv = 0.f, bv = 0.f;
            if (j < valid) {
                cv = to_f(cg[(t0 + j) * p.scs + n]);
                bv = to_f(bg[(t0 + j) * p.sbs + n]);
            }
            Cs[j * NS + n] = cv;
            Bs[j * NS + n] = bv;
        }
        for (int e = t; e < Lp * PB; e += THREADS) {
            const int j = e / PB, q = e - j * PB;
            xs[e] = j < valid ? to_f(xg[(t0 + j) * p.sxs + q]) : 0.f;
        }
        for (int j = t; j < Lp; j += THREADS)
            dts[j] = j < valid ? dtg[(t0 + j) * p.sds] : 0.f;
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            const int n = tr + 32 * k;
            if (n < N) {
#pragma unroll
                for (int q = 0; q < CPT; ++q) sts[n * PB + pc + q] = st[k][q];
            }
        }
        __syncthreads();

        // ---- cum = cumsum(dt * a) over the chunk: one warp, 4 rows a lane
        if (warp == 0) {
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
                    ws[j] = expf(cum_last - cj) * dts[j];
                }
            }
        }
        __syncthreads();
        // rows past the chunk's end have dt = 0: cum there is cum_L
        const float cum_L = cums[Lp - 1];

        // ---- inter: y = exp(cum_i) (C state) -----------------------------
        float yacc[SLOTS][CPT];
#pragma unroll
        for (int k = 0; k < SLOTS; ++k)
#pragma unroll
            for (int q = 0; q < CPT; ++q) yacc[k][q] = 0.f;
        for (int n = 0; n < N; n += 4) {
            float4 cv[SLOTS];
#pragma unroll
            for (int k = 0; k < SLOTS; ++k)
                if (32 * k < Lp)
                    cv[k] = *reinterpret_cast<const float4*>(
                        Cs + (tr + 32 * k) * NS + n);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                float sv[CPT];
                load_cols<CPT>(sts + (n + u) * PB + pc, sv);
#pragma unroll
                for (int k = 0; k < SLOTS; ++k)
                    if (32 * k < Lp) {
                        const float cu = comp(cv[k], u);
#pragma unroll
                        for (int q = 0; q < CPT; ++q)
                            yacc[k][q] = fmaf(cu, sv[q], yacc[k][q]);
                    }
            }
        }
#pragma unroll
        for (int k = 0; k < SLOTS; ++k)
            if (32 * k < Lp) {
                const float e = expf(cums[tr + 32 * k]);
#pragma unroll
                for (int q = 0; q < CPT; ++q) yacc[k][q] *= e;
            }

        // ---- state = exp(cum_L) state + (B o w)^T x (registers) -----------
        {
            const float decay = expf(cum_L);
#pragma unroll
            for (int k = 0; k < SLOTS; ++k)
#pragma unroll
                for (int q = 0; q < CPT; ++q) st[k][q] *= decay;
            for (int j = 0; j < valid; ++j) {
                float xv[CPT];
                load_cols<CPT>(xs + j * PB + pc, xv);
                const float wj = ws[j];
#pragma unroll
                for (int q = 0; q < CPT; ++q) xv[q] *= wj;
#pragma unroll
                for (int k = 0; k < SLOTS; ++k)
                    if (tr + 32 * k < N) {
                        const float bv = Bs[j * NS + tr + 32 * k];
#pragma unroll
                        for (int q = 0; q < CPT; ++q)
                            st[k][q] = fmaf(bv, xv[q], st[k][q]);
                    }
            }
        }

        // ---- intra: y += M x, M built and consumed in 32-column strips ----
        for (int s = 0; 32 * s < valid; ++s) {
            const int j0 = 32 * s;
            float acc[SLOTS][4];
#pragma unroll
            for (int k = 0; k < SLOTS; ++k)
#pragma unroll
                for (int u = 0; u < 4; ++u) acc[k][u] = 0.f;
            for (int n = 0; n < N; n += 4) {
                float4 bv[4];
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    bv[u] = *reinterpret_cast<const float4*>(
                        Bs + (j0 + tc + 8 * u) * NS + n);
#pragma unroll
                for (int k = 0; k < SLOTS; ++k)
                    if (k >= s && 32 * k < Lp) {
                        const float4 cv = *reinterpret_cast<const float4*>(
                            Cs + (tr + 32 * k) * NS + n);
#pragma unroll
                        for (int u = 0; u < 4; ++u)
                            acc[k][u] = fmaf(cv.x, bv[u].x, fmaf(cv.y, bv[u].y,
                                        fmaf(cv.z, bv[u].z, fmaf(cv.w, bv[u].w,
                                        acc[k][u]))));
                    }
            }
#pragma unroll
            for (int k = 0; k < SLOTS; ++k)
                if (k >= s && 32 * k < Lp) {
                    const int i = tr + 32 * k;
                    const float ci = cums[i];
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        const int jj = tc + 8 * u, j = j0 + jj;
                        // masked before the exponent
                        Ms[i * MS + jj] = j <= i
                            ? acc[k][u] * expf(ci - cums[j]) * dts[j] : 0.f;
                    }
                }
            __syncthreads();
#pragma unroll
            for (int jj = 0; jj < JS; jj += 4) {
                float4 mv[SLOTS];
#pragma unroll
                for (int k = 0; k < SLOTS; ++k)
                    if (k >= s && 32 * k < Lp)
                        mv[k] = *reinterpret_cast<const float4*>(
                            Ms + (tr + 32 * k) * MS + jj);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    float xv[CPT];
                    load_cols<CPT>(xs + (j0 + jj + u) * PB + pc, xv);
#pragma unroll
                    for (int k = 0; k < SLOTS; ++k)
                        if (k >= s && 32 * k < Lp) {
                            const float mu = comp(mv[k], u);
#pragma unroll
                            for (int q = 0; q < CPT; ++q)
                                yacc[k][q] = fmaf(mu, xv[q], yacc[k][q]);
                        }
                }
            }
            __syncthreads();
        }

        // ---- y for the chunk's rows below S -------------------------------
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            const int i = tr + 32 * k;
            if (i < valid) {
                T* row = yg + (long long)(t0 + i) * p.H * p.P + pc;
#pragma unroll
                for (int q = 0; q < CPT; ++q) store(row + q, yacc[k][q]);
            }
        }
        // the staging of the next chunk overwrites what this one read
        __syncthreads();
    }

    float* sg = p.state + ((long long)b * p.H + h) * N * p.P + p0 + pc;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
        const int n = tr + 32 * k;
        if (n < N) {
#pragma unroll
            for (int q = 0; q < CPT; ++q) sg[(long long)n * p.P + q] = st[k][q];
        }
    }
}

// At the limits (L 128, N 128, PB 64) a block takes 220,672 bytes of the
// 232,448 it may use.
size_t smem_bytes(int L, int N, int PB) {
    const int Lp = (L + 31) & ~31;
    return sizeof(float) * ((size_t)2 * Lp * (N + 4) + (size_t)Lp * PB
                            + (size_t)N * PB + (size_t)Lp * MS + 3 * Lp);
}

template <typename T, int CPT>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
    const size_t smem = smem_bytes(p.L, p.N, 8 * CPT);
    auto kern = ssd_kernel<T, CPT>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kern<<<B * p.H * p.splits, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int PB, cudaStream_t s) {
    switch (PB) {
        case 16: return launch<T, 2>(p, B, s);
        case 32: return launch<T, 4>(p, B, s);
        case 64: return launch<T, 8>(p, B, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, b, c and y).  Strides in elements.
extern "C" int ssd_scan(const void* x, const void* dt, const void* a,
                        const void* b, const void* c, void* y, void* state,
                        int dtype, int B, int S, int H, int P, int G, int N,
                        int L, int PB, long long sxb, long long sxs,
                        long long sxh, long long sdb, long long sds,
                        long long sdh, long long sbb, long long sbs,
                        long long sbg, long long scb, long long scs,
                        long long scg, void* stream) {
    if (B < 1 || S < 1 || H < 1 || G < 1 || H % G != 0 || L < 1
        || L > MAX_L || N < 4 || N > MAX_N || N % 4 != 0 || PB < 16
        || P % PB != 0 || (long long)B * H * (P / PB) > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    Params p{x, static_cast<const float*>(dt), static_cast<const float*>(a),
             b, c, y, static_cast<float*>(state), S, H, P, G, N, L, P / PB,
             sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, sbg, scb, scs, scg};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)dispatch<float>(p, B, PB, s);
    if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, B, PB, s);
    return (int)cudaErrorInvalidValue;
}

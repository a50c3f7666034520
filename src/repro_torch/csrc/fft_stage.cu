// fft_stage: batched complex64 FFT along the last axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel `fft_planes` (src/repro/kernels/fft_stage/kernel.py:64,
// body `_fft_body`/`_fft_kernel`): a batched radix-2 Stockham FFT with no
// bit-reversal pass, the inverse scaled by 1/n.  The TPU design keeps a whole
// row in VMEM and runs all log2(n) stages there.  On the H100 a block has at
// most 227 KB of shared memory, while the rows of the main path (the BSP FFT
// at N = 2^24 over p = 8 processes) are 2^21 points, 16 MiB each.
//
// What bounds it on this card: memory.  One (8, 2^21) transform must read and
// write 2^24 complex64 values (268 MB, ~80 us at 3.35 TB/s); its 5 n log2 n
// flops (1.76 GFLOP, ~26 us at 67 TFLOP/s fp32) are a third of that.
//
// What this design does about it: the log2(n) radix-2 stages are grouped into
// passes of up to four, each pass a radix-16 (or 2, 4, 8 for the remainder)
// Stockham step over device memory.  A thread loads its 16 inputs, applies the
// pass's twiddles, does the 16-point DFT in registers as four radix-2 stages,
// and stores 16 outputs, so a 2^21-point row costs 6 round trips through
// device memory instead of 21.  Loads are coalesced in every pass; stores are
// coalesced once the sub-transform length L reaches a warp.  The wrapper
// ping-pongs between the output and one scratch buffer it allocates.  Fewer
// passes (a four-step split with shared-memory sub-transforms, TMA) are later
// work.
//
// Precision: twiddles come from sincospif of an exact fraction and from a
// table of exp(-i*pi*e/8); no fast-math intrinsics.  Build without
// --use_fast_math.
//
// Pass algebra (Stockham, decimation in time).  Before a pass of radix T the
// row, viewed as [n/L, L], holds in row rho the L-point DFT of x[rho :: n/L].
// With D = n/(L*T) and, for r < D, k < L, m < T:
//   out[r*L*T + m*L + k] = sum_j w_{LT}^{j*k} * in[(r + j*D)*L + k] * w_T^{j*m}
// i.e. twiddle input j by w_{LT}^{jk}, then a T-point DFT over j.  The input
// address is g + j*(n/T) with g = r*L + k, so consecutive threads (consecutive
// g) read consecutive addresses for every L.

#include <cuda_runtime.h>

namespace {

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

template <int LOG>
__global__ void __launch_bounds__(256)
stockham_pass(const float2* __restrict__ in, float2* __restrict__ out,
              long long n, long long L, long long total, float sgn,
              float scale) {
    constexpr int T = 1 << LOG;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const long long groups = n / T;            // butterfly groups per row
    const long long row = t / groups;
    const long long g = t - row * groups;      // g = r*L + k
    const long long k = g & (L - 1);
    const long long r = g / L;
    const float2* src = in + row * n;
    float2* dst = out + row * n;

    float2 v[T];
#pragma unroll
    for (int j = 0; j < T; ++j) v[j] = src[g + j * groups];

    if (L > 1) {
        // w_{LT}^{jk} = exp(sgn * i * pi * x), x = 2jk/(LT) in [0, 2):
        // exact in float while jk < 2^24
        const double unit = 2.0 / (double)(L * T);
#pragma unroll
        for (int j = 1; j < T; ++j) {
            float s, c;
            sincospif((float)((double)(j * k) * unit), &s, &c);
            v[j] = cmul(v[j], make_float2(c, sgn * s));
        }
    }

    dft_regs<LOG>(v, sgn);

    float2* o = dst + r * L * T + k;
#pragma unroll
    for (int m = 0; m < T; ++m)
        o[m * L] = make_float2(v[m].x * scale, v[m].y * scale);
}

template <int LOG>
cudaError_t launch(const float2* in, float2* out, long long batch,
                   long long n, long long L, float sgn, float scale,
                   cudaStream_t stream) {
    const long long total = batch * (n >> LOG);
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    stockham_pass<LOG><<<(unsigned)blocks, threads, 0, stream>>>(
        in, out, n, L, total, sgn, scale);
    return cudaGetLastError();
}

}  // namespace

// One radix-`radix` Stockham pass over `batch` rows of `n` complex64 values
// (interleaved re/im), reading `in` and writing `out` (distinct buffers).
// `L` is the sub-transform length the rows already hold; `scale` multiplies
// every output.  Returns the CUDA error code of the launch (0 = success).
extern "C" int fft_stage_pass(const void* in, void* out, long long batch,
                              long long n, long long L, int radix,
                              int inverse, float scale, void* stream) {
    const float sgn = inverse ? 1.0f : -1.0f;
    const float2* x = static_cast<const float2*>(in);
    float2* y = static_cast<float2*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (batch <= 0 || n < radix || L < 1 || (n % (L * radix)) != 0)
        return (int)cudaErrorInvalidValue;
    switch (radix) {
        case 2: return (int)launch<1>(x, y, batch, n, L, sgn, scale, s);
        case 4: return (int)launch<2>(x, y, batch, n, L, sgn, scale, s);
        case 8: return (int)launch<3>(x, y, batch, n, L, sgn, scale, s);
        case 16: return (int)launch<4>(x, y, batch, n, L, sgn, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

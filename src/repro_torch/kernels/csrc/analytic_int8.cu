// Analytic-mode (folded-noise) IMC matmul of 8-bit integer codes on Hopper's
// int8 tensor cores.
//
// Replaces the TPU kernel repro/kernels/imc_mvm.py::_analytic_kernel
// (pallas_call in imc_analytic_matmul) on the codes route of
// kernels/ops.py::imc_matmul.  It computes
//
//   out[b, m] = ADC_MPC( (sum_k x[b, k] * w[m, k]) / sigma_yo
//                        + sigma_out * z[b, m] )
//
// with x the activation codes (u8 or s8), w the weight codes (s8) stored
// K-major as (M, K), sigma_yo a float32 read through a device pointer, z the
// counter-hash normal at the global site (TAG_ANALYTIC, b, m) and ADC_MPC the
// signed B_adc-bit converter over [-y_clip, y_clip].
//
// The code product is exact: |x w| <= 255 * 128 per term, and the wrapper
// refuses a K whose sum could leave int32.  So the sums do not depend on
// their order, and any tiling or split of K gives the same bits.  The only
// rounding is the epilogue's: one division in double, rounded once to float,
// then the noise and the ADC rounded as analytic.cu and the plain version
// round them (__fadd_rn/__fmul_rn, __fdiv_rn by the ADC step, rintf, clamp).
// The plain version divides each code by sigma_yo before a float32 product,
// so an output at an ADC knife edge may land one code apart.
//
// Its bound on this card at B = 512 is a few microseconds: the bytes (at
// 3.35 TB/s) and the int8 operations (2 B K M at 1979 TOP/s) near equal.
// Design:
//  * warpgroup MMA (wgmma m64nNk32, s32 sums) from shared memory, both
//    operands K-major in the 128-byte swizzle: a slice row is its 128 K
//    bytes, 8 rows make a 1024-byte atom, and 16-byte chunk c of row r sits
//    at chunk c ^ (r % 8), so the 8 threads that copy one row's 128 bytes
//    (one whole line of the global row) write 8 different bank groups; the
//    four 32-deep steps of a slice start 32 bytes apart;
//  * a STAGES-deep ring of BK-deep slices filled by 16-byte cp.async (zero
//    fill past the edges), so three slices are in flight while the tensor
//    cores work on the fourth; one warpgroup (128 threads) per CTA;
//  * A = x (64 batch rows, zero-filled past B), B = w (N = 64 or 128 weight
//    rows, chosen in Python: imc_mvm.int8_tile), one CTA per output tile;
//  * the MMA kernel writes its exact int32 sums into the output's storage,
//    and a second pass turns each in place into the epilogue's float
//    (division, noise, ADC) at full occupancy: fused into the MMA kernel,
//    the epilogue took longer than the product at (512, 1536) @ (1536,
//    6144).
#include <cuda_runtime.h>

#include <cstdint>

#include "prng.cuh"
#include "wgmma_int8.cuh"

namespace {

constexpr int kBK = 128;      // K bytes per pipeline slice
constexpr int kStages = 4;    // slices in the shared-memory ring
constexpr int kThreads = 128; // one warpgroup

struct Epilogue {
  int has_noise;
  uint32_t seed;
  float sigma;
  int apply_adc;
  float adc_delta, code_lo, code_hi;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

static_assert(kBK == 128, "a slice row is one 128-byte swizzle row");

// byte offset of the 16-byte chunk (row r, K chunk c) of a slice
__device__ __forceinline__ int chunk_offset(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// shared-memory matrix descriptor, 128-byte swizzle, K-major: start (the
// atom at a 1024-byte boundary, plus 32 bytes per 32-deep step), LBO unused
// (1), SBO = 1024 bytes (the next 8 rows), in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// rows [r0, r0 + R) x bytes [k0, k0 + kBK) of a row-major (rows, K) int8
// matrix into a slice; 8 consecutive threads copy one row's 128 bytes
template <int R>
__device__ __forceinline__ void load_slice(uint8_t* s, const uint8_t* g,
                                           int rows, int K, int r0, int k0) {
  constexpr int kChunks = R * (kBK / 16);
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int r = c >> 3, kc = c & 7;
    const int gr = r0 + r, gk = k0 + kc * 16;
    const bool ok = gr < rows && gk < K;  // K % 16 == 0: chunks are whole
    cp_async16(s + chunk_offset(r, kc), ok ? g + (size_t)gr * K + gk : g,
               ok ? 16 : 0);
  }
}

template <int N, bool XU>
__device__ __forceinline__ void mma(int (&d)[N / 2], uint64_t da,
                                    uint64_t db) {
  if constexpr (N == 64) {
    if constexpr (XU) wgmma_m64n64k32_u8s8(d, da, db);
    else wgmma_m64n64k32_s8s8(d, da, db);
  } else {
    static_assert(N == 128, "N is 64 or 128");
    if constexpr (XU) wgmma_m64n128k32_u8s8(d, da, db);
    else wgmma_m64n128k32_s8s8(d, da, db);
  }
}

// h: the seed's hash with the analytic tag absorbed
__device__ __forceinline__ float finish(int acc, double sigma_yo, int b,
                                        int m, const Epilogue& e, uint32_t h) {
  float y = (float)((double)acc / sigma_yo);
  if (e.has_noise) {
    const float z =
        prng_normal(prng_absorb(prng_absorb(h, (uint32_t)b), (uint32_t)m));
    y = __fadd_rn(y, __fmul_rn(e.sigma, z));
  }
  if (e.apply_adc) {
    float code = rintf(__fdiv_rn(y, e.adc_delta));
    code = fminf(fmaxf(code, e.code_lo), e.code_hi);
    y = __fmul_rn(code, e.adc_delta);
  }
  return y;
}

// A = x rows, B = w rows, grid (M / N, B / 64).  The CTA writes the bits of
// its int32 sums to out[b][m] for the epilogue pass.
template <int N, bool XU>
__global__ void __launch_bounds__(kThreads)
int8_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
            float* __restrict__ out, int B, int K, int M) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr int kSliceA = 64 * kBK, kSliceB = N * kBK;
  uint8_t* sa = smem;                      // kStages x (64 rows x kBK)
  uint8_t* sb = smem + kStages * kSliceA;  // kStages x (N rows x kBK)

  const int a0 = blockIdx.y * 64, b0 = blockIdx.x * N;
  const int nt = (K + kBK - 1) / kBK;

  int acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) {
      load_slice<64>(sa + s * kSliceA, x, B, K, a0, s * kBK);
      load_slice<N>(sb + s * kSliceB, w, M, K, b0, s * kBK);
    }
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // slice t has landed for every thread, and every warp finished the
    // products of slice t - 1, whose buffer is refilled next
    __syncthreads();
    const int nxt = t + kStages - 1;
    if (nxt < nt) {
      const int st = nxt % kStages;
      load_slice<64>(sa + st * kSliceA, x, B, K, a0, nxt * kBK);
      load_slice<N>(sb + st * kSliceB, w, M, K, b0, nxt * kBK);
    }
    cp_async_commit();
    const uint8_t* ta = sa + (t % kStages) * kSliceA;
    const uint8_t* tb = sb + (t % kStages) * kSliceB;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks)
      mma<N, XU>(acc, smem_desc(ta + ks * 32), smem_desc(tb + ks * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  cp_async_wait<0>();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < N / 2; ++r) {
    const int b = a0 + 16 * warp + (lane >> 2) + 8 * ((r >> 1) & 1);
    const int m = b0 + 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
    if (b < B && m < M) out[(size_t)b * M + m] = __int_as_float(acc[r]);
  }
}

// the epilogue pass, in place: each int32 sum's bits become its float output
// (divided, noised, converted).  A pass of its own: the noise (six hash
// rounds, a log, a square root and a cosine per output) runs at the full
// occupancy of 256-thread blocks, where the MMA kernel's one warpgroup per
// CTA would leave the SM's issue slots idle.
__global__ void epilogue_kernel(float* __restrict__ out,
                                const float* __restrict__ sigma_yo, int B,
                                int M, Epilogue e) {
  const size_t n = (size_t)B * M;
  const double sig = (double)sigma_yo[0];
  const uint32_t h = prng_absorb(prng_seed(e.seed), PRNG_TAG_ANALYTIC);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int acc = __float_as_int(out[i]);
    const int b = (int)(i / M), m = (int)(i - (size_t)b * M);
    out[i] = finish(acc, sig, b, m, e, h);
  }
}

template <int N, bool XU>
int launch(const uint8_t* x, const uint8_t* w, const float* sig, float* out,
           int B, int K, int M, const Epilogue& e, cudaStream_t stream) {
  const int smem = kStages * (64 + N) * kBK;
  auto kern = int8_kernel<N, XU>;
  static int smem_set = 0;  // the attribute, once per instantiation
  if (smem_set < smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid((M + N - 1) / N, (B + 63) / 64);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kern<<<grid, kThreads, smem, stream>>>(x, w, out, B, K, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t blocks = ((size_t)B * M + 255) / 256;
  epilogue_kernel<<<blocks < 4096 ? (int)blocks : 4096, 256, 0, stream>>>(
      out, sig, B, M, e);
  return (int)cudaGetLastError();
}

template <int N>
int launch_x(int x_unsigned, const uint8_t* x, const uint8_t* w,
             const float* sig, float* out, int B, int K, int M,
             const Epilogue& e, cudaStream_t s) {
  if (x_unsigned) return launch<N, true>(x, w, sig, out, B, K, M, e, s);
  return launch<N, false>(x, w, sig, out, B, K, M, e, s);
}

}  // namespace

// x (B, K) codes, u8 when x_unsigned else s8; w (M, K) s8 codes; sigma_yo a
// device float; out (B, M) f32.  K % 16 == 0; n_tile is 64 or 128.
extern "C" int imc_analytic_int8_matmul(
    const void* x, const void* w, const void* sigma_yo, void* out, int B,
    int K, int M, int x_unsigned, int n_tile, int has_noise, uint32_t seed,
    float sigma, int apply_adc, float adc_delta, float code_lo,
    float code_hi, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (B < 0 || K <= 0 || M < 0 || K % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Epilogue e{has_noise, seed, sigma, apply_adc, adc_delta, code_lo,
                   code_hi};
  const uint8_t* xb = (const uint8_t*)x;
  const uint8_t* wb = (const uint8_t*)w;
  const float* sg = (const float*)sigma_yo;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_tile == 64)
    return launch_x<64>(x_unsigned, xb, wb, sg, o, B, K, M, e, s);
  if (n_tile == 128)
    return launch_x<128>(x_unsigned, xb, wb, sg, o, B, K, M, e, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

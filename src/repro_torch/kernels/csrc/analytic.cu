// Analytic-mode (folded-noise) IMC matmul on Hopper.
//
// Replaces the TPU kernel repro/kernels/imc_mvm.py::_analytic_kernel
// (pallas_call in imc_analytic_matmul).  It computes
//
//   out[b, m] = ADC_MPC( sum_k x[b, k] * w[k, m] + sigma_out * z[b, m] )
//
// with x the activation codes divided by sigma_yo (float32), w the integer
// weight codes (float32), z the counter-hash normal at the global site
// (TAG_ANALYTIC, b, m) and ADC_MPC the signed B_adc-bit converter over
// [-y_clip, y_clip] (code = clamp(round(y / delta)), delta = 2 y_clip / 2^B).
//
// What bounds it on this card: at the serve's decode batch (B = 8) bytes,
// the (K, M) float32 weight codes read once; at a prefill-sized batch
// (B = 512) float32 operations, 2 B K M at 67 TFLOP/s outside the tensor
// cores.  The noise and ADC epilogue is per output and small beside either.
//
// Design:
//  * one CTA per (BM x BN) output tile; the K loop runs inside the CTA over
//    BK-deep slices of x and w staged in shared memory (the TPU kernel
//    accumulated through its output block across a sequential K grid axis,
//    which has no counterpart here), and each thread keeps a TM x TN register
//    tile of sums, fed by float4 reads of shared memory;
//  * two instantiations: 64 x 64 tiles with 4 x 4 per thread for large
//    batches, 8 x 64 tiles with 1 x 4 per thread for decode-sized batches,
//    so an 8-row call does not compute 56 rows of padding (at 8 rows and
//    the musicgen-medium site shapes the 8 x 64 one is 15-25% faster, at
//    512 rows 1.7-2x slower: chip_smoke.py --phases tiles times both);
//  * the product is float32 with fused multiply-adds in K order; the plain
//    version (cuBLAS on the card, BLAS on the CPU) sums in another order, so
//    an output at an ADC knife edge may land one code apart;
//  * the epilogue rounds every step as the plain PyTorch version does:
//    __fmul_rn/__fadd_rn keep y + sigma_out * z from contracting into a
//    fused multiply-add, the division by the ADC step is IEEE (__fdiv_rn, as
//    ref.true_div), and rintf rounds half to even like torch.round.
#include <cuda_runtime.h>

#include <cstdint>

#include "prng.cuh"

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
analytic_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int B, int K, int M, int has_noise,
                uint32_t seed, float sigma, int apply_adc, float adc_delta,
                float code_lo, float code_hi) {
  static_assert(TN % 4 == 0, "w reads are float4");
  constexpr int kThreadsM = BN / TN;
  constexpr int kThreads = (BM / TM) * kThreadsM;
  // x tile k-major; rows padded by 4 floats (fewer bank conflicts on the
  // transposing store, 16-byte alignment kept for the float4 reads)
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tm = tid % kThreadsM;  // column group within the tile
  const int tb = tid / kThreadsM;  // row group within the tile
  const int b0 = blockIdx.y * BM;
  const int m0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, c = e - r * BK;
      const int gb = b0 + r, gk = k0 + c;
      xs[c][r] = (gb < B && gk < K) ? x[(size_t)gb * K + gk] : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, c = e - r * BN;
      const int gk = k0 + r, gm = m0 + c;
      ws[r][c] = (gk < K && gm < M) ? w[(size_t)gk * M + gm] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(&xs[kk][tb * TM + i]);
          a[i] = v.x, a[i + 1] = v.y, a[i + 2] = v.z, a[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][tb * TM + i];
      }
#pragma unroll
      for (int j = 0; j < TN; j += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&ws[kk][tm * TN + j]);
        bv[j] = v.x, bv[j + 1] = v.y, bv[j + 2] = v.z, bv[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const uint32_t h_seed = prng_absorb(prng_seed(seed), PRNG_TAG_ANALYTIC);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int b = b0 + tb * TM + i;
    if (b >= B) break;
    const uint32_t h_b = prng_absorb(h_seed, (uint32_t)b);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = m0 + tm * TN + j;
      if (m >= M) break;
      float y = acc[i][j];
      if (has_noise) {
        const float z = prng_normal(prng_absorb(h_b, (uint32_t)m));
        y = __fadd_rn(y, __fmul_rn(sigma, z));
      }
      if (apply_adc) {
        float code = rintf(__fdiv_rn(y, adc_delta));
        code = fminf(fmaxf(code, code_lo), code_hi);
        y = __fmul_rn(code, adc_delta);
      }
      out[(size_t)b * M + m] = y;
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
int launch(const float* x, const float* w, float* out, int B, int K, int M,
           int has_noise, uint32_t seed, float sigma, int apply_adc,
           float adc_delta, float code_lo, float code_hi,
           cudaStream_t stream) {
  const int grid_b = (B + BM - 1) / BM;
  if (grid_b > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((M + BN - 1) / BN, grid_b);
  dim3 block((BM / TM) * (BN / TN));
  analytic_kernel<BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      x, w, out, B, K, M, has_noise, seed, sigma, apply_adc, adc_delta,
      code_lo, code_hi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int imc_analytic_matmul(const void* x, const void* w, void* out,
                                   int B, int K, int M, int has_noise,
                                   uint32_t seed, float sigma, int apply_adc,
                                   float adc_delta, float code_lo,
                                   float code_hi, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (B < 0 || K < 0 || M < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  float* of = (float*)out;
  if (B <= 16)
    return launch<8, 64, 32, 1, 4>(xf, wf, of, B, K, M, has_noise, seed,
                                   sigma, apply_adc, adc_delta, code_lo,
                                   code_hi, s);
  return launch<64, 64, 16, 4, 4>(xf, wf, of, B, K, M, has_noise, seed, sigma,
                                  apply_adc, adc_delta, code_lo, code_hi, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

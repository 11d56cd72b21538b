// Bit-serial QS-Arch IMC matmul on Hopper.
//
// Replaces the TPU kernel repro/kernels/imc_mvm.py::_bitserial_kernel
// (pallas_call in imc_bitserial_matmul).  For each SRAM bank of `rows` rows
// and each of the Bw*Bx (weight plane i, input plane j) pairs it computes the
// 0/1 plane dot product (times the per-cell gain when given), clips it at the
// headroom k_h, adds counter-hash noise (TAG_BITSERIAL at the global site
// (bank, i*Bx+j, b, m)) and a ReLU, digitizes it with a B_adc-bit ADC over
// [0, v_c], and recombines with signed powers of two, summed over banks.
//
// What bounds it on this card: operations.  The codes are one byte per
// element, so the bytes are few (K*M + B*K + 4*B*M); the plane arithmetic is
// Bw*Bx = 49 AND/adds per (b, k, m) on the integer pipes, plus per output and
// bank 49 noise draws and ADC conversions.  With the per-cell gain (every
// projection of the serve path) the 49 sums are float32 work, and the (K, M)
// fp32 gain is 4x the codes' bytes.
//
// Design:
//  * one CTA per (8-row B tile, 32-column M tile), one output per thread;
//    the bank loop runs inside the CTA and the recombined sum stays in a
//    register (the TPU's sequential bank grid axis has no counterpart here);
//  * weights and inputs arrive as int8 codes (two's complement; the low 8
//    bits are the bit planes, with the sign plane as the top bit), not as the
//    TPU's packed (K, Bw, M) fp32 plane operand, which read 28 bytes per
//    weight.  Planes are extracted in registers from 64-row chunks staged in
//    shared memory;
//  * without gain the Bw*Bx plane counts are integers <= rows, accumulated
//    exactly in int32 registers; with gain they are float64 sums rounded
//    once to float32, as in the plain version, so the order of the sum
//    does not matter;
//  * the epilogue rounds every step as the plain PyTorch version does
//    (__fmul_rn/__fadd_rn/__fdiv_rn, rintf = half to even), so the result
//    is bit-identical to it, noise included.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "prng.cuh"

namespace {

constexpr int kTileB = 8;
constexpr int kTileM = 32;
constexpr int kChunk = 64;

template <int MB, bool GAIN>
__global__ void __launch_bounds__(kTileB * kTileM)
bitserial_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ gain, float* __restrict__ out,
                 int B, int K, int M, int rows, int bx, int bw, int x_signed,
                 float k_h, int apply_adc, float adc_delta, float adc_max,
                 int has_noise, uint32_t seed, float sigma) {
  __shared__ uint8_t xs[kTileB][kChunk];
  __shared__ uint8_t ws[kChunk][kTileM];
  __shared__ float gs[GAIN ? kChunk : 1][kTileM];

  const int tx = threadIdx.x;  // m within tile
  const int ty = threadIdx.y;  // b within tile
  const int tid = ty * kTileM + tx;
  const int m = blockIdx.x * kTileM + tx;
  const int b = blockIdx.y * kTileB + ty;
  const int n_banks = (K + rows - 1) / rows;
  const uint32_t h_seed = prng_absorb(prng_seed(seed), PRNG_TAG_BITSERIAL);

  float acc = 0.0f;
  for (int bank = 0; bank < n_banks; ++bank) {
    using Cnt = typename std::conditional<GAIN, double, int>::type;
    Cnt cnt[MB][MB];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int j = 0; j < MB; ++j) cnt[i][j] = 0;

    const int k_lo = bank * rows;
    const int k_hi = min(k_lo + rows, K);  // rows past K are zero codes
    for (int k0 = k_lo; k0 < k_hi; k0 += kChunk) {
      for (int e = tid; e < kTileB * kChunk; e += kTileB * kTileM) {
        const int r = e / kChunk, c = e - r * kChunk;
        const int gb = blockIdx.y * kTileB + r, gk = k0 + c;
        xs[r][c] = (gb < B && gk < k_hi) ? x[(size_t)gb * K + gk] : 0;
      }
      for (int e = tid; e < kChunk * kTileM; e += kTileB * kTileM) {
        const int r = e / kTileM, c = e - r * kTileM;
        const int gk = k0 + r, gm = blockIdx.x * kTileM + c;
        const bool in = gk < k_hi && gm < M;
        ws[r][c] = in ? w[(size_t)gk * M + gm] : 0;
        if (GAIN) gs[r][c] = in ? gain[(size_t)gk * M + gm] : 1.0f;
      }
      __syncthreads();
      const int n = min(kChunk, k_hi - k0);
      for (int kk = 0; kk < n; ++kk) {
        const uint32_t xb = xs[ty][kk];
        const uint32_t wb = ws[kk][tx];
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          const uint32_t wi = (wb >> i) & 1u;
#pragma unroll
          for (int j = 0; j < MB; ++j) {
            const uint32_t bit = wi & (xb >> j) & 1u;
            if (GAIN) {
              if (bit) cnt[i][j] += (double)gs[kk][tx];
            } else {
              cnt[i][j] += (int)bit;
            }
          }
        }
      }
      __syncthreads();
    }

    // per-plane epilogue + signed recombination, in the plain version's
    // i-outer / j-inner order
    const uint32_t h_bank = prng_absorb(h_seed, (uint32_t)bank);
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      if (i >= bw) break;
      const float wwt = (i == bw - 1) ? -(float)(1 << i) : (float)(1 << i);
#pragma unroll
      for (int j = 0; j < MB; ++j) {
        if (j >= bx) break;
        const float xwt =
            (x_signed && j == bx - 1) ? -(float)(1 << j) : (float)(1 << j);
        float dp = fminf(GAIN ? __double2float_rn((double)cnt[i][j])
                                : (float)cnt[i][j], k_h);
        if (has_noise) {
          uint32_t hs = prng_absorb(h_bank, (uint32_t)(i * bx + j));
          hs = prng_absorb(hs, (uint32_t)b);
          hs = prng_absorb(hs, (uint32_t)m);
          const float z = prng_normal(hs);
          dp = fmaxf(__fadd_rn(dp, __fmul_rn(sigma, z)), 0.0f);
        }
        if (apply_adc) {
          float code = rintf(__fsub_rn(__fdiv_rn(dp, adc_delta), 0.5f));
          code = fminf(fmaxf(code, 0.0f), adc_max);
          dp = __fmul_rn(__fadd_rn(code, 0.5f), adc_delta);
        }
        acc = __fadd_rn(acc, __fmul_rn(wwt * xwt, dp));
      }
    }
  }
  if (b < B && m < M) out[(size_t)b * M + m] = acc;
}

template <int MB, bool GAIN>
int launch(const void* x, const void* w, const void* gain, void* out, int B,
           int K, int M, int rows, int bx, int bw, int x_signed, float k_h,
           int apply_adc, float adc_delta, float adc_max, int has_noise,
           uint32_t seed, float sigma, cudaStream_t stream) {
  dim3 block(kTileM, kTileB);
  dim3 grid((M + kTileM - 1) / kTileM, (B + kTileB - 1) / kTileB);
  bitserial_kernel<MB, GAIN><<<grid, block, 0, stream>>>(
      (const uint8_t*)x, (const uint8_t*)w, (const float*)gain, (float*)out, B,
      K, M, rows, bx, bw, x_signed, k_h, apply_adc, adc_delta, adc_max,
      has_noise, seed, sigma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int imc_bitserial_matmul(const void* x, const void* w,
                                    const void* gain, void* out, int B, int K,
                                    int M, int rows, int bx, int bw,
                                    int x_signed, float k_h, int apply_adc,
                                    float adc_delta, float adc_max,
                                    int has_noise, uint32_t seed, float sigma,
                                    void* stream) {
  if (B == 0 || M == 0) return 0;
  if (bx < 1 || bw < 1 || bx > 8 || bw > 8 || rows < 1 || B > 65535 * kTileB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool small = bx <= 7 && bw <= 7;
  if (gain != nullptr) {
    return small ? launch<7, true>(x, w, gain, out, B, K, M, rows, bx, bw,
                                   x_signed, k_h, apply_adc, adc_delta,
                                   adc_max, has_noise, seed, sigma, s)
                 : launch<8, true>(x, w, gain, out, B, K, M, rows, bx, bw,
                                   x_signed, k_h, apply_adc, adc_delta,
                                   adc_max, has_noise, seed, sigma, s);
  }
  return small ? launch<7, false>(x, w, gain, out, B, K, M, rows, bx, bw,
                                  x_signed, k_h, apply_adc, adc_delta,
                                  adc_max, has_noise, seed, sigma, s)
               : launch<8, false>(x, w, gain, out, B, K, M, rows, bx, bw,
                                  x_signed, k_h, apply_adc, adc_delta,
                                  adc_max, has_noise, seed, sigma, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

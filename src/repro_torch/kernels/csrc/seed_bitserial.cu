// The frozen seed bit-serial IMC matmul on Hopper: the benchmark baseline.
//
// Replaces the TPU kernel benchmarks/kernel_bench.py::_seed_bitserial_kernel
// (pallas_call in _seed_bitserial_matmul), the bit-serial matmul as it stood
// before the in-kernel-noise rewrite.  Per SRAM bank of `rows` rows and per
// (weight plane i, input plane j) pair it takes the 0/1 plane dot product,
// clips it at k_h, adds that plane's slice of a precomputed noise operand
// noise[bank, i*Bx + j, b, m] and floors the sum at 0 (only with noise),
// applies the mid-rise ADC (clip(rint(dp/delta - 0.5), 0, 2^b - 1) + 0.5) *
// delta, and accumulates acc += (ww[i] * xw[j]) * dp in float32, i outer and
// j inner; each bank's acc is added to the output in bank order.  There is no
// per-cell gain.
//
// What bounds it on this card: bytes.  The noise operand, (n_banks, Bw*Bx,
// B, M) float32, is read once (28.9 MB at (4, 1536) @ (1536, 6144), 7x7 bits,
// 256-row banks), beside one byte per code; the plane products are integer
// popcounts, far below the card's integer rate.  That operand is what the
// rewrite (csrc/bitserial.cu draws its noise from a counter hash) removed.
//
// Design (simple and exact, not tuned):
//  * the TPU kernel extracted every plane again from float codes on every
//    grid step; here two small passes pack the planes once per call: the
//    wrapper hands int8 codes (two's complement, so bit p is plane p and the
//    top plane is the sign plane), and pack_x / pack_w turn each 32-row slice
//    of a plane into one word per row of x and per column of w;
//  * the main kernel: one CTA per (32 columns, one batch row), one warp per
//    bank of a group of 8 banks, one column per lane.  A warp counts its
//    bank's Bw*Bx plane dots as popc(w_word & x_word) (exact int32), runs the
//    epilogue in the reference's order and leaves the bank's acc in shared
//    memory; warp 0 adds the group's accs to the output in bank order, so the
//    banks may run in parallel and the float32 sum is still the reference's;
//  * noise, w words and the output are read and written with the lanes on
//    consecutive columns (coalesced); the x words are one broadcast load;
//    the loads of a pack pass's 32 rows, and of one weight plane's Bx noise
//    values, are issued together (a first version that issued them one at a
//    time ran 0.158 ms alone at the shape above);
//  * every epilogue step is rounded as the plain PyTorch version rounds it
//    (__fdiv_rn, __fadd_rn, __fmul_rn, rintf = half to even), and a plane
//    count is an integer of at most `rows`, exact in float32, so the result
//    is bit-identical to the plain version, with noise or without.
//
// The wrapper (benchmarks.kernel_bench.seed_bitserial_cuda) pads each bank
// to a multiple of 32 rows, and K to one, with zero codes (zero planes;
// imc_mvm.kernel_layout) and allocates the packed-plane scratch; the entry
// point refuses anything else.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;    // banks in flight per CTA, one warp each
constexpr int kMaxBits = 8;  // codes of at most 8 bits (one byte)

// xp[(b * bx + j) * kw_total + kw] = bit j of x8[b, 32 kw .. 32 kw + 31]
__global__ void pack_x(const uint8_t* __restrict__ x8,
                       uint32_t* __restrict__ xp, int B, int kw_total,
                       int bx) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * kw_total) return;
  const int b = t / kw_total, kw = t % kw_total;
  const uint8_t* src = x8 + (size_t)b * kw_total * 32 + (size_t)kw * 32;
  uint32_t words[kMaxBits] = {};
#pragma unroll  // all 32 loads in flight at once
  for (int k = 0; k < 32; ++k) {
    const uint32_t v = src[k];
#pragma unroll
    for (int j = 0; j < kMaxBits; ++j) words[j] |= ((v >> j) & 1u) << k;
  }
  for (int j = 0; j < bx; ++j)
    xp[((size_t)b * bx + j) * kw_total + kw] = words[j];
}

// wp[(i * kw_total + kw) * M + m] = bit i of w8[32 kw .. 32 kw + 31, m]
__global__ void pack_w(const uint8_t* __restrict__ w8,
                       uint32_t* __restrict__ wp, int M, int kw_total,
                       int bw) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int kw = blockIdx.y;
  if (m >= M) return;
  const uint8_t* src = w8 + (size_t)kw * 32 * M + m;
  uint32_t words[kMaxBits] = {};
#pragma unroll  // all 32 loads in flight at once
  for (int k = 0; k < 32; ++k) {
    const uint32_t v = src[(size_t)k * M];
#pragma unroll
    for (int i = 0; i < kMaxBits; ++i) words[i] |= ((v >> i) & 1u) << k;
  }
  for (int i = 0; i < bw; ++i)
    wp[((size_t)i * kw_total + kw) * M + m] = words[i];
}

__global__ void __launch_bounds__(kWarps * 32)
    seed_main(const uint32_t* __restrict__ xp, const uint32_t* __restrict__ wp,
              const float* __restrict__ noise, float* __restrict__ out, int B,
              int M, int kw_total, int words_per_bank, int bx, int bw,
              int x_signed, float k_h, int apply_adc, float delta,
              float code_max) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int m = blockIdx.x * 32 + lane;
  const bool live = m < M;
  const int n_banks = (kw_total + words_per_bank - 1) / words_per_bank;
  const size_t plane_stride = (size_t)B * M;  // noise: one (B, M) slice
  float o = 0.f;
  for (int g = 0; g < n_banks; g += kWarps) {
    const int bank = g + warp;
    float acc = 0.f;
    if (bank < n_banks && live) {
      int cnt[kMaxBits][kMaxBits];
#pragma unroll
      for (int i = 0; i < kMaxBits; ++i)
#pragma unroll
        for (int j = 0; j < kMaxBits; ++j) cnt[i][j] = 0;
      const int kw0 = bank * words_per_bank;
      const int n_words = min(words_per_bank, kw_total - kw0);  // last: ragged
      const uint32_t* xrow = xp + (size_t)b * bx * kw_total + kw0;
#pragma unroll 2
      for (int kw = 0; kw < n_words; ++kw) {
        uint32_t xv[kMaxBits];
#pragma unroll
        for (int j = 0; j < kMaxBits; ++j)
          xv[j] = j < bx ? xrow[(size_t)j * kw_total + kw] : 0u;
#pragma unroll
        for (int i = 0; i < kMaxBits; ++i) {
          if (i < bw) {
            const uint32_t wv = wp[((size_t)i * kw_total + kw0 + kw) * M + m];
#pragma unroll
            for (int j = 0; j < kMaxBits; ++j) cnt[i][j] += __popc(wv & xv[j]);
          }
        }
      }
      const float* nz = noise == nullptr ? nullptr
                        : noise + (size_t)bank * bw * bx * plane_stride +
                              (size_t)b * M + m;
#pragma unroll
      for (int i = 0; i < kMaxBits; ++i) {
        // weight plane i's Bx noise values, loaded together
        float nzv[kMaxBits];
#pragma unroll
        for (int j = 0; j < kMaxBits; ++j)
          nzv[j] = (nz != nullptr && i < bw && j < bx)
                       ? nz[(size_t)(i * bx + j) * plane_stride]
                       : 0.f;
#pragma unroll
        for (int j = 0; j < kMaxBits; ++j) {
          if (i < bw && j < bx) {
            float dp = fminf((float)cnt[i][j], k_h);
            if (nz != nullptr) {
              dp = __fadd_rn(dp, nzv[j]);
              dp = fmaxf(dp, 0.f);
            }
            if (apply_adc) {
              float code = rintf(__fsub_rn(__fdiv_rn(dp, delta), 0.5f));
              code = fminf(fmaxf(code, 0.f), code_max);
              dp = __fmul_rn(__fadd_rn(code, 0.5f), delta);
            }
            // signed powers of two: w is always signed, x when x_signed
            float coef = (float)(1u << (i + j));
            if (i == bw - 1) coef = -coef;
            if (x_signed && j == bx - 1) coef = -coef;
            acc = __fadd_rn(acc, __fmul_rn(coef, dp));
          }
        }
      }
    }
    part[warp][lane] = acc;
    __syncthreads();
    if (warp == 0) {
      const int nb = min(kWarps, n_banks - g);
      for (int t = 0; t < nb; ++t) o = __fadd_rn(o, part[t][lane]);
    }
    __syncthreads();
  }
  if (warp == 0 && live) out[(size_t)b * M + m] = o;
}

}  // namespace

// x8 (B, Kp) and w8 (Kp, M) int8 codes, Kp and the bank height rows_p
// multiples of 32 (a last bank shorter than rows_p is zero-padded to 32-row
// words); noise (n_banks, bw*bx, B, M) float32 or null; xp
// (B, bx, Kp/32) and wp (bw, Kp/32, M) uint32 scratch; out (B, M) float32.
extern "C" int seed_bitserial_matmul(const void* x8, const void* w8,
                                     const void* noise, void* xp, void* wp,
                                     void* out, int B, int Kp, int M,
                                     int rows_p, int bx, int bw, int x_signed,
                                     float k_h, int apply_adc, float delta,
                                     float code_max, void* stream) {
  if (B < 0 || Kp < 0 || M < 0 || rows_p <= 0 || rows_p % 32 || Kp % 32 ||
      bx < 1 || bx > kMaxBits || bw < 1 || bw > kMaxBits || B > 65535 ||
      Kp / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int kw_total = Kp / 32;
  if (kw_total > 0) {
    const int nx = B * kw_total;
    pack_x<<<(nx + 255) / 256, 256, 0, s>>>((const uint8_t*)x8, (uint32_t*)xp,
                                            B, kw_total, bx);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pack_w<<<dim3((M + 255) / 256, kw_total), 256, 0, s>>>(
        (const uint8_t*)w8, (uint32_t*)wp, M, kw_total, bw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  seed_main<<<dim3((M + 31) / 32, B), kWarps * 32, 0, s>>>(
      (const uint32_t*)xp, (const uint32_t*)wp, (const float*)noise,
      (float*)out, B, M, kw_total, rows_p / 32, bx, bw, x_signed, k_h,
      apply_adc, delta, code_max);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

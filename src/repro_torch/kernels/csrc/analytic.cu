// Analytic-mode (folded-noise) IMC matmul on Hopper, float operands: the
// route of codes wider than 8 bits.
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
// What bounds it on this card: at a prefill-sized batch (B = 512) the
// product, which this kernel runs on the TF32 tensor cores (494.7 TFLOP/s
// dense, 7x the 67 TFLOP/s of float32 outside them); at the decode batch
// (B = 8) the bytes, the (K, M) float32 weight codes read once.
//
// Design: split TF32 ("3xTF32") on warpgroup MMA.
//  * Each operand splits into two TF32 limbs, v = hi + lo with hi =
//    rna_tf32(v) and lo = rna_tf32(v - hi) (cvt.rna.tf32.f32's rounding,
//    written as two integer operations), inside the CTA after its
//    slice lands in shared memory (no pre-pass over the operands).  The
//    product is x_lo w_hi + x_hi w_lo + x_hi w_hi (x_lo w_lo, ~2^-22 of the
//    product, is dropped), so it carries float32's precision.
//  * Integer codes with |w| <= 2^11 are exact in one limb (w_lo == 0): every
//    billed design point (6-8 bits) and the design phase's 10-bit call.  A
//    K slice whose w tile has no lo limb anywhere (a CTA-wide
//    __syncthreads_or over the low mantissa bits each thread copied) is
//    transposed without splitting and skips x_hi w_lo; codes of 12-16 bits
//    take all three products.
//  * wgmma (m64nNk8, TF32) from shared memory.  Its TF32 form takes both
//    operands K-major: x is (B, K) row-major, so its 32-deep slice lands by
//    16-byte cp.async straight into the 128-byte-swizzled K-major layout of
//    wgmma_int8.cuh's kernel and is split in place (hi) and beside it (lo);
//    w is (K, M) row-major, so its slice lands row-major in a staging buffer
//    and the split pass writes it transposed into the swizzled layout, hi
//    and lo.  One 128-byte row per operand row, 8 rows an atom, chunk c of
//    row r at c ^ (r % 8): the descriptors of wgmma_int8.cuh carry over (a
//    k8 TF32 step is 32 bytes deep, as a k32 int8 step is).
//  * The tensor cores' float32 accumulation truncates.  Over K = 6144 (1536
//    accumulations into one sum) that bias would reach ~1e-4 of an output,
//    above the 1e-5 the plain version is held to, so each 32-deep slice's
//    products sum into a fresh register tile (scale-d 0 at its first MMA)
//    that is then added to the float32 sum with round-to-nearest adds:
//    rounding then grows as in a float32 dot product.
//  * Tiles: 128 x 192 for large batches (two warpgroups of 64 x 192; 128
//    CTAs at (512, K) @ (K, 6144), one wave on 132 SMs), 64 x 96 where those
//    would leave SMs idle, 64 x 64 for decode-sized batches (B <= 16; the
//    padding rows are zero-filled copies, so they cost no bytes).  32-deep
//    slices land by 16-byte cp.async; slice t is multiplied (wgmma is
//    asynchronous) while slice t + 1 is split and slice t + 2 lands.
//  * The MMA kernel writes the products; a second pass over the outputs, at
//    full occupancy, adds the noise and runs the ADC in place (inside the
//    MMA kernel, one CTA per SM left the hash's latency exposed: on the
//    H100 it took 0.073 of 0.216 ms at (512, 1536) @ (1536, 6144)), rounded
//    as the plain PyTorch version rounds them: __fmul_rn/__fadd_rn
//    keep y + sigma_out * z from contracting into a fused multiply-add, the
//    division by the ADC step is IEEE (__fdiv_rn, as ref.true_div), and
//    rintf rounds half to even like torch.round.  The product is summed in
//    another order than cuBLAS's, so an output at an ADC knife edge may land
//    one code apart from the plain version; every tile choice sums each
//    output in the same order, so the result does not depend on the tiles.
//
// The entry point takes K and M multiples of 4 and 16-byte aligned
// operands (the wrapper, imc_mvm.analytic_cuda, pads where they are not).
#include <cuda_runtime.h>

#include <cstdint>

#include "prng.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kBK = 32;  // K floats per slice: one 128-byte swizzle row

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

// cvt.rna.tf32.f32 of a finite float (10 mantissa bits, half away from
// zero: half a TF32 ulp added to the magnitude, the 13 bits below cleared);
// the instruction itself also screens infinities and NaNs, which codes are
// not, at twice the cost
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// byte offset of the 16-byte chunk (row r, K chunk c) of a swizzled slice
__device__ __forceinline__ int chunk_offset(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// shared-memory matrix descriptor, 128-byte swizzle, K-major: start (the
// atom at a 1024-byte boundary, plus 32 bytes per 8-deep step), LBO unused
// (1), SBO = 1024 bytes (the next 8 rows), in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (BN == 64) wgmma_m64n64k8_tf32(d, da, db, scale_d);
  else if constexpr (BN == 96) wgmma_m64n96k8_tf32(d, da, db, scale_d);
  else {
    static_assert(BN == 192, "N is 64, 96 or 192");
    wgmma_m64n192k8_tf32(d, da, db, scale_d);
  }
}

// Shared memory of one CTA: the x slices as they land (swizzled, three, so
// that one is multiplied while the next is split and the one after lands;
// split in place into hi), their lo limbs (two), the w slices as they land
// (row-major, two), and the split, transposed w slices (hi and lo, two
// each).  Every part is a multiple of 1024 bytes, so every swizzle atom is
// 1024-aligned.
template <int WGS, int BN>
struct Layout {
  static constexpr int kThreads = 128 * WGS;
  static constexpr int BM = 64 * WGS, kN = BN;
  static constexpr int kA = BM * 128, kW = kBK * BN * 4, kB = BN * 128;
  static constexpr int kAL = 3 * kA, kWs = 5 * kA, kBH = kWs + 2 * kW,
                       kBL = kBH + 2 * kB;
  static constexpr int kBytes = kBL + 2 * kB;
  static constexpr int kChunksA = BM * 8, kChunksW = kBK * BN / 4;
  static constexpr int kChunksB = BN * 8;
  static_assert(kChunksA % kThreads == 0 && kChunksW % kThreads == 0 &&
                    kChunksB % kThreads == 0,
                "whole chunks per thread");
};

// slice k0 of x (rows b0 ..) into ah, swizzled, and of w (columns m0 ..)
// into ws, row-major
template <class L>
__device__ __forceinline__ void load_slice(uint8_t* ah, uint8_t* ws,
                                           const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           int B, int K, int M, int b0,
                                           int m0, int k0) {
#pragma unroll
  for (int i = 0; i < L::kChunksA / L::kThreads; ++i) {
    const int c = threadIdx.x + i * L::kThreads;
    const int r = c >> 3, kc = c & 7;
    const int gb = b0 + r, gk = k0 + 4 * kc;
    const bool ok = gb < B && gk < K;
    cp_async16(ah + chunk_offset(r, kc), ok ? x + (size_t)gb * K + gk : x,
               ok ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < L::kChunksW / L::kThreads; ++i) {
    const int c = threadIdx.x + i * L::kThreads;
    const int r = c / (L::kN / 4), nc = c % (L::kN / 4);
    const int gk = k0 + r, gm = m0 + 4 * nc;
    const bool ok = gk < K && gm < M;
    cp_async16(ws + (r * L::kN + 4 * nc) * 4,
               ok ? w + (size_t)gk * M + gm : w, ok ? 16 : 0);
  }
}

// whether a w value among this thread's own copies of a landed slice is not
// TF32 (a mantissa bit below TF32's 10): then w has a lo limb there.  A
// thread's own cp.async writes are visible to it after the wait.
template <class L>
__device__ __forceinline__ int has_lo(const uint8_t* ws_bytes) {
  uint32_t bits = 0u;
#pragma unroll
  for (int i = 0; i < L::kChunksW / L::kThreads; ++i) {
    const int c = threadIdx.x + i * L::kThreads;
    const int r = c / (L::kN / 4), nc = c % (L::kN / 4);
    const uint4 v =
        *reinterpret_cast<const uint4*>(ws_bytes + (r * L::kN + 4 * nc) * 4);
    bits |= v.x | v.y | v.z | v.w;
  }
  return (bits & 0x1FFFu) != 0u;
}

// split a landed slice: x in place (hi) and into al (lo), w transposed into
// bh and, where the slice has lo limbs (LO), bl
template <class L, bool LO>
__device__ __forceinline__ void split_slice(uint8_t* ah, uint8_t* al,
                                            const uint8_t* ws_bytes,
                                            uint8_t* bh, uint8_t* bl) {
#pragma unroll
  for (int i = 0; i < L::kChunksA / L::kThreads; ++i) {
    const int c = threadIdx.x + i * L::kThreads;
    const int off = chunk_offset(c >> 3, c & 7);
    const float4 v = *reinterpret_cast<const float4*>(ah + off);
    float4 hi, lo;
    hi.x = tf32_rna(v.x), lo.x = tf32_rna(__fsub_rn(v.x, hi.x));
    hi.y = tf32_rna(v.y), lo.y = tf32_rna(__fsub_rn(v.y, hi.y));
    hi.z = tf32_rna(v.z), lo.z = tf32_rna(__fsub_rn(v.z, hi.z));
    hi.w = tf32_rna(v.w), lo.w = tf32_rna(__fsub_rn(v.w, hi.w));
    *reinterpret_cast<float4*>(ah + off) = hi;
    *reinterpret_cast<float4*>(al + off) = lo;
  }
  const float* ws = reinterpret_cast<const float*>(ws_bytes);
#pragma unroll
  for (int i = 0; i < L::kChunksB / L::kThreads; ++i) {
    const int c = threadIdx.x + i * L::kThreads;
    const int n = c % L::kN, kc = c / L::kN;
    float v[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = ws[(4 * kc + q) * L::kN + n];
      if constexpr (LO) {
        const float hi = tf32_rna(v[q]);
        lo[q] = tf32_rna(__fsub_rn(v[q], hi));
        v[q] = hi;
      }
    }
    const int off = chunk_offset(n, kc);  // without lo limbs v is TF32
    *reinterpret_cast<float4*>(bh + off) = make_float4(v[0], v[1], v[2],
                                                       v[3]);
    if constexpr (LO)
      *reinterpret_cast<float4*>(bl + off) = make_float4(lo[0], lo[1], lo[2],
                                                         lo[3]);
  }
  // the split operands are generic-proxy writes that wgmma reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ float finish(float y, uint32_t h_b, int m,
                                        const Epilogue& e) {
  if (e.has_noise) {
    const float z = prng_normal(prng_absorb(h_b, (uint32_t)m));
    y = __fadd_rn(y, __fmul_rn(e.sigma, z));
  }
  if (e.apply_adc) {
    float code = rintf(__fdiv_rn(y, e.adc_delta));
    code = fminf(fmaxf(code, e.code_lo), e.code_hi);
    y = __fmul_rn(code, e.adc_delta);
  }
  return y;
}

// issue one slice's products into d, a fresh sum (scale-d 0 at the first
// MMA): x_lo w_hi, x_hi w_lo (where w has a lo limb), x_hi w_hi per 8-deep
// step, then commit them; LO is a template parameter so that no branch
// separates the MMAs
template <int BN, bool LO>
__device__ __forceinline__ void issue_products(float (&d)[BN / 2],
                                               const uint8_t* ah,
                                               const uint8_t* al,
                                               const uint8_t* bh,
                                               const uint8_t* bl) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < kBK / 8; ++ks) {
    const uint64_t dah = smem_desc(ah + 32 * ks);
    const uint64_t dbh = smem_desc(bh + 32 * ks);
    wgmma_tf32<BN>(d, smem_desc(al + 32 * ks), dbh, ks > 0);
    if constexpr (LO) wgmma_tf32<BN>(d, dah, smem_desc(bl + 32 * ks), 1);
    wgmma_tf32<BN>(d, dah, dbh, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// WGS warpgroups, each 64 rows x BN columns of the CTA's output tile; writes
// the products, which epilogue_kernel finishes
template <int WGS, int BN, int MIN_BLOCKS>
__global__ void __launch_bounds__(128 * WGS, MIN_BLOCKS)
analytic_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int B, int K, int M) {
  using L = Layout<WGS, BN>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const int wg = threadIdx.x >> 7;
  const int b0 = blockIdx.y * L::BM, m0 = blockIdx.x * BN;
  const int nt = (K + kBK - 1) / kBK;
  uint8_t* const base = smem;
  const auto ah = [base](int t) { return base + (t % 3) * L::kA; };
  const auto al = [base](int t) { return base + L::kAL + (t % 2) * L::kA; };
  const auto ws = [base](int t) { return base + L::kWs + (t % 2) * L::kW; };
  const auto bh = [base](int t) { return base + L::kBH + (t % 2) * L::kB; };
  const auto bl = [base](int t) { return base + L::kBL + (t % 2) * L::kB; };

  float acc[BN / 2], tmp[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f, tmp[i] = 0.f;

  // Slice t is multiplied while slice t + 1 is split and slice t + 2 lands.
  load_slice<L>(ah(0), ws(0), x, w, B, K, M, b0, m0, 0);
  cp_async_commit();
  if (nt > 1) load_slice<L>(ah(1), ws(1), x, w, B, K, M, b0, m0, kBK);
  cp_async_commit();
  cp_async_wait<1>();
  int lo = __syncthreads_or(has_lo<L>(ws(0)));
  if (lo) split_slice<L, true>(ah(0), al(0), ws(0), bh(0), bl(0));
  else split_slice<L, false>(ah(0), al(0), ws(0), bh(0), bl(0));
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const uint8_t* a_hi = ah(t) + wg * 64 * 128;
    const uint8_t* a_lo = al(t) + wg * 64 * 128;
    if (lo) issue_products<BN, true>(tmp, a_hi, a_lo, bh(t), bl(t));
    else issue_products<BN, false>(tmp, a_hi, a_lo, bh(t), bl(t));
    if (t + 1 < nt) {
      cp_async_wait<0>();
      // slice t + 1 has landed for every thread; every warpgroup is done
      // with slice t - 1, whose buffers are rewritten next
      lo = __syncthreads_or(has_lo<L>(ws(t + 1)));
      if (lo)
        split_slice<L, true>(ah(t + 1), al(t + 1), ws(t + 1), bh(t + 1),
                             bl(t + 1));
      else
        split_slice<L, false>(ah(t + 1), al(t + 1), ws(t + 1), bh(t + 1),
                              bl(t + 1));
      // after the split's proxy fence, which would otherwise wait for these
      if (t + 2 < nt)
        load_slice<L>(ah(t + 2), ws(t + 2), x, w, B, K, M, b0, m0,
                      (t + 2) * kBK);
      cp_async_commit();
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      asm volatile("" : "+f"(tmp[i])::"memory");  // written by the MMAs
      acc[i] = __fadd_rn(acc[i], tmp[i]);
    }
    __syncthreads();  // slice t + 1 is split for every warpgroup
  }

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = b0 + wg * 64 + warp * 16 + gid + 8 * h;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int m = m0 + 8 * j + 2 * tig;  // M % 4 == 0: m + 1 < M too
      if (m >= M) continue;
      *reinterpret_cast<float2*>(out + (size_t)b * M + m) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// the epilogue pass, in place: each product becomes its output (noised,
// converted).  A pass of its own: the noise (six hash rounds, a log, a
// square root and a cosine per output) runs at the full occupancy of
// 256-thread blocks, where the MMA kernel's one CTA per SM would leave the
// issue slots idle behind the hash's latency.
__global__ void epilogue_kernel(float* __restrict__ out, int B, int M,
                                Epilogue e) {
  const size_t n = (size_t)B * M;
  const uint32_t h = prng_absorb(prng_seed(e.seed), PRNG_TAG_ANALYTIC);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(i / M), m = (int)(i - (size_t)b * M);
    out[i] = finish(out[i], prng_absorb(h, (uint32_t)b), m, e);
  }
}

template <int WGS, int BN, int MIN_BLOCKS>
int launch(const float* x, const float* w, float* out, int B, int K, int M,
           const Epilogue& e, cudaStream_t stream) {
  using L = Layout<WGS, BN>;
  auto kern = analytic_kernel<WGS, BN, MIN_BLOCKS>;
  static bool smem_set = false;  // the attribute, once per instantiation
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int grid_b = (B + L::BM - 1) / L::BM;
  if (grid_b > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BN - 1) / BN, grid_b);
  kern<<<grid, L::kThreads, L::kBytes, stream>>>(x, w, out, B, K, M);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !(e.has_noise || e.apply_adc)) return (int)err;
  const size_t blocks = ((size_t)B * M + 255) / 256;
  epilogue_kernel<<<blocks < 4096 ? (int)blocks : 4096, 256, 0, stream>>>(
      out, B, M, e);
  return (int)cudaGetLastError();
}

constexpr int kSms = 132;  // streaming multiprocessors of the H100

}  // namespace

// x (B, K) and w (K, M) float32, out (B, M) float32; K % 4 == M % 4 == 0
// and 16-byte aligned x and w (the 16-byte copies).
extern "C" int imc_analytic_matmul(const void* x, const void* w, void* out,
                                   int B, int K, int M, int has_noise,
                                   uint32_t seed, float sigma, int apply_adc,
                                   float adc_delta, float code_lo,
                                   float code_hi, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (B < 0 || K < 0 || M < 0 || K % 4 || M % 4 ||
      ((uintptr_t)x | (uintptr_t)w) % 16)
    return (int)cudaErrorInvalidValue;
  const Epilogue e{has_noise, seed, sigma, apply_adc, adc_delta, code_lo,
                   code_hi};
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const float* wf = (const float*)w;
  float* of = (float*)out;
  if (B <= 16) return launch<1, 64, 2>(xf, wf, of, B, K, M, e, s);
  const long large_ctas = (long)((B + 127) / 128) * ((M + 191) / 192);
  if (large_ctas * 10 >= kSms * 9)  // at least 90% of the SMs busy
    return launch<2, 192, 1>(xf, wf, of, B, K, M, e, s);
  return launch<1, 96, 2>(xf, wf, of, B, K, M, e, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

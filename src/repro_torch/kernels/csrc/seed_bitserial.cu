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
// What bounds it on this card: bytes.  It reads the float32 codes as the
// caller holds them (the TPU kernel read float codes too) and the noise
// operand, (n_banks, Bw*Bx, B, M) float32, each once, and writes the (B, M)
// output: 66.8 MB at (4, 1536) @ (1536, 6144), 7x7 bits, 256-row banks
// (37.7 MB of weight codes, 28.9 MB of noise).  Beside them run the integer
// pipes: 58 M popcounts (at 16 a clock per SM, ~14 us) and the plane
// packing, and the epilogue's 7.2 M IEEE divisions.  On the H100 it reaches
// a quarter of the byte bound: each batch row adds its (bank, row) items'
// counts and epilogues, a chain of dependent steps per item that the few
// warps per SM do not hide (chip_smoke.py --phases device,kprofile times it
// at 1, 4 and 16 rows).
//
// Design: one launch; every byte read once.
//  * One CTA of eight warps per 32 columns covers every bank and, where the
//    columns give the SMs work enough (the main path's 192 column tiles),
//    every batch row, so each weight code is read once per call; with few
//    columns (the kernel bench's M of 128 or 256 at 32 to 128 batch rows)
//    the batch rows are split over CTAs (blockIdx.y), each packing the
//    weights anew.  It builds the bit planes itself: no pack pass, no plane
//    scratch in device memory, no cast of the codes.  A float code becomes
//    its low 8 bits (two's complement, so bit p is plane p and the top plane
//    the sign plane) by one add of 1.5 * 2^23, which leaves the integer in
//    the low mantissa bits.
//  * Phase 1 (per group of banks whose words fit shared memory): with the
//    lanes on columns (coalesced 128-byte rows of w) a warp reads two words'
//    64 rows at once and builds the Bw plane words of its column in
//    registers; with the lanes on rows (coalesced rows of x) a warp builds
//    the Bx plane words of one batch row with one __ballot_sync per plane,
//    eight rows' loads in flight.  Both land in shared memory.  Rows past a
//    bank's end (a ragged last bank, or a bank height that is not a multiple
//    of 32) load as zero codes by predicate: zero planes, which add nothing
//    to a count.
//  * Phase 2: the (bank, batch row) items are spread over the warps, one
//    column per lane.  The item's Bw*Bx noise values stream into the warp's
//    shared-memory buffer by cp.async (one coalesced 128-byte row per plane
//    pair, issued before the item is counted: the first while phase 1
//    packs, each next one after the item before it), while the warp counts
//    the plane dots as popc(w_word & x_word) (exact int32; x words are
//    broadcast reads, w words conflict-free); then the epilogue runs in the
//    reference's order and leaves the bank's acc in shared memory.
//  * Phase 3: each batch row's banks are added to the output in bank order.
//  * Every epilogue step is rounded as the plain PyTorch version rounds it
//    (div_rn: the IEEE quotient; __fadd_rn, __fmul_rn, rintf = half to
//    even), and a plane
//    count is an integer of at most `rows`, exact in float32, so the result
//    is bit-identical to the plain version, with noise or without.
//
// The launch plan (words per bank, banks per group, batch rows per chunk)
// comes from the wrapper (benchmarks.kernel_bench.seed_plan); the entry point
// checks it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;  // columns per CTA, one per lane
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

struct Args {
  const float* x;      // (B, K) codes
  const float* w;      // (K, M) codes
  const float* noise;  // (n_banks, bw*bx, B, M) or null
  float* out;          // (B, M)
  int B, K, M, rows, bx, bw, x_signed;
  float k_h;
  int apply_adc;
  float delta, code_max;
  int words;  // 32-row words per bank, even
  int group;  // banks per group
  int chunk;  // batch rows per chunk
  int b_rows;  // batch rows per CTA (blockIdx.y)
};

// the low 8 bits of an integer-valued float code in |v| < 2^22
__device__ __forceinline__ uint32_t code_bits(float v) {
  return __float_as_uint(__fadd_rn(v, 12582912.0f));  // 1.5 * 2^23
}

// a / b rounded to nearest, as __fdiv_rn(a, b), without that intrinsic's
// branch to a slow path (which keeps the compiler from interleaving an
// item's 49 divisions): q = RN(a rb), rb = RN(1 / b), is within an ulp of
// the quotient, the remainder a - q b is exact in one fused multiply-add,
// and RN(q + remainder rb) is the correctly rounded quotient (Markstein's
// theorem) wherever nothing overflows or underflows, as here: a is 0 or a
// count plus noise in counts, b the ADC step, both far inside float range
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}

// 32-bit words of shared memory of one CTA for plane width NB
__host__ __device__ inline int words_w(int NB, const Args& a) {
  return a.group * NB * a.words * kCols;
}
__host__ __device__ inline int words_x(const Args& a) {
  return a.chunk * a.group * a.words * 8;
}
__host__ __device__ inline int words_part(const Args& a) {
  return a.group * a.chunk * kCols;
}
__host__ __device__ inline int words_noise(int NB) {
  return kWarps * NB * NB * kCols;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// the 32 rows of one weight word (32-row word wd of bank `bank`, rows past
// the bank's end zero) of column m
__device__ __forceinline__ void load_rows(float (&v)[32], const Args& a,
                                          int bank, int wd, int m,
                                          bool live) {
  const int n_rows = min(a.rows, a.K - bank * a.rows) - 32 * wd;
  const float* src = a.w + (size_t)(bank * a.rows + 32 * wd) * a.M + m;
#pragma unroll
  for (int r = 0; r < 32; ++r)
    v[r] = live && r < n_rows ? src[(size_t)r * a.M] : 0.f;
}

// the NB plane words of 32 codes (bit r of plane i's word: bit i of row
// r's code); a zero float is a zero code
template <int NB>
__device__ __forceinline__ void pack_planes(uint32_t (&word)[NB],
                                            const float (&v)[32]) {
#pragma unroll
  for (int i = 0; i < NB; ++i) word[i] = 0u;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const uint32_t u = code_bits(v[r]);
#pragma unroll
    for (int i = 0; i < NB; ++i) word[i] |= ((u >> i) & 1u) << r;
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 2) seed_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ws = smem;                   // [group][NB][words][kCols]
  uint32_t* xs = ws + words_w(NB, a);    // [chunk][group][words][8]
  float* part = (float*)(xs + words_x(a));  // [group][chunk][kCols]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this warp's noise values of one item, [bw * bx][kCols]
  float* nbuf = part + words_part(a) + warp * NB * NB * kCols;
  const int m = blockIdx.x * kCols + lane;
  const bool live = m < a.M;
  const int n_banks = (a.K + a.rows - 1) / a.rows;
  const int n_planes = a.bw * a.bx;
  const size_t plane_stride = (size_t)a.B * a.M;  // noise: one (B, M) slice
  const float r_delta = __frcp_rn(a.delta);  // for div_rn
  const int b_begin = blockIdx.y * a.b_rows;  // this CTA's batch rows
  const int b_end = min(a.B, b_begin + a.b_rows);

  // the noise values of item (bank, batch row b) into nbuf, one column per
  // lane (coalesced rows); each lane reads back only its own
  const auto fetch_noise = [&](int bank, int b) {
    if (a.noise == nullptr) return;
    const float* nz = a.noise + (size_t)bank * n_planes * plane_stride +
                      (size_t)b * a.M + m;
    for (int p = 0; p < n_planes; ++p)
      cp_async4(nbuf + p * kCols + lane,
                live ? nz + (size_t)p * plane_stride : a.noise, live ? 4 : 0);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  for (int g0 = 0; g0 < n_banks; g0 += a.group) {
    const int ng = min(a.group, n_banks - g0);
    // the noise of the warp's first item lands while it packs
    const int nb0 = min(a.chunk, b_end - b_begin);
    if (warp < ng * nb0)
      fetch_noise(g0 + warp / nb0, b_begin + warp % nb0);
    // phase 1a: the group's weight plane words, lanes on columns, two words
    // (64 loads) in flight per lane
    const int n_wwords = ng * a.words;
    for (int item = warp; item < n_wwords; item += 2 * kWarps) {
      const int item2 = item + kWarps;
      float v0[32], v1[32];
      load_rows(v0, a, g0 + item / a.words, item % a.words, m, live);
      load_rows(v1, a, g0 + item2 / a.words, item2 % a.words, m,
                live && item2 < n_wwords);
      uint32_t word[NB];
      pack_planes<NB>(word, v0);
#pragma unroll
      for (int i = 0; i < NB; ++i)
        ws[((item / a.words * NB + i) * a.words + item % a.words) * kCols +
           lane] = word[i];
      if (item2 < n_wwords) {
        pack_planes<NB>(word, v1);
#pragma unroll
        for (int i = 0; i < NB; ++i)
          ws[((item2 / a.words * NB + i) * a.words + item2 % a.words) *
                 kCols + lane] = word[i];
      }
    }
    for (int b0 = b_begin; b0 < b_end; b0 += a.chunk) {
      const int nb = min(a.chunk, b_end - b0);
      const int n_items = ng * nb;
      if (b0 > b_begin && warp < n_items)
        fetch_noise(g0 + warp / nb, b0 + warp % nb);
      // phase 1b: the chunk's input plane words, whole warps with the lanes
      // on rows, eight words (eight loads) in flight per warp
      constexpr int kU = 8;
      const int n_xwords = nb * ng * a.words;
      for (int base = warp; base < n_xwords; base += kU * kWarps) {
        uint32_t u[kU];
#pragma unroll
        for (int q = 0; q < kU; ++q) {
          const int item = base + q * kWarps;
          const int bb = item / (ng * a.words);
          const int rest = item - bb * ng * a.words;
          const int bank = g0 + rest / a.words;
          const int r = 32 * (rest % a.words) + lane;
          u[q] = item < n_xwords && r < min(a.rows, a.K - bank * a.rows)
                     ? code_bits(a.x[(size_t)(b0 + bb) * a.K +
                                     bank * a.rows + r])
                     : 0u;
        }
#pragma unroll
        for (int q = 0; q < kU; ++q) {
          const int item = base + q * kWarps;
          if (item >= n_xwords) break;  // warp-uniform
          uint32_t mine = 0u;  // lane j keeps plane j's word
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            const uint32_t v = __ballot_sync(~0u, (u[q] >> j) & 1u);
            if (lane == j) mine = v;
          }
          const int bb = item / (ng * a.words);
          const int rest = item - bb * ng * a.words;
          if (lane < 8)
            xs[((bb * a.group + rest / a.words) * a.words + rest % a.words) *
                   8 + lane] = mine;
        }
      }
      __syncthreads();

      // phase 2: counts and epilogue per (bank, batch row), one item per
      // warp at a time, the item's noise landing in nbuf while it counts
      for (int item = warp; item < n_items; item += kWarps) {
        const int bl = item / nb, bb = item - bl * nb;
        int cnt[NB][NB];
#pragma unroll
        for (int i = 0; i < NB; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) cnt[i][j] = 0;
        const uint32_t* wrow = ws + bl * NB * a.words * kCols + lane;
        const uint4* xrow = reinterpret_cast<const uint4*>(
            xs + (bb * a.group + bl) * a.words * 8);
        for (int wd = 0; wd < a.words; wd += 2) {
          const uint4 p0 = xrow[2 * wd], p1 = xrow[2 * wd + 1];
          const uint4 q0 = xrow[2 * wd + 2], q1 = xrow[2 * wd + 3];
          const uint32_t xa[8] = {p0.x, p0.y, p0.z, p0.w,
                                  p1.x, p1.y, p1.z, p1.w};
          const uint32_t xb[8] = {q0.x, q0.y, q0.z, q0.w,
                                  q1.x, q1.y, q1.z, q1.w};
#pragma unroll
          for (int i = 0; i < NB; ++i) {
            if (i < a.bw) {
              const uint32_t wa = wrow[(i * a.words + wd) * kCols];
              const uint32_t wb = wrow[(i * a.words + wd + 1) * kCols];
#pragma unroll
              for (int j = 0; j < NB; ++j)
                if (j < a.bx)
                  cnt[i][j] += __popc(wa & xa[j]) + __popc(wb & xb[j]);
            }
          }
        }
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < NB; ++i) {
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            if (i < a.bw && j < a.bx) {
              float dp = fminf((float)cnt[i][j], a.k_h);
              if (a.noise != nullptr) {
                dp = __fadd_rn(dp, nbuf[(i * a.bx + j) * kCols + lane]);
                dp = fmaxf(dp, 0.f);
              }
              if (a.apply_adc) {
                float code = rintf(__fsub_rn(div_rn(dp, a.delta, r_delta),
                                             0.5f));
                code = fminf(fmaxf(code, 0.f), a.code_max);
                dp = __fmul_rn(__fadd_rn(code, 0.5f), a.delta);
              }
              // signed powers of two: w is always signed, x when x_signed
              float coef = (float)(1u << (i + j));
              if (i == a.bw - 1) coef = -coef;
              if (a.x_signed && j == a.bx - 1) coef = -coef;
              acc = __fadd_rn(acc, __fmul_rn(coef, dp));
            }
          }
        }
        part[(bl * a.chunk + bb) * kCols + lane] = acc;
        // the warp's next item's noise (this lane's reads of nbuf are done:
        // acc, just stored, depends on all of them)
        const int next = item + kWarps;
        if (next < n_items) fetch_noise(g0 + next / nb, b0 + next % nb);
      }
      __syncthreads();

      // phase 3: the banks of the group into the output, in bank order
      for (int bb = warp; bb < nb; bb += kWarps) {
        if (!live) continue;
        float* o = a.out + (size_t)(b0 + bb) * a.M + m;
        float v = g0 == 0 ? 0.f : *o;
        for (int bl = 0; bl < ng; ++bl)
          v = __fadd_rn(v, part[(bl * a.chunk + bb) * kCols + lane]);
        *o = v;
      }
      __syncthreads();  // before the next chunk's or group's words land
    }
  }
}

template <int NB>
int launch(const Args& a, cudaStream_t stream) {
  const int smem =
      (words_w(NB, a) + words_x(a) + words_part(a) + words_noise(NB)) * 4;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;  // the attribute, per instantiation
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        seed_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid((a.M + kCols - 1) / kCols,
                  (a.B + a.b_rows - 1) / a.b_rows);
  seed_kernel<NB><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, K) and w (K, M) float32 integer codes (bx- and bw-bit, two's
// complement bits), noise (n_banks, bw*bx, B, M) float32 or null, out (B, M)
// float32; words (32-row words per bank, even, at least ceil(min(rows, K) /
// 32)), group (banks per group), chunk (batch rows per chunk) and b_rows
// (batch rows per CTA) from kernel_bench.seed_plan.
extern "C" int seed_bitserial_matmul(const void* x, const void* w,
                                     const void* noise, void* out, int B,
                                     int K, int M, int rows, int bx, int bw,
                                     int x_signed, int words, int group,
                                     int chunk, int b_rows, float k_h,
                                     int apply_adc,
                                     float delta, float code_max,
                                     void* stream) {
  if (B < 0 || K < 1 || M < 0 || rows < 1 || bx < 1 || bx > 8 || bw < 1 ||
      bw > 8 || words % 2 || words * 32 < (rows < K ? rows : K) ||
      group < 1 || chunk < 1 || b_rows < 1 ||
      (B + b_rows - 1) / b_rows > 65535 || ((uintptr_t)x | (uintptr_t)w) % 4)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return 0;
  const Args a{(const float*)x, (const float*)w, (const float*)noise,
               (float*)out, B, K, M, rows, bx, bw, x_signed, k_h, apply_adc,
               delta, code_max, words, group, chunk, b_rows};
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = bx > bw ? bx : bw;
  if (nb <= 4) return launch<4>(a, s);
  if (nb == 5) return launch<5>(a, s);
  if (nb == 6) return launch<6>(a, s);
  if (nb == 7) return launch<7>(a, s);
  return launch<8>(a, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

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
// What bounds it on this card.  With the per-cell gain (every projection of
// the serve path) the plane sums are float64 work on the FP64 tensor cores:
// 2 * (plane rows) * K * (Bw * M) operations at 67 TFLOP/s, the rows padded
// to the 32-row tile (28 live at 4 slots and Bx = 7).  Without gain (the
// noiseless LM head) the counts are integer popcounts and the bytes bound it:
// the codes are one byte per element (K*M + B*K + 4*B*M).  Both pay Bw*Bx
// ADC conversions (and with noise Bw*Bx counter-hash normals, each one long
// chain of dependent instructions) per output and bank.  At 4 slots neither
// bound is reached: each of the roles below walks the banks as a chain of
// dependent instructions (PERF.md, the bit-serial finding).
//
// Design:
//  * one CTA per (32 plane rows, 8 weight columns) tile: the plane rows are
//    (b, j) = (row / Bx, row % Bx) of the 32 / Bx batches of the tile, so one
//    row tile holds 4 decode slots, and narrow tiles give 192 CTAs at
//    M = 1536.  The bank loop runs inside the CTA (the TPU's sequential bank
//    grid axis has no counterpart here);
//  * warp specialisation, three roles that overlap across banks.  MMA warp i
//    computes weight plane i and stages a bank's clipped float32 sums in one
//    of two shared-memory buffers; kP1Warps pass-1 warps turn them into
//    terms in place (noise, ADC, signed plane weight, one element per thread
//    at a time, indexed through a per-CTA decode table); the pass-2 warp adds
//    a bank's terms to one float32 running sum per (b, m) in the plain
//    version's i-outer, j-inner order and frees the buffer.  Named barriers
//    hand each buffer on (full, done, empty);
//  * the int8 codes (two's complement; bit p is plane p, the sign plane the
//    top one) and the fp32 gain stream through a 3-stage ring of 128-row
//    chunks filled by cp.async (16-byte pieces of x and the gain, 8-byte
//    pieces of w), zero-filled past the bank's end.  The TPU's (K, Bw, M)
//    fp32 plane operand, 28 bytes per weight, is never built;
//  * with gain: the stacked plane product on the FP64 tensor cores,
//    mma.sync m16n8k16 .f64 (sm_90).  A = the 0/1 input planes, rows (b, j),
//    read bit by bit from the staged x bytes; B = the gain-weighted weight
//    plane i, bit_i(w) ? g : 0, from the staged codes and gain.  Each
//    product is a float32 gain or zero, exact in float64, and a bank's sum of
//    at most `rows` gains near 1 needs about 34 bits, so the float64 sum is
//    exact in any order and rounds once to the plain version's float32;
//  * without gain: __ballot_sync packs each 32-row slice of a plane into one
//    word per plane row of x and per column of w (lanes past the bank's end
//    vote 0), and popcount(x_word & w_word) gives exact int32 counts;
//  * every epilogue step rounds as the plain PyTorch version does
//    (__fmul_rn/__fadd_rn/__fdiv_rn, rintf = half to even), so the result is
//    bit-identical to it, noise included.
//
// The wrapper (imc_mvm.bitserial_cuda) pads the operands so that rows and K
// are multiples of 16 and M of 8; the entry point refuses anything else.
#include <cuda_runtime.h>

#include <cstdint>

#include "prng.cuh"

namespace {

constexpr int kTileN = 8;     // weight columns per CTA (one n8 MMA tile per plane)
constexpr int kMT = 2;        // m16 MMA tiles of plane rows per CTA
constexpr int kTileR = 16 * kMT;  // plane rows per CTA (at most one word)
constexpr int kChunk = 128;   // bank rows per pipeline stage
constexpr int kSlices = kChunk / 32;
constexpr int kXPitch = kChunk + 16;  // bytes per staged x row (bank spread)
constexpr int kStages = 3;
constexpr int kP1Warps = 5;    // pass-1 warps (noise, ADC) per CTA
constexpr int kEpiWarps = kP1Warps + 1;  // and the pass-2 warp (ordered sums)
constexpr int kMinBlocks = 2;  // CTAs per SM the register budget allows

// named barriers (0 is __syncthreads), the last three per stage buffer: the
// MMA warps' chunk pipeline; a bank's sums staged (MMA -> pass 1); its terms
// ready (pass 1 -> pass 2); its buffer free again (pass 2 -> MMA)
constexpr int kBarMma = 1, kBarFull = 2, kBarDone = 4, kBarEmpty = 6;

struct Args {
  const uint8_t* x;    // (B, K) codes, low 8 bits
  const uint8_t* w;    // (K, M) codes, low 8 bits
  const float* gain;   // (K, M) or null
  float* out;          // (B, M)
  int B, K, M, rows, bx, bw, x_signed, bt;  // bt: batches per row tile
  float k_h;
  int apply_adc;
  float adc_delta, adc_max;
  int has_noise;
  uint32_t seed;
  float sigma;
  int col0;  // global index of w's first column in the noise sites
};

template <int MB, bool GAIN>
struct Smem {
  alignas(16) uint8_t x[kStages][kTileR][kXPitch];
  alignas(16) uint8_t w[kStages][kChunk][kTileN];
  alignas(16) float g[GAIN ? kStages : 1][GAIN ? kChunk : 1][kTileN];
  uint32_t xword[GAIN ? 1 : kSlices][kTileR];
  uint32_t wword[GAIN ? 1 : kSlices][MB][kTileN];
  float stage[2][kTileR][MB][kTileN];  // a bank's plane sums, then terms
  float sum[kTileR][kTileN];            // the running sums of pass 2
  // per (plane row, weight plane) index ri = row * Bw + i: row | i << 8 |
  // batch << 16 | (i * Bx + j) << 24, and the signed plane weight
  uint32_t decode[kTileR * MB];
  float weight[kTileR * MB];
};

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes, bool ok) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(ok ? 8 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D = A B + D on the FP64 tensor cores.  Fragments (lane = 4 g + t): a[v] at
// (row g + 8 (v & 1), k t + 4 (v >> 1)); b[v] at (k t + 4 v, col g); d[v] at
// (row g + 8 (v >> 1), col 2 t + (v & 1)).
__device__ __forceinline__ void mma_f64_16x8x16(double (&d)[4],
                                                const double (&a)[8],
                                                const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// 1.0 or 0.0 from bit `sh` of `word`
__device__ __forceinline__ double bit_as_double(uint32_t word, int sh) {
  return __hiloint2double((int)(((word >> sh) & 1u) * 0x3FF00000u), 0);
}

// a pipeline chunk: rows [k0, k_end) of bank `bank`
struct Chunk {
  int bank, k0, k_end;
};

__device__ __forceinline__ Chunk chunk_at(const Args& a, int bank, int k0) {
  return {bank, k0, min(min(bank * a.rows + a.rows, a.K), k0 + kChunk)};
}

// the chunk after c: the rest of its bank, else the next bank's first rows
__device__ __forceinline__ Chunk next_chunk(const Args& a, const Chunk& c) {
  return c.k0 + kChunk < min(c.bank * a.rows + a.rows, a.K)
             ? chunk_at(a, c.bank, c.k0 + kChunk)
             : chunk_at(a, c.bank + 1, (c.bank + 1) * a.rows);
}

// issue the copies of chunk c into stage st; rows past the bank's end are
// zero-filled
template <int MB, bool GAIN>
__device__ __forceinline__ void load_chunk(Smem<MB, GAIN>& sm, const Args& a,
                                           int st, const Chunk& ch, int m0,
                                           int b0, int n_b) {
  constexpr int kThreads = MB * 32;
  const int tid = threadIdx.x;
  const int k0 = ch.k0, k_end = ch.k_end;
  // each copy loop runs once or twice per thread: kept rolled, so that the
  // chunk loop's code stays small
#pragma unroll 1
  for (int p = tid; p < n_b * (kChunk / 16); p += kThreads) {
    const int r = p / (kChunk / 16), c = p % (kChunk / 16);
    const int gk = k0 + c * 16;
    const bool ok = gk < k_end;  // K and rows are multiples of 16
    cp_async(&sm.x[st][r][c * 16],
             ok ? a.x + (size_t)(b0 + r) * a.K + gk : a.x, 16, ok);
  }
#pragma unroll 1
  for (int p = tid; p < kChunk; p += kThreads) {
    const bool ok = k0 + p < k_end;
    cp_async(&sm.w[st][p][0], ok ? a.w + (size_t)(k0 + p) * a.M + m0 : a.w,
             8, ok);
  }
  if constexpr (GAIN) {
#pragma unroll 1
    for (int p = tid; p < 2 * kChunk; p += kThreads) {
      const int r = p >> 1, h = p & 1;
      const bool ok = k0 + r < k_end;
      cp_async(&sm.g[st][r][h * 4],
               ok ? a.gain + (size_t)(k0 + r) * a.M + m0 + h * 4 : a.gain,
               16, ok);
    }
  }
}

// Pass 1 (warps MB .. MB + kP1Warps - 1): for each bank, wait for its
// clipped plane sums and turn the live elements into terms in place, one per
// thread at a time: noise, ADC, signed plane weight.
template <int MB, bool GAIN>
__device__ __forceinline__ void pass1(Smem<MB, GAIN>& sm, const Args& a,
                                      int ptid, int n_banks, int n_b, int m0,
                                      int b0) {
  constexpr int kP1 = kP1Warps * 32;
  static_assert(kP1 % kTileN == 0, "a thread keeps its column");
  const int n_el = n_b * a.bx * a.bw * kTileN;
  const int col = ptid % kTileN;
  const uint32_t h_seed = prng_absorb(prng_seed(a.seed), PRNG_TAG_BITSERIAL);
  for (int bank = 0; bank < n_banks; ++bank) {
    const int buf = bank & 1;
    bar_sync(kBarFull + buf, (MB + kP1Warps) * 32);
    const uint32_t h_bank = prng_absorb(h_seed, (uint32_t)bank);
#pragma unroll 1
    for (int e = ptid; e < n_el; e += kP1) {
      const int ri = e / kTileN;
      const uint32_t code = sm.decode[ri];
      const int row = code & 255, i = (code >> 8) & 255;
      float d = sm.stage[buf][row][i][col];
      if (a.has_noise) {
        uint32_t hs = prng_absorb(h_bank, code >> 24);
        hs = prng_absorb(hs, (uint32_t)b0 + ((code >> 16) & 255));
        hs = prng_absorb(hs, (uint32_t)(a.col0 + m0 + col));
        const float z = prng_normal(hs);
        d = fmaxf(__fadd_rn(d, __fmul_rn(a.sigma, z)), 0.0f);
      }
      if (a.apply_adc) {
        float q = rintf(__fsub_rn(__fdiv_rn(d, a.adc_delta), 0.5f));
        q = fminf(fmaxf(q, 0.0f), a.adc_max);
        d = __fmul_rn(__fadd_rn(q, 0.5f), a.adc_delta);
      }
      sm.stage[buf][row][i][col] = __fmul_rn(sm.weight[ri], d);
    }
    bar_arrive(kBarDone + buf, (kP1Warps + 1) * 32);
  }
}

// Pass 2 (the last warp): one lane per (b, m) adds each bank's terms to its
// running sum in the plain version's i-outer, j-inner order, then frees the
// bank's buffer for bank + 2.
template <int MB, bool GAIN>
__device__ __forceinline__ void pass2(Smem<MB, GAIN>& sm, const Args& a,
                                      int lane, int n_banks, int n_b, int m0,
                                      int b0) {
  for (int bank = 0; bank < n_banks; ++bank) {
    const int buf = bank & 1;
    bar_sync(kBarDone + buf, (kP1Warps + 1) * 32);
    for (int e = lane; e < n_b * kTileN; e += 32) {
      const int bl = e / kTileN, col = e - bl * kTileN;
      const float* term = &sm.stage[buf][bl * a.bx][0][col];
      float s = sm.sum[bl][col];
#pragma unroll 1
      for (int i = 0; i < a.bw; ++i) {
        float tv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tv[j] = j < a.bx ? term[(j * MB + i) * kTileN] : 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < a.bx) s = __fadd_rn(s, tv[j]);
      }
      if (bank + 1 == n_banks)
        a.out[(size_t)(b0 + bl) * a.M + m0 + col] = s;
      else
        sm.sum[bl][col] = s;
    }
    if (bank + 2 < n_banks) bar_arrive(kBarEmpty + buf, (MB + 1) * 32);
  }
}

template <int MB, bool GAIN>
__global__ void __launch_bounds__((MB + kEpiWarps) * 32, kMinBlocks)
    bitserial_kernel(const Args a) {
  __shared__ Smem<MB, GAIN> sm;
  constexpr int kMma = MB * 32, kAll = (MB + kEpiWarps) * 32;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kTileN;
  const int b0 = blockIdx.y * a.bt;
  const int n_b = min(a.bt, a.B - b0);  // batches of this tile
  const int n_rows = n_b * a.bx;        // live plane rows
  const int n_banks = (a.K + a.rows - 1) / a.rows;
  const int per_bank = (a.rows + kChunk - 1) / kChunk;
  const int last_rows = a.K - (n_banks - 1) * a.rows;
  const int n_chunks =
      (n_banks - 1) * per_bank + (last_rows + kChunk - 1) / kChunk;

  for (int e = tid; e < (int)(sizeof(sm.xword) / 4); e += kAll)
    (&sm.xword[0][0])[e] = 0u;  // rows past n_rows stay zero
  for (int e = tid; e < kTileR * kTileN; e += kAll)
    (&sm.sum[0][0])[e] = 0.0f;
  for (int ri = tid; ri < kTileR * MB; ri += kAll) {
    const int row = ri / a.bw, i = ri - row * a.bw;  // live below n_rows
    const int bl = row / a.bx, j = row - bl * a.bx;
    sm.decode[ri] = (uint32_t)(row & 255) | (uint32_t)i << 8 |
                    (uint32_t)(bl & 255) << 16 | (uint32_t)(i * a.bx + j) << 24;
    const float wwt = (i == a.bw - 1) ? -(float)(1 << i) : (float)(1 << i);
    const float xwt = (a.x_signed && j == a.bx - 1) ? -(float)(1 << j)
                                                    : (float)(1 << j);
    sm.weight[ri] = wwt * xwt;
  }
  __syncthreads();
  if (warp >= MB + kP1Warps) {
    pass2(sm, a, lane, n_banks, n_b, m0, b0);
    return;
  }
  if (warp >= MB) {
    pass1(sm, a, tid - kMma, n_banks, n_b, m0, b0);
    return;
  }

  // warp i's plane sums: kMT m16 tiles x one n8 tile, fragment layout
  double acc[kMT][4];
  int cnt[kMT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      acc[mt][v] = 0.0;
      cnt[mt][v] = 0;
    }
  const bool mma_warp = warp < a.bw;
  // with gain the A fragments come straight from the staged x bytes: this
  // lane's rows g + 8 r (r = 2 mt + h) are plane xj[r] of staged batch
  // xb[r] (rows past n_rows read batch 0 and are masked)
  int xb[2 * kMT], xj[2 * kMT];
  uint32_t xmask[2 * kMT];
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
    const int row = 8 * r + g;
    const bool live = row < n_rows;
    xb[r] = live ? row / a.bx : 0;
    xj[r] = live ? row - xb[r] * a.bx : 0;
    xmask[r] = live ? 1u : 0u;
  }

  Chunk ld = chunk_at(a, 0, 0);  // the next chunk to load
  int ld_st = 0;
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_chunk(sm, a, ld_st, ld, m0, b0, n_b);
    cp_async_commit();
    ld = next_chunk(a, ld);
    ld_st = ld_st + 1 == kStages ? 0 : ld_st + 1;
  }
  Chunk ch = chunk_at(a, 0, 0);
  int st = 0;
  for (int q = 0; q < n_chunks; ++q) {
    cp_async_wait<kStages - 2>();
    bar_sync(kBarMma, kMma);  // chunk q landed; chunk q-1's stage is free
    if (q + kStages - 1 < n_chunks) load_chunk(sm, a, ld_st, ld, m0, b0, n_b);
    cp_async_commit();
    ld = next_chunk(a, ld);
    ld_st = ld_st + 1 == kStages ? 0 : ld_st + 1;
    const int nk = ch.k_end - ch.k0;

    // without gain: plane words per (slice, plane row) of x and per (slice,
    // plane, column) of w.  Lane l holds row k0 + 32 s + l.
    if constexpr (!GAIN) {
      for (int job = warp; job < n_b * kSlices; job += MB) {
        const int b = job / kSlices, s = job - b * kSlices;
        const int kk = s * 32 + lane;
        const uint32_t byte = kk < nk ? sm.x[st][b][kk] : 0u;
        uint32_t mine = 0;
#pragma unroll 1
        for (int j = 0; j < a.bx; ++j) {
          const uint32_t word = __ballot_sync(0xffffffffu, (byte >> j) & 1u);
          if (lane == j) mine = word;
        }
        if (lane < a.bx) sm.xword[s][b * a.bx + lane] = mine;
      }
      for (int job = warp; job < kTileN * kSlices; job += MB) {
        const int col = job / kSlices, s = job - col * kSlices;
        const int kk = s * 32 + lane;
        const uint32_t byte = kk < nk ? sm.w[st][kk][col] : 0u;
        uint32_t mine = 0;
#pragma unroll 1
        for (int i = 0; i < a.bw; ++i) {
          const uint32_t word = __ballot_sync(0xffffffffu, (byte >> i) & 1u);
          if (lane == i) mine = word;
        }
        if (lane < a.bw) sm.wword[s][lane][col] = mine;
      }
      bar_sync(kBarMma, kMma);
    }

    if (mma_warp) {
      if constexpr (GAIN) {
        // stacked plane product: A = input planes (rows (b, j)), B = weight
        // plane `warp` times the gain, one k16 step at a time
        for (int kb = t; kb < nk; kb += 16) {
          double bf[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const uint32_t wb = sm.w[st][kb + 4 * v][g];
            const double gv = (double)sm.g[st][kb + 4 * v][g];
            bf[v] = ((wb >> warp) & 1u) ? gv : 0.0;
          }
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            if (mt * 16 >= n_rows) break;  // no live row
            double af[8];
#pragma unroll
            for (int v = 0; v < 8; ++v) {
              const int r = 2 * mt + (v & 1);
              const uint32_t byte = sm.x[st][xb[r]][kb + 4 * (v >> 1)];
              af[v] = bit_as_double(byte & (xmask[r] << xj[r]), xj[r]);
            }
            mma_f64_16x8x16(acc[mt], af, bf);
          }
        }
      } else {
        for (int s = 0; s < kSlices && s * 32 < nk; ++s) {
          const uint32_t w0 = sm.wword[s][warp][2 * t];
          const uint32_t w1 = sm.wword[s][warp][2 * t + 1];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const uint32_t xv = sm.xword[s][mt * 16 + hh * 8 + g];
              cnt[mt][2 * hh] += __popc(xv & w0);
              cnt[mt][2 * hh + 1] += __popc(xv & w1);
            }
        }
      }
    }

    const int bank = ch.bank;
    ch = next_chunk(a, ch);
    st = st + 1 == kStages ? 0 : st + 1;
    if (q + 1 < n_chunks && ch.bank == bank) continue;

    // the bank is done: hand its clipped sums to the pass-1 warps (fragment
    // element v of tile mt: row 16 mt + g + 8 (v >> 1), column 2 t + (v & 1))
    // once the pass-2 warp has emptied the buffer of bank - 2
    const int buf = bank & 1;
    if (bank >= 2) bar_sync(kBarEmpty + buf, (MB + 1) * 32);
    if (mma_warp) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int row = mt * 16 + g + 8 * (v >> 1);
          if (row < n_rows)
            sm.stage[buf][row][warp][2 * t + (v & 1)] =
                fminf(GAIN ? __double2float_rn(acc[mt][v])
                           : (float)cnt[mt][v],
                      a.k_h);
          acc[mt][v] = 0.0;
          cnt[mt][v] = 0;
        }
    }
    bar_arrive(kBarFull + buf, (MB + kP1Warps) * 32);
  }
  cp_async_wait<0>();
}

template <int MB, bool GAIN>
int launch(const Args& a, cudaStream_t stream) {
  dim3 grid(a.M / kTileN, (a.B + a.bt - 1) / a.bt);
  bitserial_kernel<MB, GAIN><<<grid, (MB + kEpiWarps) * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int imc_bitserial_matmul(const void* x, const void* w,
                                    const void* gain, void* out, int B, int K,
                                    int M, int rows, int bx, int bw,
                                    int x_signed, float k_h, int apply_adc,
                                    float adc_delta, float adc_max,
                                    int has_noise, uint32_t seed, float sigma,
                                    int col0, void* stream) {
  if (B == 0 || M == 0) return 0;
  if (bx < 1 || bw < 1 || bx > 8 || bw > 8 || rows < 1 || K < 0)
    return (int)cudaErrorInvalidValue;
  // the layout the wrapper makes: 16-row K steps, 8-column tiles, 16-byte
  // aligned operands
  if (rows % 16 != 0 || K % 16 != 0 || M % kTileN != 0 ||
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)gain) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int bt = kTileR / bx;
  if ((B + bt - 1) / bt > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (K == 0)  // no bank: the sum is empty
    return (int)cudaMemsetAsync(out, 0, (size_t)B * M * sizeof(float), s);
  const Args a{(const uint8_t*)x, (const uint8_t*)w, (const float*)gain,
               (float*)out, B, K, M, rows, bx, bw, x_signed, bt, k_h,
               apply_adc, adc_delta, adc_max, has_noise, seed, sigma, col0};
  const bool small = bw <= 7;
  if (gain != nullptr)
    return small ? launch<7, true>(a, s) : launch<8, true>(a, s);
  return small ? launch<7, false>(a, s) : launch<8, false>(a, s);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Paged-attention decode on Hopper: one token per slot against a paged KV pool.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::_paged_kernel
// (pallas_call in _decode_pallas).  What it computes is the same: scatter the
// new token's K/V into its tail block (garbage block 0 for inactive and
// overrun rows), then attend over the slot's blocks in LOGICAL order with an
// fp32 online softmax (running max m, sum l, accumulator acc), optional tanh
// softcap, GQA groups and the mask  logical_row <= pos.
//
// What bounds it: bytes.  A decode step reads each live K/V row of the slot
// once (2 * ctx * Hkv * hd * 2 B per slot in bf16) and does ~4 flops per
// byte, far below the card's ~295 flops/byte balance point.  So the design
// is about keeping enough independent row loads in flight:
//  * split pass: one CTA per (kv head, slot, split of 128 logical rows); each
//    of its 4 warps walks its own rows, 4 at a time (the 4 rows' loads are
//    issued before any is used), with its own online-softmax state; a lane
//    holds hd/32 dimensions, a row's dot product is one warp reduction, and
//    the G query rows of the group share every K/V row loaded.  The CTA
//    merges its warps and writes one partial (m, l, acc) per split.  The CTA
//    reads bt[b, j] itself (the TPU kernel's scalar prefetch has no
//    counterpart);
//  * combine pass: one CTA per (kv head, slot) merges the splits that hold
//    valid rows and writes ctx = acc / max(l, 1e-30);
//  * the TPU's sequential grid axis over blocks becomes the split axis plus
//    the loops inside a warp; only rows up to each slot's position are read
//    (a masked row adds p = 0 and a correction of 1, so skipping is exact);
//  * only the one new row (dest, off) is written, not whole blocks; the new
//    token is overlaid from k_new/v_new where it is attended, and only for
//    active rows, so an inactive row attends the stale pool value like the
//    gather path.  Writes of several inactive slots to block 0 may race;
//    block 0 is garbage by contract, so they take no lock.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerStep = 4;   // rows a warp loads before using any
constexpr int kSplitRows = 128;   // logical rows per split CTA
constexpr int kMaxG = 8;          // query rows per kv head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Slot {
  int p, tail, off, limit;  // position, tail block, row in it, valid rows
  bool active;
};

__device__ __forceinline__ Slot slot_of(const int* pos, const int* act, int b,
                                        int bs, int max_blocks) {
  Slot s;
  s.p = pos[b];
  s.active = act[b] != 0;
  s.tail = s.p / bs;
  s.off = s.p - s.tail * bs;
  // rows 0..p are valid, within the table's capacity
  s.limit = min(s.p + 1, max_blocks * bs);
  return s;
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const float* __restrict__ q, const T* __restrict__ kn,
                   const T* __restrict__ vn, T* pk, T* pv,
                   const int* __restrict__ bt, const int* __restrict__ pos,
                   const int* __restrict__ act, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc,
                   int hkv, int g, int hd, int bs, int max_blocks,
                   int n_splits, float scale, float cap, int use_cap) {
  extern __shared__ float smem[];  // kWarps * g * (hd + 2)
  const int h = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Slot s = slot_of(pos, act, b, bs, max_blocks);
  const int* bt_row = bt + (size_t)b * max_blocks;
  const size_t new_base = ((size_t)b * hkv + h) * hd;

  if (sp == 0) {
    // the one new row: the slot's tail block for an active in-range row,
    // garbage block 0 otherwise
    const int dest = (s.tail >= max_blocks || !s.active) ? 0 : bt_row[s.tail];
    for (int d = tid; d < hd; d += kThreads) {
      const size_t at = (((size_t)dest * bs + s.off) * hkv + h) * hd + d;
      pk[at] = kn[new_base + d];
      pv[at] = vn[new_base + d];
    }
  }
  const int row_lo = sp * kSplitRows;
  const int row_hi = min(row_lo + kSplitRows, s.limit);
  if (row_lo >= row_hi) return;  // the combine pass never reads this split

  float qv[kMaxG][DPL], acc[kMaxG][DPL], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg) {
    m[gg] = kNegInf;
    l[gg] = 0.0f;
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane * DPL + t;
      qv[gg][t] = (gg < g && d < hd)
                      ? q[(((size_t)b * hkv + h) * g + gg) * hd + d] : 0.0f;
      acc[gg][t] = 0.0f;
    }
  }

  for (int r0 = row_lo + warp * kRowsPerStep; r0 < row_hi;
       r0 += kWarps * kRowsPerStep) {
    float kr[kRowsPerStep][DPL], vr[kRowsPerStep][DPL];
#pragma unroll
    for (int u = 0; u < kRowsPerStep; ++u) {
      const int lr = r0 + u;
      const int j = lr / bs, rr = lr - j * bs;
      const bool fresh = s.active && j == s.tail && rr == s.off;
      const size_t at =
          lr < row_hi ? (((size_t)bt_row[j] * bs + rr) * hkv + h) * hd : 0;
#pragma unroll
      for (int t = 0; t < DPL; ++t) {
        const int d = lane * DPL + t;
        float kx = 0.0f, vx = 0.0f;
        if (lr < row_hi && d < hd) {
          kx = to_f32(fresh ? kn[new_base + d] : pk[at + d]);
          vx = to_f32(fresh ? vn[new_base + d] : pv[at + d]);
        }
        kr[u][t] = kx;
        vr[u][t] = vx;
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsPerStep; ++u) {
      if (r0 + u >= row_hi) break;
#pragma unroll
      for (int gg = 0; gg < kMaxG; ++gg) {
        if (gg >= g) break;
        float dot = 0.0f;
#pragma unroll
        for (int t = 0; t < DPL; ++t) dot += qv[gg][t] * kr[u][t];
        float sc = warp_sum(dot) * scale;
        if (use_cap) sc = cap * tanhf(sc / cap);
        const float m_new = fmaxf(m[gg], sc);
        const float corr = expf(m[gg] - m_new);
        const float pr = expf(sc - m_new);
        l[gg] = l[gg] * corr + pr;
#pragma unroll
        for (int t = 0; t < DPL; ++t)
          acc[gg][t] = acc[gg][t] * corr + pr * vr[u][t];
        m[gg] = m_new;
      }
    }
  }

  // merge the warps: stage (m, l, acc) per warp in shared memory
  float* w_m = smem;                       // kWarps * g
  float* w_l = w_m + kWarps * g;           // kWarps * g
  float* w_acc = w_l + kWarps * g;         // kWarps * g * hd
#pragma unroll
  for (int gg = 0; gg < kMaxG; ++gg) {
    if (gg >= g) break;
    if (lane == 0) {
      w_m[warp * g + gg] = m[gg];
      w_l[warp * g + gg] = l[gg];
    }
#pragma unroll
    for (int t = 0; t < DPL; ++t) {
      const int d = lane * DPL + t;
      if (d < hd) w_acc[(warp * g + gg) * hd + d] = acc[gg][t];
    }
  }
  __syncthreads();
  const size_t part = ((size_t)b * hkv + h) * n_splits + sp;
  for (int idx = tid; idx < g * hd; idx += kThreads) {
    const int gg = idx / hd, d = idx - gg * hd;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_m[w * g + gg]);
    float lsum = 0.0f, a = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(w_m[w * g + gg] - mx);  // 0 for an idle warp
      lsum += c * w_l[w * g + gg];
      a += c * w_acc[(w * g + gg) * hd + d];
    }
    part_acc[part * g * hd + idx] = a;
    if (d == 0) {
      part_m[part * g + gg] = mx;
      part_l[part * g + gg] = lsum;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const int* __restrict__ pos,
                     const float* __restrict__ part_m,
                     const float* __restrict__ part_l,
                     const float* __restrict__ part_acc,
                     float* __restrict__ ctx, int hkv, int g, int hd, int bs,
                     int max_blocks, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int limit = min(pos[b] + 1, max_blocks * bs);
  const int used = (limit + kSplitRows - 1) / kSplitRows;
  const size_t part0 = ((size_t)b * hkv + h) * n_splits;
  for (int idx = threadIdx.x; idx < g * hd; idx += kThreads) {
    const int gg = idx / hd;
    float mx = kNegInf;
    for (int sp = 0; sp < used; ++sp)
      mx = fmaxf(mx, part_m[(part0 + sp) * g + gg]);
    float lsum = 0.0f, a = 0.0f;
    for (int sp = 0; sp < used; ++sp) {
      const float c = expf(part_m[(part0 + sp) * g + gg] - mx);
      lsum += c * part_l[(part0 + sp) * g + gg];
      a += c * part_acc[(part0 + sp) * g * hd + idx];
    }
    ctx[(((size_t)b * hkv + h) * g) * hd + idx] = a / fmaxf(lsum, 1e-30f);
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* kn, const void* vn, void* pk, void* pv,
           const void* bt, const void* pos, const void* act, void* scratch,
           void* ctx, int b, int hkv, int g, int hd, int bs, int max_blocks,
           float scale, float cap, int use_cap, cudaStream_t stream) {
  const int n_splits = (max_blocks * bs + kSplitRows - 1) / kSplitRows;
  float* part_m = (float*)scratch;
  float* part_l = part_m + (size_t)b * hkv * n_splits * g;
  float* part_acc = part_l + (size_t)b * hkv * n_splits * g;
  // at most kWarps * kMaxG * (256 + 2) floats = 33 KB: under the 48 KB
  // that needs no opt-in
  const size_t smem = sizeof(float) * kWarps * g * (hd + 2);
  paged_split_kernel<T, DPL><<<dim3(hkv, b, n_splits), kThreads, smem,
                               stream>>>(
      (const float*)q, (const T*)kn, (const T*)vn, (T*)pk, (T*)pv,
      (const int*)bt, (const int*)pos, (const int*)act, part_m, part_l,
      part_acc, hkv, g, hd, bs, max_blocks, n_splits, scale, cap, use_cap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_combine_kernel<<<dim3(hkv, b), kThreads, 0, stream>>>(
      (const int*)pos, part_m, part_l, part_acc, (float*)ctx, hkv, g, hd, bs,
      max_blocks, n_splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dpl(const void* q, const void* kn, const void* vn, void* pk,
               void* pv, const void* bt, const void* pos, const void* act,
               void* scratch, void* ctx, int b, int hkv, int g, int hd, int bs,
               int max_blocks, float scale, float cap, int use_cap,
               cudaStream_t s) {
  if (hd <= 32)
    return launch<T, 1>(q, kn, vn, pk, pv, bt, pos, act, scratch, ctx, b, hkv,
                        g, hd, bs, max_blocks, scale, cap, use_cap, s);
  if (hd <= 64)
    return launch<T, 2>(q, kn, vn, pk, pv, bt, pos, act, scratch, ctx, b, hkv,
                        g, hd, bs, max_blocks, scale, cap, use_cap, s);
  if (hd <= 128)
    return launch<T, 4>(q, kn, vn, pk, pv, bt, pos, act, scratch, ctx, b, hkv,
                        g, hd, bs, max_blocks, scale, cap, use_cap, s);
  return launch<T, 8>(q, kn, vn, pk, pv, bt, pos, act, scratch, ctx, b, hkv,
                      g, hd, bs, max_blocks, scale, cap, use_cap, s);
}

}  // namespace

// scratch: 2 * B * Hkv * n_splits * G + B * Hkv * n_splits * G * hd floats,
// n_splits = ceil(max_blocks * bs / paged_attention_split_rows())
extern "C" int paged_attention_split_rows() { return kSplitRows; }

extern "C" int paged_attention_decode(const void* q, const void* kn,
                                      const void* vn, void* pk, void* pv,
                                      const void* bt, const void* pos,
                                      const void* act, void* scratch,
                                      void* ctx, int b, int hkv, int g, int hd,
                                      int bs, int max_blocks, int dtype,
                                      float scale, float cap, int use_cap,
                                      void* stream) {
  if (b == 0) return 0;
  if (g < 1 || g > kMaxG || hd < 1 || hd > 256 || bs < 1 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_dpl<float>(q, kn, vn, pk, pv, bt, pos, act, scratch, ctx,
                               b, hkv, g, hd, bs, max_blocks, scale, cap,
                               use_cap, s);
    case 1:
      return launch_dpl<__nv_bfloat16>(q, kn, vn, pk, pv, bt, pos, act,
                                       scratch, ctx, b, hkv, g, hd, bs,
                                       max_blocks, scale, cap, use_cap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Paged-attention decode on Hopper: one token per slot against a paged KV pool.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::_paged_kernel
// (pallas_call in _decode_pallas).  What it computes is the same: scatter the
// new token's K/V into its tail block (garbage block 0 for inactive and
// overrun rows), then attend over the slot's blocks in LOGICAL order with an
// fp32 online softmax (running max m, sum l, accumulator acc), optional tanh
// softcap, GQA groups and the mask  logical_row <= pos.
//
// The scatter is a launch of its own (paged_write_kernel), finished before
// any row is read, and where several slots route their row to the same pool
// row the highest slot's lands, as in the plain version.  So every slot
// reads the same bits on every run, inactive ones included: several
// inactive slots write block 0 at the same offsets and read it back, and a
// retired slot's stale table may point at a block a live slot writes.  (An
// inactive row's output feeds the batch-wide quantizer ranges of the IMC
// substrates, so a race there would reach the live rows.)
//
// What bounds it: bytes.  A decode step reads each live K/V row of the slot
// once (2 * ctx * Hkv * hd * 2 B per slot in bf16) and does ~4 flops per
// byte, far below the card's ~295 flops/byte balance point.  Design:
//  * one CTA per (group of up to 8 kv heads, chunk of up to GM query rows
//    of each head, slot, split of split_rows logical rows), one warp per
//    head.  A logical row of the pool holds the group's heads side by side,
//    heads * hd contiguous elements, so the CTA copies whole rows (1 KB for
//    8 heads of 64 bf16).  A group of more query rows per kv head than the
//    plan's GM (2; granite-20b has 48 on one kv head) takes one launch all
//    the same: each chunk of GM rows is a CTA of its own on the grid's x
//    axis, and the chunks' CTAs read the same K/V rows (L2 holds them).  (The
//    register state grows with GM: at 4 and 8 it spills, and one chunk of 8
//    ran 1.4-1.9x slower than four or twenty-four chunks of 2);
//  * the pool offset of each row of the split is computed once at the start
//    (its block-table entry read once, together with the queries) into
//    shared memory, so the copies wait on no further global load and do no
//    division;
//  * K and V rows stream through a kStages-deep ring of stage_rows-row
//    stages, filled by 16-byte cp.async: two stages are in flight while the
//    warps work on the third.  A warp's work per stage is short (no generic
//    loads, no division): with one or two CTAs per SM each warp runs alone
//    on its scheduler, so its instruction count per stage is its latency;
//  * within a warp, LPR lanes hold one row as 16-byte vectors (8 bf16 or 4
//    f32 each; LPR = 8 for hd = 64 in bf16), so 32 / LPR row groups score
//    rows at once; a stage holds kRows = 4 rows per row group (128 / LPR
//    rows, 16 KB of K and 16 KB of V for 8 heads of 64 bf16), and a group
//    folds its four into its online-softmax state in one step (one
//    correction, base-2 exponentials).  A row's dot product takes log2(LPR)
//    shuffles; the groups' states are merged by a fixed butterfly at the
//    end.  Register state is sized by the instantiated query-group count;
//  * the plan (heads per CTA, stage and split rows, scratch) is made in
//    Python (paged_attention.plan_split), so the grid fills the SMs from the
//    table's capacity without reading the positions on the host;
//  * a slot whose rows span several splits writes one partial (m, l, acc)
//    per split, and a combine pass merges them in split order, so the
//    result is the same bits on every run; its loads do not wait on one
//    another.  (A merge by the last CTA of each slot, found by an atomic
//    count, was slower: its fences and three dependent rounds of global
//    loads sat on the critical path.)  A slot with one split writes ctx
//    itself;
//  * only rows up to each slot's position are read (a masked row adds p = 0
//    and a correction of 1, so skipping is exact); only the one new row of
//    each slot is written, not whole blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStages = 3;
constexpr int kRows = 4;      // rows of a stage per row group of a warp
constexpr int kMaxHeads = 8;  // kv heads per CTA, one warp each
constexpr int kMaxG = 8;      // query rows of a kv head per CTA
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Vec;  // one 16-byte vector of T as floats
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&o)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&o)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<uint32_t*>(&h) = u[i];
      const float2 f = __bfloat1622float2(h);
      o[2 * i] = f.x, o[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

struct Plan {
  int heads, stage_rows, split_rows, n_splits;
  int ring_bytes;  // the stage ring
};

// the pool row (block * bs + offset) slot r writes: its tail block when it
// is active and within capacity, garbage block 0 otherwise
__device__ __forceinline__ int64_t write_row(const int* bt, const int* pos,
                                            const int* act, int r, int bs,
                                            int max_blocks) {
  const int p = pos[r], tail = p / bs;
  const int dest = (tail >= max_blocks || act[r] == 0)
                       ? 0
                       : bt[(size_t)r * max_blocks + tail];
  return (int64_t)dest * bs + (p - tail * bs);
}

// the scatter: one CTA per slot copies its new K/V row (all kv heads, a
// multiple of 16 bytes) into the pools as 16-byte vectors, unless a higher
// slot writes the same pool row
template <typename T>
__global__ void paged_write_kernel(const T* __restrict__ kn,
                                   const T* __restrict__ vn,
                                   T* __restrict__ pk, T* __restrict__ pv,
                                   const int* __restrict__ bt,
                                   const int* __restrict__ pos,
                                   const int* __restrict__ act, int b,
                                   int row_elems, int bs, int max_blocks) {
  const int s = blockIdx.x;
  const int64_t at = write_row(bt, pos, act, s, bs, max_blocks);
  for (int r = s + 1; r < b; ++r)
    if (write_row(bt, pos, act, r, bs, max_blocks) == at) return;
  const int n_vec = row_elems * (int)sizeof(T) / 16;
  const uint4* ks = reinterpret_cast<const uint4*>(kn + (size_t)s * row_elems);
  const uint4* vs = reinterpret_cast<const uint4*>(vn + (size_t)s * row_elems);
  uint4* kd = reinterpret_cast<uint4*>(pk + (size_t)at * row_elems);
  uint4* vd = reinterpret_cast<uint4*>(pv + (size_t)at * row_elems);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    kd[i] = ks[i];
    vd[i] = vs[i];
  }
}

// LPR lanes per row, NV 16-byte vectors per lane, GM query rows per head
template <typename T, int LPR, int NV, int GM>
__global__ void __launch_bounds__(kMaxHeads * 32, 2)
paged_kernel(const float* __restrict__ q, const T* __restrict__ pk,
             const T* __restrict__ pv, const int* __restrict__ bt,
             const int* __restrict__ pos, float* __restrict__ part_ml,
             float* __restrict__ part_acc, float* __restrict__ ctx, int hkv,
             int g, int hd, int bs, int max_blocks, Plan plan, float scale,
             float cap, int use_cap) {
  constexpr int kVec = Vec<T>::kN;
  constexpr int kRowGroups = 32 / LPR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // x: (head group, query chunk); y: slot; z: split
  const int q_chunks = (g + GM - 1) / GM;
  const int hgroup = blockIdx.x / q_chunks, qc = blockIdx.x % q_chunks;
  const int b = blockIdx.y, sp = blockIdx.z;
  const int g0 = qc * GM;  // this CTA's first query row of each head
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int heads = plan.heads, sr = plan.stage_rows;
  const int h0 = hgroup * heads, h = h0 + warp;
  const int row_elems = heads * hd;  // one logical row of the head group
  const int* bt_row = bt + (size_t)b * max_blocks;

  // the pool offset of each logical row of the split (its block-table
  // entry read once), computed with the queries before the slot's position
  // is known, so no copy address waits on two dependent global loads and
  // the copy loop does no division
  const int lo = sp * plan.split_rows;
  T* stages = reinterpret_cast<T*>(smem_raw);  // [kStages][2][sr][row_elems]
  int64_t* row_at =  // [split_rows]
      reinterpret_cast<int64_t*>(smem_raw + plan.ring_bytes);
  const int n_rows = min(plan.split_rows, max_blocks * bs - lo);
  for (int i = tid; i < n_rows; i += blockDim.x) {
    const int row = lo + i, j = row / bs;
    row_at[i] = (((int64_t)bt_row[j] * bs + (row - j * bs)) * hkv + h0) * hd;
  }

  // this lane's vectors of a row: indices v * LPR + li, valid below nvr;
  // each row group takes kRows rows of every stage (sr = kRows *
  // kRowGroups); m is kept in the base-2 domain (log2 e times the score)
  const int li = lane % LPR, grp = lane / LPR;
  const int nvr = hd / kVec;
  float qv[GM][NV][kVec], acc[GM][NV][kVec], m[GM], l[GM];
#pragma unroll
  for (int gg = 0; gg < GM; ++gg) {
    m[gg] = kNegInf;
    l[gg] = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int vi = v * LPR + li;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        qv[gg][v][e] = (g0 + gg < g && vi < nvr)
            ? q[(((size_t)b * hkv + h) * g + g0 + gg) * hd + vi * kVec + e]
            : 0.0f;
        acc[gg][v][e] = 0.0f;
      }
    }
  }

  const int limit = min(pos[b] + 1, max_blocks * bs);  // rows 0..pos

  const int hi = min(lo + plan.split_rows, limit);
  if (lo >= hi) return;  // the whole CTA: no barrier is left waiting
  const int used = (limit + plan.split_rows - 1) / plan.split_rows;
  __syncthreads();

  // a stage: each warp copies whole rows (K rows, then V rows), lanes on
  // consecutive 16-byte chunks
  const int chunks_per_row = row_elems / kVec;
  const int n_warps = blockDim.x >> 5;
  auto fill = [&](int st, int r0) {
    T* dst0 = stages + (size_t)st * 2 * sr * row_elems;
    for (int rr = warp; rr < sr; rr += n_warps) {
      if (r0 + rr >= hi) break;
      const int64_t at = row_at[r0 + rr - lo];
      T* dk = dst0 + (size_t)rr * row_elems;
      T* dv = dk + (size_t)sr * row_elems;
      for (int ch = lane; ch < chunks_per_row; ch += 32) {
        cp_async16(dk + ch * kVec, pk + at + ch * kVec);
        cp_async16(dv + ch * kVec, pv + at + ch * kVec);
      }
    }
  };

  const int n_st = (hi - lo + sr - 1) / sr;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_st) fill(s, lo + s * sr);
    cp_async_commit();
  }
  for (int t = 0; t < n_st; ++t) {
    cp_async_wait_stages();
    // stage t has landed for every thread, and every warp is done with
    // stage t - 1, which is refilled next
    __syncthreads();
    const int nxt = t + kStages - 1;
    if (nxt < n_st) fill(nxt % kStages, lo + nxt * sr);
    cp_async_commit();
    const T* ks = stages + (size_t)(t % kStages) * 2 * sr * row_elems +
                  (size_t)warp * hd;
    const T* vs = ks + (size_t)sr * row_elems;
    const int r0 = lo + t * sr;
    float kx[kRows][NV][kVec], vx[kRows][NV][kVec];
    bool valid[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int rr = grp + u * kRowGroups, row = r0 + rr;
      valid[u] = row < hi;
      const T* kp = ks + (size_t)rr * row_elems;
      const T* vp = vs + (size_t)rr * row_elems;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int vi = v * LPR + li;
        if (valid[u] && vi < nvr) {
          Vec<T>::load(kp + vi * kVec, kx[u][v]);
          Vec<T>::load(vp + vi * kVec, vx[u][v]);
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kx[u][v][e] = 0.0f, vx[u][v][e] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int gg = 0; gg < GM; ++gg) {
      float sc[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        float dot = 0.0f;
#pragma unroll
        for (int v = 0; v < NV; ++v)
#pragma unroll
          for (int e = 0; e < kVec; ++e) dot += qv[gg][v][e] * kx[u][v][e];
        sc[u] = dot;
      }
      // each row's dot product over its LPR lanes; every lane of the warp
      // takes part in the shuffles
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], o);
      if (g0 + gg >= g) continue;
      // scores in the base-2 domain: exp(s - m) = exp2(s log2 e - m log2 e)
      float m_new = m[gg];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        sc[u] *= scale;
        if (use_cap) sc[u] = cap * tanhf(sc[u] / cap);
        sc[u] = valid[u] ? sc[u] * kLog2e : kNegInf;
        m_new = fmaxf(m_new, sc[u]);
      }
      // the group's rows of the stage in one online-softmax step
      const float corr = exp2f(m[gg] - m_new);
      float pr[kRows], psum = 0.0f;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        pr[u] = valid[u] ? exp2f(sc[u] - m_new) : 0.0f;
        psum += pr[u];
      }
      l[gg] = l[gg] * corr + psum;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          float pv_sum = 0.0f;
#pragma unroll
          for (int u = 0; u < kRows; ++u) pv_sum += pr[u] * vx[u][v][e];
          acc[gg][v][e] = acc[gg][v][e] * corr + pv_sum;
        }
      m[gg] = m_new;
    }
  }

  // merge the row groups of the warp: a fixed butterfly (each pair's sums
  // are commutative, so every group ends with the same bits)
#pragma unroll
  for (int gg = 0; gg < GM; ++gg) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[gg], o);
      const float lx = __shfl_xor_sync(0xffffffffu, l[gg], o);
      const float mn = fmaxf(m[gg], mo);
      const float c1 = exp2f(m[gg] - mn), c2 = exp2f(mo - mn);
      l[gg] = l[gg] * c1 + lx * c2;
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[gg][v][e], o);
          acc[gg][v][e] = acc[gg][v][e] * c1 + ao * c2;
        }
      m[gg] = mn;
    }
  }

  const size_t part0 = ((size_t)b * hkv + h) * plan.n_splits;
  if (grp == 0) {
#pragma unroll
    for (int gg = 0; gg < GM; ++gg) {
      if (g0 + gg >= g) break;
      const size_t pi = (part0 + sp) * g + g0 + gg;
      if (used > 1 && li == 0) {
        part_ml[2 * pi] = m[gg];
        part_ml[2 * pi + 1] = l[gg];
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int vi = v * LPR + li;
        if (vi >= nvr) continue;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int d = vi * kVec + e;
          if (used > 1)
            part_acc[pi * hd + d] = acc[gg][v][e];
          else
            ctx[(((size_t)b * hkv + h) * g + g0 + gg) * hd + d] =
                acc[gg][v][e] / fmaxf(l[gg], 1e-30f);
        }
      }
    }
  }
}

// the combine pass: one CTA per (kv head, slot), one thread per output
// (query row, dimension), merges the splits of a slot that used more than
// one, in split order (the same bits on every run), in one pass with a
// running max: no load waits on another
__global__ void paged_combine_kernel(const int* __restrict__ pos,
                                     const float* __restrict__ part_ml,
                                     const float* __restrict__ part_acc,
                                     float* __restrict__ ctx, int hkv, int g,
                                     int hd, int bs, int max_blocks,
                                     Plan plan) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int limit = min(pos[b] + 1, max_blocks * bs);
  const int used = (limit + plan.split_rows - 1) / plan.split_rows;
  if (used == 1) return;  // the split kernel wrote ctx itself
  for (int idx = threadIdx.x; idx < g * hd; idx += blockDim.x) {
    const int gg = idx / hd, d = idx - gg * hd;
    const size_t p0 = ((size_t)b * hkv + h) * plan.n_splits * g + gg;
    float mx = kNegInf, lsum = 0.0f, a = 0.0f;
#pragma unroll 4
    for (int s = 0; s < used; ++s) {
      const size_t pi = p0 + (size_t)s * g;
      const float ms = part_ml[2 * pi], ls = part_ml[2 * pi + 1];
      const float as = part_acc[pi * hd + d];
      const float mn = fmaxf(mx, ms);
      const float c_old = exp2f(mx - mn), c_new = exp2f(ms - mn);
      lsum = lsum * c_old + ls * c_new;
      a = a * c_old + as * c_new;
      mx = mn;
    }
    ctx[(((size_t)b * hkv + h) * g + gg) * hd + d] = a / fmaxf(lsum, 1e-30f);
  }
}

template <typename T, int LPR, int NV, int GM>
int launch(const void* q, const void* kn, const void* vn, void* pk, void* pv,
           const void* bt, const void* pos, const void* act, void* scratch,
           void* ctx, int b, int hkv, int g, int hd, int bs,
           int max_blocks, const Plan& plan, float scale, float cap,
           int use_cap, cudaStream_t stream) {
  const size_t smem =
      plan.ring_bytes + sizeof(int64_t) * plan.split_rows;
  auto kern = paged_kernel<T, LPR, NV, GM>;
  static size_t smem_set = 48 * 1024;  // raised once per instantiation
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  paged_write_kernel<T><<<b, 128, 0, stream>>>(
      (const T*)kn, (const T*)vn, (T*)pk, (T*)pv, (const int*)bt,
      (const int*)pos, (const int*)act, b, hkv * hd, bs, max_blocks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  float* part_ml = (float*)scratch;
  float* part_acc = part_ml + 2 * (size_t)b * hkv * plan.n_splits * g;
  dim3 grid(hkv / plan.heads * ((g + GM - 1) / GM), b, plan.n_splits);
  kern<<<grid, plan.heads * 32, smem, stream>>>(
      (const float*)q, (const T*)pk, (const T*)pv, (const int*)bt,
      (const int*)pos, part_ml, part_acc, (float*)ctx, hkv, g, hd, bs,
      max_blocks, plan, scale, cap, use_cap);
  e = cudaGetLastError();
  if (e != cudaSuccess || plan.n_splits == 1) return (int)e;
  const int threads = g * hd < 256 ? (g * hd + 31) / 32 * 32 : 256;
  paged_combine_kernel<<<dim3(hkv, b), threads, 0, stream>>>(
      (const int*)pos, part_ml, part_acc, (float*)ctx, hkv, g, hd, bs,
      max_blocks, plan);
  return (int)cudaGetLastError();
}

template <typename T, int LPR, int NV>
int launch_g(int gm, const void* q, const void* kn, const void* vn, void* pk,
             void* pv, const void* bt, const void* pos, const void* act,
             void* scratch, void* ctx, int b, int hkv, int g,
             int hd, int bs, int max_blocks, const Plan& plan, float scale,
             float cap, int use_cap, cudaStream_t s) {
#define PA_LAUNCH(GM)                                                        \
  return launch<T, LPR, NV, GM>(q, kn, vn, pk, pv, bt, pos, act, scratch,    \
                                ctx, b, hkv, g, hd, bs, max_blocks, plan,    \
                                scale, cap, use_cap, s)
  switch (gm) {
    case 1: PA_LAUNCH(1);
    case 2: PA_LAUNCH(2);
    case 4: PA_LAUNCH(4);
    case 8: PA_LAUNCH(8);
  }
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_t(int lpr, int nv, int gm, const void* q, const void* kn,
             const void* vn, void* pk, void* pv, const void* bt,
             const void* pos, const void* act, void* scratch, void* ctx,
             int b, int hkv, int g, int hd, int bs, int max_blocks,
             const Plan& plan, float scale, float cap, int use_cap,
             cudaStream_t s) {
#define PA_LAUNCH(LPR, NV)                                                    \
  return launch_g<T, LPR, NV>(gm, q, kn, vn, pk, pv, bt, pos, act, scratch,   \
                              ctx, b, hkv, g, hd, bs, max_blocks, plan,      \
                              scale, cap, use_cap, s)
  if (nv == 2) {
    if (lpr == 32) PA_LAUNCH(32, 2);
    return (int)cudaErrorInvalidValue;
  }
  switch (lpr) {
    case 1: PA_LAUNCH(1, 1);
    case 2: PA_LAUNCH(2, 1);
    case 4: PA_LAUNCH(4, 1);
    case 8: PA_LAUNCH(8, 1);
    case 16: PA_LAUNCH(16, 1);
    case 32: PA_LAUNCH(32, 1);
  }
#undef PA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The plan (heads per CTA, stage rows, split rows, splits, lanes per row,
// vectors per lane, instantiated query rows per CTA) comes from
// paged_attention.plan_split; G > gm runs in ceil(G / gm) chunks of gm
// query rows, each a CTA of its own.  scratch: 2 * B * Hkv * n_splits * G +
// B * Hkv * n_splits * G * hd floats (unused with one split).
extern "C" int paged_attention_decode(
    const void* q, const void* kn, const void* vn, void* pk, void* pv,
    const void* bt, const void* pos, const void* act, void* scratch,
    void* ctx, int b, int hkv, int g, int hd, int bs, int max_blocks,
    int dtype, int heads, int stage_rows, int split_rows,
    int n_splits, int lpr, int nv, int gm, float scale, float cap,
    int use_cap, void* stream) {
  if (b == 0) return 0;
  const int elt = dtype == 0 ? 4 : 2;
  if (g < 1 || gm < 1 || gm > kMaxG || (gm & (gm - 1)) != 0 || hd < 1 ||
      hd > 256 ||
      (hd * elt) % 16 != 0 || lpr * nv * 16 < hd * elt || bs < 1 ||
      max_blocks < 1 || heads < 1 || heads > kMaxHeads || hkv % heads != 0 ||
      stage_rows != kRows * 32 / lpr || split_rows < stage_rows ||
      (size_t)n_splits * split_rows < (size_t)max_blocks * bs)
    return (int)cudaErrorInvalidValue;
  const size_t ring = (size_t)kStages * 2 * stage_rows * heads * hd * elt;
  const Plan plan{heads, stage_rows, split_rows, n_splits, (int)ring};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_t<float>(lpr, nv, gm, q, kn, vn, pk, pv, bt, pos, act,
                             scratch, ctx, b, hkv, g, hd, bs,
                             max_blocks, plan, scale, cap, use_cap, s);
    case 1:
      return launch_t<__nv_bfloat16>(lpr, nv, gm, q, kn, vn, pk, pv, bt, pos,
                                     act, scratch, ctx, b, hkv, g,
                                     hd, bs, max_blocks, plan, scale, cap,
                                     use_cap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Counter-based PRNG shared by the CUDA kernels.
//
// Bit for bit the hash of repro_torch/kernels/prng.py (and of the JAX
// reference repro/kernels/prng.py): a splitmix32 finalizer chained over the
// counter fields, each absorbed with a Weyl offset.  The draw at a noise site
// is a pure function of (seed, global counter fields), so a kernel's noise
// does not depend on its tiling and the plain PyTorch version reproduces it
// draw for draw.
#pragma once
#include <cstdint>

#define PRNG_TAG_BITSERIAL 0x51u
#define PRNG_TAG_ANALYTIC 0xA7u

__device__ __forceinline__ uint32_t prng_mix32(uint32_t h) {
  h = (h ^ (h >> 16)) * 0x7FEB352Du;
  h = (h ^ (h >> 15)) * 0x846CA68Bu;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t prng_seed(uint32_t seed) {
  return prng_mix32(seed ^ 0x9E3779B9u);
}

// absorb one counter field into a running hash
__device__ __forceinline__ uint32_t prng_absorb(uint32_t h, uint32_t f) {
  return prng_mix32(h ^ (f * 0x9E3779B9u + 0x85EBCA6Bu));
}

// Box-Muller on the top 24 bits of two draws; every step is rounded as in
// the plain version (no contraction into fused multiply-adds).
__device__ __forceinline__ float prng_normal_from_bits(uint32_t a, uint32_t b) {
  float u1 = __fmul_rn((float)(a >> 8) + 1.0f, 5.9604644775390625e-08f);
  float u2 = __fmul_rn((float)(b >> 8), 5.9604644775390625e-08f);
  float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.2831854820251465f, u2)));
}

// standard normal at the site whose fields were absorbed into h
__device__ __forceinline__ float prng_normal(uint32_t h) {
  return prng_normal_from_bits(prng_absorb(h, 1u), prng_absorb(h, 2u));
}

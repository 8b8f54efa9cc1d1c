// The table hash on the card, shared by the bucket probe (probe.cu, K1) and
// the counting ladder's run totals (runs.cu, K4f): murmur3-32's body and
// fmix over a k-mer's W key words, word 0 first, seeded with "jspr"
// (ops/hashing.py:mix32, which computes the same bits in int64-held u32).

#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

template <int W>
__device__ __forceinline__ uint32_t mix32(const uint32_t (&kw)[W]) {
  uint32_t h = 0x6A737072u;  // "jspr"
#pragma unroll
  for (int j = 0; j < W; ++j) {
    uint32_t kx = kw[j] * 0xCC9E2D51u;
    kx = rotl32(kx, 15);
    kx *= 0x1B873593u;
    h ^= kx;
    h = rotl32(h, 13);
    h = h * 5u + 0xE6546B64u;
  }
  h ^= 4u * W;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

}  // namespace

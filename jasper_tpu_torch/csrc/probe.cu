// Bucket probe of the word-major k-mer count table, whole probe chain.
//
// Replaces jasper_tpu/table/pallas_probe.py:_probe_call (kernel body
// _probe_kernel) AND the XLA continuation rounds that follow it
// (kmer_table.lookup_kmers, pallas_probe.py:155-165): for every lane it
// returns exactly kmer_table.lookup_kmers(tab, keys, valid).
//
//   tab    uint32 [n_buckets + PAD_BUCKETS, 64], row = one bucket, word-major:
//          slot s's key word j at column j*S + s, its count at W*S + s
//          (0 == empty slot).
//   keys   uint32 [B, W] (word 0 least significant), canonical k-mers.
//   valid  uint8  [B]; invalid lanes read 0.
//   out    uint32 [B] counts (0 = absent).
//
// Per lane: h = murmur3-32 over the W words (ops/hashing.py:mix32), home
// bucket = mulhi(h, n_buckets), then probe offsets 0, 1, ..., PAD_BUCKETS+1
// with the row clamped to n_buckets + PAD_BUCKETS - 1. The first row with
// a matching occupied slot answers its count; the first row with an empty
// slot answers 0 (the insert invariant: a stored key's chain is all-full);
// a lane still pending after the last offset answers 0.
//
// What bounds it on Hopper: each probe is a random 256-byte row read from a
// table far larger than the 50 MB L2 (1.24 GB at the 20 Mbp
// configuration), so the kernel is bound by DRAM latency and transactions,
// not arithmetic (the hash is ~20 integer ops per word). The design keeps
// the TPU kernel's one point — fetch and compare fused, 4 bytes out per
// lane instead of the 256-byte gathered row the XLA path materializes —
// with one thread per lane and no padding of the batch: the ragged last
// block is masked. Each thread reads only the count block and, on an
// occupied slot, that slot's key words; the 32-byte sectors of one row are
// reused through L1 (read-only loads). Coalescing the row read across a
// warp and fusing extraction and classification into one pass over a
// contig tile are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowU32 = 64;
constexpr uint32_t kPadBuckets = 32;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

template <int W>
__global__ void probe_chain_kernel(const uint32_t* __restrict__ tab,
                                   const uint32_t* __restrict__ keys,
                                   const uint8_t* __restrict__ valid,
                                   uint32_t* __restrict__ out, int64_t B,
                                   uint32_t n_buckets, int S) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  if (!valid[lane]) {
    out[lane] = 0;
    return;
  }
  uint32_t kw[W];
  uint32_t h = 0x6A737072u;  // "jspr"
#pragma unroll
  for (int j = 0; j < W; ++j) {
    kw[j] = __ldg(keys + lane * W + j);
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

  const uint32_t home = n_buckets <= 1 ? 0u : __umulhi(h, n_buckets);
  const uint64_t last = static_cast<uint64_t>(n_buckets) + kPadBuckets - 1;
  uint32_t result = 0;
  for (uint32_t off = 0; off <= kPadBuckets + 1; ++off) {
    uint64_t b = static_cast<uint64_t>(home) + off;
    if (b > last) b = last;
    const uint32_t* row = tab + b * kRowU32;  // 64-bit row offset
    bool empty = false;
    bool hit = false;
    for (int s = 0; s < S; ++s) {
      const uint32_t c = __ldg(row + W * S + s);
      if (c == 0) {
        empty = true;
        continue;
      }
      bool eq = true;
#pragma unroll
      for (int j = 0; j < W; ++j) eq = eq && (__ldg(row + j * S + s) == kw[j]);
      if (eq) {
        result = c;
        hit = true;
        break;
      }
    }
    if (hit || empty) break;
  }
  out[lane] = result;
}

template <int W>
void launch(const uint32_t* tab, const uint32_t* keys, const uint8_t* valid,
            uint32_t* out, int64_t B, uint32_t n_buckets, int S,
            cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  probe_chain_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      tab, keys, valid, out, B, n_buckets, S);
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 = launched). W must be 1..4 (k <= 64); the wrapper checks the rest.
int jt_probe_lookup(const void* tab, const void* keys, const void* valid,
                    void* out, int64_t B, uint32_t n_buckets, int W, int S,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  auto* t = static_cast<const uint32_t*>(tab);
  auto* k = static_cast<const uint32_t*>(keys);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: launch<1>(t, k, v, o, B, n_buckets, S, st); break;
    case 2: launch<2>(t, k, v, o, B, n_buckets, S, st); break;
    case 3: launch<3>(t, k, v, o, B, n_buckets, S, st); break;
    case 4: launch<4>(t, k, v, o, B, n_buckets, S, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* jt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

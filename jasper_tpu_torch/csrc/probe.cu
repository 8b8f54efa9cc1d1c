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
// bucket = mulhi(h << owner_bits, n_buckets) (owner_bits 0 but on a shard),
// then probe offsets 0, 1, ..., PAD_BUCKETS+1 with the row clamped to
// n_buckets + PAD_BUCKETS - 1. The first row with a matching occupied slot
// answers the sum of its matching slots' counts (mod 2^32, as the plain
// twin sums them); the first row with an empty slot answers 0 (the insert
// invariant: a stored key's chain is all-full); a lane still pending after
// the last offset answers 0.
//
// What bounds it on Hopper: bytes. Each probe reads one random 256-byte row
// of a table far larger than the 50 MB L2 (1.24 GB at the 20 Mbp
// configuration), so a lane costs its key, its valid flag, its row (two
// full 128-byte lines) and its 4-byte count: 269 bytes at k=25, ~0.34 ms
// for a 4 M-lane scan tile at 3.35 TB/s. The hash and the compares are a
// few dozen integer operations a lane, far under the card's rate.
//
// Design. The first version gave each thread one lane and walked the row
// slot by slot with dependent loads: every 32-byte sector was its own DRAM
// round trip and a warp touched 32 rows at once with no load coalesced, so
// it ran latency-bound at a quarter of the bound. Here a warp owns 32 lanes:
//   * keys and valid flags load coalesced, one lane per thread, and each
//     thread hashes its own lane;
//   * every pending lane's row is fetched at once with cp.async into the
//     warp's 32 row buffers in shared memory (8 KB): a half-warp moves one
//     row as 16 x 16 bytes, so a row is two full lines in one round trip,
//     and the warp has up to 32 rows (8 KB) in flight. Blocks of 4 warps
//     take 32 KB of shared memory, so ~6 blocks share an SM and ~190 KB of
//     rows can be in flight per SM, well past the ~20 KB that Little's law
//     asks (3.35 TB/s x ~0.8 us over 132 SMs). A ring of stages inside one
//     warp is not needed: while one warp compares, the other warps' rows
//     are in flight;
//   * the compare is slot-parallel: for each pending lane, thread t < S
//     checks slot t of that lane's row from shared memory (conflict-free:
//     neighbouring threads read neighbouring words), __ballot_sync gives
//     hit and has-empty and __reduce_add_sync sums the matching counts;
//   * a lane whose row was full without its key stays pending and the warp
//     fetches the next offset of every such lane together. At the fast
//     load most lanes settle at offset 0.
// Rows are fetched with .cg (L2 only): a row is read once per probe, and
// caching it in L1 would only evict the other warps' rows.
//
// Ranged mode (kRanged, entry jt_probe_lookup_ranged) also replaces the
// ranged lookup jasper_tpu left to XLA (kmer_table.lookup_kmers with
// n_buckets_global and home_base, kmer_table.py:302-321), which its
// bucket-range partitioned scanner runs once per table slice. `tab` is then
// the slice holding buckets [b0, b0 + n_buckets) of a table with n_global
// buckets, plus the next PAD_BUCKETS rows. A lane's home is
// mulhi(h, n_global); a lane whose home lies outside the slice's range
// reads 0 and fetches no row, the others probe at home - b0 with the row
// clamped to the slice's last row. The same code path with the range
// compare compiled in: the unranged instantiation is unchanged. Its bound
// is the keys, flags and counts of every lane plus the rows of the
// in-range lanes, so with P slices about 1/P of a warp's lanes fetch rows.
//
// Owner bits (owner_bits, both entries) replace lookup_kmers_pallas's and
// kmer_table.lookup_kmers's owner_bits (pallas_probe.py:142-153,
// kmer_table.py:288-317): a shard of a hash-sharded table
// (parallel/sharded_table.py) owns the keys whose top owner_bits hash bits
// name it, so its home is taken from the bits after them,
// mulhi(h << owner_bits, n) (ops/hashing.py:home_of). 0 <= owner_bits < 32:
// the wrapper refuses 32 and more, where the shift is undefined. The shift
// is a template flag (kOwner) like the range compare, and the entries pick
// the instantiation without it when owner_bits is 0: with the shift at run
// time the unsharded kernel at k=37 ran 1.2-2.6% slower than before it, in
// turns on an H100 (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kRowU32 = 64;  // one bucket row: 256 bytes
constexpr uint32_t kPadBuckets = 32;
constexpr int kWarps = 4;  // warps per block
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int W, bool kRanged, bool kOwner>
__global__ void __launch_bounds__(kWarps * 32)
    probe_chain_kernel(const uint32_t* __restrict__ tab,
                       const uint32_t* __restrict__ keys,
                       const uint8_t* __restrict__ valid,
                       uint32_t* __restrict__ out, int64_t B,
                       uint32_t n_buckets, uint32_t n_global, uint32_t b0,
                       uint32_t owner_bits, int S) {
  __shared__ __align__(16) uint32_t rows[kWarps][32][kRowU32];
  const int t = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kWarps + w) * 32;
  if (first >= B) return;  // the whole warp: the ragged last block
  const int64_t lane = first + t;
  const bool in = lane < B;

  uint32_t kw[W];
#pragma unroll
  for (int j = 0; j < W; ++j) kw[j] = in ? __ldg(keys + lane * W + j) : 0u;
  bool pending = in && __ldg(valid + lane) != 0;
  // on a shard: the hash after the shard-owner bits (owner_bits < 32)
  const uint32_t h = kOwner ? mix32<W>(kw) << owner_bits : mix32<W>(kw);
  uint32_t home;
  if constexpr (kRanged) {
    // n_buckets is the slice's; the home is taken over the whole table
    const uint32_t hg = n_global <= 1 ? 0u : __umulhi(h, n_global);
    const bool in_range = hg >= b0 && hg - b0 < n_buckets;
    pending = pending && in_range;
    home = in_range ? hg - b0 : 0u;
  } else {
    home = n_buckets <= 1 ? 0u : __umulhi(h, n_buckets);
  }
  const uint64_t last = static_cast<uint64_t>(n_buckets) + kPadBuckets - 1;

  uint32_t(*buf)[kRowU32] = rows[w];  // row buffer r holds lane r's row
  const int half = t >> 4;            // a fetch moves two rows: this half's
  const int chunk = (t & 15) * 4;     // 16 bytes of that row
  uint32_t result = 0;
  uint32_t pend = __ballot_sync(kFull, pending);
  for (uint32_t off = 0; pend != 0 && off <= kPadBuckets + 1; ++off) {
    // fetch: every pending lane's row at this offset, two rows at a time
    for (uint32_t m = pend; m != 0;) {
      const int r0 = __ffs(m) - 1;
      m &= m - 1;
      const bool two = m != 0;
      const int r1 = two ? __ffs(m) - 1 : r0;
      if (two) m &= m - 1;
      const int r = half ? r1 : r0;
      uint64_t b = static_cast<uint64_t>(__shfl_sync(kFull, home, r)) + off;
      if (b > last) b = last;
      if (!half || two) cp_async16(&buf[r][chunk], tab + b * kRowU32 + chunk);
    }
    cp_async_wait_all();
    __syncwarp();  // every thread's copies are visible to the whole warp

    // compare: thread t < S checks slot t of each pending lane's row
    for (uint32_t m = pend; m != 0; m &= m - 1) {
      const int r = __ffs(m) - 1;
      uint32_t kr[W];
#pragma unroll
      for (int j = 0; j < W; ++j) kr[j] = __shfl_sync(kFull, kw[j], r);
      uint32_t c = 0;
      bool eq = false;
      bool empty = false;
      if (t < S) {
        c = buf[r][W * S + t];
        empty = c == 0;
        eq = !empty;
#pragma unroll
        for (int j = 0; j < W; ++j) eq = eq && buf[r][j * S + t] == kr[j];
      }
      const unsigned settled = __ballot_sync(kFull, eq || empty);
      const uint32_t sum = __reduce_add_sync(kFull, eq ? c : 0u);
      if (t == r && settled != 0) {  // a hit answers its sum, an empty slot 0
        result = sum;
        pending = false;
      }
    }
    __syncwarp();  // reads done before the next round overwrites the buffers
    pend = __ballot_sync(kFull, pending);
  }
  if (in) out[lane] = result;
}

template <int W, bool kRanged, bool kOwner>
cudaError_t launch(const uint32_t* tab, const uint32_t* keys,
                   const uint8_t* valid, uint32_t* out, int64_t B,
                   uint32_t n_buckets, uint32_t n_global, uint32_t b0,
                   uint32_t owner_bits, int S, cudaStream_t stream) {
  // shared memory before L1: the rows bypass L1, and more resident blocks
  // keep more rows in flight
  static bool carved = false;
  if (!carved) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_chain_kernel<W, kRanged, kOwner>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    carved = true;
  }
  constexpr int64_t kLanesPerBlock = kWarps * 32;
  const int64_t blocks = (B + kLanesPerBlock - 1) / kLanesPerBlock;
  probe_chain_kernel<W, kRanged, kOwner>
      <<<static_cast<unsigned>(blocks), kWarps * 32, 0, stream>>>(
          tab, keys, valid, out, B, n_buckets, n_global, b0, owner_bits, S);
  return cudaGetLastError();
}

template <bool kRanged, bool kOwner>
int dispatch_w(const void* tab, const void* keys, const void* valid, void* out,
               int64_t B, uint32_t n_buckets, uint32_t n_global, uint32_t b0,
               uint32_t owner_bits, int W, int S, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  if (S < 1 || S > 32 || owner_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* t = static_cast<const uint32_t*>(tab);
  auto* k = static_cast<const uint32_t*>(keys);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<uint32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: err = launch<1, kRanged, kOwner>(t, k, v, o, B, n_buckets, n_global, b0, owner_bits, S, st); break;
    case 2: err = launch<2, kRanged, kOwner>(t, k, v, o, B, n_buckets, n_global, b0, owner_bits, S, st); break;
    case 3: err = launch<3, kRanged, kOwner>(t, k, v, o, B, n_buckets, n_global, b0, owner_bits, S, st); break;
    case 4: err = launch<4, kRanged, kOwner>(t, k, v, o, B, n_buckets, n_global, b0, owner_bits, S, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

template <bool kRanged>
int dispatch(const void* tab, const void* keys, const void* valid, void* out,
             int64_t B, uint32_t n_buckets, uint32_t n_global, uint32_t b0,
             uint32_t owner_bits, int W, int S, int device, void* stream) {
  return owner_bits
      ? dispatch_w<kRanged, true>(tab, keys, valid, out, B, n_buckets, n_global,
                                  b0, owner_bits, W, S, device, stream)
      : dispatch_w<kRanged, false>(tab, keys, valid, out, B, n_buckets,
                                   n_global, b0, 0u, W, S, device, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 = launched). W must be 1..4 (k <= 64), S <= 32 and
// owner_bits <= 31; the wrapper checks the rest.
int jt_probe_lookup(const void* tab, const void* keys, const void* valid,
                    void* out, int64_t B, uint32_t n_buckets,
                    uint32_t owner_bits, int W, int S, int device,
                    void* stream) {
  return dispatch<false>(tab, keys, valid, out, B, n_buckets, 0u, 0u,
                         owner_bits, W, S, device, stream);
}

// The ranged lookup: `tab` holds buckets [b0, b0 + n_buckets) of a table
// of n_global buckets, plus the next PAD_BUCKETS rows.
int jt_probe_lookup_ranged(const void* tab, const void* keys,
                           const void* valid, void* out, int64_t B,
                           uint32_t n_buckets, uint32_t n_global, uint32_t b0,
                           uint32_t owner_bits, int W, int S, int device,
                           void* stream) {
  return dispatch<true>(tab, keys, valid, out, B, n_buckets, n_global, b0,
                        owner_bits, W, S, device, stream);
}

const char* jt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

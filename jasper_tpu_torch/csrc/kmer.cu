// The count's and the scan's feed on the card: window extraction (K3) and
// the table hash (K2).
//
// Replaces the device programs jasper_tpu left to XLA:
//   K3  jasper_tpu/ops/kmer.py:canonical_windows_fast (:118) and
//       forward_windows (:99), with extract_windows' padding to 16 lanes
//       and its hash-partition filter (jasper_tpu/count/sorted_runs.py:
//       297-320): codes u8 [L] -> W u32 key words and a valid flag for
//       each of the n = L-k+1 windows;
//   K2  jasper_tpu/ops/hashing.py:mix32 (:28): the murmur3-32 body and
//       fmix over each lane's W u32 words (hash.cuh, shared with K1, K4f).
// Every key word and hash is written as an int64 holding a u32
// (ops/hashing.py), word 0 the least significant.
//
// What bounds them on Hopper: bytes. K3 reads a code (1 B) and writes
// 8 W + 1 B a window; K2 reads 8 W B (4 W B for int32 input) and writes
// 8 B a lane. K3's integer work must stay a few tens of operations a
// window to stay under the bytes: at 16.7 T int32 ops/s, 2^23 windows at
// 45 operations take half of the 0.045 ms that their 151 MB take.
//
// Design:
//   * K3: a block of kThreads threads takes a tile of kTile windows. Each
//     thread loads 16 codes as one 16 B vector (tile starts are multiples
//     of kTile, so a tile's chunks are aligned whatever the codes' offset
//     within 16 B, and only the partial chunks at the array's ends are
//     read a byte at a time) and packs them once: their 2-bit values into
//     a u32, the first code in the top bits, and a 16-bit mask of the
//     codes > 3, by multiplications that gather four bytes' bits without
//     carries (pack4, bad4). The tile's kTile + k - 1 codes (the halo
//     under 0.8% of them at k = 64) live in shared memory only in that
//     packed form: a 2-bit stream and a 1-bit bad stream, 32 codes a u32
//     word of it (the 16-bit masks stored swapped in pairs). Then each window costs
//     O(1), no loop over k: its key words are cut from W + 1 stream words
//     by funnel shifts, its validity from two or three bad-stream words
//     (its k bits all zero); the reverse complement is the two-bit-group
//     reversal (rev2) of the complemented key shifted down to 2k bits;
//     canonical keeps the smaller, compared as 2k-bit integers (the twin's
//     words_le). Invalid windows keep the same codes & 3 keys as the twin;
//     lanes past n (pad16) get zero keys and valid false. With part_bits >
//     0 the valid flag also needs the top part_bits of mix32(key), hashed
//     in registers, to equal part_p; no hash is stored. Threads stride
//     over the tile's windows by kThreads, so a warp's stores cover
//     adjacent rows: 8 B a lane at W = 1, 16 B at W = 2; at W = 3 and 4
//     kGroup rows are staged in shared memory and written as 16 B vectors
//     of the group's contiguous bytes; valid one byte a window.
//     It comes within 5% of the time of a copy that writes K3's output
//     shape with no arithmetic (chip_smoke.py's K3_FLOOR_CU; PERF.md).
//     Measured against it in turns on an H100 and dropped: the rolling
//     design (a thread rolls 8 consecutive windows, the forward key
//     shifting a code in at the bottom and the reverse complement at bit
//     2k - 2, validity a count of good codes, rows staged in shared
//     memory), 3-26% slower: a thread warms up on k - 1 codes and reads its
//     codes a byte at a time; the reverse complement cut from a second,
//     complemented and reversed stream, no faster (within 2%: the integer
//     work hides under the stores either way); tiles of 4096 and 16384
//     windows, up to 5% slower on the scan's 4 M windows or 2% faster on a
//     count chunk.
//   * K2: a thread a lane, its W words read as int64 (the low 32 bits) or
//     int32 bit patterns, mix32 in registers, one int64 stored.

#include <cstdint>
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;           // threads a block (K3, K2); lanes a K2 block
constexpr int kTile = 8192;             // windows a K3 block takes
constexpr int kChunks = kTile / 16 + 8;  // 16-code chunks a tile stages: its codes,
                                         // the halo, the 16 B offset, the cut's reach
constexpr int kGroup = 512;             // rows staged between stores at W >= 3
constexpr int kMaxK = 64;               // W <= 4

// x with the order of its 32 two-bit groups reversed (bits within a group
// kept in order)
__device__ __forceinline__ uint64_t rev2(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

// four codes (the bytes of x, the first in the low byte) -> their 2-bit
// values, the first in bits 7-6: (x & 0x03030303) * (2^30 + 2^20 + 2^10 +
// 1) puts byte j's bits at 30 - 2j; every other product falls on its own
// bit pair below bit 24 or past bit 31, so nothing carries
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((x & 0x03030303u) * 0x40100401u) >> 24;
}

// four codes -> a 4-bit mask of those > 3, the first in bit 3: a byte's
// flag (bit 7 of each byte: its bits 7-2 not all zero) moved by (2^27 +
// 2^18 + 2^9 + 1) from bit 8j to bit 27 - j, the other products on their
// own bits below 24 or past 31
__device__ __forceinline__ uint32_t bad4(uint32_t x) {
  const uint32_t z = x & 0xFCFCFCFCu;
  const uint32_t f = (((z & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | z) & 0x80808080u;
  return ((f >> 7) * 0x08040201u) >> 24;
}

// One window of the tile: u its first code's index in the staged streams
// -> its key words (word 0 least significant) and whether no code is > 3.
template <int W, bool kCanon>
__device__ __forceinline__ bool window_key(const uint32_t* __restrict__ s_code,
                                           const uint32_t* __restrict__ s_bad32, int u,
                                           int k, uint32_t (&kw)[W]) {
  // g[j]: the 16 codes from u + 16 j, the first in the top bits
  const int c = u >> 4, s = 2 * (u & 15);
  uint32_t g[W];
#pragma unroll
  for (int j = 0; j < W; ++j) g[j] = __funnelshift_l(s_code[c + j + 1], s_code[c + j], s);
  // the key: the top 2k bits of g[0]:...:g[W-1]
  const int sh = 32 * W - 2 * k;  // 0..30
#pragma unroll
  for (int j = 0; j < W; ++j)
    kw[j] = __funnelshift_r(g[W - 1 - j], j + 1 < W ? g[W - 2 - j] : 0u, sh);
  // its k bad bits: the top k of the 64 from code u
  const int q = u >> 5, r = u & 31;
  const uint32_t f0 = __funnelshift_l(s_bad32[q + 1], s_bad32[q], r);
  bool ok;
  if constexpr (W <= 2) {
    ok = (f0 >> (32 - k)) == 0;  // k <= 32
  } else {
    ok = (f0 | (__funnelshift_l(s_bad32[q + 2], s_bad32[q + 1], r) >> (64 - k))) == 0;
  }
  if constexpr (kCanon) {
    uint64_t lo = kw[0], hi = 0;
    if constexpr (W > 1) lo |= static_cast<uint64_t>(kw[1]) << 32;
    if constexpr (W > 2) hi = kw[2];
    if constexpr (W > 3) hi |= static_cast<uint64_t>(kw[3]) << 32;
    uint64_t rlo, rhi = 0;
    if constexpr (W > 2) {
      // the 128-bit ~(hi:lo) reversed is rev2(~lo):rev2(~hi); its top
      // 2k bits are the reverse complement
      const uint64_t a = rev2(~lo), b = rev2(~hi);
      const int sh2 = 128 - 2 * k;  // 0..62 for k = 33..64
      rlo = sh2 ? (b >> sh2) | (a << (64 - sh2)) : b;
      rhi = a >> sh2;
    } else {
      rlo = rev2(~lo) >> (64 - 2 * k);  // 0..62 for k = 1..32
    }
    if (rhi < hi || (rhi == hi && rlo < lo)) {
      kw[0] = static_cast<uint32_t>(rlo);
      if constexpr (W > 1) kw[1] = static_cast<uint32_t>(rlo >> 32);
      if constexpr (W > 2) kw[2] = static_cast<uint32_t>(rhi);
      if constexpr (W > 3) kw[3] = static_cast<uint32_t>(rhi >> 32);
    }
  }
  return ok;
}

template <int W, bool kCanon, bool kPart>
__global__ void __launch_bounds__(kThreads)
windows_kernel(const uint8_t* __restrict__ codes, int64_t L, int k, int64_t n,
               int64_t n_out, int part_bits, uint32_t part_p,
               int64_t* __restrict__ keys, bool* __restrict__ valid) {
  constexpr bool kStage = W >= 3;
  __shared__ uint32_t s_code[kChunks];  // chunk c: codes 16c..16c+15, the first in bits 31-30
  __shared__ __align__(4) uint16_t s_bad[kChunks];  // chunk c's mask at c ^ 1
  __shared__ __align__(16) int64_t s_rows[kStage ? kGroup * W : 2];
  // stream code u is codes[w0 - mis + u]: chunk c starts on a 16 B boundary
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(codes) & 15);
  const int64_t g0 = w0 - mis;
  const int loaded = (mis + kTile + k - 1 + 15) >> 4;  // chunks holding the tile's codes
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    uint32_t x[4] = {0u, 0u, 0u, 0u};
    const int64_t g = g0 + 16 * c;
    if (c < loaded) {
      if (g >= 0 && g + 16 <= L) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(codes + g));
        x[0] = v.x;
        x[1] = v.y;
        x[2] = v.z;
        x[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (g + j >= 0 && g + j < L)
            x[j >> 2] |= static_cast<uint32_t>(codes[g + j]) << (8 * (j & 3));
      }
    }
    s_code[c] = (pack4(x[0]) << 24) | (pack4(x[1]) << 16) | (pack4(x[2]) << 8) | pack4(x[3]);
    s_bad[c ^ 1] = static_cast<uint16_t>((bad4(x[0]) << 12) | (bad4(x[1]) << 8) |
                                         (bad4(x[2]) << 4) | bad4(x[3]));
  }
  __syncthreads();
  // the bad stream as u32 words of 32 codes, the first in bit 31
  const uint32_t* s_bad32 = reinterpret_cast<const uint32_t*>(s_bad);
  // the tile's rows, and those of them that are windows (the rest pad lanes)
  const int rows = n_out - w0 < kTile ? static_cast<int>(n_out - w0) : kTile;
  const int live = n - w0 < kTile ? static_cast<int>(n - w0 > 0 ? n - w0 : 0) : kTile;
  auto row = [&](int t, uint32_t (&kw)[W]) -> bool {
#pragma unroll
    for (int j = 0; j < W; ++j) kw[j] = 0u;
    if (t >= live) return false;  // past the n windows: zero and invalid
    bool ok = window_key<W, kCanon>(s_code, s_bad32, mis + t, k, kw);
    if constexpr (kPart) {
      if (ok) ok = (mix32<W>(kw) >> (32 - part_bits)) == part_p;
    }
    return ok;
  };
  if constexpr (kStage) {
    for (int t0 = 0; t0 < rows; t0 += kGroup) {
      const int cnt = rows - t0 < kGroup ? rows - t0 : kGroup;
      for (int j = threadIdx.x; j < cnt; j += kThreads) {
        uint32_t kw[W];
        valid[w0 + t0 + j] = row(t0 + j, kw);
#pragma unroll
        for (int w = 0; w < W; ++w) s_rows[j * W + w] = kw[w];
      }
      __syncthreads();
      // the group's cnt * W words are contiguous in keys, 16 B aligned
      int64_t* dst = keys + (w0 + t0) * W;
      const int words = cnt * W;
      for (int v = threadIdx.x; v < words / 2; v += kThreads)
        reinterpret_cast<longlong2*>(dst)[v] = reinterpret_cast<const longlong2*>(s_rows)[v];
      if ((words & 1) && threadIdx.x == 0) dst[words - 1] = s_rows[words - 1];
      __syncthreads();
    }
  } else {
    for (int t = threadIdx.x; t < rows; t += kThreads) {
      uint32_t kw[W];
      valid[w0 + t] = row(t, kw);
      if constexpr (W == 2) {
        reinterpret_cast<longlong2*>(keys)[w0 + t] = make_longlong2(kw[0], kw[1]);
      } else {
        keys[w0 + t] = kw[0];
      }
    }
  }
}

template <int W, bool kI32>
__global__ void __launch_bounds__(kThreads)
mix32_kernel(const void* __restrict__ words, int64_t B, int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= B) return;
  uint32_t kw[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if constexpr (kI32) {
      kw[j] = static_cast<const uint32_t*>(words)[i * W + j];
    } else {
      kw[j] = static_cast<uint32_t>(static_cast<const int64_t*>(words)[i * W + j]);
    }
  }
  out[i] = mix32<W>(kw);
}

template <int W, bool kCanon, bool kPart>
cudaError_t launch_windows(const uint8_t* codes, int64_t L, int k, int64_t n,
                           int64_t n_out, int part_bits, uint32_t part_p,
                           int64_t* keys, bool* valid, cudaStream_t st) {
  const int64_t blocks = (n_out + kTile - 1) / kTile;
  windows_kernel<W, kCanon, kPart><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      codes, L, k, n, n_out, part_bits, part_p, keys, valid);
  return cudaGetLastError();
}

template <int W>
cudaError_t windows_w(const uint8_t* codes, int64_t L, int k, int64_t n, int64_t n_out,
                      bool canonical, int part_bits, uint32_t part_p, int64_t* keys,
                      bool* valid, cudaStream_t st) {
  if (canonical) {
    return part_bits
        ? launch_windows<W, true, true>(codes, L, k, n, n_out, part_bits, part_p, keys, valid, st)
        : launch_windows<W, true, false>(codes, L, k, n, n_out, 0, 0u, keys, valid, st);
  }
  return part_bits
      ? launch_windows<W, false, true>(codes, L, k, n, n_out, part_bits, part_p, keys, valid, st)
      : launch_windows<W, false, false>(codes, L, k, n, n_out, 0, 0u, keys, valid, st);
}

template <int W>
cudaError_t mix32_w(const void* words, int64_t B, bool i32, int64_t* out, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  if (i32) {
    mix32_kernel<W, true><<<blocks, kThreads, 0, st>>>(words, B, out);
  } else {
    mix32_kernel<W, false><<<blocks, kThreads, 0, st>>>(words, B, out);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3. codes u8 [L] -> for each of the n = L-k+1 windows (none when L < k)
// its canonical (canonical != 0) or forward key, out_keys int64 [n_out, W]
// row-major, W = ceil(2k / 32), and out_valid bool [n_out]; n_out = n, or
// 16 * ceil(n / 16) with pad16 != 0 (the pad lanes zero and invalid).
// part_bits > 0 also clears valid where mix32(key) >> (32 - part_bits) !=
// part_p. Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 = launched). 1 <= k <= 64, 0 <= part_bits < 32; codes at
// any address, out_keys 16 B aligned (cudaErrorMisalignedAddress if not).
int jt_windows(const void* codes, int64_t L, int k, int canonical, int pad16,
               int part_bits, uint32_t part_p, void* out_keys, void* out_valid,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > kMaxK || part_bits < 0 || part_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out_keys) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t n = L - k + 1;
  if (n <= 0) return 0;
  const int64_t n_out = pad16 ? (n + 15) / 16 * 16 : n;
  auto* c = static_cast<const uint8_t*>(codes);
  auto* o = static_cast<int64_t*>(out_keys);
  auto* v = static_cast<bool*>(out_valid);
  auto st = static_cast<cudaStream_t>(stream);
  const bool canon = canonical != 0;
  switch ((2 * k + 31) / 32) {
    case 1: err = windows_w<1>(c, L, k, n, n_out, canon, part_bits, part_p, o, v, st); break;
    case 2: err = windows_w<2>(c, L, k, n, n_out, canon, part_bits, part_p, o, v, st); break;
    case 3: err = windows_w<3>(c, L, k, n, n_out, canon, part_bits, part_p, o, v, st); break;
    default: err = windows_w<4>(c, L, k, n, n_out, canon, part_bits, part_p, o, v, st); break;
  }
  return static_cast<int>(err);
}

// K3's tile: the windows a block takes (the tile borders that phase 20 of
// chip_smoke.py straddles).
int jt_windows_tile() { return kTile; }

// K2. words [B, W] row-major, int64 values (their low 32 bits) or, with
// in_is_int32 != 0, int32 bit patterns -> out_h int64 [B] in [0, 2^32).
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t. 1 <= W <= 4.
int jt_mix32(const void* words, int64_t B, int W, int in_is_int32, void* out_h,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  auto* o = static_cast<int64_t*>(out_h);
  auto st = static_cast<cudaStream_t>(stream);
  const bool i32 = in_is_int32 != 0;
  switch (W) {
    case 1: err = mix32_w<1>(words, B, i32, o, st); break;
    case 2: err = mix32_w<2>(words, B, i32, o, st); break;
    case 3: err = mix32_w<3>(words, B, i32, o, st); break;
    case 4: err = mix32_w<4>(words, B, i32, o, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

}  // extern "C"

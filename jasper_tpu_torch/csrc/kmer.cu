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
// 8 B a lane. Their integer work is a few tens of operations a window or
// word, far under the card's rate at these byte counts.
//
// Design (simple first):
//   * K3: a block of kThreads threads takes kThreads consecutive windows.
//     It stages their kThreads + k - 1 codes in shared memory with
//     coalesced byte loads, once. Each thread then packs its window's k
//     codes directly, first base most significant, into a 128-bit
//     (hi, lo) pair (the 64-bit lo alone at W <= 2), and takes validity
//     from the same k reads (no code > 3): the block's own codes, no
//     global cumsum. The reverse complement is the two-bit-group reversal
//     of the complemented key (a bit reversal and a swap within each
//     pair) shifted down to 2k bits; canonical keeps the smaller, compared
//     as 2k-bit integers, which is the twin's word order (words_le).
//     Invalid windows keep the same codes & 3 keys as the twin; pad lanes
//     past n (pad16) get zero keys and valid false. With part_bits > 0 the
//     valid flag also needs the top part_bits of mix32(key), hashed in
//     registers, to equal part_p; no hash is stored. A row's W int64 words
//     are adjacent, stored as 16 B vectors at W = 2 and 4.
//   * K2: a thread a lane, its W words read as int64 (the low 32 bits) or
//     int32 bit patterns, mix32 in registers, one int64 stored.

#include <cstdint>
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;  // windows (K3) or lanes (K2) a block takes
constexpr int kMaxK = 64;      // W <= 4

// x with the order of its 32 two-bit groups reversed (bits within a group
// kept in order)
__device__ __forceinline__ uint64_t rev2(uint64_t x) {
  x = __brevll(x);
  return ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
}

template <int W>
__device__ __forceinline__ void store_row(int64_t* row, const uint32_t (&kw)[W]) {
  if constexpr (W == 2) {
    *reinterpret_cast<longlong2*>(row) = make_longlong2(kw[0], kw[1]);
  } else if constexpr (W == 4) {
    reinterpret_cast<longlong2*>(row)[0] = make_longlong2(kw[0], kw[1]);
    reinterpret_cast<longlong2*>(row)[1] = make_longlong2(kw[2], kw[3]);
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) row[j] = kw[j];
  }
}

template <int W, bool kCanon, bool kPart>
__global__ void __launch_bounds__(kThreads)
windows_kernel(const uint8_t* __restrict__ codes, int64_t L, int k, int64_t n,
               int64_t n_out, int part_bits, uint32_t part_p,
               int64_t* __restrict__ keys, bool* __restrict__ valid) {
  __shared__ uint8_t s[kThreads + kMaxK - 1];
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int span = kThreads + k - 1;
  for (int j = threadIdx.x; j < span; j += kThreads) {
    const int64_t g = w0 + j;
    s[j] = g < L ? codes[g] : 0;
  }
  __syncthreads();
  const int64_t i = w0 + threadIdx.x;
  if (i >= n_out) return;
  uint64_t lo = 0, hi = 0;
  bool ok = false;
  if (i < n) {
    const uint8_t* c = s + threadIdx.x;
    uint32_t bad = 0;
#pragma unroll 4
    for (int p = 0; p < k; ++p) {
      const uint32_t x = c[p];
      bad |= x > 3u;
      if constexpr (W > 2) hi = (hi << 2) | (lo >> 62);
      lo = (lo << 2) | (x & 3u);
    }
    ok = bad == 0;
    if constexpr (kCanon) {
      uint64_t rlo, rhi = 0;
      if constexpr (W > 2) {
        // the 128-bit ~(hi:lo) reversed is rev2(~lo):rev2(~hi); its top
        // 2k bits are the reverse complement
        const uint64_t a = rev2(~lo), b = rev2(~hi);
        const int sh = 128 - 2 * k;  // 0..62 for k = 33..64
        rlo = sh ? (b >> sh) | (a << (64 - sh)) : b;
        rhi = a >> sh;
      } else {
        rlo = rev2(~lo) >> (64 - 2 * k);  // 0..62 for k = 1..32
      }
      if (rhi < hi || (rhi == hi && rlo < lo)) {
        lo = rlo;
        hi = rhi;
      }
    }
  }
  uint32_t kw[W];
  kw[0] = static_cast<uint32_t>(lo);
  if constexpr (W > 1) kw[1] = static_cast<uint32_t>(lo >> 32);
  if constexpr (W > 2) kw[2] = static_cast<uint32_t>(hi);
  if constexpr (W > 3) kw[3] = static_cast<uint32_t>(hi >> 32);
  if constexpr (kPart) {
    if (ok) ok = (mix32<W>(kw) >> (32 - part_bits)) == part_p;
  }
  store_row<W>(keys + i * W, kw);
  valid[i] = ok;
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
  const int64_t blocks = (n_out + kThreads - 1) / kThreads;
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
// cudaError_t (0 = launched). 1 <= k <= 64, 0 <= part_bits < 32.
int jt_windows(const void* codes, int64_t L, int k, int canonical, int pad16,
               int part_bits, uint32_t part_p, void* out_keys, void* out_valid,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1 || k > kMaxK || part_bits < 0 || part_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
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

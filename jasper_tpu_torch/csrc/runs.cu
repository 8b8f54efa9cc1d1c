// K4's two dominant device steps of the counting ladder: the merge of two
// sorted runs (K4m) and a stage flush's run totals with compaction (K4f).
//
// Replaces the device programs jasper_tpu left to XLA in
// jasper_tpu/count/sorted_runs.py:
//   K4m  merge_runs (:136-154): _sort_by_key over the concatenation of two
//        runs, the neighbour add saturated at 2^32-1, then _compact;
//   K4f  make_run_ones's totals (:88-121, the reverse cummin of last-of-run
//        positions) and _compact (:124-133), the stable partition of the
//        actives that every stage flush, run_from_keys and finish run.
//
// A run is (h [L], keys [L, W] row-major, counts [L]), every value an int64
// holding a u32 (ops/hashing.py). Active lanes (count > 0) hold distinct
// keys sorted by (h, keys[W-1], ..., keys[0]) compared as u32, the last key
// word most significant (jasper_tpu's _sort_by_key, :40-50). Outputs are
// written as int64; the dead tail is written as zeros.
//
// What bounds them on Hopper: bytes. Each active lane is read and written
// once at 8 (W + 2) bytes a lane (32 B at W = 2), a dead output lane needs
// only its count (8 B); the compares are a few integer operations a lane.
// At 3.35 TB/s a 2 x 2^26-lane merge at W = 2 with every lane active moves
// ~8.6 GB and could take ~2.6 ms; the torch path it replaces re-sorts both
// runs with two or three stable 64-bit sort passes and a compaction sort.
//
// Design (simple first, no wgmma, no TMA):
//   * K4m is a merge-path merge in tiles of kTile merged lanes. One thread
//     per tile diagonal binary-searches the split (i, j) of the actives
//     (a before b on equal keys). A block stages its tile's lanes of a and b
//     in shared memory, plus a[i-1] before and b[j] after the tile, and each
//     thread merges kItems lanes from its own sub-diagonal. Equal keys are
//     neighbours in that order: a b lane is dropped when the a lane before
//     it (across the tile boundary too) equals it, and an a lane adds the
//     count of the b lane after it. A counting pass gives each tile's
//     survivors, one block scans them into offsets, and the writing pass
//     repeats the merge and stores the survivors there. The n_a and n_b
//     actives are read from device memory (no host sync) and clamped to
//     their runs' lanes, so a count out of range cannot read past a run.
//   * K4f (multiplicity 1) takes the unsorted lanes and the sort's
//     permutation, so the three gathers of make_run_ones are fused: a block
//     stages its tile's gathered lanes (and the one before), flags the
//     representatives (valid and unequal to the lane before), counts them,
//     and the valid lanes' end (valid lanes sort first). After the tile
//     scan a second pass stores each representative's position compacted;
//     a representative's total is the next one's position (or the valid
//     count) minus its own: adjacent differences, no cummin.
//     kCompact writes (h, keys, totals) compacted; otherwise the sorted
//     lanes with totals at the representatives and 0 elsewhere.
//   * K4f (counts given) is _compact: tile counts of the lanes with count >
//     0, the tile scan, and a pass that stores them in input order, kThreads
//     lanes a round with a block scan a round, so reads and writes coalesce.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // merged lanes or input lanes a block
constexpr int kSlots = kTile + 2;         // a tile's lanes and one on each side
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kU32Max = 0xffffffffull;

// ---- scans -----------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T warp_inclusive(T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix of v over the block's NT threads; `total` gets the sum.
// Every thread of the block must call it; `warps` is shared, NT / 32 long.
template <int NT, typename T>
__device__ __forceinline__ T block_exclusive(T v, T* warps, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T inc = warp_inclusive(v);
  if (lane == 31) warps[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < NT / 32 ? warps[lane] : T(0);
    w = warp_inclusive(w);
    if (lane < NT / 32) warps[lane] = w;
  }
  __syncthreads();
  total = warps[NT / 32 - 1];
  const T out = (warp ? warps[warp - 1] : T(0)) + inc - v;
  __syncthreads();  // the scratch may be reused by the next scan
  return out;
}

// One block: off[t] = cnt[0] + ... + cnt[t-1], *total = the sum of all.
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(const int32_t* __restrict__ cnt, int64_t n_tiles,
                  int64_t* __restrict__ off, int64_t* __restrict__ total) {
  __shared__ long long warps[kScanThreads / 32];
  const int64_t per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int64_t b = threadIdx.x * per;
  const int64_t e = b + per < n_tiles ? b + per : n_tiles;
  long long s = 0;
  for (int64_t t = b; t < e; ++t) s += cnt[t];
  long long all;
  long long run = block_exclusive<kScanThreads>(s, warps, all);
  for (int64_t t = b; t < e; ++t) {
    off[t] = run;
    run += cnt[t];
  }
  if (threadIdx.x == 0) *total = all;
}

// ---- keys ------------------------------------------------------------------

// (h, w[W-1], ..., w[0]) of slots x and y: -1, 0 or 1.
template <int W>
__device__ __forceinline__ int cmp_slots(const uint32_t* sh,
                                         const uint32_t (*sw)[kSlots], int x,
                                         int y) {
  if (sh[x] != sh[y]) return sh[x] < sh[y] ? -1 : 1;
#pragma unroll
  for (int j = W - 1; j >= 0; --j)
    if (sw[j][x] != sw[j][y]) return sw[j][x] < sw[j][y] ? -1 : 1;
  return 0;
}

// a[i] <= b[j] in run order, read from device memory.
template <int W>
__device__ __forceinline__ bool le_global(const int64_t* ha, const int64_t* ka,
                                          int64_t i, const int64_t* hb,
                                          const int64_t* kb, int64_t j) {
  const uint32_t x = static_cast<uint32_t>(ha[i]);
  const uint32_t y = static_cast<uint32_t>(hb[j]);
  if (x != y) return x < y;
#pragma unroll
  for (int w = W - 1; w >= 0; --w) {
    const uint32_t p = static_cast<uint32_t>(ka[i * W + w]);
    const uint32_t q = static_cast<uint32_t>(kb[j * W + w]);
    if (p != q) return p < q;
  }
  return true;
}

template <int W>
__device__ __forceinline__ void store_lane(int64_t* oh, int64_t* ok, int64_t* oc,
                                           int64_t q, uint32_t h,
                                           const uint32_t* w, uint64_t c) {
  oh[q] = h;
#pragma unroll
  for (int j = 0; j < W; ++j) ok[q * W + j] = w[j];
  oc[q] = static_cast<int64_t>(c);
}

template <int W>
__device__ __forceinline__ void zero_lane(int64_t* oh, int64_t* ok, int64_t* oc,
                                          int64_t q) {
  oh[q] = 0;
#pragma unroll
  for (int j = 0; j < W; ++j) ok[q * W + j] = 0;
  oc[q] = 0;
}

// Output lanes [t * kTile, (t + 1) * kTile) of [n_active, L) become dead
// lanes of zeros; the survivors all lie below n_active.
template <int W>
__device__ __forceinline__ void zero_tail(int64_t* oh, int64_t* ok, int64_t* oc,
                                          int64_t t, int64_t n_active,
                                          int64_t L) {
  const int64_t q0 = t * kTile;
  const int64_t q1 = q0 + kTile < L ? q0 + kTile : L;
  for (int64_t q = (q0 > n_active ? q0 : n_active) + threadIdx.x; q < q1;
       q += kThreads)
    zero_lane<W>(oh, ok, oc, q);
}

// ---- K4m: the merge-path merge ---------------------------------------------

// An active count read on the card, clamped to [0, lanes].
__device__ __forceinline__ int64_t active_count(const int64_t* n, int64_t lanes) {
  const int64_t v = *n;
  return v < 0 ? 0 : v < lanes ? v : lanes;
}

// split[t] = the a lanes among the first min(t * kTile, n_a + n_b) merged.
template <int W>
__global__ void __launch_bounds__(kThreads)
merge_split_kernel(const int64_t* __restrict__ ha, const int64_t* __restrict__ ka,
                   const int64_t* __restrict__ hb, const int64_t* __restrict__ kb,
                   const int64_t* __restrict__ n_a_p, const int64_t* __restrict__ n_b_p,
                   int64_t La, int64_t L, int64_t n_tiles, int64_t* __restrict__ split) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t > n_tiles) return;
  const int64_t n_a = active_count(n_a_p, La), n_b = active_count(n_b_p, L - La);
  const int64_t d = t * kTile < n_a + n_b ? t * kTile : n_a + n_b;
  int64_t lo = d - n_b > 0 ? d - n_b : 0;
  int64_t hi = d < n_a ? d : n_a;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (le_global<W>(ha, ka, mid, hb, kb, d - mid - 1))
      lo = mid + 1;
    else
      hi = mid;
  }
  split[t] = lo;
}

// One block per tile of merged lanes. kWrite = false: cnt[t] = the tile's
// survivors; kWrite = true: the survivors at off[t] on, and the dead tail.
template <int W, bool kWrite>
__global__ void __launch_bounds__(kThreads)
merge_tile_kernel(const int64_t* __restrict__ ha, const int64_t* __restrict__ ka,
                  const int64_t* __restrict__ ca, const int64_t* __restrict__ hb,
                  const int64_t* __restrict__ kb, const int64_t* __restrict__ cb,
                  const int64_t* __restrict__ n_a_p, const int64_t* __restrict__ n_b_p,
                  const int64_t* __restrict__ split, int32_t* __restrict__ cnt,
                  const int64_t* __restrict__ off, const int64_t* __restrict__ n_out,
                  int64_t* __restrict__ oh, int64_t* __restrict__ ok,
                  int64_t* __restrict__ oc, int64_t La, int64_t L) {
  __shared__ uint32_t s_h[kSlots];
  __shared__ uint32_t s_w[W][kSlots];
  __shared__ uint32_t s_c[kSlots];
  __shared__ int warps[kThreads / 32];
  const int64_t n_a = active_count(n_a_p, La), n_b = active_count(n_b_p, L - La);
  const int64_t n = n_a + n_b;
  const int64_t t = blockIdx.x;
  const int64_t d0 = t * kTile;
  uint32_t rh[kItems], rw[kItems][W];
  uint64_t rc[kItems];
  bool keep[kItems];
#pragma unroll
  for (int s = 0; s < kItems; ++s) keep[s] = false;
  int survivors = 0;
  if (d0 < n) {  // uniform across the block
    const int64_t d1 = d0 + kTile < n ? d0 + kTile : n;
    const int64_t i0 = split[t], i1 = split[t + 1];
    const int64_t j0 = d0 - i0, j1 = d1 - i1;
    const int na = static_cast<int>(i1 - i0), nb = static_cast<int>(j1 - j0);
    // slot 0: a[i0 - 1]; 1..na: a[i0, i1); na+1..na+nb: b[j0, j1); then b[j1]
    for (int x = threadIdx.x; x < na + nb + 2; x += kThreads) {
      const bool in_a = x <= na;
      const int64_t g = in_a ? i0 - 1 + x : j0 + (x - na - 1);
      if (in_a ? g >= 0 : g < n_b) {
        const int64_t* H = in_a ? ha : hb;
        const int64_t* K = in_a ? ka : kb;
        const int64_t* C = in_a ? ca : cb;
        s_h[x] = static_cast<uint32_t>(H[g]);
#pragma unroll
        for (int j = 0; j < W; ++j) s_w[j][x] = static_cast<uint32_t>(K[g * W + j]);
        s_c[x] = static_cast<uint32_t>(C[g]);
      }
    }
    __syncthreads();
    const bool has_prev_a = i0 > 0;    // slot 0 holds a lane
    const bool has_next_b = j1 < n_b;  // slot na + nb + 1 holds a lane
    const int tn = na + nb;
    const int diag = threadIdx.x * kItems;
    if (diag < tn) {
      int lo = diag - nb > 0 ? diag - nb : 0;
      int hi = diag < na ? diag : na;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        // a[mid] at slot 1 + mid, b[diag - mid - 1] at slot na + diag - mid
        if (cmp_slots<W>(s_h, s_w, 1 + mid, na + diag - mid) <= 0)
          lo = mid + 1;
        else
          hi = mid;
      }
      int ia = lo, jb = diag - lo;
#pragma unroll
      for (int s = 0; s < kItems; ++s) {
        if (diag + s >= tn) break;
        const int xa = 1 + ia, xb = na + 1 + jb;
        const bool b_here = jb < nb || has_next_b;
        const int c = b_here ? cmp_slots<W>(s_h, s_w, xa, xb) : -1;
        if (ia < na && (jb >= nb || c <= 0)) {
          // its twin in b, if any, is the b lane next in the merge
          uint64_t sum = s_c[xa];
          if (b_here && c == 0) sum += s_c[xb];
          keep[s] = true;
          rh[s] = s_h[xa];
#pragma unroll
          for (int j = 0; j < W; ++j) rw[s][j] = s_w[j][xa];
          rc[s] = sum < kU32Max ? sum : kU32Max;
          ++ia;
        } else {
          // a duplicate when the a lane before it (slot ia) equals it
          keep[s] = !((ia > 0 || has_prev_a) && cmp_slots<W>(s_h, s_w, ia, xb) == 0);
          rh[s] = s_h[xb];
#pragma unroll
          for (int j = 0; j < W; ++j) rw[s][j] = s_w[j][xb];
          rc[s] = s_c[xb];
          ++jb;
        }
        survivors += keep[s];
      }
    }
  }
  int total;
  const int excl = block_exclusive<kThreads>(survivors, warps, total);
  if (!kWrite) {
    if (threadIdx.x == 0) cnt[t] = total;
    return;
  }
  int64_t q = off[t] + excl;
#pragma unroll
  for (int s = 0; s < kItems; ++s)
    if (keep[s]) store_lane<W>(oh, ok, oc, q++, rh[s], rw[s], rc[s]);
  zero_tail<W>(oh, ok, oc, t, *n_out, L);
}

// ---- K4f, multiplicity 1: run totals of sorted windows ----------------------

// One block per tile of sorted lanes: flags[p] = lane p is a representative;
// cnt[t] = the tile's representatives; *n_valid = the valid lanes' end.
template <int W>
__global__ void __launch_bounds__(kThreads)
ones_flag_kernel(const int64_t* __restrict__ h, const int64_t* __restrict__ keys,
                 const uint8_t* __restrict__ valid, const int64_t* __restrict__ perm,
                 int64_t B, uint8_t* __restrict__ flags, int32_t* __restrict__ cnt,
                 int64_t* __restrict__ n_valid) {
  __shared__ uint32_t s_h[kSlots];
  __shared__ uint32_t s_w[W][kSlots];
  __shared__ uint8_t s_v[kSlots];
  __shared__ int warps[kThreads / 32];
  const int64_t t = blockIdx.x;
  const int64_t p0 = t * kTile;
  // slot x holds sorted lane p0 - 1 + x, gathered through perm
  for (int x = threadIdx.x; x < kSlots; x += kThreads) {
    const int64_t p = p0 - 1 + x;
    uint8_t v = 0;
    if (p >= 0 && p < B) {
      const int64_t src = perm[p];
      v = valid[src] != 0;
      if (v) {
        s_h[x] = static_cast<uint32_t>(h[src]);
#pragma unroll
        for (int j = 0; j < W; ++j) s_w[j][x] = static_cast<uint32_t>(keys[src * W + j]);
      }
    }
    s_v[x] = v;
  }
  __syncthreads();
  int reps = 0;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int x = 1 + s * kThreads + threadIdx.x;
    const int64_t p = p0 - 1 + x;
    if (p < B) {
      const bool v = s_v[x];
      const bool rep = v && !(s_v[x - 1] && cmp_slots<W>(s_h, s_w, x, x - 1) == 0);
      flags[p] = rep;
      reps += rep;
      if (v && !s_v[x + 1]) *n_valid = p + 1;  // valid lanes sort first
    }
  }
  int total;
  block_exclusive<kThreads>(reps, warps, total);
  if (threadIdx.x == 0) cnt[t] = total;
}

// pos[off[t] + rank] = p for every flagged lane p of tile t, in lane order.
__global__ void __launch_bounds__(kThreads)
ones_pos_kernel(const uint8_t* __restrict__ flags, int64_t B,
                const int64_t* __restrict__ off, int64_t* __restrict__ pos) {
  __shared__ int warps[kThreads / 32];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTile;
  int64_t base = off[blockIdx.x];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int64_t p = p0 + s * kThreads + threadIdx.x;
    const int f = p < B ? flags[p] : 0;
    int total;
    const int excl = block_exclusive<kThreads>(f, warps, total);
    if (f) pos[base + excl] = p;
    base += total;
  }
}

// The representative of rank q: its run's total from the next one's
// position (or the valid lanes' end).
__device__ __forceinline__ int64_t run_total(const int64_t* pos, int64_t q,
                                             int64_t n_act, int64_t n_valid) {
  return (q + 1 < n_act ? pos[q + 1] : n_valid) - pos[q];
}

// Compacted: output lane q < n_active is the representative of rank q.
template <int W>
__global__ void __launch_bounds__(kThreads)
ones_compact_kernel(const int64_t* __restrict__ h, const int64_t* __restrict__ keys,
                    const int64_t* __restrict__ perm, const int64_t* __restrict__ pos,
                    const int64_t* __restrict__ n_active_p,
                    const int64_t* __restrict__ n_valid_p, int64_t B,
                    int64_t* __restrict__ oh, int64_t* __restrict__ ok,
                    int64_t* __restrict__ oc) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= B) return;
  const int64_t n_act = *n_active_p;
  if (q >= n_act) {
    zero_lane<W>(oh, ok, oc, q);
    return;
  }
  const int64_t src = perm[pos[q]];
  oh[q] = h[src];
#pragma unroll
  for (int j = 0; j < W; ++j) ok[q * W + j] = keys[src * W + j];
  oc[q] = run_total(pos, q, n_act, *n_valid_p);
}

// Uncompacted, first pass: every sorted lane gathered; totals 0 off the
// representatives (ones_totals_kernel writes theirs).
template <int W>
__global__ void __launch_bounds__(kThreads)
ones_sorted_kernel(const int64_t* __restrict__ h, const int64_t* __restrict__ keys,
                   const int64_t* __restrict__ perm, const uint8_t* __restrict__ flags,
                   int64_t B, int64_t* __restrict__ oh, int64_t* __restrict__ ok,
                   int64_t* __restrict__ oc) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= B) return;
  const int64_t src = perm[p];
  oh[p] = h[src];
#pragma unroll
  for (int j = 0; j < W; ++j) ok[p * W + j] = keys[src * W + j];
  if (!flags[p]) oc[p] = 0;
}

__global__ void __launch_bounds__(kThreads)
ones_totals_kernel(const int64_t* __restrict__ pos, const int64_t* __restrict__ n_active_p,
                   const int64_t* __restrict__ n_valid_p, int64_t B,
                   int64_t* __restrict__ oc) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t n_act = *n_active_p;
  if (q >= B || q >= n_act) return;
  oc[pos[q]] = run_total(pos, q, n_act, *n_valid_p);
}

// ---- K4f, counts given: the stable partition of the actives ------------------

__global__ void __launch_bounds__(kThreads)
compact_count_kernel(const int64_t* __restrict__ counts, int64_t B,
                     int32_t* __restrict__ cnt) {
  __shared__ int warps[kThreads / 32];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTile;
  int live = 0;
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int64_t p = p0 + s * kThreads + threadIdx.x;
    live += p < B && counts[p] != 0;
  }
  int total;
  block_exclusive<kThreads>(live, warps, total);
  if (threadIdx.x == 0) cnt[blockIdx.x] = total;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
compact_write_kernel(const int64_t* __restrict__ h, const int64_t* __restrict__ keys,
                     const int64_t* __restrict__ counts, int64_t B,
                     const int64_t* __restrict__ off, const int64_t* __restrict__ n_out,
                     int64_t* __restrict__ oh, int64_t* __restrict__ ok,
                     int64_t* __restrict__ oc) {
  __shared__ int warps[kThreads / 32];
  const int64_t t = blockIdx.x;
  int64_t base = off[t];
#pragma unroll
  for (int s = 0; s < kItems; ++s) {
    const int64_t p = t * kTile + s * kThreads + threadIdx.x;
    const int64_t c = p < B ? counts[p] : 0;
    int total;
    const int excl = block_exclusive<kThreads>(c != 0 ? 1 : 0, warps, total);
    if (c != 0) {
      const int64_t q = base + excl;
      oh[q] = h[p];
#pragma unroll
      for (int j = 0; j < W; ++j) ok[q * W + j] = keys[p * W + j];
      oc[q] = c;
    }
    base += total;
  }
  zero_tail<W>(oh, ok, oc, t, *n_out, B);
}

// ---- launches ----------------------------------------------------------------

inline unsigned blocks_for(int64_t n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

inline int64_t tiles_for(int64_t n) { return (n + kTile - 1) / kTile; }

// Every entry's scratch holds 3 * tiles + 1 int64 words: its int64 arrays
// first, then the int32 tile counts from word 2 * tiles + 1 on.
inline int32_t* tile_counts(int64_t* scratch, int64_t tiles) {
  return reinterpret_cast<int32_t*>(scratch + 2 * tiles + 1);
}

template <int W>
cudaError_t merge_w(const int64_t* ha, const int64_t* ka, const int64_t* ca,
                    const int64_t* hb, const int64_t* kb, const int64_t* cb,
                    const int64_t* n_a, const int64_t* n_b, int64_t La, int64_t L,
                    int64_t* scratch, int64_t* oh, int64_t* ok, int64_t* oc,
                    int64_t* n_active, cudaStream_t st) {
  const int64_t tiles = tiles_for(L);
  int64_t* split = scratch;            // tiles + 1
  int64_t* off = scratch + tiles + 1;  // tiles
  int32_t* cnt = tile_counts(scratch, tiles);
  merge_split_kernel<W><<<blocks_for(tiles + 1, kThreads), kThreads, 0, st>>>(
      ha, ka, hb, kb, n_a, n_b, La, L, tiles, split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_tile_kernel<W, false><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      ha, ka, ca, hb, kb, cb, n_a, n_b, split, cnt, nullptr, nullptr, nullptr,
      nullptr, nullptr, La, L);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_tiles_kernel<<<1, kScanThreads, 0, st>>>(cnt, tiles, off, n_active);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  merge_tile_kernel<W, true><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      ha, ka, ca, hb, kb, cb, n_a, n_b, split, nullptr, off, n_active, oh, ok, oc, La, L);
  return cudaGetLastError();
}

template <int W>
cudaError_t totals_w(const int64_t* h, const int64_t* keys, const uint8_t* valid,
                     const int64_t* perm, int64_t B, int64_t* scratch,
                     uint8_t* flags, int64_t* pos, int64_t* oh, int64_t* ok,
                     int64_t* oc, int64_t* n_active, bool compact, cudaStream_t st) {
  const int64_t tiles = tiles_for(B);
  int64_t* off = scratch;                // tiles
  int64_t* n_valid = scratch + tiles;    // 1
  int32_t* cnt = tile_counts(scratch, tiles);
  cudaError_t err = cudaMemsetAsync(n_valid, 0, sizeof(int64_t), st);
  if (err != cudaSuccess) return err;
  ones_flag_kernel<W><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      h, keys, valid, perm, B, flags, cnt, n_valid);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_tiles_kernel<<<1, kScanThreads, 0, st>>>(cnt, tiles, off, n_active);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ones_pos_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(flags, B, off, pos);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned lanes = blocks_for(B, kThreads);
  if (compact) {
    ones_compact_kernel<W><<<lanes, kThreads, 0, st>>>(h, keys, perm, pos, n_active,
                                                      n_valid, B, oh, ok, oc);
    return cudaGetLastError();
  }
  ones_sorted_kernel<W><<<lanes, kThreads, 0, st>>>(h, keys, perm, flags, B, oh, ok, oc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ones_totals_kernel<<<lanes, kThreads, 0, st>>>(pos, n_active, n_valid, B, oc);
  return cudaGetLastError();
}

template <int W>
cudaError_t compact_w(const int64_t* h, const int64_t* keys, const int64_t* counts,
                      int64_t B, int64_t* scratch, int64_t* oh, int64_t* ok,
                      int64_t* oc, int64_t* n_active, cudaStream_t st) {
  const int64_t tiles = tiles_for(B);
  int64_t* off = scratch;
  int32_t* cnt = tile_counts(scratch, tiles);
  compact_count_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(counts, B, cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_tiles_kernel<<<1, kScanThreads, 0, st>>>(cnt, tiles, off, n_active);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  compact_write_kernel<W><<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      h, keys, counts, B, off, n_active, oh, ok, oc);
  return cudaGetLastError();
}

#define JT_DISPATCH_W(W, CALL)                                   \
  switch (W) {                                                   \
    case 1: err = CALL(1); break;                                \
    case 2: err = CALL(2); break;                                \
    case 3: err = CALL(3); break;                                \
    case 4: err = CALL(4); break;                                \
    default: return static_cast<int>(cudaErrorInvalidValue);     \
  }

#define I64(p) static_cast<const int64_t*>(p)
#define O64(p) static_cast<int64_t*>(p)

}  // namespace

extern "C" {

// Merged or input lanes a block takes. Every entry takes a scratch of
// 3 * ceil(lanes / tile) + 1 int64 words on the device, and launches on
// `stream` without synchronising; it returns the launch's cudaError_t
// (0 = launched).
int jt_runs_tile(void) { return kTile; }

// K4m. a = (ha, ka, ca) of La lanes, b = (hb, kb, cb) of L - La: the first
// *n_a (*n_b) lanes active and sorted, the rest ignored (a count is clamped
// to its run's lanes). Writes L lanes of (oh, ok, oc) and *n_active.
int jt_merge_runs(const void* ha, const void* ka, const void* ca, const void* hb,
                  const void* kb, const void* cb, const void* n_a, const void* n_b,
                  int64_t La, int64_t L, void* oh, void* ok, void* oc, void* n_active, int W,
                  void* scratch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (L <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
#define JT_MERGE(WW)                                                                \
  merge_w<WW>(I64(ha), I64(ka), I64(ca), I64(hb), I64(kb), I64(cb), I64(n_a),       \
              I64(n_b), La, L, O64(scratch), O64(oh), O64(ok), O64(oc),            \
              O64(n_active), st)
  JT_DISPATCH_W(W, JT_MERGE)
#undef JT_MERGE
  return static_cast<int>(err);
}

// K4f, multiplicity 1: lane p of the sorted order is lane perm[p] of (h,
// keys, valid), valid lanes first. compact != 0: (oh, ok, oc) get the
// representatives compacted with their run lengths, and zeros after;
// otherwise the sorted lanes with run lengths at the representatives, 0
// elsewhere. flags (B bytes) and pos (B int64) are scratch.
int jt_run_totals(const void* h, const void* keys, const void* valid,
                  const void* perm, int64_t B, void* flags, void* pos, void* oh,
                  void* ok, void* oc, void* n_active, int compact, int W,
                  void* scratch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
#define JT_TOTALS(WW)                                                             \
  totals_w<WW>(I64(h), I64(keys), static_cast<const uint8_t*>(valid), I64(perm), \
               B, O64(scratch), static_cast<uint8_t*>(flags), O64(pos), O64(oh), \
               O64(ok), O64(oc), O64(n_active), compact != 0, st)
  JT_DISPATCH_W(W, JT_TOTALS)
#undef JT_TOTALS
  return static_cast<int>(err);
}

// K4f, counts given (_compact): the lanes with counts != 0 first, in input
// order, then zeros; *n_active their number.
int jt_compact_run(const void* h, const void* keys, const void* counts, int64_t B,
                   void* oh, void* ok, void* oc, void* n_active, int W,
                   void* scratch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
#define JT_COMPACT(WW)                                                           \
  compact_w<WW>(I64(h), I64(keys), I64(counts), B, O64(scratch), O64(oh),       \
                O64(ok), O64(oc), O64(n_active), st)
  JT_DISPATCH_W(W, JT_COMPACT)
#undef JT_COMPACT
  return static_cast<int>(err);
}

}  // extern "C"

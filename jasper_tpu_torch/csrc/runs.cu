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
// written as int64. A dead output lane gets its count, 0, and nothing else:
// the run contract (count/sorted_runs.py) leaves a dead lane's h and keys
// garbage, and every reader of a run masks them by count or n_active.
//
// What bounds them on Hopper: bytes. Each active lane is read and written
// once at 8 (W + 2) bytes a lane (32 B at W = 2), a dead output lane needs
// only its count (8 B); the compares are a few integer operations a lane.
//
// Design: one pass over the lanes, with a decoupled look-back scan
// (Merrill and Garland's single-pass prefix scan). A block takes the next
// tile (kTile = 2048 merged lanes of K4m, kRunTile = 1024 lanes of K4f)
// by an atomic ticket, so tiles start in order and the look-back cannot
// deadlock; it finds its tile's survivors, publishes their
// aggregate in the tile's status word, and warp 0 reads back 32 status
// words at a time, summing aggregates until it meets a tile whose inclusive
// prefix is out. The survivors then go out compacted from shared memory,
// each warp storing consecutive 8 B words of h, keys and counts.
//   * K4m is a merge-path merge. One thread per tile diagonal binary-
//     searches the split (i, j) of the actives (a before b on equal keys).
//     A block loads its tile's ranges a[i0-1, i1) and b[j0, j1] once,
//     coalesced, into shared memory, 8 B a thread: a variant that moved
//     the ranges and the stores 16 B a thread (aligned pairs, one word at
//     a cut end) was slower on an H100 (PERF.md), and cp.async copies the
//     int64 words as they are, so its staged tile would be twice the u32
//     words this one holds. Each thread merges kItems lanes
//     from its own sub-diagonal: a b lane is dropped when the a lane before
//     it (across the tile boundary too) equals it, and an a lane adds the
//     count of the b lane after it, saturated at 2^32-1. Each survivor's
//     slot and count go to shared memory at its rank in the tile. The n_a
//     and n_b actives are read from device memory (no host sync) and
//     clamped to their runs' lanes, so a count out of range cannot read
//     past a run.
//   * K4f (multiplicity 1) takes the unsorted windows and the sort's
//     permutation. Sorted lane p reads perm[p] (coalesced) and its key row
//     keys[perm[p]] (one random 8 W-byte row, inside one 32 B sector at
//     W <= 2; these random reads, not the bytes, bound K4f: on an H100 a
//     kernel that only gathers the valid lanes' rows through perm and
//     writes them out, chip_smoke.py's GATHER_FLOOR_CU, takes ~89% of
//     K4f's time at 2^26 lanes),
//     and recomputes h = mix32(key) (hash.cuh): every caller
//     passes h = mix32(keys). Valid lanes sort first, so lane p is valid iff
//     p < n_valid, counted coalesced over `valid` before the pass. A lane is
//     a representative when valid and unequal to the lane before; ballots
//     rank them, and a total is the next representative's position in the
//     tile (or the tile's valid end) minus its own. A run that crosses
//     tiles: each tile records its leading continuation (its valid lanes
//     before its first representative), and a small kernel over the tiles
//     adds it to the last representative before the tile (atomics on
//     integers: the same bits in any order). kCompact writes (h, keys,
//     totals) compacted; otherwise every sorted lane in place, totals at the
//     representatives and 0 elsewhere.
//   * K4f (counts given) is _compact: the lanes with count != 0 ranked by
//     ballots, the look-back, and their h, keys and counts stored compacted
//     in input order.

#include <cstdint>
#include <cuda_runtime.h>

#include "hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                  // merged lanes a K4m thread
constexpr int kTile = kThreads * kItems;   // merged lanes a K4m block
constexpr int kSlots = kTile + 2;          // a merge tile's lanes and one on each side
constexpr int kSkewed = kTile + kTile / 32;  // a merge tile's ranks, skewed (skew below)
constexpr int kRunItems = 4;               // sorted or input lanes a K4f thread
constexpr int kRunTile = kThreads * kRunItems;  // ... a K4f block
constexpr int kWords = kRunTile / 32;      // ballot words of a K4f tile
constexpr int kFixBlocks = 1024;           // grid of the grid-stride kernels
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

// Rank r of a tile, spread so that ranks a few apart fall in other banks.
__device__ __forceinline__ int skew(int r) { return r + (r >> 5); }

// The flagged lanes of a K4f tile in lane order, lane x = s * kThreads +
// threadIdx.x holding flag[s]: one ballot word per 32 lanes, their
// popcounts scanned by warp 0, then pos[r] = the r-th flagged lane.
// Returns their number; every thread of the block must call it.
__device__ __forceinline__ int rank_flags(const bool (&flag)[kRunItems], uint32_t* mask,
                                          int* pre, uint16_t* pos) {
  static_assert(kWords % 32 == 0, "warp 0 scans whole ballot words");
  const int tid = threadIdx.x;
#pragma unroll
  for (int s = 0; s < kRunItems; ++s) {
    const unsigned m = __ballot_sync(kFull, flag[s]);
    if ((tid & 31) == 0) mask[(s * kThreads + tid) >> 5] = m;
  }
  __syncthreads();
  if (tid < 32) {
    constexpr int per = kWords / 32;
    int c[per], sum = 0;
#pragma unroll
    for (int i = 0; i < per; ++i) sum += c[i] = __popc(mask[tid * per + i]);
    int run = warp_inclusive(sum) - sum;
#pragma unroll
    for (int i = 0; i < per; ++i) {
      pre[tid * per + i] = run;
      run += c[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kRunItems; ++s) {
    const int x = s * kThreads + tid;
    if (flag[s])
      pos[pre[x >> 5] + __popc(mask[x >> 5] & ((1u << (x & 31)) - 1))] = x;
  }
  __syncthreads();
  return pre[kWords - 1] + __popc(mask[kWords - 1]);
}

// ---- the decoupled look-back ------------------------------------------------

// status[t]: 0 until tile t publishes, then kAgg | its own aggregate, then
// kPrefix | its inclusive prefix; a value and its flag change in one store.
constexpr uint64_t kAgg = 1ull << 62, kPrefix = 2ull << 62, kValue = kAgg - 1;

template <bool kMax>
__device__ __forceinline__ uint64_t combine(uint64_t a, uint64_t b) {
  return kMax ? (a > b ? a : b) : a + b;
}

// Warp 0 of the block holding tile t (all 32 lanes): publishes the tile's
// aggregate and returns the combine (sum, or with kMax the maximum) of
// every earlier tile's aggregate, then publishes the inclusive prefix.
template <bool kMax>
__device__ uint64_t look_back(uint64_t* status, int64_t t, uint64_t agg) {
  const int lane = threadIdx.x & 31;
  volatile uint64_t* vs = status;
  if (t == 0) {
    if (lane == 0) vs[0] = kPrefix | agg;
    return 0;
  }
  if (lane == 0) vs[t] = kAgg | agg;
  uint64_t excl = 0;
  for (int64_t base = t - 1;; base -= 32) {
    // lane l reads tile base - l; before tile 0 an empty prefix
    const int64_t j = base - lane;
    uint64_t s = kPrefix;
    do {
      if (j >= 0) s = vs[j];
    } while (__any_sync(kFull, s == 0));
    const unsigned pre = __ballot_sync(kFull, s >= kPrefix);
    const int stop = pre ? __ffs(pre) - 1 : 31;  // the nearest prefix ends the walk
    uint64_t v = lane <= stop ? (s & kValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = combine<kMax>(v, __shfl_xor_sync(kFull, v, o));
    excl = combine<kMax>(excl, v);
    if (pre) break;
  }
  if (lane == 0) vs[t] = kPrefix | combine<kMax>(excl, agg);
  return excl;
}

// Each block's tile, in the order the blocks start.
__device__ __forceinline__ int64_t take_tile(unsigned long long* ticket, int64_t* s_tile) {
  if (threadIdx.x == 0) *s_tile = static_cast<int64_t>(atomicAdd(ticket, 1ull));
  __syncthreads();
  return *s_tile;
}

// ---- keys ------------------------------------------------------------------

// (h, w[W-1], ..., w[0]) of slots x and y: -1, 0 or 1.
template <int W, int N>
__device__ __forceinline__ int cmp_slots(const uint32_t* sh, const uint32_t (*sw)[N],
                                         int x, int y) {
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

// Key row `src` as u32 words: 16 B loads where the rows are 16 B aligned.
template <int W>
__device__ __forceinline__ void load_row(const int64_t* __restrict__ keys, int64_t src,
                                         bool pairs, uint32_t (&w)[W]) {
  const int64_t* row = keys + src * W;
  if constexpr (W % 2 == 0) {
    if (pairs) {
#pragma unroll
      for (int j = 0; j < W; j += 2) {
        const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(row + j));
        w[j] = static_cast<uint32_t>(v.x);
        w[j + 1] = static_cast<uint32_t>(v.y);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j)
    w[j] = static_cast<uint32_t>(__ldg(reinterpret_cast<const long long*>(row + j)));
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

// Dynamic shared memory of a merge tile: its lanes' h, W key words and
// counts (u32, kSlots each), then each survivor's count and slot by rank.
template <int W>
constexpr int merge_smem_bytes() {
  return (W + 2) * kSlots * 4 + kSkewed * (4 + 2);
}

// One block per tile of merged lanes, tiles taken in order: the tile's
// survivors at their global offset, and *n_active from the last tile.
template <int W>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const int64_t* __restrict__ ha, const int64_t* __restrict__ ka,
             const int64_t* __restrict__ ca, const int64_t* __restrict__ hb,
             const int64_t* __restrict__ kb, const int64_t* __restrict__ cb,
             const int64_t* __restrict__ n_a_p, const int64_t* __restrict__ n_b_p,
             const int64_t* __restrict__ split, uint64_t* status,
             unsigned long long* ticket, int64_t* __restrict__ oh,
             int64_t* __restrict__ ok, int64_t* __restrict__ oc,
             int64_t* __restrict__ n_active, int64_t La, int64_t L, int64_t n_tiles) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_h = smem;
  uint32_t(*s_w)[kSlots] = reinterpret_cast<uint32_t(*)[kSlots]>(smem + kSlots);
  uint32_t* s_c = smem + (W + 1) * kSlots;
  uint32_t* s_oc = smem + (W + 2) * kSlots;                 // by skewed rank
  uint16_t* s_sel = reinterpret_cast<uint16_t*>(s_oc + kSkewed);  // ditto
  __shared__ int warps[kThreads / 32];
  __shared__ int64_t s_tile, s_off;
  const int tid = threadIdx.x;
  const int64_t t = take_tile(ticket, &s_tile);
  const int64_t n_a = active_count(n_a_p, La), n_b = active_count(n_b_p, L - La);
  const int64_t n = n_a + n_b;
  const int64_t d0 = t * kTile;
  int sel[kItems];  // each merged lane's slot
  uint32_t cnt_of[kItems];
  unsigned keep = 0;  // bit s: merged lane s survives
  int survivors = 0;
  if (d0 < n) {  // uniform across the block
    const int64_t d1 = d0 + kTile < n ? d0 + kTile : n;
    const int64_t i0 = split[t], i1 = split[t + 1];
    const int64_t j0 = d0 - i0, j1 = d1 - i1;
    const int na = static_cast<int>(i1 - i0), nb = static_cast<int>(j1 - j0);
    // slot 0: a[i0 - 1]; 1..na: a[i0, i1); na+1..na+nb: b[j0, j1); then
    // b[j1]: each run's range read once, neighbouring threads on
    // neighbouring words
    for (int x = tid; x <= na; x += kThreads) {
      const int64_t g = i0 - 1 + x;
      if (g >= 0) {
        s_h[x] = static_cast<uint32_t>(ha[g]);
        s_c[x] = static_cast<uint32_t>(ca[g]);
      }
    }
    for (int x = tid; x <= nb; x += kThreads) {
      const int64_t g = j0 + x;
      if (g < n_b) {
        s_h[na + 1 + x] = static_cast<uint32_t>(hb[g]);
        s_c[na + 1 + x] = static_cast<uint32_t>(cb[g]);
      }
    }
    for (int e = tid; e < (na + 1) * W; e += kThreads) {
      const int x = e / W;
      if (i0 - 1 + x >= 0) s_w[e % W][x] = static_cast<uint32_t>(ka[(i0 - 1) * W + e]);
    }
    for (int e = tid; e < (nb + 1) * W; e += kThreads) {
      const int x = e / W;
      if (j0 + x < n_b) s_w[e % W][na + 1 + x] = static_cast<uint32_t>(kb[j0 * W + e]);
    }
    __syncthreads();
    const bool has_prev_a = i0 > 0;    // slot 0 holds a lane
    const bool has_next_b = j1 < n_b;  // slot na + nb + 1 holds a lane
    const int tn = na + nb;
    const int diag = tid * kItems;
    if (diag < tn) {
      int lo = diag - nb > 0 ? diag - nb : 0;
      int hi = diag < na ? diag : na;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        // a[mid] at slot 1 + mid, b[diag - mid - 1] at slot na + diag - mid
        if (cmp_slots<W, kSlots>(s_h, s_w, 1 + mid, na + diag - mid) <= 0)
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
        const int c = b_here ? cmp_slots<W, kSlots>(s_h, s_w, xa, xb) : -1;
        bool k;
        if (ia < na && (jb >= nb || c <= 0)) {
          // its twin in b, if any, is the b lane next in the merge
          uint64_t sum = s_c[xa];
          if (b_here && c == 0) sum += s_c[xb];
          k = true;
          sel[s] = xa;
          cnt_of[s] = static_cast<uint32_t>(sum < kU32Max ? sum : kU32Max);
          ++ia;
        } else {
          // a duplicate when the a lane before it (slot ia) equals it
          k = !((ia > 0 || has_prev_a) && cmp_slots<W, kSlots>(s_h, s_w, ia, xb) == 0);
          sel[s] = xb;
          cnt_of[s] = s_c[xb];
          ++jb;
        }
        keep |= static_cast<unsigned>(k) << s;
        survivors += k;
      }
    }
  }
  int total;
  int q = block_exclusive<kThreads>(survivors, warps, total);
  if (tid < 32) {
    const uint64_t off = look_back<false>(status, t, static_cast<uint64_t>(total));
    if (tid == 0) {
      s_off = static_cast<int64_t>(off);
      if (t == n_tiles - 1) *n_active = static_cast<int64_t>(off) + total;
    }
  }
#pragma unroll
  for (int s = 0; s < kItems; ++s)
    if (keep >> s & 1) {
      s_oc[skew(q)] = cnt_of[s];
      s_sel[skew(q)] = static_cast<uint16_t>(sel[s]);
      ++q;
    }
  __syncthreads();
  const int64_t off = s_off;
  for (int r = tid; r < total; r += kThreads) {
    oh[off + r] = s_h[s_sel[skew(r)]];
    oc[off + r] = s_oc[skew(r)];
  }
  for (int e = tid; e < total * W; e += kThreads)
    ok[off * W + e] = s_w[e % W][s_sel[skew(e / W)]];
}

// ---- K4f, multiplicity 1: run totals of sorted windows ----------------------

// One block per tile of sorted lanes, tiles taken in order. Slot x + 1
// holds sorted lane p0 + x, slot 0 lane p0 - 1. The look-back combines
// representative counts (kCompact: a tile's output offset) or, otherwise,
// the last representative's position + 1 (its maximum). lead[t] and
// target[t]: the continuation of the last run before the tile and that
// run's output lane (fix_kernel adds it there).
template <int W, bool kCompact>
__global__ void __launch_bounds__(kThreads)
totals_kernel(const int64_t* __restrict__ keys, const int64_t* __restrict__ perm,
              int64_t B, bool pairs, const int64_t* __restrict__ n_valid_p,
              uint64_t* status, unsigned long long* ticket, int64_t* __restrict__ lead,
              int64_t* __restrict__ target, int64_t* __restrict__ oh,
              int64_t* __restrict__ ok, int64_t* __restrict__ oc,
              int64_t* __restrict__ n_active, int64_t n_tiles) {
  __shared__ uint32_t s_h[kRunTile + 1];
  __shared__ uint32_t s_w[W][kRunTile + 1];
  __shared__ uint16_t s_pos[kRunTile];
  __shared__ uint32_t s_mask[kWords];
  __shared__ int s_pre[kWords];
  __shared__ int64_t s_tile, s_off;
  const int tid = threadIdx.x;
  const int64_t t = take_tile(ticket, &s_tile);
  const int64_t p0 = t * kRunTile;
  const int end = static_cast<int>(B - p0 < kRunTile ? B - p0 : kRunTile);
  const int64_t nv = *n_valid_p;
  const int vend = nv <= p0 ? 0 : nv - p0 < end ? static_cast<int>(nv - p0) : end;
  const int gend = kCompact ? vend : end;  // compacted: only valid lanes matter
  // the permutation coalesced, then one key row a lane at random, every
  // row of the tile in flight at once
  int64_t src[kRunItems];
#pragma unroll
  for (int s = 0; s < kRunItems; ++s) {
    const int x = s * kThreads + tid;
    src[s] = x < gend ? perm[p0 + x] : 0;
  }
  const bool prev = tid == 0 && p0 > 0 && vend > 0;  // lane p0 - 1, valid
  const int64_t src_prev = prev ? perm[p0 - 1] : 0;
  uint32_t w[kRunItems][W];
#pragma unroll
  for (int s = 0; s < kRunItems; ++s)
    if (s * kThreads + tid < gend) load_row<W>(keys, src[s], pairs, w[s]);
  if (prev) {
    uint32_t wp[W];
    load_row<W>(keys, src_prev, pairs, wp);
    s_h[0] = mix32<W>(wp);
#pragma unroll
    for (int j = 0; j < W; ++j) s_w[j][0] = wp[j];
  }
#pragma unroll
  for (int s = 0; s < kRunItems; ++s) {
    const int x = s * kThreads + tid;
    if (x < gend) {
      s_h[x + 1] = mix32<W>(w[s]);
#pragma unroll
      for (int j = 0; j < W; ++j) s_w[j][x + 1] = w[s][j];
    }
  }
  __syncthreads();
  // representatives: valid and unequal to the lane before
  bool rep[kRunItems];
#pragma unroll
  for (int s = 0; s < kRunItems; ++s) {
    const int x = s * kThreads + tid;
    rep[s] = x < vend && (p0 + x == 0 || cmp_slots<W, kRunTile + 1>(s_h, s_w, x + 1, x) != 0);
  }
  const int cnt = rank_flags(rep, s_mask, s_pre, s_pos);
  if (tid < 32) {
    const uint64_t agg = kCompact ? static_cast<uint64_t>(cnt)
                                  : cnt ? static_cast<uint64_t>(p0 + s_pos[cnt - 1] + 1) : 0;
    const int64_t excl = static_cast<int64_t>(look_back<!kCompact>(status, t, agg));
    if (tid == 0) {
      s_off = excl;
      // the valid lanes before the first representative continue the
      // last run before the tile: its rank (kCompact) or its position
      lead[t] = excl > 0 ? (cnt ? s_pos[0] : vend) : 0;
      target[t] = excl - 1;
      if (kCompact && t == n_tiles - 1) *n_active = excl + cnt;
    }
  }
  __syncthreads();
  const int64_t off = s_off;
  if (kCompact) {
    for (int r = tid; r < cnt; r += kThreads) {
      const int x = s_pos[r];
      oh[off + r] = s_h[x + 1];
      oc[off + r] = (r + 1 < cnt ? s_pos[r + 1] : vend) - x;
    }
    for (int e = tid; e < cnt * W; e += kThreads)
      ok[off * W + e] = s_w[e % W][s_pos[e / W] + 1];
  } else {
    for (int x = tid; x < end; x += kThreads) {
      const unsigned m = s_mask[x >> 5];
      int64_t total = 0;
      if (m >> (x & 31) & 1) {
        const int r = s_pre[x >> 5] + __popc(m & ((1u << (x & 31)) - 1));
        total = (r + 1 < cnt ? s_pos[r + 1] : vend) - x;
      }
      oh[p0 + x] = s_h[x + 1];
      oc[p0 + x] = total;
    }
    for (int e = tid; e < end * W; e += kThreads)
      ok[p0 * W + e] = s_w[e % W][e / W + 1];
  }
}

// *n_valid += the nonzero bytes of valid[0, B): 16 B loads where aligned.
__global__ void __launch_bounds__(kThreads)
count_valid_kernel(const uint8_t* __restrict__ valid, int64_t B,
                   unsigned long long* n_valid) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t mis = static_cast<int64_t>(reinterpret_cast<uintptr_t>(valid) & 15);
  const int64_t head = mis ? (16 - mis < B ? 16 - mis : B) : 0;
  const int64_t nvec = (B - head) / 16;
  const uint4* vec = reinterpret_cast<const uint4*>(valid + head);
  unsigned long long c = 0;
  for (int64_t i = gid; i < nvec; i += stride) {
    const uint4 v = vec[i];
    c += __popc(__vcmpne4(v.x, 0) & 0x01010101u) + __popc(__vcmpne4(v.y, 0) & 0x01010101u) +
         __popc(__vcmpne4(v.z, 0) & 0x01010101u) + __popc(__vcmpne4(v.w, 0) & 0x01010101u);
  }
  for (int64_t i = gid; i < head; i += stride) c += valid[i] != 0;
  for (int64_t i = head + nvec * 16 + gid; i < B; i += stride) c += valid[i] != 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(n_valid, c);
}

// After a tile pass: each tile's continuation lead[t] > 0 added to the
// count at target[t] (lead null: none), and with n_active given the dead
// lanes' counts oc[*n_active, L) set to 0.
__global__ void __launch_bounds__(kThreads)
fix_kernel(const int64_t* __restrict__ lead, const int64_t* __restrict__ target,
           int64_t n_tiles, const int64_t* __restrict__ n_active, int64_t L,
           int64_t* __restrict__ oc) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  if (lead)
    for (int64_t t = gid; t < n_tiles; t += stride) {
      const int64_t l = lead[t];
      if (l > 0)
        atomicAdd(reinterpret_cast<unsigned long long*>(oc + target[t]),
                  static_cast<unsigned long long>(l));
    }
  if (n_active)
    for (int64_t q = *n_active + gid; q < L; q += stride) oc[q] = 0;
}

// ---- K4f, counts given: the stable partition of the actives ------------------

// One block per tile of input lanes, tiles taken in order: the lanes with
// count != 0 at their global offset, in input order.
template <int W>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const int64_t* __restrict__ h, const int64_t* __restrict__ keys,
               const int64_t* __restrict__ counts, int64_t B, uint64_t* status,
               unsigned long long* ticket, int64_t* __restrict__ oh,
               int64_t* __restrict__ ok, int64_t* __restrict__ oc,
               int64_t* __restrict__ n_active, int64_t n_tiles) {
  __shared__ uint16_t s_pos[kRunTile];
  __shared__ uint32_t s_mask[kWords];
  __shared__ int s_pre[kWords];
  __shared__ int64_t s_tile, s_off;
  const int tid = threadIdx.x;
  const int64_t t = take_tile(ticket, &s_tile);
  const int64_t p0 = t * kRunTile;
  bool live[kRunItems];
#pragma unroll
  for (int s = 0; s < kRunItems; ++s) {
    const int64_t p = p0 + s * kThreads + tid;
    live[s] = p < B && counts[p] != 0;
  }
  const int cnt = rank_flags(live, s_mask, s_pre, s_pos);
  if (tid < 32) {
    const int64_t excl = static_cast<int64_t>(look_back<false>(status, t, cnt));
    if (tid == 0) {
      s_off = excl;
      if (t == n_tiles - 1) *n_active = excl + cnt;
    }
  }
  __syncthreads();
  const int64_t off = s_off;
  for (int r = tid; r < cnt; r += kThreads) {
    const int64_t p = p0 + s_pos[r];
    oh[off + r] = h[p];
    oc[off + r] = counts[p];
  }
  for (int e = tid; e < cnt * W; e += kThreads)
    ok[off * W + e] = keys[(p0 + s_pos[e / W]) * W + e % W];
}

// ---- launches ----------------------------------------------------------------

inline unsigned blocks_for(int64_t n, int per) {
  return static_cast<unsigned>((n + per - 1) / per);
}

inline unsigned fix_blocks(int64_t n) {
  const unsigned b = blocks_for(n > 0 ? n : 1, kThreads);
  return b < kFixBlocks ? b : kFixBlocks;
}

inline int64_t tiles_for(int64_t n, int tile) { return (n + tile - 1) / tile; }

// Every entry's scratch, in int64 words for T tiles: the tile status words
// [0, T), the ticket (T) and the valid count (T + 1), all zeroed per
// launch; then two arrays of T + 1 words: the merge-path splits, or the
// continuations and their targets.
struct Scratch {
  uint64_t* status;
  unsigned long long* ticket;
  int64_t* n_valid;
  int64_t* a;
  int64_t* b;
};

inline int64_t scratch_words(int64_t lanes) {
  return 3 * tiles_for(lanes, kTile < kRunTile ? kTile : kRunTile) + 4;
}

inline cudaError_t carve(int64_t* s, int64_t T, cudaStream_t st, Scratch* out) {
  *out = {reinterpret_cast<uint64_t*>(s), reinterpret_cast<unsigned long long*>(s + T),
          s + T + 1, s + T + 2, s + 2 * T + 3};
  return cudaMemsetAsync(s, 0, (T + 2) * sizeof(int64_t), st);
}

template <int W>
cudaError_t merge_w(const int64_t* ha, const int64_t* ka, const int64_t* ca,
                    const int64_t* hb, const int64_t* kb, const int64_t* cb,
                    const int64_t* n_a, const int64_t* n_b, int64_t La, int64_t L,
                    int64_t* scratch, int64_t* oh, int64_t* ok, int64_t* oc,
                    int64_t* n_active, cudaStream_t st) {
  const int64_t T = tiles_for(L, kTile);
  Scratch sc;
  cudaError_t err = carve(scratch, T, st, &sc);
  if (err != cudaSuccess) return err;
  merge_split_kernel<W><<<blocks_for(T + 1, kThreads), kThreads, 0, st>>>(
      ha, ka, hb, kb, n_a, n_b, La, L, T, sc.a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int smem = merge_smem_bytes<W>();
  err = cudaFuncSetAttribute(merge_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  merge_kernel<W><<<static_cast<unsigned>(T), kThreads, smem, st>>>(
      ha, ka, ca, hb, kb, cb, n_a, n_b, sc.a, sc.status, sc.ticket, oh, ok, oc, n_active,
      La, L, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fix_kernel<<<fix_blocks(L), kThreads, 0, st>>>(nullptr, nullptr, 0, n_active, L, oc);
  return cudaGetLastError();
}

template <int W>
cudaError_t totals_w(const int64_t* keys, const uint8_t* valid, const int64_t* perm,
                     int64_t B, int64_t* scratch, int64_t* oh, int64_t* ok, int64_t* oc,
                     int64_t* n_active, bool compact, cudaStream_t st) {
  const int64_t T = tiles_for(B, kRunTile);
  Scratch sc;
  cudaError_t err = carve(scratch, T, st, &sc);
  if (err != cudaSuccess) return err;
  count_valid_kernel<<<fix_blocks(B / 16), kThreads, 0, st>>>(
      valid, B, reinterpret_cast<unsigned long long*>(sc.n_valid));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const bool pairs = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  if (compact)
    totals_kernel<W, true><<<static_cast<unsigned>(T), kThreads, 0, st>>>(
        keys, perm, B, pairs, sc.n_valid, sc.status, sc.ticket, sc.a, sc.b, oh, ok, oc,
        n_active, T);
  else
    totals_kernel<W, false><<<static_cast<unsigned>(T), kThreads, 0, st>>>(
        keys, perm, B, pairs, sc.n_valid, sc.status, sc.ticket, sc.a, sc.b, oh, ok, oc,
        n_active, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fix_kernel<<<fix_blocks(compact ? B : T), kThreads, 0, st>>>(
      sc.a, sc.b, T, compact ? n_active : nullptr, B, oc);
  return cudaGetLastError();
}

template <int W>
cudaError_t compact_w(const int64_t* h, const int64_t* keys, const int64_t* counts,
                      int64_t B, int64_t* scratch, int64_t* oh, int64_t* ok,
                      int64_t* oc, int64_t* n_active, cudaStream_t st) {
  const int64_t T = tiles_for(B, kRunTile);
  Scratch sc;
  cudaError_t err = carve(scratch, T, st, &sc);
  if (err != cudaSuccess) return err;
  compact_kernel<W><<<static_cast<unsigned>(T), kThreads, 0, st>>>(
      h, keys, counts, B, sc.status, sc.ticket, oh, ok, oc, n_active, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fix_kernel<<<fix_blocks(B), kThreads, 0, st>>>(nullptr, nullptr, 0, n_active, B, oc);
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

// Lanes a block takes: merged lanes of K4m (entry 0), sorted or input
// lanes of K4f (entry 1).
int jt_runs_tile(int entry) { return entry ? kRunTile : kTile; }

// int64 words of device scratch an entry needs for `lanes` lanes (L of a
// merge, B of the others). Every entry launches on `stream` without
// synchronising, zeroes its scratch's status words itself, and returns the
// launches' cudaError_t (0 = launched).
int64_t jt_runs_scratch(int64_t lanes) { return scratch_words(lanes); }

// K4m. a = (ha, ka, ca) of La lanes, b = (hb, kb, cb) of L - La: the first
// *n_a (*n_b) lanes active and sorted, the rest ignored (a count is clamped
// to its run's lanes). Writes the L lanes' counts of oc, the actives' h and
// keys, and *n_active.
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

// K4f, multiplicity 1: lane p of the sorted order is lane perm[p] of (keys,
// valid), valid lanes first, and its h is mix32 of its key. compact != 0:
// (oh, ok, oc) get the representatives compacted with their run lengths,
// then dead lanes (count 0), and *n_active their number; otherwise the
// sorted lanes with run lengths at the representatives, 0 elsewhere.
int jt_run_totals(const void* keys, const void* valid, const void* perm, int64_t B,
                  void* oh, void* ok, void* oc, void* n_active, int compact, int W,
                  void* scratch, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
#define JT_TOTALS(WW)                                                          \
  totals_w<WW>(I64(keys), static_cast<const uint8_t*>(valid), I64(perm), B,   \
               O64(scratch), O64(oh), O64(ok), O64(oc), O64(n_active),        \
               compact != 0, st)
  JT_DISPATCH_W(W, JT_TOTALS)
#undef JT_TOTALS
  return static_cast<int>(err);
}

// K4f, counts given (_compact): the lanes with counts != 0 first, in input
// order, then dead lanes (count 0); *n_active their number.
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

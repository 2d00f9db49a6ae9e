// K23 frame_pick: the window's First and Last over a frame.
//
// Replaces the reference's spark_rapids_tpu/exec/window.py:338-355: over
// rows sorted by (partition keys, order keys), row i's frame is the
// inclusive range [lo_i, hi_i] of sorted rows (exec/window.py
// _frame_bounds; a whole frame is the partition, a running ROWS frame its
// start to the row, a running RANGE frame its start to the end of the
// row's peer run).  Per row the pick is
//   - first ignoring nulls: the first valid row j >= lo_i, kept if j <= hi_i;
//   - last ignoring nulls: the last valid row j <= hi_i, kept if j >= lo_i;
//   - with nulls counted: lo_i (first) or hi_i (last) itself;
// and the result is the index (clamped into [0, n)) and a flag: the frame
// is not empty, j lies in it and row j is valid.  A row is valid where the
// column's validity holds and the row is live: the live rows are the
// first n_live (the window's padding sorts last), so the kernel takes
// their count and ANDs it in, and no combined lane is built.  The
// reference finds j by searchsorted(cpre, cpre[lo] + 1) - 1 over the
// valid-count prefix cpre (and searchsorted(cpre, cpre[hi + 1]) - 1 for
// last): a binary search a row.  Here a frame lies inside its partition,
// so the nearest valid row at or after lo (at or before hi) is the same
// whether or not the scan stops at partition starts: one unsegmented scan
// of positions gives it.
//
// The scan (where nulls are ignored): tiles of 8,192 rows, 32 a thread --
// one 32-bit word of valid bits, read as two 16-byte loads of the valid
// bytes; a thread's nearest valid row is one __ffs / __clz of its word,
// a warp and then the block join them with shuffles, and each tile finds
// the tiles before it in the scan's direction (from the start for last,
// from the end for first) by a decoupled look-back carrying one 32-bit
// position a tile.  Then one of two launch plans:
//   - fused, one launch: where every row's bound at the pick end is the
//     row itself (last with hi the row: the forward fill; first with lo
//     the row), a row's pick is the scan's own running value, which the
//     tile holds when its look-back ends.  The tile stages the picks in
//     shared memory and the block then reads the other bound, 4 rows a
//     thread as 16-byte loads, and writes the index and the flag
//     coalesced.  Nothing goes back to device memory between scan and
//     pick.
//   - bitmap, two launches: a bound may lie in a tile that finishes later
//     (a frame that reaches FOLLOWING rows, a whole partition, a RANGE
//     frame's start for first), so the scan writes, a word a thread, the
//     word's valid bits and the nearest valid row beyond the word toward
//     the scan's start (last: the greatest valid row before it; first:
//     the least after it): 8 bytes per 32 rows, 8 MB at 2^25 rows, which
//     stay in the 50 MB L2 cache.  The pick reads the word at the bound,
//     masks the bits on the far side of the bound and takes __clz / __ffs
//     of the rest; only where that word holds no valid row on the near
//     side does it read the word's nearest-valid entry.  Two cached reads
//     a row, whatever the run of nulls.
// With nulls counted one launch: the pick is the bound, and its valid
// byte is read where it lies in the live rows.
// Work per thread is 32 rows (scan) and 4 rows (pick) whatever the frames
// and the nulls: an all-null partition of millions of rows costs what any
// other rows cost.
//
// Bound: device-memory bytes.  The valid byte a row and, where they are
// materialised, 4 bytes a bound a row, the int32 index and the flag byte
// written a row; the bitmap plan adds its 8 bytes per 32 rows written and
// read.  Over 3.35 TB/s.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 32;                  // rows a thread (scan): a word
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kValueBits = 0xffffffffull;
constexpr int kBound = 0, kBitmap = 1, kFused = 2;   // the launch plans

__device__ __forceinline__ unsigned long long pack(unsigned long long status,
                                                   int value) {
  return (status << 62) | (static_cast<unsigned>(value) & kValueBits);
}

// The valid bits of a thread's rows [first, first + rows): two 16-byte
// loads where the 32 bytes are whole and aligned, else one byte a row;
// rows at or past n_live are not valid.
__device__ __forceinline__ unsigned load_bits(const unsigned char* valid,
                                              long long first, int rows,
                                              int n_live) {
  unsigned bits = 0;
  const unsigned char* p = valid + first;
  if (rows == kItems && reinterpret_cast<size_t>(p) % 16 == 0) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        bits |= ((w[q] >> (8 * c)) & 0xffu) ? (1u << (4 * q + c)) : 0u;
  } else {
    for (int k = 0; k < rows; ++k) bits |= p[k] ? (1u << k) : 0u;
  }
  const long long live = n_live - first;
  if (live < kItems) bits &= live <= 0 ? 0u : (1u << live) - 1u;
  return bits;
}

__device__ __forceinline__ int stage_at(int e) { return e + e / kItems; }

// A thread's W consecutive words of the scan: its first row, each word's
// valid bits, and each word's nearest valid row beyond it toward the
// scan's start (LAST: the greatest valid row before the word, or -1;
// else the least after it, or INT_MAX).
template <int W>
struct Span {
  long long first;
  unsigned bits[W];
  int carry[W];
};

// The scan of tile `tile` (LAST: tiles from the array's start; else from
// its end) over [tile_first, tile_first + kTile * W), W words a thread,
// every thread of the block together.  status: a word a tile, zero on
// entry.
template <bool LAST, int W>
__device__ Span<W> scan_tile(const unsigned char* __restrict__ valid, int n,
                             int n_live, int tile, long long tile_first,
                             volatile unsigned long long* status) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_carry;
  constexpr int kNone = LAST ? -1 : INT_MAX;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  Span<W> w;
  w.first = tile_first + (long long)tid * kItems * W;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const long long at = w.first + q * kItems;
    const int rows = static_cast<int>(
        n - at >= kItems ? kItems : (n > at ? n - at : 0));
    w.bits[q] = rows > 0 ? load_bits(valid, at, rows, n_live) : 0u;
  }
  // the thread's nearest valid row toward the scan's far end
  int mine = kNone;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const int at = static_cast<int>(w.first) + q * kItems;
    if (w.bits[q])
      mine = LAST ? at + 31 - __clz(w.bits[q])
                  : min(mine, at + __ffs(w.bits[q]) - 1);
  }

  // the threads before this one in the scan's direction: lower lanes
  // (LAST) or higher ones
  int scan = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = LAST ? __shfl_up_sync(kFull, scan, off)
                       : __shfl_down_sync(kFull, scan, off);
    if (LAST ? lane >= off : lane + off < 32)
      scan = LAST ? max(scan, y) : min(scan, y);
  }
  int carry = LAST ? __shfl_up_sync(kFull, scan, 1)
                   : __shfl_down_sync(kFull, scan, 1);
  if (LAST ? lane == 0 : lane == 31) carry = kNone;
  if (LAST ? lane == 31 : lane == 0) s_warp[warp] = scan;
  __syncthreads();
  for (int q = 0; q < kWarps; ++q)
    if (LAST ? q < warp : q > warp)
      carry = LAST ? max(carry, s_warp[q]) : min(carry, s_warp[q]);

  if (warp == 0) {
    int agg = kNone;
    for (int q = 0; q < kWarps; ++q)
      agg = LAST ? max(agg, s_warp[q]) : min(agg, s_warp[q]);
    int before = kNone;
    if (tile == 0) {
      if (lane == 0) status[0] = pack(2, agg);
    } else {
      if (lane == 0) status[tile] = pack(1, agg);
      for (int base = tile - 1;; base -= 32) {
        const int t = base - lane;
        unsigned long long st = pack(2, kNone);
        do {
          if (t >= 0) st = status[t];
        } while (__any_sync(kFull, (st >> 62) == 0));
        const unsigned done = __ballot_sync(kFull, (st >> 62) == 2);
        const int stop = done ? __ffs(done) - 1 : 31;
        int x = lane <= stop ? static_cast<int>(st & kValueBits) : kNone;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const int y = __shfl_xor_sync(kFull, x, off);
          x = LAST ? max(x, y) : min(x, y);
        }
        before = LAST ? max(before, x) : min(before, x);
        if (done) break;
      }
      if (lane == 0)
        status[tile] = pack(2, LAST ? max(before, agg) : min(before, agg));
    }
    if (lane == 0) s_carry = before;
  }
  __syncthreads();
  carry = LAST ? max(carry, s_carry) : min(carry, s_carry);
  // each word's own carry: the thread's, then its words toward the start
#pragma unroll
  for (int u = 0; u < W; ++u) {
    const int q = LAST ? u : W - 1 - u;
    const int at = static_cast<int>(w.first) + q * kItems;
    w.carry[q] = carry;
    if (w.bits[q])
      carry = LAST ? at + 31 - __clz(w.bits[q]) : at + __ffs(w.bits[q]) - 1;
  }
  return w;
}

// The tile a block scans: numbered in the order the blocks start, so a
// tile's look-back waits only on running ones.  Returns its first row.
template <bool LAST>
__device__ __forceinline__ long long next_tile(unsigned long long* state,
                                               int tile_rows, int* tile) {
  __shared__ int s_tile;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(state, 1ull));
  __syncthreads();
  *tile = s_tile;
  return (long long)(LAST ? s_tile : gridDim.x - 1 - s_tile) * tile_rows;
}

// Row r's result from its frame [l, h] (clamped as the reference clamps
// it) and its pick j; j_valid: row j is valid if it lies in [0, n) (the
// scan's picks), else the valid byte at j is read (nulls counted).
struct Picked {
  int idx;
  unsigned char flag;
};

__device__ __forceinline__ Picked pick_row(int l, int h, int j, int n,
                                           bool j_valid,
                                           const unsigned char* valid,
                                           int n_live) {
  const int jc = min(max(j, 0), n - 1);
  const bool in = h >= l && j >= l && j <= h;
  const bool ok = in && (j_valid || (jc < n_live && __ldg(valid + jc)));
  return Picked{jc, static_cast<unsigned char>(ok ? 1 : 0)};
}

// Row r's bound: a null bound is the row itself; clamped into
// [lo_clamp, n).
__device__ __forceinline__ int load_bound(const int* __restrict__ b,
                                          long long r, int lo_clamp, int n) {
  const int x = b ? __ldg(b + r) : static_cast<int>(r);
  return min(max(x, lo_clamp), n - 1);
}

// Four rows' bounds from r (m of them below n), one 16-byte load where
// whole and vec.
__device__ __forceinline__ void load_bounds4(const int* __restrict__ b,
                                             long long r, int m, bool vec,
                                             int lo_clamp, int n, int* out) {
  if (b && vec && m == 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(b + r));
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = min(max(out[k], lo_clamp), n - 1);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[k] = k < m ? load_bound(b, r + k, lo_clamp, n) : 0;
}

__device__ __forceinline__ void store4(int* __restrict__ idx,
                                       unsigned char* __restrict__ flag,
                                       long long r, int m, bool vec,
                                       const Picked* p) {
  if (vec && m == 4) {
    *reinterpret_cast<int4*>(idx + r) =
        make_int4(p[0].idx, p[1].idx, p[2].idx, p[3].idx);
    *reinterpret_cast<unsigned*>(flag + r) =
        p[0].flag | (p[1].flag << 8) | (p[2].flag << 16) |
        (static_cast<unsigned>(p[3].flag) << 24);
    return;
  }
  for (int k = 0; k < m; ++k) {
    idx[r + k] = p[k].idx;
    flag[r + k] = p[k].flag;
  }
}

// The fused plan: scan a tile, then pick at each of its rows, whose
// bound at the pick end is the row itself (LAST: hi; else lo), and read
// the other bound, 4 rows a thread a step (16-byte loads and stores; on
// the H100 a little faster than a row a thread at qg4's forward fill).
template <bool LAST>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const unsigned char* __restrict__ valid,
             const int* __restrict__ lo, const int* __restrict__ hi, int n,
             int n_live, unsigned long long* state, int vec,
             int* __restrict__ idx, unsigned char* __restrict__ flag) {
  __shared__ int s_stage[kTile + kThreads];
  int tile;
  const long long tile_first = next_tile<LAST>(state, kTile, &tile);
  const Span<1> w = scan_tile<LAST, 1>(valid, n, n_live, tile, tile_first,
                                       state + 1);
  const int tid = threadIdx.x;
  int c = w.carry[0];
  if (LAST) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if ((w.bits[0] >> k) & 1u) c = static_cast<int>(w.first) + k;
      s_stage[stage_at(tid * kItems + k)] = c;
    }
  } else {
#pragma unroll
    for (int k = kItems - 1; k >= 0; --k) {
      if ((w.bits[0] >> k) & 1u) c = static_cast<int>(w.first) + k;
      s_stage[stage_at(tid * kItems + k)] = c;
    }
  }
  __syncthreads();
  const int tile_rows = static_cast<int>(
      n - tile_first < kTile ? n - tile_first : (long long)kTile);
  for (int e = 4 * tid; e < tile_rows; e += 4 * kThreads) {
    const long long r = tile_first + e;
    const int m = tile_rows - e < 4 ? tile_rows - e : 4;
    int l[4], h[4];
    load_bounds4(LAST ? lo : nullptr, r, m, vec, 0, n, l);
    load_bounds4(LAST ? nullptr : hi, r, m, vec, -1, n, h);
    Picked p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      p[k] = pick_row(l[k], h[k], s_stage[stage_at(min(e + k, kTile - 1))],
                      n, true, valid, n_live);
    store4(idx, flag, r, m, vec, p);
  }
}

// The bitmap plan's scan: kSpanWords words a thread, each word's valid
// bits and its nearest valid row beyond it toward the scan's start.
constexpr int kSpanWords = 4;
constexpr int kSpanTile = kTile * kSpanWords;

template <bool LAST>
__global__ void __launch_bounds__(kThreads)
summary_kernel(const unsigned char* __restrict__ valid, int n, int n_live,
               unsigned long long* state, unsigned* __restrict__ bits,
               int* __restrict__ near) {
  int tile;
  const long long tile_first = next_tile<LAST>(state, kSpanTile, &tile);
  const Span<kSpanWords> w = scan_tile<LAST, kSpanWords>(
      valid, n, n_live, tile, tile_first, state + 1);
  const long long word = w.first / kItems;
  const long long words = ((long long)n + kItems - 1) / kItems;
  if (word + kSpanWords <= words) {
    *reinterpret_cast<uint4*>(bits + word) =
        make_uint4(w.bits[0], w.bits[1], w.bits[2], w.bits[3]);
    *reinterpret_cast<int4*>(near + word) =
        make_int4(w.carry[0], w.carry[1], w.carry[2], w.carry[3]);
    return;
  }
#pragma unroll
  for (int q = 0; q < kSpanWords; ++q) {
    if (word + q < words) {
      bits[word + q] = w.bits[q];
      near[word + q] = w.carry[q];
    }
  }
}

// A row a thread: the frame [lo, hi] (a null bound: the row itself); the
// pick j: the bound itself (kBound), or the nearest valid row toward the
// frame from it over the bitmap (kBitmap); idx = j clamped into [0, n);
// flag = frame not empty, j inside it, row j valid.  (4 rows a thread
// with 16-byte loads took longer at qg4's calls on the H100.)
template <int PLAN, bool LAST>
__global__ void __launch_bounds__(kThreads)
pick_kernel(const unsigned char* __restrict__ valid,
            const int* __restrict__ lo, const int* __restrict__ hi, int n,
            int n_live, const unsigned* __restrict__ bits,
            const int* __restrict__ near, int* __restrict__ idx,
            unsigned char* __restrict__ flag) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x; r < n;
       r += stride) {
    const int l = load_bound(lo, r, 0, n);
    const int h = load_bound(hi, r, -1, n);
    int j = LAST ? h : l;
    if (PLAN == kBitmap && j >= 0) {
      const int at = j / kItems, b = j % kItems;
      const unsigned word =
          __ldg(bits + at) & (LAST ? kFull >> (31 - b) : kFull << b);
      j = word ? at * kItems + (LAST ? 31 - __clz(word) : __ffs(word) - 1)
               : __ldg(near + at);
    }
    const Picked p = pick_row(l, h, j, n, PLAN == kBitmap, valid, n_live);
    idx[r] = p.idx;
    flag[r] = p.flag;
  }
}

int tiles_of(int n, int tile_rows) {
  return static_cast<int>(((long long)n + tile_rows - 1) / tile_rows);
}

long long words_of(int n) { return ((long long)n + kItems - 1) / kItems; }

template <int PLAN>
void launch_pick(int last, const unsigned char* valid, const int* lo,
                 const int* hi, int n, int n_live, const unsigned* bits,
                 const int* near, int* idx, unsigned char* flag,
                 cudaStream_t stream) {
  const long long blocks = ((long long)n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 8192 ? blocks : 8192);
  if (last)
    pick_kernel<PLAN, true><<<grid, kThreads, 0, stream>>>(
        valid, lo, hi, n, n_live, bits, near, idx, flag);
  else
    pick_kernel<PLAN, false><<<grid, kThreads, 0, stream>>>(
        valid, lo, hi, n, n_live, bits, near, idx, flag);
}

}  // namespace

// The scratch's 64-bit words for n rows: the tile counter and a status
// word a tile, then the bitmap plan's words of valid bits and their
// nearest-valid entries (4 bytes each a 32-row word).
extern "C" int srt_frame_pick_scratch_words(int n) {
  const int m = n < 1 ? 1 : n;
  return static_cast<int>(1 + tiles_of(m, kTile) + words_of(m) + 3);
}

extern "C" int srt_tile_rows() { return kTile; }

// valid: bool[n] (the picked column's validity); n_live: rows at or past
// it are not valid (the window's padding); lo, hi: int32[n] frame bounds
// over the sorted rows, or null for the row itself; last: 0 first, 1
// last; plan: 0 the bound itself (nulls counted), 1 the nearest valid row
// over a bitmap (two launches), 2 the nearest valid row in the scan's
// launch (last with a null hi, or first with a null lo); scratch:
// srt_frame_pick_scratch_words(n) words for plans 1 and 2.  Writes idx
// int32[n] and flag bool[n].  n >= 0.  vec: lo, hi and idx 16-byte
// aligned and flag 4-byte aligned (the fused plan's 16-byte accesses).
extern "C" int srt_frame_pick(const unsigned char* valid, const int* lo,
                              const int* hi, int n, int n_live, int last,
                              int plan, void* scratch, int vec, int* idx,
                              unsigned char* flag, cudaStream_t stream) {
  if (n < 0 || !valid || !idx || !flag || plan < kBound || plan > kFused ||
      (plan != kBound && !scratch) ||
      (plan == kFused && (last ? hi != nullptr : lo != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  n_live = std::min(std::max(n_live, 0), n);
  if (plan == kBound) {
    launch_pick<kBound>(last, valid, lo, hi, n, n_live, nullptr, nullptr,
                        idx, flag, stream);
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = tiles_of(n, plan == kFused ? kTile : kSpanTile);
  auto* state = static_cast<unsigned long long*>(scratch);
  const cudaError_t err = cudaMemsetAsync(
      state, 0, (1 + (size_t)tiles) * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan == kFused) {
    if (last)
      fused_kernel<true><<<tiles, kThreads, 0, stream>>>(
          valid, lo, hi, n, n_live, state, vec, idx, flag);
    else
      fused_kernel<false><<<tiles, kThreads, 0, stream>>>(
          valid, lo, hi, n, n_live, state, vec, idx, flag);
    return static_cast<int>(cudaGetLastError());
  }
  // the words' arrays after the state words of the fused plan's tiles,
  // 16-byte aligned for the scan's stores
  auto* bits = reinterpret_cast<unsigned*>(
      state + ((2 + tiles_of(n, kTile)) & ~1));
  int* near = reinterpret_cast<int*>(bits + ((words_of(n) + 3) & ~3ll));
  if (last)
    summary_kernel<true><<<tiles, kThreads, 0, stream>>>(valid, n, n_live,
                                                          state, bits, near);
  else
    summary_kernel<false><<<tiles, kThreads, 0, stream>>>(valid, n, n_live,
                                                           state, bits, near);
  launch_pick<kBitmap>(last, valid, lo, hi, n, n_live, bits, near, idx,
                       flag, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// is not empty, j lies in it and valid[j] is set.  The reference finds j by
// searchsorted(cpre, cpre[lo] + 1) - 1 over the valid-count prefix cpre
// (and searchsorted(cpre, cpre[hi + 1]) - 1 for last): a binary search a
// row.  Here a frame lies inside its partition, so the nearest valid row
// at or after lo (at or before hi) is the same whether or not the scan
// stops at partition starts: one unsegmented scan of positions gives it.
//
// Two launches where nulls are ignored, one where they count:
//   1. nearest_kernel: near[i] = the least valid row >= i (first; INT_MAX
//      if none) or the greatest valid row <= i (last; -1 if none): a
//      min-scan from the right or a max-scan from the left of
//      valid ? i : none.  Tiles of 8,192 rows (32 a thread, read as two
//      16-byte loads of the valid bytes); a thread's nearest valid row is
//      one __ffs / __clz of its 32 bits, a warp and then the block join
//      them with shuffles, and each tile finds the tiles before it in the
//      scan's direction by a decoupled look-back carrying one 32-bit
//      position a tile.  The outputs leave through a shared-memory stage,
//      a warp writing 128 consecutive ints an instruction.
//   2. pick_kernel: per row, the bound's near entry (or the bound itself),
//      the frame test and the valid byte at the pick.
// The read at a bound must wait for the whole scan: a bound may lie in a
// tile that finishes later (a frame that reaches FOLLOWING rows, a whole
// partition), so the pick is its own launch rather than the scan's tail.
// Work per thread is 32 rows (scan) and one row (pick) whatever the
// frames and the nulls: an all-null partition of millions of rows costs
// what any other rows cost.
//
// Bound: device-memory bytes.  The valid byte a row and, where they are
// materialised, 4 bytes a bound a row, the int32 index and the flag byte
// written a row; the scan adds its 4-byte write and read a row.  Over
// 3.35 TB/s.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 32;                  // rows a thread (scan)
constexpr int kTile = kThreads * kItems;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kValueBits = 0xffffffffull;

__device__ __forceinline__ unsigned long long pack(unsigned long long status,
                                                   int value) {
  return (status << 62) | (static_cast<unsigned>(value) & kValueBits);
}

// The valid bits of a thread's rows [first, first + rows): two 16-byte
// loads where the 32 bytes are whole and aligned, else one byte a row.
__device__ __forceinline__ unsigned load_bits(const unsigned char* valid,
                                              long long first, int rows) {
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
    return bits;
  }
  for (int k = 0; k < rows; ++k) bits |= p[k] ? (1u << k) : 0u;
  return bits;
}

__device__ __forceinline__ int stage_at(int e) { return e + e / kItems; }

// LAST: near[i] = the greatest valid row <= i, or -1 (tiles from the
// array's start); else the least valid row >= i, or INT_MAX (tiles from
// its end).  state: the tile counter, then a status word a tile, zero on
// entry.
template <bool LAST>
__global__ void __launch_bounds__(kThreads)
nearest_kernel(const unsigned char* __restrict__ valid, int n,
               int* __restrict__ near, unsigned long long* state) {
  __shared__ int s_stage[kTile + kThreads];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile, s_carry;
  constexpr int kNone = LAST ? -1 : INT_MAX;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(state, 1ull));
  __syncthreads();
  const int tile = s_tile;
  volatile unsigned long long* status = state + 1;
  const long long tile_first =
      (long long)(LAST ? tile : gridDim.x - 1 - tile) * kTile;
  const int tile_rows = static_cast<int>(
      n - tile_first < kTile ? n - tile_first : (long long)kTile);
  const long long first = tile_first + (long long)tid * kItems;
  const int rows = static_cast<int>(
      n - first >= kItems ? kItems : (n > first ? n - first : 0));
  const unsigned bits = rows > 0 ? load_bits(valid, first, rows) : 0u;
  // the thread's nearest valid row toward the scan's far end
  const int mine = !bits ? kNone
                   : LAST ? static_cast<int>(first) + 31 - __clz(bits)
                          : static_cast<int>(first) + __ffs(bits) - 1;

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
  for (int w = 0; w < kWarps; ++w)
    if (LAST ? w < warp : w > warp)
      carry = LAST ? max(carry, s_warp[w]) : min(carry, s_warp[w]);

  if (warp == 0) {
    int agg = kNone;
    for (int w = 0; w < kWarps; ++w)
      agg = LAST ? max(agg, s_warp[w]) : min(agg, s_warp[w]);
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
  int c = LAST ? max(carry, s_carry) : min(carry, s_carry);
  if (LAST) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if ((bits >> k) & 1u) c = static_cast<int>(first) + k;
      s_stage[stage_at(tid * kItems + k)] = c;
    }
  } else {
#pragma unroll
    for (int k = kItems - 1; k >= 0; --k) {
      if ((bits >> k) & 1u) c = static_cast<int>(first) + k;
      s_stage[stage_at(tid * kItems + k)] = c;
    }
  }
  __syncthreads();
  for (int e = tid; e < tile_rows; e += kThreads)
    near[tile_first + e] = s_stage[stage_at(e)];
}

// Per row: the frame [lo, hi] (a null bound: the row itself), clamped as
// the reference clamps it; the pick j (near's entry at the bound, or the
// bound); idx = j clamped into [0, n); flag = frame not empty, j inside
// it, valid[j].
__global__ void __launch_bounds__(kThreads)
pick_kernel(const unsigned char* __restrict__ valid,
            const int* __restrict__ lo, const int* __restrict__ hi, int n,
            int last, const int* __restrict__ near, int* __restrict__ idx,
            unsigned char* __restrict__ flag) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    int l = lo ? __ldg(lo + i) : static_cast<int>(i);
    int h = hi ? __ldg(hi + i) : static_cast<int>(i);
    l = min(max(l, 0), n - 1);
    h = min(max(h, -1), n - 1);
    int j;
    if (near)
      j = last ? (h >= 0 ? __ldg(near + h) : -1) : __ldg(near + l);
    else
      j = last ? h : l;
    const bool in = h >= l && j >= l && j <= h;
    const int jc = min(max(j, 0), n - 1);
    idx[i] = jc;
    flag[i] = in && __ldg(valid + jc) ? 1 : 0;
  }
}

int tiles_of(int n) {
  return static_cast<int>(((long long)n + kTile - 1) / kTile);
}

}  // namespace

// The look-back state's 64-bit words for n rows: the tile counter and a
// status word a tile.
extern "C" int srt_frame_pick_state_words(int n) {
  return 1 + tiles_of(n < 1 ? 1 : n);
}

extern "C" int srt_tile_rows() { return kTile; }

// valid: bool[n] (the picked column's validity and the live rows); lo, hi:
// int32[n] frame bounds over the sorted rows, or null for the row itself;
// last: 0 first, 1 last; ignore_nulls: pick the nearest valid row (near:
// int32[n] scratch, state: srt_frame_pick_state_words(n) words), else the
// bound itself (near and state unused).  Writes idx int32[n] and flag
// bool[n].  n >= 0.
extern "C" int srt_frame_pick(const unsigned char* valid, const int* lo,
                              const int* hi, int n, int last,
                              int ignore_nulls, int* near,
                              unsigned long long* state, int* idx,
                              unsigned char* flag, cudaStream_t stream) {
  if (n < 0 || !valid || !idx || !flag || (ignore_nulls && (!near || !state)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int tiles = tiles_of(n);
  if (ignore_nulls) {
    const cudaError_t err = cudaMemsetAsync(
        state, 0, (1 + (size_t)tiles) * sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (last)
      nearest_kernel<true><<<tiles, kThreads, 0, stream>>>(valid, n, near,
                                                            state);
    else
      nearest_kernel<false><<<tiles, kThreads, 0, stream>>>(valid, n, near,
                                                             state);
  }
  const long long blocks = ((long long)n + kThreads - 1) / kThreads;
  pick_kernel<<<static_cast<int>(blocks < 8192 ? blocks : 8192), kThreads, 0,
                stream>>>(valid, lo, hi, n, last,
                          ignore_nulls ? near : nullptr, idx, flag);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K16: the gather of string spans: new offsets for a row selection, then
// the selected bytes.
//
// Replaces the reference's ops/strings.py gather_strings and
// ops/gather.py gather_spans: new offsets are a cumsum of the selected
// lengths (0 for an invalid slot), and every output byte finds its row
// by a searchsorted over the new offsets (or a scatter-and-cummax fill
// on the TPU), then reads chars[src_start[row] + p - new_start[row]].
//
// Bound: device-memory bytes.  Per output row the index (4 B), the valid
// flag (1 B) and the source offsets (8 B) read and the new offset (4 B)
// written; then the selected bytes read once and the whole output buffer
// (the zero tail past the byte total included) written once, over
// 3.35 TB/s.  What held the first design (one warp copying its 32 rows
// one after another, byte loads and byte stores) below that: its work
// per lane followed the row length, so one-byte rows kept 1 lane of 32
// busy and every store was one byte; and it read the source offsets at
// random a second time.
//
// This design balances the copy by output bytes, not by rows:
//
//   1. offsets_kernel: each output row's length (the source row's where
//      valid, else 0) and their exclusive scan, written as offsets
//      int32[n + 1], with the byte total as int64 in `total` (so a total
//      past 2^31 - 1 is seen, never wrapped), and beside them each row's
//      source start (int32[n], 0 for an invalid slot), so the copy reads
//      nothing at random but the chars.  One block a tile of 4,096 rows;
//      each thread has its 16 rows' random reads of the source offsets
//      in flight together; the tile scans in registers and warp
//      shuffles and finds the sum of the earlier tiles by decoupled
//      look-back, as K7 (csrc/expand_ends.cu) does: tiles take their
//      numbers from an atomic counter, publish their own sum, then
//      their inclusive prefix, in one 64-bit word (flag in the top two
//      bits);
//   2. stretch_kernel: the output is cut into stretches of kStretch =
//      4,096 bytes; one thread a stretch finds, by two binary searches
//      over the new offsets, the rows that cover its first and last byte
//      (as K5's merge-path partition finds its tiles' rows,
//      csrc/join_expand.cu);
//   3. copy_kernel: one block a stretch, one 16-byte chunk of output a
//      thread.  The block stages its rows' (new offset, source start)
//      pairs in shared memory, 4,096 rows a round (empty rows are staged
//      too, so a long run of nulls takes more rounds); each thread finds
//      the first row of its chunk by a binary search there, builds the
//      16 bytes in two 64-bit registers and writes them with one 16-byte
//      store.  Each row piece in the chunk is read as the aligned 8-byte
//      words that hold it (one for a one-byte flag, at most three),
//      realigned by funnel shifts (64-bit shifts) and masked in; the
//      loads of kBatch = 2 pieces all start before either is used.
//      Blocks past the byte total write the zero tail.  The work of a
//      thread no longer depends on row length or skew: one-byte flags
//      come 16 to a thread, and a 1 MB row spreads over 256 blocks.
//
// Through a sort's order both launches read at random (a row's pair of
// source offsets, then its bytes), and on the card they run at about the
// rate of index_select's random reads (chip_smoke.py prints both), well
// above the byte bound.  Tried on the card and left out: 4 pieces a batch
// (76 registers, 3 blocks an SM: slower), 16-byte loads in the copy and
// one 16-byte load for a row's offset pair (no faster), a block copy
// that gathers the stretch's source words into shared memory first
// (slower), and cache hints on the streamed arrays (no faster).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kPadded = kTile + kTile / kItems;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr int kChunk = 16;                       // output bytes a thread
constexpr int kStretch = kThreads * kChunk;      // output bytes a block
constexpr int kStage = 4096;                     // rows staged a round
constexpr int kBatch = 2;  // row pieces whose loads start together

__device__ __forceinline__ int padded(int i) { return i + i / kItems; }

__device__ __forceinline__ long long warp_inclusive_scan(long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// state: a tile counter (word 0) and one word per tile, all zero on entry.
__global__ void __launch_bounds__(kThreads)
offsets_kernel(const int* __restrict__ src_offsets, int src_rows,
               const int* __restrict__ indices,
               const unsigned char* __restrict__ valid, int n,
               int* __restrict__ new_offsets, int* __restrict__ starts,
               long long* __restrict__ total, unsigned long long* state) {
  __shared__ int s_rows[kPadded];
  __shared__ long long s_warp[kWarps];
  __shared__ long long s_before;
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(state, 1ull));
  __syncthreads();
  const int tile = s_tile;
  volatile unsigned long long* status = state + 1;
  const long long first = (long long)tile * kTile;
  const int rows =
      static_cast<int>(n - first < kTile ? n - first : (long long)kTile);

  // loads in three rounds, so each thread has its 16 rows' random reads
  // of the source offsets in flight together
  int src[kItems], start[kItems], end[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    src[k] = -1;
    if (i < rows && src_rows > 0) {
      const int r = indices[first + i];
      if (valid[first + i])
        src[k] = r < 0 ? 0 : (r >= src_rows ? src_rows - 1 : r);
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    start[k] = src[k] >= 0 ? src_offsets[src[k]] : 0;
    end[k] = src[k] >= 0 ? src_offsets[src[k] + 1] : 0;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    if (i < rows) starts[first + i] = start[k];
    s_rows[padded(i)] = end[k] - start[k];
  }
  __syncthreads();

  long long run[kItems];
  long long sum = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    sum += s_rows[padded(tid * kItems + k)];
    run[k] = sum;
  }
  const long long incl = warp_inclusive_scan(sum);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  long long warp_base = 0, aggregate = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    warp_base += w < warp ? s_warp[w] : 0;
    aggregate += s_warp[w];
  }

  if (warp == 0) {
    long long before = 0;
    if (tile == 0) {
      if (lane == 0)
        status[0] = kPrefix | static_cast<unsigned long long>(aggregate);
    } else {
      if (lane == 0)
        status[tile] =
            kAggregate | static_cast<unsigned long long>(aggregate);
      for (int base = tile - 1;; base -= 32) {
        const int t = base - lane;
        unsigned long long s = kPrefix;
        do {
          if (t >= 0) s = status[t];
        } while (__any_sync(0xffffffffu, (s >> 62) == 0));
        const unsigned done = __ballot_sync(0xffffffffu, (s >> 62) == 2);
        const int stop = done ? __ffs(done) - 1 : 31;
        long long v = lane <= stop ? static_cast<long long>(s & kValueMask)
                                   : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        before += v;
        if (done) break;
      }
      if (lane == 0)
        status[tile] =
            kPrefix | static_cast<unsigned long long>(before + aggregate);
    }
    if (lane == 0) s_before = before;
  }
  __syncthreads();

  // inclusive ends: row i's end is new_offsets[i + 1].  The scan is done,
  // so s_rows is rewritten with the ends; an end is below 2^31 wherever
  // the caller goes on to copy (srt_gather_chars takes int32 offsets).
  const long long offset = s_before + warp_base + incl - sum;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    s_rows[padded(tid * kItems + k)] = static_cast<int>(offset + run[k]);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    if (i < rows) new_offsets[first + i + 1] = s_rows[padded(i)];
  }
  if (tile == 0 && tid == 0) new_offsets[0] = 0;
  if (first + kTile >= n && tid == 0) *total = s_before + aggregate;
}

// The first i in [0, n] with offs[i] > x (offs nondecreasing, n + 1 long).
__device__ __forceinline__ int upper_bound(const int* __restrict__ offs,
                                           int n, long long x) {
  int lo = 0, hi = n + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// rows[m] = (the row holding stretch m's first byte, one past the row
// holding its last byte below `total`), for m < stretches.
__global__ void __launch_bounds__(kThreads)
stretch_kernel(const int* __restrict__ new_offsets, int n, long long total,
               int stretches, int2* __restrict__ rows) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= stretches) return;
  const long long b0 = (long long)m * kStretch;
  const long long b1 = b0 + kStretch < total ? b0 + kStretch : total;
  rows[m] = make_int2(upper_bound(new_offsets, n, b0) - 1,
                      upper_bound(new_offsets, n, b1 - 1));
}

// Bytes [a, b) of a 64-bit word, a and b clamped to [0, 8].  Written as
// one run of b - a bytes shifted into place, so no shift reaches 64 (the
// form (1 << 8b) - 1 & ~((1 << 8a) - 1) came out all ones on the card
// for a = 0 and b < 8).
__device__ __forceinline__ unsigned long long byte_mask(int a, int b) {
  a = max(0, min(a, 8));
  b = max(0, min(b, 8));
  if (b <= a) return 0;
  return (~0ull >> (64 - 8 * (b - a))) << (8 * a);
}

// ORs into the 16-byte chunk [c0, c1) (lo: bytes 0-7, hi: 8-15) the
// pieces of the staged rows j .. j + kBatch - 1 that fall in it.  All
// the pieces' loads start before any is used.  A piece reads the
// aligned 8-byte words that hold its bytes, at most three, counted from
// the word holding chunk byte 0's source, and is realigned by funnel
// shifts and masked in; a piece whose words would leave the chars buffer
// (at its two ends) is read byte by byte.
__device__ __forceinline__ void place_batch(
    const unsigned char* __restrict__ chars, long long chars_len,
    const int* s_off, const int* s_src, int j, int cnt, long long c0,
    long long c1, unsigned long long& lo, unsigned long long& hi) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(chars);
  unsigned long long w[kBatch][3];
  long long src[kBatch];
  int d0[kBatch], d1[kBatch], k[kBatch];
  bool word[kBatch];
#pragma unroll
  for (int p = 0; p < kBatch; ++p) {
    const int row = j + p;
    d0[p] = d1[p] = k[p] = 0;
    src[p] = 0;
    word[p] = false;
    w[p][0] = w[p][1] = w[p][2] = 0;
    if (row < cnt && s_off[row] < c1) {
      const long long ro = s_off[row];
      const long long from = ro > c0 ? ro : c0;
      const long long to = s_off[row + 1] < c1 ? s_off[row + 1] : c1;
      if (from < to) {
        d0[p] = static_cast<int>(from - c0);
        d1[p] = static_cast<int>(to - c0);
        src[p] = s_src[row] + (from - ro);
        const uintptr_t at = base + static_cast<uintptr_t>(src[p] - d0[p]);
        const uintptr_t aligned = at & ~static_cast<uintptr_t>(7);
        k[p] = static_cast<int>(at - aligned);
        const int i0 = (k[p] + d0[p]) >> 3, i1 = (k[p] + d1[p] - 1) >> 3;
        const long long rel = static_cast<long long>(aligned - base);
        word[p] = rel + 8 * i0 >= 0 && rel + 8 * i1 + 8 <= chars_len;
        if (word[p]) {
          const unsigned long long* wp =
              reinterpret_cast<const unsigned long long*>(aligned);
          if (i0 == 0) w[p][0] = __ldg(wp);
          if (i0 <= 1 && i1 >= 1) w[p][1] = __ldg(wp + 1);
          if (i1 == 2) w[p][2] = __ldg(wp + 2);
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kBatch; ++p) {
    if (word[p]) {
      unsigned long long x_lo = w[p][0], x_hi = w[p][1];
      if (k[p]) {
        const int sh = 8 * k[p];
        x_lo = (w[p][0] >> sh) | (w[p][1] << (64 - sh));
        x_hi = (w[p][1] >> sh) | (w[p][2] << (64 - sh));
      }
      lo |= x_lo & byte_mask(d0[p], d1[p]);
      hi |= x_hi & byte_mask(d0[p] - 8, d1[p] - 8);
    } else {
      for (int d = d0[p]; d < d1[p]; ++d) {
        const unsigned long long b = __ldg(chars + src[p] + (d - d0[p]));
        if (d < 8) lo |= b << (8 * d); else hi |= b << (8 * (d - 8));
      }
    }
  }
}

// One block a stretch of kStretch output bytes; blocks at or past
// `stretches` hold only the zero tail.  out is 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
copy_kernel(const unsigned char* __restrict__ chars, long long chars_len,
            const int* __restrict__ starts,
            const int* __restrict__ new_offsets,
            const int2* __restrict__ rows, int stretches, long long total,
            unsigned char* __restrict__ out, long long out_cap) {
  __shared__ int s_off[kStage + 1];
  __shared__ int s_src[kStage];
  const long long c0 =
      (long long)blockIdx.x * kStretch + (long long)threadIdx.x * kChunk;
  const long long c1 = c0 + kChunk < total ? c0 + kChunk : total;
  unsigned long long lo = 0, hi = 0;
  if (static_cast<int>(blockIdx.x) < stretches) {
    const int2 r = rows[blockIdx.x];
    for (int first = r.x; first < r.y; first += kStage) {
      const int cnt = r.y - first < kStage ? r.y - first : kStage;
      for (int j = threadIdx.x; j < cnt; j += kThreads) {
        s_off[j] = new_offsets[first + j];
        s_src[j] = starts[first + j];
      }
      if (threadIdx.x == 0) s_off[cnt] = new_offsets[first + cnt];
      __syncthreads();
      if (c0 < c1 && s_off[0] < c1 && s_off[cnt] > c0) {
        // the row holding c0 (or the round's first row, if later)
        int a = 0, z = cnt;
        while (a < z) {
          const int mid = (a + z) >> 1;
          if (s_off[mid] <= c0) a = mid + 1; else z = mid;
        }
        for (int j = a > 0 ? a - 1 : 0; j < cnt && s_off[j] < c1;
             j += kBatch)
          place_batch(chars, chars_len, s_off, s_src, j, cnt, c0, c1, lo,
                      hi);
      }
      __syncthreads();
    }
  }
  if (c0 + kChunk <= out_cap) {
    *reinterpret_cast<ulonglong2*>(out + c0) = make_ulonglong2(lo, hi);
  } else {
    for (int d = 0; d < kChunk && c0 + d < out_cap; ++d)
      out[c0 + d] = static_cast<unsigned char>(
          (d < 8 ? lo >> (8 * d) : hi >> (8 * (d - 8))) & 0xff);
  }
}

}  // namespace

// src_offsets: int32[src_rows + 1]; indices: int32[n] source rows; valid:
// bool[n]; new_offsets: int32[n + 1] out; starts: int32[n] out, each
// row's source start (0 for an invalid slot); total: int64[1] out;
// state: 1 + tiles zeroed words (kTile rows a tile), n >= 1.
extern "C" int srt_gather_offsets(const int* src_offsets, int src_rows,
                                  const int* indices,
                                  const unsigned char* valid, int n,
                                  int* new_offsets, int* starts,
                                  long long* total,
                                  unsigned long long* state,
                                  cudaStream_t stream) {
  if (n < 1 || src_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kTile - 1) / kTile;
  offsets_kernel<<<tiles, kThreads, 0, stream>>>(
      src_offsets, src_rows, indices, valid, n, new_offsets, starts, total,
      state);
  return static_cast<int>(cudaGetLastError());
}

// chars: chars_len source bytes; starts, new_offsets: from
// srt_gather_offsets over n >= 1 rows, total = new_offsets[n] in
// [1, out_cap]; stretches: ceil(total / kStretch); rows: int32[2 *
// stretches] scratch; out: out_cap bytes, 16-byte aligned, every one
// written (zero past total).
extern "C" int srt_gather_chars(const unsigned char* chars,
                                long long chars_len, const int* starts,
                                const int* new_offsets, int n,
                                long long total, int stretches, int* rows,
                                unsigned char* out, long long out_cap,
                                cudaStream_t stream) {
  if (n < 1 || total < 1 || total > out_cap || total > 0x7fffffffll ||
      stretches != (total + kStretch - 1) / kStretch)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  stretch_kernel<<<(stretches + kThreads - 1) / kThreads, kThreads, 0,
                   stream>>>(new_offsets, n, total, stretches,
                             reinterpret_cast<int2*>(rows));
  const long long blocks = (out_cap + kStretch - 1) / kStretch;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  copy_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      chars, chars_len, starts, new_offsets,
      reinterpret_cast<const int2*>(rows), stretches, total, out, out_cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kTile; }

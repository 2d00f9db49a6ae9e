// K16: the gather of string spans: new offsets for a row selection, then
// the selected bytes.
//
// Replaces the reference's ops/strings.py gather_strings and
// ops/gather.py gather_spans: new offsets are a cumsum of the selected
// lengths (0 for an invalid slot), and every output byte finds its row
// by a searchsorted over the new offsets (or a scatter-and-cummax fill
// on the TPU), then reads chars[src_start[row] + p - new_start[row]].
// Here two launches:
//
//   1. offsets_kernel: each output row's length (the source row's where
//      valid, else 0) and their exclusive scan, written as offsets
//      int32[n + 1], with the byte total as int64 in `total` (so a total
//      past 2^31 - 1 is seen, never wrapped).  One block a tile of 4,096
//      rows; the tile scans in registers and warp shuffles and finds the
//      sum of the earlier tiles by decoupled look-back, as K7
//      (csrc/expand_ends.cu) does: tiles take their numbers from an
//      atomic counter, publish their own sum, then their inclusive
//      prefix, in one 64-bit word (flag in the top two bits);
//   2. copy_kernel: a warp copies its 32 rows one after another, each
//      row's bytes spread over the 32 lanes (lane j copies bytes j,
//      j + 32, ...), so the stores of a row are coalesced.  Skew: a 1 MB
//      row is copied by its whole warp, 32 KB a lane, and no other warp
//      waits on it (no block-wide barrier).
//
// Bound: device-memory bytes.  Per output row the index (4 B), the valid
// flag (1 B), the source offsets (8 B) read and the new offset (4 B)
// written, and the selected bytes read once and written once, over
// 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kPadded = kTile + kTile / kItems;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;

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
               int* __restrict__ new_offsets, long long* __restrict__ total,
               unsigned long long* state) {
  __shared__ long long s_rows[kPadded];
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

#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    long long len = 0;
    if (i < rows && valid[first + i] && src_rows > 0) {
      int r = indices[first + i];
      r = r < 0 ? 0 : (r >= src_rows ? src_rows - 1 : r);
      len = src_offsets[r + 1] - src_offsets[r];
    }
    s_rows[padded(i)] = len;
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

  // inclusive ends: row i's end is new_offsets[i + 1]
  const long long offset = s_before + warp_base + incl - sum;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    s_rows[padded(tid * kItems + k)] = offset + run[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    if (i < rows)
      new_offsets[first + i + 1] = static_cast<int>(s_rows[padded(i)]);
  }
  if (tile == 0 && tid == 0) new_offsets[0] = 0;
  if (first + kTile >= n && tid == 0) *total = s_before + aggregate;
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const int* __restrict__ src_offsets,
            const unsigned char* __restrict__ chars, int src_rows,
            const int* __restrict__ indices,
            const int* __restrict__ new_offsets, int n,
            unsigned char* __restrict__ out, long long out_cap) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long src = 0, dst = 0;
  int len = 0;
  if (i < n) {
    dst = new_offsets[i];
    len = new_offsets[i + 1] - static_cast<int>(dst);
    if (len > 0) {
      int r = indices[i];
      r = r < 0 ? 0 : (r >= src_rows ? src_rows - 1 : r);
      src = src_offsets[r];
    }
  }
  unsigned todo = __ballot_sync(0xffffffffu, len > 0);
  while (todo) {
    const int owner = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long s = __shfl_sync(0xffffffffu, src, owner);
    const long long d = __shfl_sync(0xffffffffu, dst, owner);
    const int l = __shfl_sync(0xffffffffu, len, owner);
    // bounded by the buffer: a caller's byte total that fell short of the
    // offsets would truncate, never write past the allocation
    const long long l_in =
        d + l <= out_cap ? l : (d < out_cap ? out_cap - d : 0);
    for (int j = lane; j < l_in; j += 32) out[d + j] = __ldg(chars + s + j);
  }
}

}  // namespace

// src_offsets: int32[src_rows + 1]; indices: int32[n] source rows; valid:
// bool[n]; new_offsets: int32[n + 1] out; total: int64[1] out; state:
// 1 + tiles zeroed words (kTile rows a tile), n >= 1.
extern "C" int srt_gather_offsets(const int* src_offsets, int src_rows,
                                  const int* indices,
                                  const unsigned char* valid, int n,
                                  int* new_offsets, long long* total,
                                  unsigned long long* state,
                                  cudaStream_t stream) {
  if (n < 1 || src_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kTile - 1) / kTile;
  offsets_kernel<<<tiles, kThreads, 0, stream>>>(
      src_offsets, src_rows, indices, valid, n, new_offsets, total, state);
  return static_cast<int>(cudaGetLastError());
}

// chars: the source bytes; new_offsets: int32[n + 1] from
// srt_gather_offsets; out: out_cap bytes, new_offsets[n] of them written.
extern "C" int srt_gather_chars(const int* src_offsets,
                                const unsigned char* chars, int src_rows,
                                const int* indices, const int* new_offsets,
                                int n, unsigned char* out, long long out_cap,
                                cudaStream_t stream) {
  if (n < 0 || src_rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || src_rows == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kThreads - 1) / kThreads;
  copy_kernel<<<blocks, kThreads, 0, stream>>>(src_offsets, chars, src_rows,
                                               indices, new_offsets, n, out,
                                               out_cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kTile; }

// K18: the child rows of gathered spans.
//
// Replaces the child branch of the reference's ops/gather.py gather_spans:
// once K16's first launch has written the new offsets of a row selection
// over an ARRAY or MAP column (and each selected row's source start), every
// output child slot p < total finds the row r whose new span holds it
// (new_offsets[r] <= p < new_offsets[r + 1]) and reads its child row
// starts[r] + p - new_offsets[r].  The reference finds r by a searchsorted
// over the new offsets (numpy) or a scatter-and-cummax fill
// (ops/scan.py fill_rows_from_starts, on the TPU).  Slots from total on
// read child row 0 and are out of range.
//
// Bound: device-memory bytes.  4 B written per child slot, and the new
// offsets and starts read once per row that holds a slot (8 B a row), over
// 3.35 TB/s.
//
// Design: merge-path tiles, as K5 expands a join's pairs
// (csrc/join_expand.cu, csrc/merge_path.cuh).  The n row ends
// (new_offsets[r + 1]) and the total slots form one merged sequence of
// n + total items, cut into tiles of kTile items, so a tile's work never
// depends on the spans: a row of 2^24 elements spreads over 8,192 tiles,
// and a run of empty or null rows costs one item a row (a tile of row ends
// alone writes nothing and returns).  The launch is one wave of resident
// blocks, each owning every G-th tile (G blocks):
//   1. each block first finds the diagonals of all its tiles, one thread
//      a diagonal, so every binary search of the call (a chain of about
//      23 dependent reads at qa1's shapes) is in flight at once, and no
//      block waits on one serially before each tile;
//   2. per tile, the block loads its rows' (new offset, start) pairs into
//      shared memory with coalesced reads, every load of a thread in
//      flight together; each row that holds a slot writes its index at
//      its first slot in the tile (a shared atomic max: the row begun
//      before the tile, if any, and the tile's first row that starts
//      there both write the tile's first slot), and a block-wide max scan
//      over the tile's slots gives each slot its row: no search, so no
//      chain of dependent reads or divergent loop per slot (a binary
//      search in shared memory per run of 4 slots took half of the
//      tiles' time at qa1's call).  Consecutive threads write
//      consecutive slots;
//   3. then the blocks write the zero tail [total, out_cap) in 16-byte
//      stores.
// No scratch in device memory: the diagonals stay in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 4;                          // tail slots a store
constexpr int kTile = 2048;                      // merge items a tile
constexpr int kPer = kTile / kThreads;           // a thread's loads, slots
constexpr int kMaxTiles = 512;                   // tiles a block, at most

// Row i's end among the merge items: new_offsets[i + 1].
struct RowEnd {
  const int* offs;
  __device__ __forceinline__ long long operator()(long long i) const {
    return __ldg(offs + i + 1);
  }
};

// The inclusive max of v over the block's threads before and at this one.
__device__ __forceinline__ int block_max_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = max(v, y);
  }
  if (lane == 31) s_warp[w] = v;
  __syncthreads();
  for (int q = 0; q < w; ++q) v = max(v, s_warp[q]);
  return v;
}

__global__ void __launch_bounds__(kThreads)
span_rows_kernel(const int* __restrict__ starts,
                 const int* __restrict__ new_offsets, int n, int total,
                 int* __restrict__ out, long long out_cap, int tiles) {
  __shared__ int s_off[kTile + 1];   // s_off[l] = new_offsets[i0 + l]
  __shared__ int s_src[kTile + 1];   // s_src[l] = starts[i0 + l]
  __shared__ int s_row[kTile];       // the row (less i0) of each slot
  __shared__ int s_split[2 * kMaxTiles];
  __shared__ int s_warp[kThreads / 32];
  const int tid = threadIdx.x;
  const int grid = gridDim.x;
  const int mine = (tiles - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  const long long items = (long long)n + total;
  // 1. the rows before each owned tile's first and last diagonal
  for (int j = tid; j < 2 * mine; j += kThreads) {
    long long d = ((long long)blockIdx.x + (long long)(j >> 1) * grid +
                   (j & 1)) * kTile;
    if (d > items) d = items;
    s_split[j] = static_cast<int>(
        srt::merge_path_rows(RowEnd{new_offsets}, n, total, d));
  }
  __syncthreads();
  // 2. the tiles
  for (int q = 0; q < mine; ++q) {
    const long long d0 = ((long long)blockIdx.x + (long long)q * grid) *
                         kTile;
    const long long d1 = d0 + kTile < items ? d0 + kTile : items;
    const int i0 = s_split[2 * q], i1 = s_split[2 * q + 1];
    const long long j0 = d0 - i0;                // the tile's slots
    const int slots = static_cast<int>(d1 - i1 - j0);
    if (slots <= 0) continue;                    // row ends only
    // rows i0 .. i1: the slots after the tile's last row end (if any)
    // belong to row i1 < n
    const int nrows = i1 - i0;
    int off[kPer + 1], src[kPer + 1];
#pragma unroll
    for (int u = 0; u <= kPer; ++u) {
      const int l = u * kThreads + tid;
      off[u] = l <= nrows ? __ldg(new_offsets + i0 + l) : 0;
      src[u] = l <= nrows && i0 + l < n ? __ldg(starts + i0 + l) : 0;
    }
#pragma unroll
    for (int u = 0; u <= kPer; ++u) {
      const int l = u * kThreads + tid;
      if (l <= nrows) {
        s_off[l] = off[u];
        s_src[l] = src[u];
      }
      if (u < kPer) s_row[u * kThreads + tid] = -1;
    }
    __syncthreads();
    // each row that holds a slot at its first slot in the tile (a row
    // that began before the tile: the tile's first); empty rows write
    // nothing, so a run of them costs no atomic on one address
#pragma unroll
    for (int u = 0; u <= kPer; ++u) {
      const int l = u * kThreads + tid;
      if (l <= nrows && (l == nrows || s_off[l + 1] > off[u])) {
        const long long at = off[u] - j0 > 0 ? off[u] - j0 : 0;
        if (at < slots) atomicMax(&s_row[at], l);
      }
    }
    __syncthreads();
    int r = -1;
#pragma unroll
    for (int e = 0; e < kPer; ++e) r = max(r, s_row[tid * kPer + e]);
    const int before = block_max_scan(r, s_warp);
    r = __shfl_up_sync(0xffffffffu, before, 1);
    if ((tid & 31) == 0) r = -1;
    for (int q2 = 0; q2 < (tid >> 5); ++q2) r = max(r, s_warp[q2]);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int at = tid * kPer + e;
      r = max(r, s_row[at]);
      s_row[at] = r;
    }
    __syncthreads();
    // consecutive threads, consecutive slots: each store of a warp fills
    // 128 bytes
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int at = u * kThreads + tid;
      if (at < slots) {
        const int row = s_row[at];
        out[j0 + at] = s_src[row] + static_cast<int>(j0 + at - s_off[row]);
      }
    }
    __syncthreads();
  }
  // 3. the zero tail, 4 slots a thread
  const long long groups = (out_cap + kRun - 1) / kRun;
  for (long long g = total / kRun + (long long)blockIdx.x * kThreads + tid;
       g < groups; g += (long long)grid * kThreads) {
    const long long a = g * kRun;
    if (a >= total && a + kRun <= out_cap) {
      *reinterpret_cast<int4*>(out + a) = make_int4(0, 0, 0, 0);
    } else {
      for (int k = 0; k < kRun; ++k)
        if (a + k >= total && a + k < out_cap) out[a + k] = 0;
    }
  }
}

// Resident blocks of span_rows_kernel on the current device, once.
int resident_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, span_rows_kernel, kThreads, 0) != cudaSuccess ||
        sms * per_sm < 1)
      return 0;
    blocks = sms * per_sm;
  }
  return blocks;
}

}  // namespace

// starts: int32[n] each selected row's source start; new_offsets:
// int32[n + 1], new_offsets[n] = total, n >= 1; out: int32[out_cap],
// 16-byte aligned, total <= out_cap; every slot written (0 from total on).
extern "C" int srt_span_rows(const int* starts, const int* new_offsets,
                             int n, int total, int* out, long long out_cap,
                             cudaStream_t stream) {
  if (n < 1 || total < 0 || total > out_cap || out_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long tiles = ((long long)n + total + kTile - 1) / kTile;
  const long long tail = (out_cap - total + kRun) / kRun;
  const int resident = resident_blocks();
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // one wave of resident blocks, but at most kMaxTiles tiles a block, and
  // at least a block a tile or a thread a 16-byte store of the tail
  long long grid = tiles > tail / kThreads ? tiles : tail / kThreads;
  if (grid > resident) grid = resident;
  if (grid < (tiles + kMaxTiles - 1) / kMaxTiles)
    grid = (tiles + kMaxTiles - 1) / kMaxTiles;
  if (grid < 1) grid = 1;
  if (grid > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  span_rows_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      starts, new_offsets, n, total, out, out_cap, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kTile; }

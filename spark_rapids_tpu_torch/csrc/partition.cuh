// Stable counting partition of rows into B buckets, shared by the
// compaction (K1, B = 2) and segment-start (K3, B = 2) kernels.
//
// Three launches, each over tiles of kTile consecutive rows:
//   1. tile_counts_kernel: rows of each bucket per tile, by warp ballots;
//   2. scan_kernel: one block scans the counts in bucket-major order, so
//      offsets[b * tiles + t] is where tile t's rows of bucket b start;
//   3. tile_scatter_kernel: each tile walks its rows in order, ranks each
//      row inside its bucket with ballots, and hands (row, destination,
//      bucket) to a writer.
// Rows of a bucket keep their input order, which is what makes the
// compaction stable.
//
// The work is bound by device-memory bytes: each pass reads the bucket
// source twice (count, scatter) and moves each lane once.  Ballots keep
// ranking in registers and shared memory; no atomics touch device memory.

#pragma once

#include <cuda_runtime.h>

namespace srt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // rows per tile
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;

inline int num_tiles(int n) { return (n + kTile - 1) / kTile; }

// counts[b * tiles + t] = rows of tile t whose bucket is b.
template <int B, class Digit>
__global__ void __launch_bounds__(kThreads)
tile_counts_kernel(Digit digit, int n, int tiles, int* counts) {
  __shared__ int s_cnt[B];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < B) s_cnt[tid] = 0;
  __syncthreads();
  int warp_cnt[B];
#pragma unroll
  for (int b = 0; b < B; ++b) warp_cnt[b] = 0;
  const long long base = (long long)blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + (long long)r * kThreads + tid;
    const int d = (i < n) ? digit(i) : B;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      warp_cnt[b] += __popc(__ballot_sync(0xffffffffu, d == b));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      if (warp_cnt[b]) atomicAdd(&s_cnt[b], warp_cnt[b]);
    }
  }
  __syncthreads();
  if (tid < B) counts[tid * tiles + blockIdx.x] = s_cnt[tid];
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// Exclusive scan of counts[0, m) into offsets; *total gets the sum.
// One block of kScanThreads threads.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* counts, int m, int* offsets, int* total) {
  __shared__ int s_warp[kScanThreads / 32 + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  int carry = 0;
  for (int start = 0; start < m; start += kScanThreads * kScanItems) {
    const int first = start + tid * kScanItems;
    int v[kScanItems];
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      v[k] = (first + k < m) ? counts[first + k] : 0;
      sum += v[k];
    }
    const int incl = warp_inclusive_scan(sum);
    if (lane == 31) s_warp[w] = incl;
    __syncthreads();
    if (w == 0) {
      const int x = s_warp[lane];
      const int xi = warp_inclusive_scan(x);
      s_warp[lane] = xi - x;
      if (lane == 31) s_warp[32] = xi;
    }
    __syncthreads();
    int run = carry + s_warp[w] + incl - sum;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (first + k < m) offsets[first + k] = run;
      run += v[k];
    }
    carry += s_warp[32];
    __syncthreads();
  }
  if (tid == 0 && total != nullptr) *total = carry;
}

// Hands every row of [0, n) to writer(row, destination, bucket).
template <int B, class Digit, class Writer>
__global__ void __launch_bounds__(kThreads)
tile_scatter_kernel(Digit digit, Writer writer, int n, int tiles,
                    const int* offsets) {
  __shared__ int s_base[B];
  __shared__ int s_warp[kWarps][B];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  if (tid < B) s_base[tid] = offsets[tid * tiles + blockIdx.x];
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + (long long)r * kThreads + tid;
    const int d = (i < n) ? digit(i) : B;
    int rank = 0;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const unsigned m = __ballot_sync(0xffffffffu, d == b);
      if (d == b) rank = __popc(m & lower);
      if (lane == 0) s_warp[w][b] = __popc(m);
    }
    __syncthreads();
    if (tid < B) {
      int run = s_base[tid];
      for (int k = 0; k < kWarps; ++k) {
        const int c = s_warp[k][tid];
        s_warp[k][tid] = run;
        run += c;
      }
      s_base[tid] = run;
    }
    __syncthreads();
    if (d < B) writer(i, s_warp[w][d] + rank, d);
    __syncthreads();
  }
}

// Runs the three launches; offsets gets B * tiles entries.
template <int B, class Digit, class Writer>
cudaError_t partition(Digit digit, Writer writer, int n, int* counts,
                      int* offsets, cudaStream_t stream) {
  const int tiles = num_tiles(n);
  if (tiles == 0) return cudaSuccess;
  tile_counts_kernel<B, Digit><<<tiles, kThreads, 0, stream>>>(
      digit, n, tiles, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_kernel<<<1, kScanThreads, 0, stream>>>(counts, B * tiles, offsets,
                                              nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tile_scatter_kernel<B, Digit, Writer><<<tiles, kThreads, 0, stream>>>(
      digit, writer, n, tiles, offsets);
  return cudaGetLastError();
}

// Row lanes moved by a partition: lane k copies in[k][row] to
// out[k][destination]; with clear_back[k] set, rows of bucket != 0 land
// as zero (the compaction's validity lanes).
constexpr int kMaxLanes = 16;

struct Lanes {
  const void* in[kMaxLanes];
  void* out[kMaxLanes];
  int bytes[kMaxLanes];
  int clear_back[kMaxLanes];
  int count;
};

struct LaneWriter {
  Lanes lanes;
  __device__ void operator()(long long i, int dest, int d) const {
#pragma unroll
    for (int k = 0; k < kMaxLanes; ++k) {
      if (k >= lanes.count) break;
      const bool zero = lanes.clear_back[k] && d != 0;
      switch (lanes.bytes[k]) {
        case 8: {
          const long long v = static_cast<const long long*>(lanes.in[k])[i];
          static_cast<long long*>(lanes.out[k])[dest] = zero ? 0ll : v;
          break;
        }
        case 4: {
          const int v = static_cast<const int*>(lanes.in[k])[i];
          static_cast<int*>(lanes.out[k])[dest] = zero ? 0 : v;
          break;
        }
        case 2: {
          const short v = static_cast<const short*>(lanes.in[k])[i];
          static_cast<short*>(lanes.out[k])[dest] = zero ? (short)0 : v;
          break;
        }
        default: {
          const unsigned char v =
              static_cast<const unsigned char*>(lanes.in[k])[i];
          static_cast<unsigned char*>(lanes.out[k])[dest] =
              zero ? (unsigned char)0 : v;
          break;
        }
      }
    }
  }
};

// Fills a Lanes struct from host arrays; returns false past kMaxLanes or
// for a lane width other than 1, 2, 4 or 8 bytes.
inline bool make_lanes(int count, const void* const* in, void* const* out,
                       const int* bytes, const int* clear_back, Lanes* l) {
  if (count < 0 || count > kMaxLanes) return false;
  l->count = count;
  for (int k = 0; k < count; ++k) {
    if (bytes[k] != 1 && bytes[k] != 2 && bytes[k] != 4 && bytes[k] != 8)
      return false;
    l->in[k] = in[k];
    l->out[k] = out[k];
    l->bytes[k] = bytes[k];
    l->clear_back[k] = clear_back ? clear_back[k] : 0;
  }
  return true;
}

}  // namespace srt

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return srt::kTile; }

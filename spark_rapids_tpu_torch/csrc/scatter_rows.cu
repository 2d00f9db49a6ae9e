// K13: scatter of row lanes back through a row order, the dual of K8.
//
// Replaces the reference's spark_rapids_tpu/exec/window.py:517-522, where
// the window results ride a second carry-sort (ops/carry.py sort_lanes)
// keyed by the layout sort's order to get back to input order.  The
// inverse permutation is the same function: out[l][order[i]] = in[l][i]
// for up to kMaxLanes lanes of 1, 2, 4 or 8 bytes a launch.
//
// Bound: device-memory bytes.  Least traffic is the order (4 B a row)
// read once, and every lane read once and written once, over 3.35 TB/s.
// What holds a single pass (one thread a row and a lane, writing
// out[order[i]] at random) far below that: every write is a partial
// 32-byte sector, 4x the bytes of an 8-byte lane and 32x a bool's, and a
// read-modify-write in device memory once the output outgrows the 50 MB
// L2.
//
// This design bins by destination first.  `order` is a permutation, so
// bucket b of destinations [b << shift, (b + 1) << shift) receives
// exactly that many rows: its place in the binned array is known before
// any pass, and no histogram is needed.  Two kernels:
//
//   1. bin_kernel, one block a tile of 3,072 rows: each row's bucket is
//      the top 8 bits of its destination (shift chosen by the host so
//      there are at most 256); rows are ranked inside the tile by warp
//      ballots over the 8-bit digit, as K2's one-sweep pass ranks
//      (csrc/onesweep.cu), the tile claims a run of each bucket with one
//      atomic on that bucket's cursor (the order inside a bucket does not
//      matter: destinations are distinct), and (destination, every lane)
//      leave through shared memory in bucket order, so the writes come in
//      runs of about 12 rows, and the runs of the tiles in flight sit
//      next to each other;
//   2. place_kernel, one thread a binned row, blocks in bucket order:
//      reads the binned destination and lanes (coalesced) and writes
//      out[l][dest].  The blocks in flight write into the windows of one
//      or two buckets (at 2^25 rows a bucket is 131,072 destinations,
//      1.7 MB over q4's three lanes), which stay in L2, so the partial
//      sectors merge there before they are written back.
//
// Device-memory traffic: about 2 x (4 + lane bytes) + 2 x lane bytes a
// row (64 B at q4's 13 B of lanes) against 4 + 2 x 13 = 30 B for the
// single pass, but every pass streams whole sectors.  Scratch: the
// binned copy, (4 + lane bytes) a row, allocated by the caller.  Outputs
// of up to 48 MiB keep the single pass (single_kernel): their partial
// sectors already merge in the 50 MB L2, and the second pass would cost
// more than it saves (chip_smoke.py times both around that size).  The
// host chooses (ops/gather.py scatter_plan).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 16;
constexpr int kBuckets = 256;
constexpr int kItems = 12;
constexpr int kTile = kThreads * kItems;  // rows a bin_kernel tile
static_assert(kThreads == kBuckets, "a thread owns a bucket");

struct Lanes {
  const void* in[kMaxLanes];
  void* out[kMaxLanes];
  int bytes[kMaxLanes];
};

__device__ __forceinline__ unsigned long long load_lane(const void* p, int b,
                                                        long long i) {
  switch (b) {
    case 8: return __ldg(static_cast<const unsigned long long*>(p) + i);
    case 4: return __ldg(static_cast<const unsigned int*>(p) + i);
    case 2: return __ldg(static_cast<const unsigned short*>(p) + i);
    default: return __ldg(static_cast<const unsigned char*>(p) + i);
  }
}

__device__ __forceinline__ void store_lane(void* p, int b, long long i,
                                           unsigned long long v) {
  switch (b) {
    case 8: static_cast<unsigned long long*>(p)[i] = v; break;
    case 4: static_cast<unsigned int*>(p)[i] = static_cast<unsigned>(v);
      break;
    case 2: static_cast<unsigned short*>(p)[i] =
        static_cast<unsigned short>(v);
      break;
    default: static_cast<unsigned char*>(p)[i] =
        static_cast<unsigned char>(v);
  }
}

// One thread a row and a lane, blockIdx.y the lane, as in K8.
__global__ void __launch_bounds__(kThreads)
single_kernel(const int* __restrict__ order, int n, Lanes lanes) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int k = blockIdx.y;
  store_lane(lanes.out[k], lanes.bytes[k], __ldg(order + i),
             load_lane(lanes.in[k], lanes.bytes[k], i));
}

// The lanes of `active` whose digit equals this lane's, by eight ballots.
__device__ __forceinline__ unsigned peers_of(unsigned d, unsigned active) {
  unsigned peers = active;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned bit = (d >> b) & 1u;
    const unsigned vote = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? vote : ~vote;
  }
  return peers;
}

// lanes.in: the rows' lanes; lanes.out: the binned lanes (n each);
// cursor: int32[256] zero on entry; binned_dest: int32[n] out.
__global__ void __launch_bounds__(kThreads)
bin_kernel(const int* __restrict__ order, int n, int shift, Lanes lanes,
           int nlanes, int* cursor, int* __restrict__ binned_dest) {
  __shared__ int s_dest[kTile];
  __shared__ unsigned long long s_val[kTile];
  __shared__ int s_count[kBuckets];   // the tile's rows a bucket
  __shared__ int s_start[kBuckets];   // their first slot in the tile
  __shared__ int s_base[kBuckets];    // their first binned position
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long first = (long long)blockIdx.x * kTile;
  const int rows =
      static_cast<int>(n - first < kTile ? n - first : (long long)kTile);
  s_count[tid] = 0;
  __syncthreads();

  // rank inside the tile: a warp's rows of one bucket take consecutive
  // ranks from one shared-memory atomic
  const unsigned lower = (1u << lane) - 1u;
  int dest[kItems], slot[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    dest[k] = i < rows ? __ldg(order + first + i) : 0;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool ok = k * kThreads + tid < rows;
    const unsigned active = __ballot_sync(0xffffffffu, ok);
    slot[k] = -1;
    if (active == 0) continue;  // the same for the whole warp
    const unsigned b = ok ? static_cast<unsigned>(dest[k]) >> shift : 0u;
    const unsigned peers = peers_of(b, active);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (ok && lane == leader) base = atomicAdd(&s_count[b], __popc(peers));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (ok) slot[k] = base + __popc(peers & lower);
  }
  __syncthreads();

  // thread b owns bucket b: its start in the tile and its binned run
  const int c = s_count[tid];
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  if (c > 0) s_base[tid] = (tid << shift) + atomicAdd(&cursor[tid], c);
  __syncthreads();
  int warp_base = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_base += w < warp ? s_warp[w] : 0;
  s_start[tid] = warp_base + incl - c;
  __syncthreads();

  // slots in bucket order: each row's destination, then its place
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (slot[k] >= 0) {
      slot[k] += s_start[static_cast<unsigned>(dest[k]) >> shift];
      s_dest[slot[k]] = dest[k];
    }
  }
  __syncthreads();
  int at[kItems];  // binned position of tile slot k * kThreads + tid
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int j = k * kThreads + tid;
    at[k] = -1;
    if (j < rows) {
      const int d = s_dest[j];
      const int b = static_cast<int>(static_cast<unsigned>(d) >> shift);
      at[k] = s_base[b] + (j - s_start[b]);
      binned_dest[at[k]] = d;
    }
  }
  for (int l = 0; l < nlanes; ++l) {
    const int bytes = lanes.bytes[l];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (slot[k] >= 0)
        s_val[slot[k]] =
            load_lane(lanes.in[l], bytes, first + k * kThreads + tid);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (at[k] >= 0)
        store_lane(lanes.out[l], bytes, at[k], s_val[k * kThreads + tid]);
    }
    __syncthreads();
  }
}

// lanes.in: the binned lanes; lanes.out: the results.
__global__ void __launch_bounds__(kThreads)
place_kernel(const int* __restrict__ binned_dest, int n, Lanes lanes,
             int nlanes) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int d = __ldg(binned_dest + i);
  for (int l = 0; l < nlanes; ++l)
    store_lane(lanes.out[l], lanes.bytes[l], d,
               load_lane(lanes.in[l], lanes.bytes[l], i));
}

}  // namespace

// order: int32[n], a permutation of 0..n-1; in / out / bytes: host arrays
// of nlanes (<= 16) lanes of n elements each.  binned_dest null: the
// single pass.  Otherwise the binned path: shift such that
// (n - 1) >> shift < 256; cursor: int32[256] zeroed; binned_dest:
// int32[n] and binned: nlanes lanes of n elements, the lanes' widths,
// scratch.
extern "C" int srt_scatter_rows(const int* order, int n, int nlanes,
                                const void* const* in, void* const* out,
                                const int* bytes, int shift, int* cursor,
                                int* binned_dest, void* const* binned,
                                cudaStream_t stream) {
  if (n < 0 || nlanes < 1 || nlanes > kMaxLanes || shift < 0 || shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  Lanes lanes;
  for (int k = 0; k < nlanes; ++k) {
    if (bytes[k] != 1 && bytes[k] != 2 && bytes[k] != 4 && bytes[k] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    lanes.in[k] = in[k];
    lanes.out[k] = out[k];
    lanes.bytes[k] = bytes[k];
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (binned_dest == nullptr) {
    const dim3 grid((n + kThreads - 1) / kThreads, nlanes);
    single_kernel<<<grid, kThreads, 0, stream>>>(order, n, lanes);
    return static_cast<int>(cudaGetLastError());
  }
  if (((n - 1) >> shift) >= kBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  Lanes to_bins = lanes, from_bins = lanes;
  for (int k = 0; k < nlanes; ++k) {
    to_bins.out[k] = binned[k];
    from_bins.in[k] = binned[k];
  }
  bin_kernel<<<(n + kTile - 1) / kTile, kThreads, 0, stream>>>(
      order, n, shift, to_bins, nlanes, cursor, binned_dest);
  place_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      binned_dest, n, from_bins, nlanes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kTile; }

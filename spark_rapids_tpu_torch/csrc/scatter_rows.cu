// K13: scatter of row lanes back through a row order, the dual of K8.
//
// Replaces the reference's spark_rapids_tpu/exec/window.py:517-522, where
// the window results ride a second carry-sort (ops/carry.py sort_lanes)
// keyed by the layout sort's order to get back to input order.  The
// inverse permutation is the same function in one pass:
// out[l][order[i]] = in[l][i] for up to kMaxLanes lanes of 1, 4 or 8
// bytes a launch.
//
// Bound: device-memory bytes.  Least traffic is the order (4 B a row)
// read once, and every lane read once and written once, over 3.35 TB/s.
// One thread a row and a lane, blockIdx.y the lane, as in K8: the blocks
// in flight write one lane's array at a time, so its random writes stay
// within one array's pages.  Reads of the order and the lane are
// coalesced; each write is a partial 32-byte sector on an unsorted
// order.  `order` is a permutation, so no two threads write one element.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 16;

struct Lanes {
  const void* in[kMaxLanes];
  void* out[kMaxLanes];
  int bytes[kMaxLanes];
};

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ order, int n, Lanes lanes) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int k = blockIdx.y;
  const long long dst = __ldg(order + i);
  switch (lanes.bytes[k]) {
    case 8:
      static_cast<unsigned long long*>(lanes.out[k])[dst] =
          __ldg(static_cast<const unsigned long long*>(lanes.in[k]) + i);
      break;
    case 4:
      static_cast<unsigned int*>(lanes.out[k])[dst] =
          __ldg(static_cast<const unsigned int*>(lanes.in[k]) + i);
      break;
    default:
      static_cast<unsigned char*>(lanes.out[k])[dst] =
          __ldg(static_cast<const unsigned char*>(lanes.in[k]) + i);
      break;
  }
}

}  // namespace

// order: int32[n], a permutation of 0..n-1; in / out / bytes: host arrays
// of nlanes (<= 16) lanes of n elements each.
extern "C" int srt_scatter_rows(const int* order, int n, int nlanes,
                                const void* const* in, void* const* out,
                                const int* bytes, cudaStream_t stream) {
  if (n < 0 || nlanes < 1 || nlanes > kMaxLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  Lanes lanes;
  for (int k = 0; k < nlanes; ++k) {
    if (bytes[k] != 1 && bytes[k] != 4 && bytes[k] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    lanes.in[k] = in[k];
    lanes.out[k] = out[k];
    lanes.bytes[k] = bytes[k];
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kThreads - 1) / kThreads, nlanes);
  scatter_kernel<<<grid, kThreads, 0, stream>>>(order, n, lanes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

// K8: gather of a batch's row lanes through a row order.
//
// Replaces the payload half of the reference's ops/carry.py sort_rows /
// sort_lanes, where lax.sort carries every payload lane through the
// sort's comparator network (chosen there because the TPU's gathers
// were slow).  On the card the sort (K2) returns the row order and this
// kernel moves the lanes: out[l][i] = in[l][order[i]] for up to
// kMaxLanes lanes of 1, 4 or 8 bytes a launch.
//
// Bound: device-memory bytes.  Least traffic is the order (4 B a row)
// read once, and every lane read once and written once, over 3.35 TB/s.
// One thread a row and a lane: blockIdx.y is the lane, so the blocks in
// flight (the grid runs x first) read one lane's rows at a time and its
// random reads stay within one array's pages; the order is read again
// for every lane.  With all lanes of a row in one thread, every lane's
// array is read at random at once, and the gather was slower on the
// H100 (PERF.md).  Writes are coalesced; each read is one 32-byte sector
// on an unsorted order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 16;

struct Lanes {
  const void* in[kMaxLanes];
  void* out[kMaxLanes];
  int bytes[kMaxLanes];
  int count;
};

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ order, int n, Lanes lanes) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int k = blockIdx.y;
  const long long src = order[i];
  switch (lanes.bytes[k]) {
    case 8:
      static_cast<unsigned long long*>(lanes.out[k])[i] =
          __ldg(static_cast<const unsigned long long*>(lanes.in[k]) + src);
      break;
    case 4:
      static_cast<unsigned int*>(lanes.out[k])[i] =
          __ldg(static_cast<const unsigned int*>(lanes.in[k]) + src);
      break;
    default:
      static_cast<unsigned char*>(lanes.out[k])[i] =
          __ldg(static_cast<const unsigned char*>(lanes.in[k]) + src);
      break;
  }
}

}  // namespace

// order: int32[n], each entry a row of every input lane; in / out /
// bytes: host arrays of nlanes (<= 16) lanes, out lanes hold n elements.
extern "C" int srt_gather_rows(const int* order, int n, int nlanes,
                               const void* const* in, void* const* out,
                               const int* bytes, cudaStream_t stream) {
  if (n < 0 || nlanes < 1 || nlanes > kMaxLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  Lanes lanes;
  lanes.count = nlanes;
  for (int k = 0; k < nlanes; ++k) {
    if (bytes[k] != 1 && bytes[k] != 4 && bytes[k] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    lanes.in[k] = in[k];
    lanes.out[k] = out[k];
    lanes.bytes[k] = bytes[k];
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kThreads - 1) / kThreads, nlanes);
  gather_kernel<<<grid, kThreads, 0, stream>>>(order, n, lanes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

// K4: the probe of the equi-join.  For every probe row, the range of
// equal hashes in the build side's combined key hashes, sorted in
// ascending unsigned order by K2.
//
// Replaces the reference's ops/join_kernels.py count_matches after its
// sort: the numpy branch's two searchsorted calls (the jnp branch's one
// combined sort over build and probe rows stands in for them on the TPU,
// whose gathers were slow).
//
// One thread per probe row: a binary search gives the lower bound of its
// hash, written for every row, live or not; for a live row a galloping
// search from there (steps 1, 2, 4, ... until a larger hash, then a
// binary search inside the last step) gives the upper bound, so a key
// that matches once costs two reads past the lower bound, and a hot key
// with c copies 2 log2(c).  A dead row's count is 0.
//
// Bound: device-memory bytes.  Least traffic is the probe hash (8 B) and
// live flag (1 B) read and lo (4 B) and count (8 B) written per probe
// row, and the sorted hashes (8 B per build row) read once, over 3.35
// TB/s.  The sorted hashes of a 100,000-row build side (800 KB) stay in
// L2; the top levels of every search are the same few addresses for all
// threads and stay in L1.  A shared-memory or hash-table probe is later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// First index in [lo, hi) whose hash is not below h, else hi.
__device__ __forceinline__ int lower_bound(const unsigned long long* s,
                                           int lo, int hi,
                                           unsigned long long h) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(s + mid) < h) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// First index in [lo, hi) whose hash is above h, else hi.
__device__ __forceinline__ int upper_bound(const unsigned long long* s,
                                           int lo, int hi,
                                           unsigned long long h) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(s + mid) <= h) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const unsigned long long* __restrict__ sorted, int nb,
             const unsigned long long* __restrict__ probe,
             const unsigned char* __restrict__ live, int np,
             int* __restrict__ lo_out, long long* __restrict__ counts) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= np) return;
  const unsigned long long h = probe[i];
  const int lo = lower_bound(sorted, 0, nb, h);
  long long count = 0;
  if (live[i] && lo < nb && __ldg(sorted + lo) == h) {
    // gallop: double the step while sorted[lo + step] still holds h;
    // the upper bound then lies in [below, top]
    int step = 1;
    int below = lo + 1;       // every index before `below` holds h
    while (lo + step < nb && __ldg(sorted + lo + step) <= h) {
      below = lo + step + 1;
      step <<= 1;
    }
    const int top = lo + step < nb ? lo + step : nb;
    count = upper_bound(sorted, below, top, h) - lo;
  }
  lo_out[i] = lo;
  counts[i] = count;
}

}  // namespace

// sorted: nb hashes in ascending unsigned order; probe: np hashes;
// live: bool[np]; lo: int[np] and counts: long long[np] out.
extern "C" int srt_join_probe(const unsigned long long* sorted, int nb,
                              const unsigned long long* probe,
                              const unsigned char* live, int np, int* lo,
                              long long* counts, cudaStream_t stream) {
  // the gallop's lo + step stays below 2 nb
  if (nb < 0 || nb >= (1 << 30) || np < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (np == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (np + kThreads - 1) / kThreads;
  probe_kernel<<<blocks, kThreads, 0, stream>>>(sorted, nb, probe, live, np,
                                                lo, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

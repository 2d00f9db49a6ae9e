// K7: the join's effective match counts and their running sums, the input
// of the pair expansion (K5).
//
// Replaces the reference's ops/join_kernels.py expand_pairs lines that
// compute eff_counts and offs (a maximum, a where and cumsum_fast).  One
// pass over the probe side: each row's effective count is its matches,
// at least 1 for a left or full join (the null-extended row), 0 for a
// dead row; `ends` is their inclusive running sum and `total` its last
// element, written to a one-element device array so that the host reads
// it once, after the launch.
//
// One block a tile of 4,096 rows (256 threads x 16).  The tile is loaded
// coalesced into shared memory, each thread sums 16 consecutive rows in
// registers, the block scans the thread sums with warp shuffles, and the
// tile finds the sum of every earlier tile by decoupled look-back, as
// K2's one-sweep pass does (csrc/onesweep.cu): tiles take their numbers
// from an atomic counter, so they start in order; each publishes its own
// sum, then its inclusive prefix once it knows it.  Here one warp reads
// 32 earlier tiles' states at a time.  A state is one 64-bit word, the
// flag in the top two bits and the value below, so a reader never sees a
// flag without its value; values stay below 2^62 (at most 2^31 rows of
// at most 2^31 matches).  The scanned tile goes back through shared
// memory, so the stores are coalesced too.
//
// Bound: device-memory bytes.  Per probe row the count (8 B) and the live
// flag (1 B) are read and the end (8 B) written, over 3.35 TB/s; the
// look-back state is 8 B a tile.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kPadded = kTile + kTile / kItems;  // one pad word per 16
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
constexpr unsigned long long kAggregate = 1ull << 62;  // the tile's own sum
constexpr unsigned long long kPrefix = 2ull << 62;     // inclusive prefix

// Row i of the tile in shared memory: a thread's 16 consecutive rows land
// in distinct banks for each half-warp.
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

// state: one word per tile and a tile counter (word 0), all zero on entry.
__global__ void __launch_bounds__(kThreads)
ends_kernel(const long long* __restrict__ counts,
            const unsigned char* __restrict__ live, int n, int outer,
            long long* __restrict__ ends, long long* __restrict__ total,
            unsigned long long* state) {
  __shared__ long long s_rows[kPadded];
  __shared__ long long s_warp[kWarps];
  __shared__ long long s_before;
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0)
    s_tile = static_cast<int>(atomicAdd(state, 1ull));
  __syncthreads();
  const int tile = s_tile;
  volatile unsigned long long* status = state + 1;
  const long long first = (long long)tile * kTile;
  const int rows =
      static_cast<int>(n - first < kTile ? n - first : (long long)kTile);

#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    long long e = 0;
    if (i < rows) {
      // both loads issued together: the count is read whether or not the
      // row is live
      const long long c = counts[first + i];
      e = live[first + i] ? (outer && c < 1 ? 1 : c) : 0;
    }
    s_rows[padded(i)] = e;
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
      // look back 32 tiles at a time, nearest first, until one that has
      // published its inclusive prefix (tile 0 always does)
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

  const long long offset = s_before + warp_base + incl - sum;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    s_rows[padded(tid * kItems + k)] = offset + run[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = k * kThreads + tid;
    if (i < rows) ends[first + i] = s_rows[padded(i)];
  }
  if (first + kTile >= n && tid == 0) *total = s_before + aggregate;
}

}  // namespace

// counts: long long[n] matches per probe row; live: bool[n]; outer: 1 for
// a left or full join; ends: long long[n] out; total: long long[1] out;
// state: 1 + tiles zeroed words (kTile rows a tile), n >= 1.
extern "C" int srt_expand_ends(const long long* counts,
                               const unsigned char* live, int n, int outer,
                               long long* ends, long long* total,
                               unsigned long long* state,
                               cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kTile - 1) / kTile;
  ends_kernel<<<tiles, kThreads, 0, stream>>>(counts, live, n, outer, ends,
                                              total, state);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kTile; }

// K5: the equi-join's pair expansion, fused with the row gathers of both
// sides.
//
// Replaces the reference's ops/join_kernels.py expand_pairs together
// with the gather_column calls of exec/join.py HashJoinExec._expand (the
// jnp branch fills rows from span starts with a running max instead of a
// search, a TPU workaround; the numpy branch's searchsorted states the
// semantics).
//
// Work is fixed per output position, whatever the skew: one thread per
// position p < out_cap.  Its probe row is the first row whose running
// match count `ends[row]` exceeds p (clamped to the last row), it is the
// row's k-th pair, k = p - ends[row - 1], and its build row is
// order[lo[row] + min(k, max(counts[row] - 1, 0))] (the position clamped
// into the build side).  So a hot key's pairs spread over as many threads
// as it has pairs.  Thread 0 of each block of 256 positions finds the
// rows of the block's first and last position, and every thread then
// searches only between them.
//
// With no probe rows (np == 0, so total == 0) every position is padding:
// both indices 0, every lane invalid and zero.
//
// Each column is written as data and validity together: probe columns at
// `row`, valid where the source row is and p < total; build columns at the
// build row, valid where besides counts[row] > 0 (the null-extended row of
// a left or full join has none); data is zero where invalid.  The pair
// indices (probe row, build row) are written too.
//
// Bound: device-memory bytes.  Least traffic is ends, lo and counts read
// once per probe row, order and the build lanes once per build row, the
// probe lanes once per probe row, and per output position the two
// indices and every lane written once, over 3.35 TB/s.  Probe reads are
// near-sequential; build reads are random rows of a build side that at
// q2's shapes (100,000 rows) fits in L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 32;

struct Columns {
  const void* data[kMaxCols];
  const unsigned char* valid[kMaxCols];
  void* out_data[kMaxCols];
  unsigned char* out_valid[kMaxCols];
  int bytes[kMaxCols];
  int build[kMaxCols];
  int count;
};

// First index in [lo, hi) whose running count is above p, else hi.
__device__ __forceinline__ int upper_bound(const long long* ends, int lo,
                                           int hi, long long p) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (ends[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <class T>
__device__ __forceinline__ void copy(const void* src, void* dst, long long i,
                                     long long p, bool valid) {
  static_cast<T*>(dst)[p] = valid ? static_cast<const T*>(src)[i] : T(0);
}

__global__ void __launch_bounds__(kThreads)
expand_kernel(const long long* __restrict__ ends, int np,
              const int* __restrict__ lo, const long long* __restrict__ counts,
              const int* __restrict__ order, int nb, long long total,
              long long out_cap, int* __restrict__ pidx,
              int* __restrict__ bidx, Columns cols) {
  __shared__ int s_rows[2];
  const long long first = (long long)blockIdx.x * kThreads;
  if (threadIdx.x == 0) {
    long long last = first + kThreads - 1;
    if (last > out_cap - 1) last = out_cap - 1;
    const int r0 = upper_bound(ends, 0, np, first);
    s_rows[0] = r0;
    s_rows[1] = upper_bound(ends, r0, np, last);
  }
  __syncthreads();
  const long long p = first + threadIdx.x;
  if (p >= out_cap) return;
  // with no probe rows every position is padding: indices 0, no pair
  int row = 0;
  int b = 0;
  long long count = 0;
  if (np > 0) {
    // ends[s_rows[1]] > the block's last position >= p, when it exists
    row = upper_bound(ends, s_rows[0], s_rows[1], p);
    if (row > np - 1) row = np - 1;
    const long long start = row > 0 ? ends[row - 1] : 0;
    count = counts[row];
    const long long span = count > 1 ? count - 1 : 0;
    const long long k = p - start;
    long long pos = lo[row] + (k < span ? k : span);
    if (pos > nb - 1) pos = nb - 1;
    if (pos < 0) pos = 0;
    b = nb > 0 ? order[pos] : 0;
  }
  pidx[p] = row;
  bidx[p] = b;
  const bool pair = p < total;   // total is 0 when np is 0
  const bool matched = pair && count > 0;
#pragma unroll 4
  for (int c = 0; c < cols.count; ++c) {
    const bool build = cols.build[c];
    const long long i = build ? b : row;
    const bool valid = (build ? matched : pair) && cols.valid[c][i];
    cols.out_valid[c][p] = valid;
    switch (cols.bytes[c]) {
      case 8:
        copy<long long>(cols.data[c], cols.out_data[c], i, p, valid);
        break;
      case 4:
        copy<int>(cols.data[c], cols.out_data[c], i, p, valid);
        break;
      default:
        copy<unsigned char>(cols.data[c], cols.out_data[c], i, p, valid);
        break;
    }
  }
}

}  // namespace

// ends: long long[np] running sums of the effective counts; lo: int[np];
// counts: long long[np]; order: int[nb]; pidx, bidx: int[out_cap] out.
// Columns are described by host arrays of ncols entries: source data and
// validity (np rows on the probe side, nb on the build side), output
// data and validity (out_cap rows), element bytes (1, 4 or 8), side (0
// probe, 1 build).
extern "C" int srt_join_expand(const long long* ends, int np, const int* lo,
                               const long long* counts, const int* order,
                               int nb, long long total, long long out_cap,
                               int* pidx, int* bidx, int ncols,
                               const void* const* data,
                               const void* const* valid,
                               void* const* out_data, void* const* out_valid,
                               const int* bytes, const int* build,
                               cudaStream_t stream) {
  if (np < 0 || nb < 0 || ncols < 0 || ncols > kMaxCols || total < 0 ||
      (np == 0 && total != 0) || out_cap < total || out_cap >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Columns cols;
  cols.count = ncols;
  for (int c = 0; c < ncols; ++c) {
    if (bytes[c] != 1 && bytes[c] != 4 && bytes[c] != 8)
      return static_cast<int>(cudaErrorInvalidValue);
    cols.data[c] = data[c];
    cols.valid[c] = static_cast<const unsigned char*>(valid[c]);
    cols.out_data[c] = out_data[c];
    cols.out_valid[c] = static_cast<unsigned char*>(out_valid[c]);
    cols.bytes[c] = bytes[c];
    cols.build[c] = build[c];
  }
  if (out_cap == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (out_cap + kThreads - 1) / kThreads;
  expand_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      ends, np, lo, counts, order, nb, total, out_cap, pidx, bidx, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

// K3: grouped reduce over key-sorted rows.
//
// Replaces the reduction of the reference's exec/aggregate.py
// _group_reduce (steps 2-3 of its docstring: exclusive-scan differences
// for integer sums and counts, a segmented scan of the finite float
// values with inf/nan rebuilt from per-segment counts, and one
// compaction sort that moves each group's first row to its output slot)
// together with ops/segmented.py segment_boundaries / segment_ids.
//
// Two steps.  A stable 2-bucket partition (K1's count / scan / scatter)
// flags each row that starts a group -- a live row that is the first row
// or differs from the previous row in a key word -- and writes the start
// row of group g to starts[g].  Then one thread per group folds the rows
// of its group, in row order, for every op: a wrapping int64 sum, a
// float64 sum of the finite values with NaN / +-inf rebuilt from flags,
// or a count.  No float atomics, so a result is the same from run to
// run, which the aggregate's stable_merge determinism relies on.  A hot
// key leaves one thread folding all of its rows.
//
// Bound: device-memory bytes.  Least traffic is every key word, the live
// flags, each op's value lane and contributor mask read once, and the
// per-group outputs written once, over 3.35 TB/s.

#include "partition.cuh"

namespace {

constexpr int kMaxWords = 16;
constexpr int kMaxOps = 16;
constexpr int kCount = 0;
constexpr int kSumInt = 1;
constexpr int kSumFloat = 2;

struct Words {
  const long long* w[kMaxWords];
  int count;
};

struct BoundaryDigit {
  Words words;
  const unsigned char* live;
  __device__ int operator()(long long i) const {
    bool start = (i == 0);
#pragma unroll
    for (int k = 0; k < kMaxWords; ++k) {
      if (k >= words.count || start) break;
      start = words.w[k][i] != words.w[k][i - 1];
    }
    return (start && live[i]) ? 0 : 1;
  }
};

struct StartWriter {
  int* starts;
  __device__ void operator()(long long i, int dest, int d) const {
    if (d == 0) starts[dest] = static_cast<int>(i);
  }
};

struct Ops {
  const void* vals[kMaxOps];
  const unsigned char* contrib[kMaxOps];
  int kind[kMaxOps];
  void* sums[kMaxOps];
  long long* counts[kMaxOps];
  int count;
};

__device__ double fold_float(const double* v, const unsigned char* c,
                             int start, int end, long long* cnt) {
  double acc = 0.0;
  bool pinf = false, ninf = false, nan = false;
  long long n = 0;
  for (int r = start; r < end; ++r) {
    if (!c[r]) continue;
    ++n;
    const double x = v[r];
    const long long bits = __double_as_longlong(x);
    if (((bits >> 52) & 0x7ff) == 0x7ff) {
      if (bits & 0xfffffffffffffll) nan = true;
      else if (bits < 0) ninf = true;
      else pinf = true;
    } else {
      acc += x;
    }
  }
  *cnt = n;
  if (n == 0) return 0.0;
  if (nan || (pinf && ninf))
    return __longlong_as_double(0x7ff8000000000000ll);
  if (pinf) return __longlong_as_double(0x7ff0000000000000ll);
  if (ninf) return __longlong_as_double(static_cast<long long>(
      0xfff0000000000000ull));
  return acc;
}

__global__ void fold_kernel(Ops ops, const int* starts, int* groups,
                            int global_agg, int n, int* first_row) {
  // an ungrouped aggregate has one group, whatever the row count
  if (global_agg && blockIdx.x == 0 && threadIdx.x == 0) *groups = 1;
  const int g_count = global_agg ? 1 : *groups;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       g < g_count; g += (long long)gridDim.x * blockDim.x) {
    const int start = global_agg ? 0 : starts[g];
    const int end = (g + 1 < g_count) ? starts[g + 1] : n;
    first_row[g] = start;
#pragma unroll
    for (int k = 0; k < kMaxOps; ++k) {
      if (k >= ops.count) break;
      const unsigned char* c = ops.contrib[k];
      long long cnt = 0;
      if (ops.kind[k] == kSumInt) {
        const long long* v = static_cast<const long long*>(ops.vals[k]);
        unsigned long long acc = 0;
        for (int r = start; r < end; ++r) {
          if (c[r]) {
            acc += static_cast<unsigned long long>(v[r]);
            ++cnt;
          }
        }
        static_cast<long long*>(ops.sums[k])[g] =
            static_cast<long long>(acc);
      } else if (ops.kind[k] == kSumFloat) {
        static_cast<double*>(ops.sums[k])[g] = fold_float(
            static_cast<const double*>(ops.vals[k]), c, start, end, &cnt);
      } else {
        for (int r = start; r < end; ++r) cnt += c[r] ? 1 : 0;
      }
      ops.counts[k][g] = cnt;
    }
  }
}

}  // namespace

// words: host array of nwords device pointers to int64[n] sorted key
// words; live: bool[n].  Per op k: vals[k] (int64 or float64[n], null
// for a count), contrib[k] (bool[n]), kind[k] (0 count, 1 int64 sum,
// 2 float64 sum), sums[k] (int64 or float64[n], null for a count),
// counts[k] (int64[n]).  Groups fill slots [0, *groups); first_row[g] is
// the row that starts group g.  scratch: 4 * num_tiles(n) + n ints.
extern "C" int srt_segment_reduce(const long long* const* words, int nwords,
                                  const unsigned char* live, int n,
                                  int global_agg, int nops,
                                  const void* const* vals,
                                  const unsigned char* const* contrib,
                                  const int* kind, void* const* sums,
                                  long long* const* counts, int* first_row,
                                  int* groups, int* scratch,
                                  cudaStream_t stream) {
  if (nwords < 0 || nwords > kMaxWords || nops < 0 || nops > kMaxOps)
    return static_cast<int>(cudaErrorInvalidValue);
  Ops ops;
  ops.count = nops;
  for (int k = 0; k < nops; ++k) {
    if (kind[k] < kCount || kind[k] > kSumFloat)
      return static_cast<int>(cudaErrorInvalidValue);
    ops.vals[k] = vals[k];
    ops.contrib[k] = contrib[k];
    ops.kind[k] = kind[k];
    ops.sums[k] = sums[k];
    ops.counts[k] = counts[k];
  }
  const int tiles = srt::num_tiles(n);
  int* starts = scratch + 4 * tiles;
  cudaError_t err = cudaSuccess;
  if (global_agg) {
    // one group over every row: no boundaries to find
  } else if (n == 0) {
    err = cudaMemsetAsync(groups, 0, sizeof(int), stream);
  } else {
    Words w;
    w.count = nwords;
    for (int k = 0; k < nwords; ++k) w.w[k] = words[k];
    int* offsets = scratch + 2 * tiles;
    err = srt::partition<2>(BoundaryDigit{w, live}, StartWriter{starts}, n,
                            scratch, offsets, stream);
    if (err == cudaSuccess)
      err = cudaMemcpyAsync(groups, offsets + tiles, sizeof(int),
                            cudaMemcpyDeviceToDevice, stream);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!global_agg && n == 0) return static_cast<int>(cudaSuccess);
  fold_kernel<<<132 * 8, 256, 0, stream>>>(ops, starts, groups, global_agg,
                                           n, first_row);
  return static_cast<int>(cudaGetLastError());
}

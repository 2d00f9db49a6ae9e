// K5: the equi-join's pair expansion, fused with the row gathers of both
// sides.
//
// Replaces the reference's ops/join_kernels.py expand_pairs together
// with the gather_column calls of exec/join.py HashJoinExec._expand (the
// jnp branch fills rows from span starts with a running max instead of a
// search, a TPU workaround; the numpy branch's searchsorted states the
// semantics).
//
// Output position p < out_cap belongs to probe row `row`, the first whose
// running count `ends[row]` exceeds p (clamped to the last row); it is
// the row's k-th pair, k = p - ends[row - 1], and its build row is
// order[lo[row] + min(k, max(counts[row] - 1, 0))] (the position clamped
// into the build side).  With no probe rows (np == 0, so total == 0)
// every position is padding: both indices 0, every lane invalid and
// zero.  Each column is written as data and validity: probe columns at
// `row`, valid where the source row is and p < total; build columns at
// the build row, valid where besides counts[row] > 0 (the null-extended
// row of a left or full join has none); data is zero where invalid.  The
// pair indices (probe row, build row) are written too.
//
// Design: merge-path tiles (the load-balanced search of Baxter's
// moderngpu, csrc/merge_path.cuh).  The np row ends and the out_cap
// positions form one merged sequence, a row's end before position p when
// ends[row] <= p; it is cut into tiles of kTile items, so every tile has
// the same work whatever the keys: a hot key's run of positions and a run
// of rows without matches cost the same per item.
//   1. partition_kernel: one thread a tile boundary finds, by one binary
//      search along its diagonal, how many rows come before it.
//   2. expand_kernel, one block a tile: the tile's rows' ends, starts,
//      clamped spans (from counts) and lo go into shared memory with coalesced loads (a tile
//      of rows only, with no position, loads nothing); each thread then
//      owns runs of 4 consecutive positions, aligned to 4, finds their
//      rows by a binary search in shared memory, reads order[pos] (the
//      only dependent global load), and writes the indices and every
//      column: 4 validity bytes as one word and 4 values as 16-byte
//      vectors (8-byte lanes as two), the lane width chosen once per
//      column and not per position.  Columns go through a two-stage
//      pipeline: the next column's data and validity loads are issued
//      before this column's stores.  The run at each end of a tile that
//      the next tile shares is written element by element.
// The columns come through a device array of pointers and widths, so one
// launch writes any number of columns and the indices once.  Build-side
// reads are random rows of a build side that at q2's shapes (100,000
// rows) fits in L2, through the read-only path.
//
// Bound: device-memory bytes.  Least traffic is ends, lo and counts read
// once per probe row, order and the build lanes once per build row, the
// probe lanes once per probe row, and per output position the two
// indices and every lane written once, over 3.35 TB/s.

#include <cuda_runtime.h>

#include "merge_path.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 4;      // consecutive positions a thread writes
constexpr int kTile = 2048;  // merge items (row ends + positions) a tile

// Row count before each tile's first diagonal (csrc/merge_path.cuh), one
// thread a tile boundary.
__global__ void __launch_bounds__(kThreads)
partition_kernel(const long long* __restrict__ ends, int np,
                 long long out_cap, int tiles, int* __restrict__ split) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t > tiles) return;
  const long long items = np + out_cap;
  long long d = (long long)t * kTile;
  if (d > items) d = items;
  split[t] = static_cast<int>(srt::merge_path_rows(
      [ends](long long i) { return ends[i]; }, np, out_cap, d));
}

// One column of the descriptor (see expand_kernel).
struct Column {
  const void* src;
  const unsigned char* src_valid;
  void* out;
  unsigned char* out_valid;
  int bytes;
  bool build;
};

__device__ __forceinline__ Column column(const long long* __restrict__ desc,
                                         int ncols, int c) {
  Column col;
  col.src = reinterpret_cast<const void*>(__ldg(desc + c));
  col.src_valid =
      reinterpret_cast<const unsigned char*>(__ldg(desc + ncols + c));
  col.out = reinterpret_cast<void*>(__ldg(desc + 2 * ncols + c));
  col.out_valid =
      reinterpret_cast<unsigned char*>(__ldg(desc + 3 * ncols + c));
  col.bytes = static_cast<int>(__ldg(desc + 4 * ncols + c));
  col.build = __ldg(desc + 5 * ncols + c) != 0;
  return col;
}

// One column's source values over a run of 4 positions, as loaded: data
// widened to 64 bits and validity, both read where `ok` (the pair, or the
// match for a build column) and applied only when stored, so the loads of
// the next column are in flight before these are used.
struct Run {
  long long x[kRun];
  unsigned char valid[kRun];
  bool ok[kRun];
};

template <class T>
__device__ __forceinline__ void load_typed(const Column& col,
                                           const int (&row)[kRun],
                                           const int (&b)[kRun], Run& r) {
  const T* __restrict__ src = static_cast<const T*>(col.src);
#pragma unroll
  for (int v = 0; v < kRun; ++v) {
    const int i = col.build ? b[v] : row[v];
    r.x[v] = r.ok[v] ? static_cast<long long>(__ldg(src + i)) : 0;
    r.valid[v] = r.ok[v] ? __ldg(col.src_valid + i) : 0;
  }
}

__device__ __forceinline__ void load_run(const Column& col,
                                         const int (&row)[kRun],
                                         const int (&b)[kRun],
                                         const bool (&pair)[kRun],
                                         const bool (&matched)[kRun],
                                         Run& r) {
#pragma unroll
  for (int v = 0; v < kRun; ++v) r.ok[v] = col.build ? matched[v] : pair[v];
  if (col.bytes == 8) {
    load_typed<long long>(col, row, b, r);
  } else if (col.bytes == 4) {
    load_typed<int>(col, row, b, r);
  } else if (col.bytes == 2) {
    load_typed<short>(col, row, b, r);
  } else {
    load_typed<unsigned char>(col, row, b, r);
  }
}

template <class T>
__device__ __forceinline__ void write_vector(T* out, long long a,
                                             const T (&v)[kRun]);

template <>
__device__ __forceinline__ void write_vector<long long>(
    long long* out, long long a, const long long (&v)[kRun]) {
  reinterpret_cast<longlong2*>(out + a)[0] = make_longlong2(v[0], v[1]);
  reinterpret_cast<longlong2*>(out + a)[1] = make_longlong2(v[2], v[3]);
}

template <>
__device__ __forceinline__ void write_vector<int>(int* out, long long a,
                                                  const int (&v)[kRun]) {
  *reinterpret_cast<int4*>(out + a) = make_int4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void write_vector<short>(short* out, long long a,
                                                    const short (&v)[kRun]) {
  *reinterpret_cast<short4*>(out + a) = make_short4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void write_vector<unsigned char>(
    unsigned char* out, long long a, const unsigned char (&v)[kRun]) {
  *reinterpret_cast<uchar4*>(out + a) = make_uchar4(v[0], v[1], v[2], v[3]);
}

// Writes one loaded run: data zero where invalid; one vector store each
// for data and validity where the thread owns all 4 positions (`full`)
// and the column is aligned, else element by element.
template <class T>
__device__ __forceinline__ void store_typed(const Column& col, const Run& r,
                                            const bool (&own)[kRun],
                                            bool full, long long a) {
  T* out = static_cast<T*>(col.out);
  T val[kRun];
  unsigned char vb[kRun];
#pragma unroll
  for (int v = 0; v < kRun; ++v) {
    vb[v] = r.ok[v] && r.valid[v];
    val[v] = vb[v] ? static_cast<T>(r.x[v]) : T(0);
  }
  if (full && (reinterpret_cast<unsigned long long>(out) & 15) == 0 &&
      (reinterpret_cast<unsigned long long>(col.out_valid) & 3) == 0) {
    write_vector<T>(out, a, val);
    write_vector<unsigned char>(col.out_valid, a, vb);
  } else {
#pragma unroll
    for (int v = 0; v < kRun; ++v) {
      if (own[v]) {
        out[a + v] = val[v];
        col.out_valid[a + v] = vb[v];
      }
    }
  }
}

__device__ __forceinline__ void store_run(const Column& col, const Run& r,
                                          const bool (&own)[kRun], bool full,
                                          long long a) {
  if (col.bytes == 8) {
    store_typed<long long>(col, r, own, full, a);
  } else if (col.bytes == 4) {
    store_typed<int>(col, r, own, full, a);
  } else if (col.bytes == 2) {
    store_typed<short>(col, r, own, full, a);
  } else {
    store_typed<unsigned char>(col, r, own, full, a);
  }
}

// desc: long long[6 * ncols]: source data, source validity, output data,
// output validity (pointers), element bytes (1, 2, 4 or 8), side (0 probe, 1
// build), each ncols long.
__global__ void __launch_bounds__(kThreads)
expand_kernel(const long long* __restrict__ ends, int np,
              const int* __restrict__ lo, const long long* __restrict__ counts,
              const int* __restrict__ order, int nb, long long total,
              long long out_cap, const int* __restrict__ split,
              int* __restrict__ pidx, int* __restrict__ bidx,
              const long long* __restrict__ desc, int ncols) {
  __shared__ int s_end[kTile];         // ends of the tile's rows
  __shared__ int s_start[kTile + 1];   // per slot: its row's first position
  __shared__ int s_lo[kTile + 1];
  // per slot: the largest pair index k its row clamps to, min(counts - 1,
  // 2^31 - 1), or -1 for a row without matches
  __shared__ int s_span[kTile + 1];
  const int tid = threadIdx.x;
  const long long d0 = (long long)blockIdx.x * kTile;
  const long long items = np + out_cap;
  const long long d1 = d0 + kTile < items ? d0 + kTile : items;
  const int i0 = split[blockIdx.x];
  const int i1 = split[blockIdx.x + 1];
  const long long j0 = d0 - i0;  // the tile's positions: [j0, j1)
  const long long j1 = d1 - i1;
  if (j1 <= j0) return;  // row ends only
  const int nrows = i1 - i0;
  // slot l is row min(i0 + l, np - 1); slot nrows holds the row of the
  // positions after the tile's last row end (the last row for padding).
  // Ends and starts are at most the total (< 2^31) where they are read.
  if (np > 0) {
    for (int l = tid; l <= nrows; l += kThreads) {
      const int row = i0 + l < np ? i0 + l : np - 1;
      long long start = row > 0 ? ends[row - 1] : 0;
      s_start[l] = static_cast<int>(start < out_cap ? start : out_cap);
      const long long count = counts[row];
      s_span[l] = count < 1 ? -1
                            : static_cast<int>(count - 1 < 2147483647ll
                                                   ? count - 1
                                                   : 2147483647ll);
      s_lo[l] = lo[row];
      if (l < nrows) {
        const long long e = ends[i0 + l];
        s_end[l] = static_cast<int>(e < out_cap ? e : out_cap);
      }
    }
  }
  __syncthreads();

  const long long g_last = (j1 - 1) / kRun;
  for (long long g = j0 / kRun + tid; g <= g_last; g += kThreads) {
    const long long a = g * kRun;
    int row[kRun], b[kRun];
    bool own[kRun], pair[kRun], matched[kRun];
    bool full = true;
    int l = 0;
#pragma unroll
    for (int v = 0; v < kRun; ++v) {
      const long long p = a + v;
      own[v] = p >= j0 && p < j1;
      full = full && own[v];
      row[v] = 0;
      b[v] = 0;
      int span = -1;
      if (own[v] && np > 0) {
        int h = nrows;  // first slot whose row end is above p
        while (l < h) {
          const int m = (l + h) >> 1;
          if (s_end[m] <= p) {
            l = m + 1;
          } else {
            h = m;
          }
        }
        row[v] = i0 + l < np ? i0 + l : np - 1;
        span = s_span[l];
        // k < 2^31 - 1, so the clamped span picks the same build row
        const long long k = p - s_start[l];
        long long pos = s_lo[l] + (k < span ? k : (span > 0 ? span : 0));
        if (pos > nb - 1) pos = nb - 1;
        if (pos < 0) pos = 0;
        b[v] = nb > 0 ? __ldg(order + pos) : 0;
      }
      pair[v] = own[v] && p < total;  // total is 0 when np is 0
      matched[v] = pair[v] && span >= 0 && nb > 0;
    }
    if (full) {
      *reinterpret_cast<int4*>(pidx + a) =
          make_int4(row[0], row[1], row[2], row[3]);
      *reinterpret_cast<int4*>(bidx + a) = make_int4(b[0], b[1], b[2], b[3]);
    } else {
#pragma unroll
      for (int v = 0; v < kRun; ++v) {
        if (own[v]) {
          pidx[a + v] = row[v];
          bidx[a + v] = b[v];
        }
      }
    }
    // columns in a pipeline: the next column's loads go out before this
    // column's stores
    if (ncols == 0) continue;
    Column col = column(desc, ncols, 0);
    Run cur;
    load_run(col, row, b, pair, matched, cur);
    for (int c = 0; c < ncols; ++c) {
      Column next_col = col;
      Run next = cur;
      if (c + 1 < ncols) {
        next_col = column(desc, ncols, c + 1);
        load_run(next_col, row, b, pair, matched, next);
      }
      store_run(col, cur, own, full, a);
      col = next_col;
      cur = next;
    }
  }
}

}  // namespace

// ends: long long[np] running sums of the effective counts, total its last
// element; lo: int[np]; counts: long long[np]; order: int[nb]; split:
// int[tiles + 1] scratch, tiles = ceil((np + out_cap) / kTile); pidx,
// bidx: int[out_cap] out, 16-byte aligned.  desc: see expand_kernel.
extern "C" int srt_join_expand(const long long* ends, int np, const int* lo,
                               const long long* counts, const int* order,
                               int nb, long long total, long long out_cap,
                               int* split, int* pidx, int* bidx,
                               const long long* desc, int ncols,
                               cudaStream_t stream) {
  if (np < 0 || nb < 0 || ncols < 0 || total < 0 ||
      (np == 0 && total != 0) || out_cap < total || out_cap >= (1ll << 31) ||
      (reinterpret_cast<unsigned long long>(pidx) & 15) != 0 ||
      (reinterpret_cast<unsigned long long>(bidx) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_cap == 0) return static_cast<int>(cudaSuccess);
  const long long tiles = (np + out_cap + kTile - 1) / kTile;
  partition_kernel<<<static_cast<unsigned>((tiles + kThreads) / kThreads),
                     kThreads, 0, stream>>>(ends, np, out_cap,
                                            static_cast<int>(tiles), split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      ends, np, lo, counts, order, nb, total, out_cap, split, pidx, bidx,
      desc, ncols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kTile; }

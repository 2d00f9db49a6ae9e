// K3: grouped reduce over rows read in key order.
//
// Replaces the reduction of the reference's exec/aggregate.py
// _group_reduce (steps 2-3 of its docstring: exclusive-scan differences
// for integer sums and counts, a segmented scan of the finite float
// values with inf/nan rebuilt from per-segment counts, and one
// compaction sort that moves each group's first row to its output slot)
// together with ops/segmented.py segment_boundaries / segment_ids.  The
// reference carries every lane through its sort so that no row gather
// follows it; here the lanes stay in input order and sorted position i
// reads input row order[i] (K2's permutation), inside the kernel.
//
// Launches over tiles of srt::kTile = 4096 sorted rows, 256 threads a
// tile, 16 consecutive sorted rows a thread:
//   1. varying_kernel: which key words are not the same in every row,
//      read in input order; a constant word (the null word of a key with
//      no nulls) can start no group and is not read again.
//   2. starts_kernel: a row starts a group if it is live and is the first
//      row or differs from the previous sorted row in a varying word.
//      One 16-bit start mask per thread, and the start count per tile.
//   3. srt::scan_kernel: tile start counts -> each tile's first group
//      slot; the total is the group count.
//   4. fold_kernel, one launch per op (so one contributor mask at a time
//      shares the L2 cache with the value lane's reads): each thread
//      folds its 16 rows serially; a block-wide segmented scan in a fixed
//      order (warp shuffles, then shared memory) joins the threads' runs.
//      A group that opens and closes inside the tile is written to its
//      slot; the tile's open head segment (a group begun in an earlier
//      tile) and open tail segment go to per-tile partials.
//   5. fixup_kernel: one block per tile that holds a start finishes the
//      group begun at that tile's last start: its tail partial, then the
//      head partials of the following tiles up to and including the next
//      tile with a start, folded by a fixed tree.
// Steps 4-5 run once for each set of up to 16 ops (the ops of a set are
// passed by value); the key words of any count are read through a
// device array of pointers.
//
// Min and max (kinds 3-6) replace the reference's ops/segmented.py
// segment_reduce(xp, "min"|"max") on its jax branch (_argext_rows over
// _ordered_words32): per group, the row of the extreme ordered word
// among the contributing rows, the earliest in sorted order on a tie,
// and that row's value bit for bit (so -0.0 stays -0.0).  An int64 lane
// is its own word; a float64 lane's word is Spark's total order of
// encode_float_ordered (-0.0 equals 0.0, NaN canonical and greatest).
// The fold state is (the kept value's bits, its sorted position); two
// states combine by word, then by position, which is associative and
// commutative, so the fold, the head/tail partials and the fixup tree
// carry it as they carry the sums, and the result is the same bits on
// every run.  Max compares the other way; there is no inverted lane.
// So every thread folds 16 rows whatever the key skew: a hot key that
// holds 10M rows spans ~2,460 tiles and costs a ~2,460-partial tree in
// step 5, not a 10M-row loop on one thread.  No float atomics: every
// combination order is fixed by the sorted layout and the tile shape,
// so a result is the same bits from run to run, which the aggregate's
// stable_merge determinism relies on.
//
// Bound: device-memory bytes.  Least traffic is order (4 B/row), each
// key word (8 B/row), the live flags where given (1 B/row), each
// distinct value lane and contributor mask once, and the per-group
// outputs written once, over 3.35 TB/s.  The lanes are read at random
// rows, so each read moves a whole access granule, not 8 bytes; they
// are read once per row and op and never written back: the gathered
// copies of every lane that the previous design needed (written, then
// read again) are gone.

#include "partition.cuh"

namespace {

// Ops folded by one set of launches (the by-value Ops struct); more ops
// run in further sets over the same start masks and group offsets.
constexpr int kOpsPerLaunch = 16;
constexpr int kCount = 0;
constexpr int kSumInt = 1;
constexpr int kSumFloat = 2;
constexpr int kMinInt = 3;
constexpr int kMaxInt = 4;
constexpr int kMinFloat = 5;
constexpr int kMaxFloat = 6;
constexpr int kRows = srt::kRounds;  // consecutive sorted rows a thread
constexpr unsigned kPosInf = 1, kNegInf = 2, kNaN = 4;

// The key words: a device array of count pointers, so a key of any
// width fits one launch.
struct Words {
  const long long* const* w;
  int count;
};

struct Ops {
  const void* vals[kOpsPerLaunch];
  const unsigned char* contrib[kOpsPerLaunch];
  int kind[kOpsPerLaunch];
  void* sums[kOpsPerLaunch];
  long long* counts[kOpsPerLaunch];
  int count;
};

__host__ __device__ constexpr bool is_extreme(int kind) {
  return kind >= kMinInt;
}

// A fold of some rows of one op: wrapping int sum (min/max: the kept
// value's bits), finite float sum, contributor count, and which of
// +inf / -inf / NaN contributed (min/max: the kept row's sorted
// position).  Also the layout of a per-tile partial.
struct Acc {
  unsigned long long i;
  double f;
  long long n;
  unsigned flags;
};

__device__ __forceinline__ Acc zero_acc() { return Acc{0ull, 0.0, 0ll, 0u}; }

// The ordered word of a min/max value's bits: signed order of the words
// is the value order.
template <int KIND>
__device__ __forceinline__ long long ordered_word(long long bits) {
  if (KIND == kMinFloat || KIND == kMaxFloat) {
    if (((bits >> 52) & 0x7ff) == 0x7ff && (bits & 0xfffffffffffffll))
      bits = 0x7ff8000000000000ll;                    // canonical NaN
    if (bits == static_cast<long long>(0x8000000000000000ull))
      bits = 0;                                       // -0.0 as 0.0
    return bits < 0 ? bits ^ 0x7fffffffffffffffll : bits;
  }
  return bits;
}

// Whether the state (b, pb) is kept over (a, pa): the extreme word, then
// the earlier sorted position.
template <int KIND>
__device__ __forceinline__ bool keeps(long long b, unsigned pb, long long a,
                                      unsigned pa) {
  const long long wb = ordered_word<KIND>(b), wa = ordered_word<KIND>(a);
  if (wb != wa)
    return (KIND == kMinInt || KIND == kMinFloat) ? wb < wa : wb > wa;
  return pb < pa;
}

// a then b: a holds the earlier rows
template <int KIND>
__device__ __forceinline__ Acc combine(const Acc& a, const Acc& b) {
  if (is_extreme(KIND)) {
    const bool take_b =
        b.n > 0 && (a.n == 0 || keeps<KIND>(static_cast<long long>(b.i),
                                            b.flags,
                                            static_cast<long long>(a.i),
                                            a.flags));
    return Acc{take_b ? b.i : a.i, 0.0, a.n + b.n,
               take_b ? b.flags : a.flags};
  }
  return Acc{a.i + b.i, a.f + b.f, a.n + b.n, a.flags | b.flags};
}

// One row at sorted position pos: c says whether it contributes, bits
// are its value's 64 bits.
template <int KIND>
__device__ __forceinline__ void add_row(Acc& a, bool c, long long bits,
                                        unsigned pos) {
  if (is_extreme(KIND)) {
    if (c && (a.n == 0 || keeps<KIND>(bits, pos,
                                      static_cast<long long>(a.i),
                                      a.flags))) {
      a.i = static_cast<unsigned long long>(bits);
      a.flags = pos;
    }
    a.n += c ? 1 : 0;
    return;
  }
  a.n += c ? 1 : 0;
  if (KIND == kSumInt) {
    a.i += c ? static_cast<unsigned long long>(bits) : 0ull;
  } else if (KIND == kSumFloat) {
    if (((bits >> 52) & 0x7ff) == 0x7ff) {
      const unsigned flag = (bits & 0xfffffffffffffll) ? kNaN
                            : (bits < 0)               ? kNegInf
                                                       : kPosInf;
      a.flags |= c ? flag : 0u;
    } else {
      a.f += c ? __longlong_as_double(bits) : 0.0;
    }
  }
}

__device__ __forceinline__ void write_group(const Ops& ops, int kind, int k,
                                            int g, const Acc& a) {
  ops.counts[k][g] = a.n;
  if (is_extreme(kind)) {
    // no contributor: null, canonical zero under it
    static_cast<long long*>(ops.sums[k])[g] =
        a.n > 0 ? static_cast<long long>(a.i) : 0ll;
  } else if (kind == kSumInt) {
    static_cast<long long*>(ops.sums[k])[g] = static_cast<long long>(a.i);
  } else if (kind == kSumFloat) {
    double s = a.f;
    if (a.n == 0)
      s = 0.0;
    else if ((a.flags & kNaN) || (a.flags & (kPosInf | kNegInf)) ==
                                     (kPosInf | kNegInf))
      s = __longlong_as_double(0x7ff8000000000000ll);
    else if (a.flags & kPosInf)
      s = __longlong_as_double(0x7ff0000000000000ll);
    else if (a.flags & kNegInf)
      s = __longlong_as_double(static_cast<long long>(0xfff0000000000000ull));
    static_cast<double*>(ops.sums[k])[g] = s;
  }
}

__device__ __forceinline__ Acc shfl_up(const Acc& a, int off) {
  return Acc{__shfl_up_sync(0xffffffffu, a.i, off),
             __shfl_up_sync(0xffffffffu, a.f, off),
             __shfl_up_sync(0xffffffffu, a.n, off),
             __shfl_up_sync(0xffffffffu, a.flags, off)};
}

__device__ __forceinline__ Acc shfl_down(const Acc& a, int off) {
  return Acc{__shfl_down_sync(0xffffffffu, a.i, off),
             __shfl_down_sync(0xffffffffu, a.f, off),
             __shfl_down_sync(0xffffffffu, a.n, off),
             __shfl_down_sync(0xffffffffu, a.flags, off)};
}

// One element of the segmented scan: the fold since the last start, and
// whether a start lies in it.
struct Seg {
  Acc a;
  int start;
};

// x then y
template <int KIND>
__device__ __forceinline__ Seg seg_op(const Seg& x, const Seg& y) {
  return Seg{y.start ? y.a : combine<KIND>(x.a, y.a), x.start | y.start};
}

// Block-wide segmented scan in thread order: *excl gets threads
// [0, tid), *incl threads [0, tid].  s_warp: kWarps shared entries.
// Ends with a barrier, so s_warp can be used again.
template <int KIND>
__device__ void block_seg_scan(Seg x, Seg* s_warp, Seg* excl, Seg* incl) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  Seg in = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg y{shfl_up(in.a, off),
                __shfl_up_sync(0xffffffffu, in.start, off)};
    if (lane >= off) in = seg_op<KIND>(y, in);
  }
  Seg before{shfl_up(in.a, 1), __shfl_up_sync(0xffffffffu, in.start, 1)};
  if (lane == 31) s_warp[w] = in;
  __syncthreads();
  Seg pre{zero_acc(), 0};
  for (int q = 0; q < w; ++q) pre = seg_op<KIND>(pre, s_warp[q]);
  *excl = lane == 0 ? pre : (w == 0 ? before : seg_op<KIND>(pre, before));
  *incl = w == 0 ? in : seg_op<KIND>(pre, in);
  __syncthreads();
}

// Block-wide count of set start bits before this thread (exclusive).
__device__ int block_exclusive_sum(int v, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int in = srt::warp_inclusive_scan(v);
  if (lane == 31) s_warp[w] = in;
  __syncthreads();
  int pre = 0;
  for (int q = 0; q < w; ++q) pre += s_warp[q];
  __syncthreads();
  return pre + in - v;
}

// Shared copy of a tile's input rows, padded one int in 32 so that a
// thread's 16 consecutive rows sit in distinct banks across the warp.
constexpr int kPaddedTile = srt::kTile + srt::kTile / 32;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// rows[j] = input row of sorted row first + j (0 past n); returns the
// bits of the rows below n.
__device__ unsigned load_rows(const int* order, int n, int* s_rows,
                              int* rows) {
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * srt::kTile;
  for (int r = 0; r < kRows; ++r) {
    const int i = r * srt::kThreads + tid;
    if (base + i < n)
      s_rows[padded(i)] =
          order ? order[base + i] : static_cast<int>(base + i);
  }
  __syncthreads();
  const long long first = base + (long long)tid * kRows;
  const int valid =
      first >= n ? 0 : (n - first >= kRows ? kRows : (int)(n - first));
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    rows[j] = j < valid ? s_rows[padded(tid * kRows + j)] : 0;
  return valid == kRows ? 0xffffu : (1u << valid) - 1u;
}

// varying[k] = 1 if key word k is not the same in every row (varying is
// zeroed first).  Its rows are read in input order, coalesced, so a
// constant word (the null word of a key with no nulls) costs 8 B/row
// read in order here and no gather in starts_kernel.
__global__ void __launch_bounds__(srt::kThreads)
varying_kernel(Words words, int n, int* varying) {
  const long long stride = (long long)gridDim.x * srt::kThreads;
  for (int k = 0; k < words.count; ++k) {
    const long long* w = words.w[k];
    const long long w0 = w[0];
    bool differs = false;
    for (long long i = (long long)blockIdx.x * srt::kThreads + threadIdx.x;
         i < n; i += stride)
      differs |= w[i] != w0;
    if (__syncthreads_or(differs) && threadIdx.x == 0) varying[k] = 1;
  }
}

__global__ void __launch_bounds__(srt::kThreads)
starts_kernel(Words words, const int* varying, const unsigned char* live,
              const int* order, int n, int global_agg,
              unsigned short* masks, int* tile_counts) {
  __shared__ int s_rows[kPaddedTile];
  __shared__ int s_cnt;
  const int tid = threadIdx.x;
  if (tid == 0) s_cnt = 0;
  int rows[kRows];
  const unsigned valid = load_rows(order, n, s_rows, rows);
  const long long first = (long long)blockIdx.x * srt::kTile +
                          (long long)tid * kRows;
  unsigned m = 0;
  if (global_agg) {
    m = first == 0 ? (valid & 1u) : 0u;
  } else if (valid) {
    unsigned diff = first == 0 ? 1u : 0u;
    int prev = 0;
    if (first > 0)
      prev = tid > 0 ? s_rows[padded(tid * kRows - 1)]
                     : (order ? order[first - 1] : (int)(first - 1));
    for (int k = 0; k < words.count; ++k) {
      if (!varying[k]) continue;      // a constant word starts no group
      const long long* w = words.w[k];
      long long p = w[prev];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const long long c = w[rows[j]];
        diff |= (c != p) ? (1u << j) : 0u;
        p = c;
      }
    }
    unsigned lv = 0xffffu;
    if (live) {
      lv = 0;
#pragma unroll
      for (int j = 0; j < kRows; ++j) lv |= live[rows[j]] ? (1u << j) : 0u;
    }
    m = diff & lv & valid;
  }
  masks[(long long)blockIdx.x * srt::kThreads + tid] =
      static_cast<unsigned short>(m);
  int cnt = __popc(m);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if ((tid & 31) == 0 && cnt) atomicAdd(&s_cnt, cnt);
  __syncthreads();
  if (tid == 0) tile_counts[blockIdx.x] = s_cnt;
}

template <int KIND>
__device__ void fold_op(const Ops& ops, int k, const int* s_rows,
                        unsigned valid, unsigned mask, int slot0,
                        int before, Acc* head, Acc* tail, Seg* s_seg) {
  const long long* vals = static_cast<const long long*>(ops.vals[k]);
  const unsigned char* contrib = ops.contrib[k];
  // every read of the thread's rows is issued before any write below
  unsigned c = 0;
  long long bits[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int r = ((valid >> j) & 1u)
                      ? s_rows[padded(threadIdx.x * kRows + j)] : 0;
    c |= contrib[r] ? (1u << j) : 0u;
    bits[j] = KIND == kCount ? 0ll : vals[r];
  }
  c &= valid;
  Acc first_run = zero_acc(), run = zero_acc();
  int seen = 0;
  const unsigned pos0 = static_cast<unsigned>(
      (long long)blockIdx.x * srt::kTile + threadIdx.x * kRows);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if ((mask >> j) & 1u) {
      if (seen == 0)
        first_run = run;
      else
        write_group(ops, KIND, k, slot0 + seen - 1, run);
      ++seen;
      run = zero_acc();
    }
    add_row<KIND>(run, (c >> j) & 1u, bits[j], pos0 + j);
  }
  Seg excl, incl;
  block_seg_scan<KIND>(Seg{run, seen > 0}, s_seg, &excl, &incl);
  const long long part = (long long)blockIdx.x * ops.count + k;
  if (seen > 0) {
    // the group open at this thread's first start closes there
    const Acc a = combine<KIND>(excl.a, first_run);
    if (before > 0)
      write_group(ops, KIND, k, slot0 - 1, a);
    else
      head[part] = a;
  }
  if (threadIdx.x == srt::kThreads - 1) {
    if (incl.start)
      tail[part] = incl.a;
    else
      head[part] = incl.a;
  }
}

// One op k over one tile; the launch for op 0 also writes first_row.
template <int KIND>
__global__ void __launch_bounds__(srt::kThreads)
fold_kernel(Ops ops, int k, const int* order, int n,
            const unsigned short* masks, const int* tile_offsets,
            int* first_row, Acc* head, Acc* tail) {
  __shared__ int s_rows[kPaddedTile];
  __shared__ int s_warp[srt::kWarps];
  __shared__ Seg s_seg[srt::kWarps];
  const int tid = threadIdx.x;
  int rows[kRows];
  const unsigned valid = load_rows(order, n, s_rows, rows);
  const unsigned mask =
      masks[(long long)blockIdx.x * srt::kThreads + tid];
  const int before = block_exclusive_sum(__popc(mask), s_warp);
  const int slot0 = tile_offsets[blockIdx.x] + before;
  if (first_row) {
    int s = 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if ((mask >> j) & 1u) first_row[slot0 + s++] = rows[j];
  }
  if (k < ops.count)
    fold_op<KIND>(ops, k, s_rows, valid, mask, slot0, before, head, tail,
                  s_seg);
}

// Op k of the group begun at tile t's last start: the tail partial,
// then the head partials of tiles [lo, hi) of each thread.
template <int KIND>
__device__ void fixup_op(const Ops& ops, int k, int t, int slot, int lo,
                         int hi, const Acc* head, const Acc* tail,
                         Acc* s_warp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  Acc a = zero_acc();
  for (int u = lo; u < hi; ++u)
    a = combine<KIND>(a, head[(long long)u * ops.count + k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Acc b = shfl_down(a, off);
    if (lane + off < 32) a = combine<KIND>(a, b);
  }
  if (lane == 0) s_warp[w] = a;
  __syncthreads();
  if (tid == 0) {
    Acc r = tail[(long long)t * ops.count + k];
    for (int q = 0; q < srt::kWarps; ++q) r = combine<KIND>(r, s_warp[q]);
    write_group(ops, ops.kind[k], k, slot, r);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(srt::kThreads)
fixup_kernel(Ops ops, const int* tile_counts, const int* tile_offsets,
             int tiles, const Acc* head, const Acc* tail) {
  __shared__ int s_first;
  __shared__ Acc s_warp[srt::kWarps];
  const int t = blockIdx.x;
  if (tile_counts[t] == 0) return;
  const int tid = threadIdx.x;
  // the group runs on through every tile up to and including the next
  // one that holds a start (or the last tile)
  int end = tiles;
  for (int c = t + 1; c < tiles; c += srt::kThreads) {
    if (tid == 0) s_first = tiles;
    __syncthreads();
    const int u = c + tid;
    if (u < tiles && tile_counts[u] > 0) atomicMin(&s_first, u);
    __syncthreads();
    const int found = s_first;
    __syncthreads();
    if (found < tiles) {
      end = found + 1;
      break;
    }
  }
  const int lo_all = t + 1;
  const int per = (end - lo_all + srt::kThreads - 1) / srt::kThreads;
  const int lo = lo_all + tid * per;
  const int hi = min(lo + per, end);
  const int slot = tile_offsets[t] + tile_counts[t] - 1;
#pragma unroll 1
  for (int k = 0; k < ops.count; ++k) {
    switch (ops.kind[k]) {
      case kMinInt:
        fixup_op<kMinInt>(ops, k, t, slot, lo, hi, head, tail, s_warp);
        break;
      case kMaxInt:
        fixup_op<kMaxInt>(ops, k, t, slot, lo, hi, head, tail, s_warp);
        break;
      case kMinFloat:
        fixup_op<kMinFloat>(ops, k, t, slot, lo, hi, head, tail, s_warp);
        break;
      case kMaxFloat:
        fixup_op<kMaxFloat>(ops, k, t, slot, lo, hi, head, tail, s_warp);
        break;
      default:  // counts and sums combine alike; write_group tells them
        fixup_op<kCount>(ops, k, t, slot, lo, hi, head, tail, s_warp);
    }
  }
}

// An ungrouped aggregate over no rows: one group, every count 0.
__global__ void empty_global_kernel(Ops ops, int* first_row, int* groups) {
  *groups = 1;
  *first_row = 0;
  for (int k = 0; k < ops.count; ++k)
    write_group(ops, ops.kind[k], k, 0, zero_acc());
}

struct Layout {
  Acc* head;
  Acc* tail;
  unsigned short* masks;
  int* tile_counts;
  int* tile_offsets;
  int* varying;
};

int ops_per_launch(int nops) {
  return nops < kOpsPerLaunch ? nops : kOpsPerLaunch;
}

// head and tail partials [tiles][ops of one launch], start masks
// [tiles][kThreads], tile start counts and tile group offsets [tiles],
// varying [max(nwords, 1)]
long long layout_bytes(int n, int nwords, int nops) {
  const long long tiles = srt::num_tiles(n);
  return tiles * (2ll * ops_per_launch(nops) * sizeof(Acc) +
                  srt::kThreads * sizeof(unsigned short) + 2 * sizeof(int)) +
         (nwords > 1 ? nwords : 1) * sizeof(int);
}

Layout layout(void* scratch, int n, int nops) {
  const long long tiles = srt::num_tiles(n);
  const long long parts = tiles * ops_per_launch(nops);
  Layout l;
  l.head = static_cast<Acc*>(scratch);
  l.tail = l.head + parts;
  l.masks = reinterpret_cast<unsigned short*>(l.tail + parts);
  l.tile_counts = reinterpret_cast<int*>(l.masks + tiles * srt::kThreads);
  l.tile_offsets = l.tile_counts + tiles;
  l.varying = l.tile_offsets + tiles;
  return l;
}

}  // namespace

// Bytes of scratch that srt_segment_reduce needs for n rows, nwords key
// words and nops ops.
extern "C" long long srt_segment_reduce_scratch_bytes(int n, int nwords,
                                                      int nops) {
  return layout_bytes(n, nwords, nops);
}

// words: device array of nwords device pointers to int64[n] key words;
// live: bool[n] or null (every row live); order: int32[n] or null (the
// rows are already in key order); all lanes in input order, sorted row
// i being input row order[i].  Per op k: vals[k] (int64 or float64[n],
// null for a count), contrib[k] (bool[n]), kind[k] (0 count, 1 int64
// sum, 2 float64 sum, 3 / 4 int64 min / max, 5 / 6 float64 min / max),
// sums[k] (the lane's type, [max(n, 1)], null for a count; min and max
// write the kept value's bits, 0 where no row contributed), counts[k]
// (int64[max(n, 1)]); host arrays of nops entries.
// Groups fill slots [0, *groups) in key order; first_row[g] is the input
// row of group g's first sorted row.  Rows before the first group start
// belong to no group.  The starts are found once; the ops are folded
// kOpsPerLaunch at a time, each set with its own fold and fixup
// launches, so an op's result does not depend on how many ops there are.
// scratch: srt_segment_reduce_scratch_bytes(n, nwords, nops) bytes,
// 8-byte aligned.
extern "C" int srt_segment_reduce(const long long* const* words, int nwords,
                                  const unsigned char* live,
                                  const int* order, int n, int global_agg,
                                  int nops, const void* const* vals,
                                  const unsigned char* const* contrib,
                                  const int* kind, void* const* sums,
                                  long long* const* counts, int* first_row,
                                  int* groups, void* scratch,
                                  cudaStream_t stream) {
  if (nwords < 0 || nops < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < nops; ++k)
    if (kind[k] < kCount || kind[k] > kMaxFloat)
      return static_cast<int>(cudaErrorInvalidValue);
  // the ops of set s: [s * kOpsPerLaunch, +ops.count)
  auto op_set = [&](int s) {
    Ops ops;
    ops.count = ops_per_launch(nops - s * kOpsPerLaunch);
    for (int j = 0; j < ops.count; ++j) {
      const int k = s * kOpsPerLaunch + j;
      ops.vals[j] = vals[k];
      ops.contrib[j] = contrib[k];
      ops.kind[j] = kind[k];
      ops.sums[j] = sums[k];
      ops.counts[j] = counts[k];
    }
    return ops;
  };
  const int sets = nops > 0 ? (nops + kOpsPerLaunch - 1) / kOpsPerLaunch : 1;
  cudaError_t err = cudaSuccess;
  if (n == 0) {
    if (global_agg) {
      for (int s = 0; s < sets && err == cudaSuccess; ++s) {
        empty_global_kernel<<<1, 1, 0, stream>>>(op_set(s), first_row,
                                                 groups);
        err = cudaGetLastError();
      }
      return static_cast<int>(err);
    }
    return static_cast<int>(
        cudaMemsetAsync(groups, 0, sizeof(int), stream));
  }
  const Words w{words, nwords};
  const int tiles = srt::num_tiles(n);
  const Layout l = layout(scratch, n, nops);
  err = cudaMemsetAsync(l.varying, 0, (nwords > 1 ? nwords : 1) * sizeof(int),
                        stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!global_agg && nwords > 0) {
    varying_kernel<<<tiles < 1056 ? tiles : 1056, srt::kThreads, 0,
                     stream>>>(w, n, l.varying);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  starts_kernel<<<tiles, srt::kThreads, 0, stream>>>(
      w, l.varying, live, order, n, global_agg, l.masks, l.tile_counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  srt::scan_kernel<<<1, srt::kScanThreads, 0, stream>>>(
      l.tile_counts, tiles, l.tile_offsets, groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int s = 0; s < sets; ++s) {
    const Ops ops = op_set(s);
    // one launch per op, so one contributor mask at a time shares the L2
    // cache with the value lane's gathers
    for (int k = 0; k < (ops.count > 0 ? ops.count : 1); ++k) {
      int* fr = s == 0 && k == 0 ? first_row : nullptr;
      const int kk = k < ops.count ? ops.kind[k] : kCount;
#define SRT_FOLD(KIND)                                                    \
  fold_kernel<KIND><<<tiles, srt::kThreads, 0, stream>>>(                 \
      ops, k, order, n, l.masks, l.tile_offsets, fr, l.head, l.tail)
      switch (kk) {
        case kSumInt: SRT_FOLD(kSumInt); break;
        case kSumFloat: SRT_FOLD(kSumFloat); break;
        case kMinInt: SRT_FOLD(kMinInt); break;
        case kMaxInt: SRT_FOLD(kMaxInt); break;
        case kMinFloat: SRT_FOLD(kMinFloat); break;
        case kMaxFloat: SRT_FOLD(kMaxFloat); break;
        default: SRT_FOLD(kCount);
      }
#undef SRT_FOLD
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    fixup_kernel<<<tiles, srt::kThreads, 0, stream>>>(
        ops, l.tile_counts, l.tile_offsets, tiles, l.head, l.tail);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(err);
}

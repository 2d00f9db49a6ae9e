// K11 segment_scan and K12 run_ends: the window operator's scans over rows
// sorted by (partition keys, order keys).
//
// K11 replaces the reference's spark_rapids_tpu/exec/window.py
// _seg_start_positions (:46, a cummax over ops/scan.py:76 cummax_i32),
// _running (:429-448, running sums and counts as differences of global
// prefix sums, ops/scan.py:15 cumsum_fast) and DenseRank's runs_cum
// (:205-209).  One pass computes, per row: the position of its partition's
// first row and of its peer run's first row (max-scans of the flagged
// positions), the running count of run starts, and for up to kMaxPairs
// (value, valid) pairs the running sum of the valid values (int64 wrapping
// mod 2^64, or float64) and their count, both restarting at each
// partition.  The segmented operator
//   (f1, a1) + (f2, a2) = (f1 | f2, f2 ? a2 : a1 + a2)
// is associative, so the scan is one inclusive scan of a small state:
// each thread folds kItems consecutive rows, a warp scans the thread
// states with shuffles, the block combines its warps, and each tile finds
// the state of every earlier tile by decoupled look-back, as K7
// (csrc/expand_ends.cu) and K2's one-sweep pass do.  A tile's state is
// 16 + 12 P bytes for P pairs, too wide for one atomic word: a tile
// writes it with L2 stores, fences, then raises its status word; a
// reader polls the status, fences, then reads the state from L2.
// Integer sums equal the reference's prefix differences bit for bit; a
// float sum adds only the rows of its own partition, so it is more
// accurate than a difference of two global prefix sums.
//
// What costs time beside the bytes, and what the design does about it:
//   - every tile takes a look-back step: a thread folds 32 rows with one
//     pair (tiles of 8,192), 16 with two, 8 with three or four, so 2^25
//     rows take 4,096 steps with one pair; the pairs' values stay in
//     shared memory, not in registers, so three blocks share an SM;
//   - a step reads up to 32 earlier states: the warp folds them with a
//     shuffle tree, five combines deep, not one lane after another;
//   - a thread's rows are consecutive, so its own loads and stores would
//     span a warp instruction over 32 runs: the 8-byte values come in,
//     and every output goes out, through a shared-memory stage in which
//     a warp moves 512 consecutive bytes an instruction.  The flag lanes
//     come in as 16-byte loads of a thread's own bytes.
//
// K12 replaces _run_end_positions (:54, a reversed cummax of negated
// positions): per row, the last row of its partition and of its peer run.
// Row i ends a run when it is live and the next row starts a run or is
// the first padding row (rows from n_live on); the answer is the nearest
// end at or after the row, a min-scan from the right.  Tiles run from the
// array's end (tile b holds the rows below n - b * kTile), each thread
// folds kItems rows, and the look-back carries one 64-bit word a tile:
// the status in the top two bits, the two minima in 31 bits each.  A
// padding row reads n_live - 1, so no run reaches into the padding.
//
// No thread walks a partition or a run: the work per thread is kItems
// rows whatever the skew, and a partition spanning many tiles costs one
// look-back step a tile, as any other data.
//
// Bound: device-memory bytes.  K11 reads 2 flag bytes a row and 9 bytes a
// pair (value and valid), and writes 4 bytes a position output and 12
// bytes a pair (sum and count); K12 reads 2 flag bytes and writes 8
// bytes a row; over 3.35 TB/s.  K12's look-back state is 8 bytes a tile
// of 2,048 rows.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;              // K12 rows a thread
constexpr int kTile = kThreads * kItems;
constexpr int kMaxPairs = 4;
constexpr unsigned kFull = 0xffffffffu;

enum Kind { kCountOnly = 0, kInt64 = 1, kFloat64 = 2 };

struct Pair {
  const unsigned long long* value;  // int64 or float64 bits, or null
  const unsigned char* valid;
  unsigned long long* sum;          // or null
  int* count;                       // or null
  int kind;
};

struct ScanArgs {
  const unsigned char* new_seg;
  const unsigned char* new_run;     // null when no run output is asked
  int n;
  int* seg_start;                   // each output may be null
  int* run_start;
  int* runs_cum;
  int npairs;
  Pair pairs[kMaxPairs];
};

// The scanned state of a stretch of rows, with P (value, valid) pairs.
// flag: a partition starts in the stretch; sum / count: since the last
// partition start in the stretch, or over the whole stretch without one.
template <int P>
struct Agg {
  int seg_start;
  int run_start;
  int runs;
  int flag;
  unsigned long long sum[P > 0 ? P : 1];
  int count[P > 0 ? P : 1];
};

template <int P>
__device__ __forceinline__ Agg<P> identity() {
  Agg<P> a;
  a.seg_start = -1;
  a.run_start = -1;
  a.runs = 0;
  a.flag = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a.sum[p] = 0;
    a.count[p] = 0;
  }
  return a;
}

__device__ __forceinline__ unsigned long long add(int kind,
                                                  unsigned long long a,
                                                  unsigned long long b) {
  if (kind == kFloat64)
    return static_cast<unsigned long long>(__double_as_longlong(
        __longlong_as_double(static_cast<long long>(a)) +
        __longlong_as_double(static_cast<long long>(b))));
  return a + b;
}

// a covers earlier rows than b.
template <int P>
__device__ __forceinline__ Agg<P> combine(const Agg<P>& a, const Agg<P>& b,
                                          const int* kind) {
  Agg<P> c;
  c.seg_start = max(a.seg_start, b.seg_start);
  c.run_start = max(a.run_start, b.run_start);
  c.runs = a.runs + b.runs;
  c.flag = a.flag | b.flag;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    c.sum[p] = b.flag ? b.sum[p] : add(kind[p], a.sum[p], b.sum[p]);
    c.count[p] = b.flag ? b.count[p] : a.count[p] + b.count[p];
  }
  return c;
}

template <int P>
__device__ __forceinline__ Agg<P> shfl_up(const Agg<P>& a, int off) {
  Agg<P> r;
  r.seg_start = __shfl_up_sync(kFull, a.seg_start, off);
  r.run_start = __shfl_up_sync(kFull, a.run_start, off);
  r.runs = __shfl_up_sync(kFull, a.runs, off);
  r.flag = __shfl_up_sync(kFull, a.flag, off);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    r.sum[p] = __shfl_up_sync(kFull, a.sum[p], off);
    r.count[p] = __shfl_up_sync(kFull, a.count[p], off);
  }
  return r;
}

template <int P>
__device__ __forceinline__ Agg<P> shfl_down(const Agg<P>& a, int off) {
  Agg<P> r;
  r.seg_start = __shfl_down_sync(kFull, a.seg_start, off);
  r.run_start = __shfl_down_sync(kFull, a.run_start, off);
  r.runs = __shfl_down_sync(kFull, a.runs, off);
  r.flag = __shfl_down_sync(kFull, a.flag, off);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    r.sum[p] = __shfl_down_sync(kFull, a.sum[p], off);
    r.count[p] = __shfl_down_sync(kFull, a.count[p], off);
  }
  return r;
}

// Look-back state goes through L2 (st.cg / ld.cg): L1 is not coherent
// across SMs.
template <int P>
__device__ __forceinline__ void store_l2(Agg<P>* dst, const Agg<P>& a) {
  __stcg(&dst->seg_start, a.seg_start);
  __stcg(&dst->run_start, a.run_start);
  __stcg(&dst->runs, a.runs);
  __stcg(&dst->flag, a.flag);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    __stcg(reinterpret_cast<long long*>(&dst->sum[p]),
           static_cast<long long>(a.sum[p]));
    __stcg(&dst->count[p], a.count[p]);
  }
}

template <int P>
__device__ __forceinline__ Agg<P> load_l2(const Agg<P>* src) {
  Agg<P> a;
  a.seg_start = __ldcg(&src->seg_start);
  a.run_start = __ldcg(&src->run_start);
  a.runs = __ldcg(&src->runs);
  a.flag = __ldcg(&src->flag);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    a.sum[p] = static_cast<unsigned long long>(
        __ldcg(reinterpret_cast<const long long*>(&src->sum[p])));
    a.count[p] = __ldcg(&src->count[p]);
  }
  return a;
}

// I bytes of a flag lane as bits (row k in bit k); a full run of rows in
// 8- or 16-byte loads.
template <int I>
__device__ __forceinline__ unsigned load_bits(const unsigned char* lane,
                                              long long first, int rows) {
  static_assert(I == 8 || I == 16 || I == 32, "a run is whole vectors");
  unsigned bits = 0;
  if (rows == I) {
    unsigned w[I / 4];
    if constexpr (I == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(lane + first);
      w[0] = v.x, w[1] = v.y;
    } else {
#pragma unroll
      for (int h = 0; h < I / 16; ++h) {
        const uint4 v = reinterpret_cast<const uint4*>(lane + first)[h];
        w[4 * h] = v.x, w[4 * h + 1] = v.y, w[4 * h + 2] = v.z,
        w[4 * h + 3] = v.w;
      }
    }
#pragma unroll
    for (int q = 0; q < I / 4; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        bits |= ((w[q] >> (8 * k)) & 1u) << (4 * q + k);
  } else {
    for (int k = 0; k < rows; ++k) bits |= (lane[first + k] ? 1u : 0u) << k;
  }
  return bits;
}

// int32 lane: kItems values from first, two 16-byte stores when full (K12).
__device__ __forceinline__ void store_ints(int* lane, long long first,
                                           int rows, const int* v) {
  if (rows == kItems) {
    int4* dst = reinterpret_cast<int4*>(lane + first);
    dst[0] = make_int4(v[0], v[1], v[2], v[3]);
    dst[1] = make_int4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)   // constant indices keep v in registers
      if (k < rows) lane[first + k] = v[k];
  }
}

constexpr int kNone = 0, kAggregate = 1, kPrefix = 2;

// K11's rows a thread: 32 with one pair (tiles of 8,192 rows), 16 with
// two, 8 with three or four, so that every pair's values fit in shared
// memory at about 70 KB a block.
template <int P>
struct ScanShape {
  static constexpr int kItems = P <= 1 ? 32 : P == 2 ? 16 : 8;
  static constexpr int kTile = kThreads * kItems;
  // a stage: one 8-byte word a row, and one of padding after each
  // thread's run, so a thread's run and a warp's stripe both fall on
  // distinct banks; one stage a pair's values (one at least)
  static constexpr int kStage = kTile + kThreads;
  static constexpr int kSmem = (P > 0 ? P : 1) * kStage * 8;
  static __device__ __forceinline__ int at(int e) {
    return e + e / kItems;
  }
};
constexpr int kScanMinTile = kThreads * 8;

// The tile's rows of an 8-byte lane into the stage: a thread reads two
// words with one 16-byte load, a warp 512 consecutive bytes.
template <class S>
__device__ __forceinline__ void stage_in(const unsigned long long* src,
                                         long long tile_first,
                                         int tile_rows,
                                         unsigned long long* stage) {
#pragma unroll
  for (int k = 0; k < S::kItems / 2; ++k) {
    const int e = 2 * (k * kThreads + threadIdx.x);
    if (e + 1 < tile_rows) {
      const ulonglong2 w =
          __ldg(reinterpret_cast<const ulonglong2*>(src + tile_first + e));
      stage[S::at(e)] = w.x;
      stage[S::at(e + 1)] = w.y;
    } else if (e < tile_rows) {
      stage[S::at(e)] = __ldg(src + tile_first + e);
    }
  }
}

// The staged tile out to a lane with 16-byte stores (two 8-byte or four
// 4-byte elements a thread), a warp writing 512 consecutive bytes.  A
// thread's elements never straddle a pad (kItems is a multiple of 4).
template <class S>
__device__ __forceinline__ void stage_out(unsigned long long* dst,
                                          long long tile_first,
                                          int tile_rows,
                                          const unsigned long long* stage) {
#pragma unroll
  for (int k = 0; k < S::kItems / 2; ++k) {
    const int e = 2 * (k * kThreads + threadIdx.x);
    if (e + 1 < tile_rows)
      *reinterpret_cast<ulonglong2*>(dst + tile_first + e) =
          make_ulonglong2(stage[S::at(e)], stage[S::at(e) + 1]);
    else if (e < tile_rows)
      dst[tile_first + e] = stage[S::at(e)];
  }
}

template <class S>
__device__ __forceinline__ void stage_out(int* dst, long long tile_first,
                                          int tile_rows, const int* stage) {
#pragma unroll
  for (int k = 0; k < S::kItems / 4; ++k) {
    const int e = 4 * (k * kThreads + threadIdx.x);
    const int* v = stage + S::at(e);
    if (e + 3 < tile_rows) {
      *reinterpret_cast<int4*>(dst + tile_first + e) =
          make_int4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; j < 4 && e + j < tile_rows; ++j)
        dst[tile_first + e + j] = v[j];
    }
  }
}

// The combined state of the earlier tiles, read by warp 0: 32 earlier
// tiles at a time, nearest first, until one that has published its
// inclusive prefix (tile 0 always does).  The window's states fold by a
// shuffle tree (lane j + off holds earlier tiles than lane j), so a step
// costs five combines, not 32.  Lane 0's result is the one to use.
template <int P>
__device__ __forceinline__ Agg<P> look_back(int tile, volatile int* status,
                                            const Agg<P>* aggs,
                                            const Agg<P>* prefs,
                                            const int* kind) {
  const int lane = threadIdx.x & 31;
  Agg<P> before = identity<P>();
  for (int base = tile - 1;; base -= 32) {
    const int t = base - lane;
    int st = kPrefix;
    do {
      if (t >= 0) st = status[t];
    } while (__any_sync(kFull, st == kNone));
    __threadfence();
    const unsigned done = __ballot_sync(kFull, st == kPrefix);
    const int stop = done ? __ffs(done) - 1 : 31;
    Agg<P> x = identity<P>();
    if (lane <= stop && t >= 0)
      x = load_l2(st == kPrefix ? &prefs[t] : &aggs[t]);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Agg<P> y = shfl_down(x, off);
      if (lane + off < 32) x = combine(y, x, kind);
    }
    before = combine(x, before, kind);
    if (done) break;
  }
  return before;
}

// counter: tile counter; status: one word a tile (kNone on entry);
// aggs / prefs: each tile's own state and its inclusive prefix.  Each
// thread holds its kItems rows' flags as bits, and each pair's values
// stay in its stage, across the look-back, so every lane is read once.
template <int P>
__global__ void __launch_bounds__(kThreads, P <= 2 ? 3 : 2)
segment_scan_kernel(ScanArgs args, unsigned int* counter, int* status,
                    Agg<P>* aggs, Agg<P>* prefs) {
  using S = ScanShape<P>;
  constexpr int I = S::kItems;
  extern __shared__ unsigned long long s_stage[];  // S::kSmem bytes
  __shared__ Agg<P> s_warp[kWarps];
  __shared__ Agg<P> s_before;
  __shared__ int s_tile;
  int* s_stage32 = reinterpret_cast<int*>(s_stage);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  const int tile = s_tile;
  const int n = args.n;
  int kind[P > 0 ? P : 1];
#pragma unroll
  for (int p = 0; p < P; ++p) kind[p] = args.pairs[p].kind;
  const long long tile_first = (long long)tile * S::kTile;
  const int tile_rows = static_cast<int>(
      n - tile_first < S::kTile ? n - tile_first : (long long)S::kTile);
  const long long first = tile_first + (long long)tid * I;
  const int mine = tile_rows - tid * I;
  const int rows = mine >= I ? I : (mine > 0 ? mine : 0);

  // this thread's rows: flags and valid bits, values, the folded state
  const unsigned seg_bits =
      rows ? load_bits<I>(args.new_seg, first, rows) : 0;
  const unsigned run_bits =
      rows && args.new_run ? load_bits<I>(args.new_run, first, rows) : 0;
  unsigned valid_bits[P > 0 ? P : 1];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    valid_bits[p] =
        rows ? load_bits<I>(args.pairs[p].valid, first, rows) : 0;
    if (kind[p] != kCountOnly)
      stage_in<S>(args.pairs[p].value, tile_first, tile_rows,
                  s_stage + p * S::kStage);
  }
  __syncthreads();
  // row k's value of pair p (0 for a count-only pair)
  auto value = [&](int p, int k) -> unsigned long long {
    return kind[p] == kCountOnly
               ? 0ull
               : s_stage[p * S::kStage + S::at(tid * I + k)];
  };
  Agg<P> a = identity<P>();
#pragma unroll
  for (int k = 0; k < I; ++k) {
    if (k >= rows) break;
    const bool s = (seg_bits >> k) & 1u;
    if (s) {
      a.seg_start = static_cast<int>(first + k);
      a.flag = 1;
    }
    if ((run_bits >> k) & 1u) {
      a.run_start = static_cast<int>(first + k);
      a.runs += 1;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (s) {
        a.sum[p] = 0;
        a.count[p] = 0;
      }
      if ((valid_bits[p] >> k) & 1u) {
        a.count[p] += 1;
        a.sum[p] = add(kind[p], a.sum[p], value(p, k));
      }
    }
  }

  // the warp's inclusive scan, then each warp's total
  Agg<P> incl = a;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Agg<P> y = shfl_up(incl, off);
    if (lane >= off) incl = combine(y, incl, kind);
  }
  Agg<P> before_me = shfl_up(incl, 1);
  if (lane == 0) before_me = identity<P>();
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  Agg<P> warp_before = identity<P>();
  for (int w = 0; w < warp; ++w)
    warp_before = combine(warp_before, s_warp[w], kind);

  if (warp == 0) {
    Agg<P> tile_agg = identity<P>();
    for (int w = 0; w < kWarps; ++w)
      tile_agg = combine(tile_agg, s_warp[w], kind);
    volatile int* vstatus = status;
    Agg<P> before = identity<P>();
    if (tile == 0) {
      if (lane == 0) {
        store_l2(&prefs[0], tile_agg);
        __threadfence();
        vstatus[0] = kPrefix;
      }
    } else {
      if (lane == 0) {
        store_l2(&aggs[tile], tile_agg);
        __threadfence();
        vstatus[tile] = kAggregate;
      }
      before = look_back(tile, vstatus, aggs, prefs, kind);
      if (lane == 0) {
        store_l2(&prefs[tile], combine(before, tile_agg, kind));
        __threadfence();
        vstatus[tile] = kPrefix;
      }
    }
    if (lane == 0) s_before = before;
  }
  __syncthreads();

  // each output in turn: this thread's rows from its starting state into
  // a stage, then the stage out (every branch is the same for the whole
  // block).  The sums go first, each over its pair's values in place
  // (each thread in its own slots); then stage 0 takes the rest.
  const Agg<P> start =
      combine(s_before, combine(warp_before, before_me, kind), kind);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (!args.pairs[p].sum) continue;
    unsigned long long c = start.sum[p];
    unsigned long long* stage = s_stage + p * S::kStage;
#pragma unroll
    for (int k = 0; k < I; ++k) {
      if (k < rows) {
        if ((seg_bits >> k) & 1u) c = 0;
        if ((valid_bits[p] >> k) & 1u) c = add(kind[p], c, value(p, k));
        stage[S::at(tid * I + k)] = c;
      }
    }
    __syncthreads();
    stage_out<S>(args.pairs[p].sum, tile_first, tile_rows, stage);
    __syncthreads();
  }
  auto put = [&](int* dst) {
    __syncthreads();
    stage_out<S>(dst, tile_first, tile_rows, s_stage32);
    __syncthreads();
  };
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (!args.pairs[p].count) continue;
    int c = start.count[p];
#pragma unroll
    for (int k = 0; k < I; ++k) {
      if (k < rows) {
        if ((seg_bits >> k) & 1u) c = 0;
        if ((valid_bits[p] >> k) & 1u) c += 1;
        s_stage32[S::at(tid * I + k)] = c;
      }
    }
    put(args.pairs[p].count);
  }
  auto positions = [&](int* dst, unsigned bits, int init, bool count) {
    int c = init;
#pragma unroll
    for (int k = 0; k < I; ++k) {
      if (k < rows) {
        if ((bits >> k) & 1u) c = count ? c + 1 : static_cast<int>(first + k);
        s_stage32[S::at(tid * I + k)] = c;
      }
    }
    put(dst);
  };
  if (args.seg_start)
    positions(args.seg_start, seg_bits, start.seg_start, false);
  if (args.run_start)
    positions(args.run_start, run_bits, start.run_start, false);
  if (args.runs_cum) positions(args.runs_cum, run_bits, start.runs, true);
}

// ---------------------------------------------------------------------------
// K12
// ---------------------------------------------------------------------------

constexpr unsigned long long kMask31 = (1ull << 31) - 1;

__device__ __forceinline__ unsigned long long pack(unsigned long long status,
                                                   int seg, int run) {
  return (status << 62) |
         ((static_cast<unsigned long long>(seg) & kMask31) << 31) |
         (static_cast<unsigned long long>(run) & kMask31);
}

// state: a tile counter (word 0), then one word a tile, all zero on entry.
__global__ void __launch_bounds__(kThreads)
run_ends_kernel(const unsigned char* __restrict__ new_seg,
                const unsigned char* __restrict__ new_run, int n,
                int n_live, int* __restrict__ seg_end,
                int* __restrict__ run_end, unsigned long long* state) {
  __shared__ int s_seg[kWarps], s_run[kWarps];
  __shared__ int s_after_seg, s_after_run;
  __shared__ int s_tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = static_cast<int>(atomicAdd(state, 1ull));
  __syncthreads();
  const int tile = s_tile;
  volatile unsigned long long* status = state + 1;
  // tile 0 is the array's last tile of kTile rows, so a thread's rows
  // start 8-aligned
  const long long first = (long long)(gridDim.x - 1 - tile) * kTile +
                          (long long)tid * kItems;
  const int rows = static_cast<int>(
      n - first >= kItems ? kItems : (n > first ? n - first : 0));

  // the ends among this thread's rows (bit k: row first + k ends its
  // partition or run), and the nearest one
  unsigned live_bits = 0, last_bit = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (first + k < n_live) live_bits |= 1u << k;
    if (first + k + 1 == n_live) last_bit = 1u << k;
  }
  auto ends = [&](const unsigned char* flags) -> unsigned {
    if (!flags || !rows) return 0u;
    unsigned next = load_bits<kItems>(flags, first, rows) >> 1;
    if (rows == kItems && first + kItems < n && flags[first + kItems])
      next |= 1u << (kItems - 1);
    return (next | last_bit) & live_bits;
  };
  const unsigned seg_bits = ends(new_seg);
  const unsigned run_bits = ends(new_run);
  const int mseg =
      seg_bits ? static_cast<int>(first) + __ffs(seg_bits) - 1 : INT_MAX;
  const int mrun =
      run_bits ? static_cast<int>(first) + __ffs(run_bits) - 1 : INT_MAX;

  // the warp's suffix minimum (later rows are in higher lanes)
  int sseg = mseg, srun = mrun;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ys = __shfl_down_sync(kFull, sseg, off);
    const int yr = __shfl_down_sync(kFull, srun, off);
    if (lane + off < 32) {
      sseg = min(sseg, ys);
      srun = min(srun, yr);
    }
  }
  int after_seg = __shfl_down_sync(kFull, sseg, 1);
  int after_run = __shfl_down_sync(kFull, srun, 1);
  if (lane == 31) {
    after_seg = INT_MAX;
    after_run = INT_MAX;
  }
  if (lane == 0) {
    s_seg[warp] = sseg;
    s_run[warp] = srun;
  }
  __syncthreads();
  for (int w = warp + 1; w < kWarps; ++w) {
    after_seg = min(after_seg, s_seg[w]);
    after_run = min(after_run, s_run[w]);
  }

  if (warp == 0) {
    int tile_seg = INT_MAX, tile_run = INT_MAX;
    for (int w = 0; w < kWarps; ++w) {
      tile_seg = min(tile_seg, s_seg[w]);
      tile_run = min(tile_run, s_run[w]);
    }
    int bseg = INT_MAX, brun = INT_MAX;
    if (tile == 0) {
      if (lane == 0) status[0] = pack(2, tile_seg, tile_run);
    } else {
      if (lane == 0) status[tile] = pack(1, tile_seg, tile_run);
      for (int base = tile - 1;; base -= 32) {
        const int t = base - lane;
        unsigned long long s = 2ull << 62 | pack(0, INT_MAX, INT_MAX);
        do {
          if (t >= 0) s = status[t];
        } while (__any_sync(kFull, (s >> 62) == 0));
        const unsigned done = __ballot_sync(kFull, (s >> 62) == 2);
        const int stop = done ? __ffs(done) - 1 : 31;
        int vs = lane <= stop ? static_cast<int>((s >> 31) & kMask31)
                              : INT_MAX;
        int vr = lane <= stop ? static_cast<int>(s & kMask31) : INT_MAX;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          vs = min(vs, __shfl_xor_sync(kFull, vs, off));
          vr = min(vr, __shfl_xor_sync(kFull, vr, off));
        }
        bseg = min(bseg, vs);
        brun = min(brun, vr);
        if (done) break;
      }
      if (lane == 0)
        status[tile] = pack(2, min(bseg, tile_seg), min(brun, tile_run));
    }
    if (lane == 0) {
      s_after_seg = bseg;
      s_after_run = brun;
    }
  }
  __syncthreads();

  if (!rows) return;
  int cseg = min(s_after_seg, after_seg);
  int crun = min(s_after_run, after_run);
  const int cap = n_live - 1;
  int seg_out[kItems], run_out[kItems];
#pragma unroll
  for (int k = kItems - 1; k >= 0; --k) {
    if ((seg_bits >> k) & 1u) cseg = static_cast<int>(first) + k;
    if ((run_bits >> k) & 1u) crun = static_cast<int>(first) + k;
    seg_out[k] = max(min(cseg, cap), 0);
    run_out[k] = max(min(crun, cap), 0);
  }
  if (seg_end) store_ints(seg_end, first, rows, seg_out);
  if (run_end) store_ints(run_end, first, rows, run_out);
}

int tiles_of(int n) {
  return static_cast<int>(((long long)n + kTile - 1) / kTile);
}

// scratch layout: the tile counter (16 B), a status word a tile, then
// each tile's state and inclusive prefix
size_t status_offset() { return 16; }
size_t aggs_offset(int tiles) {
  return (status_offset() + 4 * (size_t)tiles + 15) / 16 * 16;
}

template <int P>
int launch_scan(const ScanArgs& args, void* scratch, cudaStream_t stream) {
  using S = ScanShape<P>;
  const int tiles =
      static_cast<int>(((long long)args.n + S::kTile - 1) / S::kTile);
  const cudaError_t err = cudaFuncSetAttribute(
      segment_scan_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  char* base = static_cast<char*>(scratch);
  unsigned int* counter = reinterpret_cast<unsigned int*>(base);
  int* status = reinterpret_cast<int*>(base + status_offset());
  Agg<P>* aggs = reinterpret_cast<Agg<P>*>(base + aggs_offset(tiles));
  Agg<P>* prefs = aggs + tiles;
  segment_scan_kernel<P><<<tiles, kThreads, S::kSmem, stream>>>(
      args, counter, status, aggs, prefs);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<size_t>(p) % bytes == 0;
}

}  // namespace

// Enough for any pair count: the most tiles (the narrowest) of the widest
// state.
extern "C" int srt_segment_scan_scratch_bytes(int n) {
  const int tiles = static_cast<int>(
      ((long long)(n < 1 ? 1 : n) + kScanMinTile - 1) / kScanMinTile);
  return static_cast<int>(aggs_offset(tiles) +
                          2 * sizeof(Agg<kMaxPairs>) * tiles);
}

// new_seg, new_run: bool[n] (new_run may be null when run_start and
// runs_cum are); seg_start, run_start, runs_cum: int32[n] out or null;
// per pair p < npairs: values[p] int64 / float64 [n] or null (kinds[p] 1,
// 2, or 0 for a count only), valids[p] bool[n], sums[p] [n] out or null,
// counts[p] int32[n] out or null; scratch: the bytes
// srt_segment_scan_scratch_bytes(n) gives, zeroed; n >= 1.  Every lane
// is 16-byte aligned.
extern "C" int srt_segment_scan(const unsigned char* new_seg,
                                const unsigned char* new_run, int n,
                                int* seg_start, int* run_start,
                                int* runs_cum, int npairs,
                                const void* const* values, const int* kinds,
                                const void* const* valids,
                                void* const* sums, void* const* counts,
                                void* scratch, cudaStream_t stream) {
  if (n < 1 || npairs < 0 || npairs > kMaxPairs ||
      ((run_start || runs_cum) && new_run == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  bool ok = aligned(new_seg, 16) && aligned(new_run, 16) &&
            aligned(seg_start, 16) && aligned(run_start, 16) &&
            aligned(runs_cum, 16);
  ScanArgs args;
  args.new_seg = new_seg;
  args.new_run = new_run;
  args.n = n;
  args.seg_start = seg_start;
  args.run_start = run_start;
  args.runs_cum = runs_cum;
  args.npairs = npairs;
  for (int p = 0; p < kMaxPairs; ++p) {
    Pair& q = args.pairs[p];
    q.value = nullptr;
    q.valid = nullptr;
    q.sum = nullptr;
    q.count = nullptr;
    q.kind = kCountOnly;
    if (p >= npairs) continue;
    if (kinds[p] < kCountOnly || kinds[p] > kFloat64 ||
        valids[p] == nullptr ||
        (kinds[p] != kCountOnly && values[p] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    q.value = static_cast<const unsigned long long*>(values[p]);
    q.valid = static_cast<const unsigned char*>(valids[p]);
    q.sum = kinds[p] == kCountOnly
                ? nullptr
                : static_cast<unsigned long long*>(sums[p]);
    q.count = static_cast<int*>(counts[p]);
    q.kind = kinds[p];
    ok = ok && aligned(q.value, 16) && aligned(q.valid, 16) &&
         aligned(q.sum, 16) && aligned(q.count, 16);
  }
  if (!ok) return static_cast<int>(cudaErrorMisalignedAddress);
  switch (npairs) {
    case 0: return launch_scan<0>(args, scratch, stream);
    case 1: return launch_scan<1>(args, scratch, stream);
    case 2: return launch_scan<2>(args, scratch, stream);
    case 3: return launch_scan<3>(args, scratch, stream);
    default: return launch_scan<4>(args, scratch, stream);
  }
}

// new_seg, new_run: bool[n] or null; seg_end, run_end: int32[n] out, null
// where its flags are; state: 1 + tiles zeroed words; 0 <= n_live <= n,
// n >= 1.
extern "C" int srt_run_ends(const unsigned char* new_seg,
                            const unsigned char* new_run, int n, int n_live,
                            int* seg_end, int* run_end,
                            unsigned long long* state, cudaStream_t stream) {
  if (n < 1 || n_live < 0 || n_live > n ||
      (new_seg == nullptr && new_run == nullptr) ||
      (seg_end != nullptr && new_seg == nullptr) ||
      (run_end != nullptr && new_run == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(new_seg, 8) || !aligned(new_run, 8) || !aligned(seg_end, 16) ||
      !aligned(run_end, 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  run_ends_kernel<<<tiles_of(n), kThreads, 0, stream>>>(
      new_seg, new_run, n, n_live, seg_end, run_end, state);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kTile; }

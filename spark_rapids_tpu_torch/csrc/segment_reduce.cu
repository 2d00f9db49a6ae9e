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
// The ops are folded in sets of up to kOpsPerLaunch, all ops of a set in
// one pass over the rows, and each input is read once a row however many
// ops read it: the host (exec/aggregate.py k3_plan) hands each set its
// distinct value lanes and contributor masks, distinct by storage, and
// each op the index of its lane and mask.  Two paths, chosen by the host
// from sizes alone:
//   - the record path: pack_kernel writes each input row's lanes of the
//     set (its distinct value lanes, in the first set the varying key
//     words where there are at most 7, and one mask word holding each
//     distinct contributor mask and the live flag as a bit) into a
//     record of R = 16, 32, 64 or 128 bytes, read and written coalesced;
//     the fold then copies one record a row through the order straight
//     into shared memory (cp.async, R / 16 neighbouring threads a
//     record: one random request a sector).  A tile holds 64 KB of
//     records, 256 x K rows with K = 256 / R rows a thread, so three
//     blocks share an SM;
//   - the direct path: each distinct input read at the sorted rows'
//     input rows, 8 rows a thread: for rows already in key order, a
//     count-only fold, and inputs that fit in the L2 cache, where the
//     records would move more bytes.
// Launches, for each set of ops:
//   1. varying_kernel (once, before the first set): which key words are
//      not the same in every row, read in input order; a constant word
//      (the null word of a key with no nulls) can start no group and is
//      neither packed nor compared.  It also counts the order's descents
//      up to 64.  The host reads these once where the record path may
//      pay, to lay out the record; an order of a few increasing runs (a
//      few groups: K2's order is stable) keeps the direct path, whose
//      reads then stream.
//   2. pack_kernel (record path).
//   3. fold_kernel: in the first set a row starts a group if it is live
//      and is the first row or differs from the previous sorted row in a
//      varying word; the tile's start count goes through a decoupled
//      look-back over the earlier tiles (a status word a tile, tiles
//      numbered in the order the blocks start, so a tile waits only on
//      running ones) to the tile's first group slot, and the start bits
//      are kept for the later sets.  Then every op of the set: each
//      thread folds its K rows serially, a warp-wide segmented scan
//      (shuffles) closes the groups whose start lies in the same warp,
//      and what each warp leaves open waits in shared memory; after one
//      barrier for all the ops, the warps' folds join in a fixed order.
//      A group that opens and closes inside the tile is written to its
//      slot; the tile's open head segment (a group begun in an earlier
//      tile) and open tail segment go to per-tile partials.
//   4. fixup_kernel: one block per tile that holds a start finishes the
//      group begun at that tile's last start: its tail partial, then the
//      head partials of the following tiles up to and including the next
//      tile with a start, folded by a fixed tree (one warp when they are
//      at most 32).
// The op's kind is a warp-uniform switch inside the one fold launch.
//
// Min and max (kinds 3-6) replace the reference's ops/segmented.py
// segment_reduce(xp, "min"|"max") on its jax branch (_argext_rows over
// _ordered_words32): per group, the row of the extreme ordered word
// among the contributing rows, the earliest in sorted order on a tie,
// and that row's value bit for bit (so -0.0 stays -0.0).  An int64 lane
// is its own word; a float64 lane's word is Spark's total order of
// encode_float_ordered (-0.0 equals 0.0, NaN canonical and greatest).
// The fold state is (the kept value's bits, its ordered word, its sorted
// position): a row's word is computed once, when the row is folded, and
// two states combine by word, then by position, which is associative and
// commutative, so the fold, the head/tail partials and the fixup tree
// carry it as they carry the sums, and the result is the same bits on
// every run.  Max compares the other way; there is no inverted lane.
// So every thread folds K rows whatever the key skew: a hot key that
// holds 10M rows spans thousands of tiles and costs a tree over their
// partials in step 4, not a 10M-row loop on one thread.  No float
// atomics: every combination order is fixed by the sorted layout and the
// tile shape, so a result is the same bits from run to run, which the
// aggregate's stable_merge determinism relies on.
//
// Bound: device-memory bytes.  Least traffic is order (4 B/row), each
// key word (8 B/row), the live flags where given (1 B/row), each
// distinct value lane and contributor mask once, and the per-group
// outputs written once, over 3.35 TB/s.  A read through the order moves
// a whole 32-byte sector: the direct path pays one a row for each input,
// the record path one (two at 64 bytes) a row for the record, plus the
// pack's coalesced read of the inputs and write of the records.  Such
// reads are bound by their count of sectors, so a 64-byte record (two
// sectors) costs about twice a 32-byte one.

#include "partition.cuh"

namespace {

constexpr int kThreads = srt::kThreads;      // 256
constexpr int kWarps = srt::kWarps;
constexpr int kOpsPerLaunch = 16;            // ops, lanes and masks a set
constexpr int kMaxKeys = 15;                 // varying words in a record
constexpr int kDirectRows = 8;               // rows a thread, direct path
constexpr int kStage = 65536;                // a record tile's records
constexpr int kCount = 0;
constexpr int kSumInt = 1;
constexpr int kSumFloat = 2;
constexpr int kMinInt = 3;
constexpr int kMaxInt = 4;
constexpr int kMinFloat = 5;
constexpr int kMaxFloat = 6;
constexpr unsigned kPosInf = 1, kNegInf = 2, kNaN = 4;
constexpr unsigned kLiveBit = 1u << 31;      // in a record's mask word
constexpr unsigned long long kReady = 1ull << 62, kDone = 2ull << 62;
constexpr unsigned long long kCountBits = (1ull << 62) - 1;

// The key words: a device array of count pointers, so a key of any
// width fits one launch (the direct path reads them where they vary).
struct Words {
  const long long* const* w;
  int count;
};

// One set of ops and its distinct inputs.
struct Set {
  int count;                               // ops
  int kind[kOpsPerLaunch];
  int lane[kOpsPerLaunch];                 // index into lanes, -1: count
  int mask[kOpsPerLaunch];                 // index into masks
  void* sums[kOpsPerLaunch];
  long long* counts[kOpsPerLaunch];
  int nlanes;
  const long long* lanes[kOpsPerLaunch];   // int64 or float64 bits
  int lane_off[kOpsPerLaunch];             // byte offset in a record
  int nmasks;
  const unsigned char* masks[kOpsPerLaunch];
  int mask_off;                            // the mask word's byte offset
};

// What starts a group (the first set only).
struct Keys {
  Words words;                             // direct path
  const int* varying;                      // direct path: [words.count]
  int count;                               // record path: varying words
  const long long* w[kMaxKeys];
  int off[kMaxKeys];                       // byte offset in a record
  const unsigned char* live;               // or null
};

__host__ __device__ constexpr bool is_extreme(int kind) {
  return kind >= kMinInt;
}

// A fold of some rows of one op: wrapping int sum, finite float sum,
// contributor count, and which of +inf / -inf / NaN contributed.  For
// min/max: the kept value's bits (i), its ordered word (f's bits) and
// its sorted position (flags).  Also the layout of a per-tile partial.
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

__device__ __forceinline__ long long word_of(const Acc& a) {
  return __double_as_longlong(a.f);
}

// Whether word wb at position pb is kept over wa at pa: the extreme
// word, then the earlier sorted position.
template <int KIND>
__device__ __forceinline__ bool keeps(long long wb, unsigned pb, long long wa,
                                      unsigned pa) {
  if (wb != wa)
    return (KIND == kMinInt || KIND == kMinFloat) ? wb < wa : wb > wa;
  return pb < pa;
}

// a then b: a holds the earlier rows
template <int KIND>
__device__ __forceinline__ Acc combine(const Acc& a, const Acc& b) {
  if (is_extreme(KIND)) {
    const bool take_b =
        b.n > 0 && (a.n == 0 ||
                    keeps<KIND>(word_of(b), b.flags, word_of(a), a.flags));
    return take_b ? Acc{b.i, b.f, a.n + b.n, b.flags}
                  : Acc{a.i, a.f, a.n + b.n, a.flags};
  }
  return Acc{a.i + b.i, a.f + b.f, a.n + b.n, a.flags | b.flags};
}

// One row at sorted position pos, after every row already in a: c says
// whether it contributes, bits are its value's 64 bits.
template <int KIND>
__device__ __forceinline__ void add_row(Acc& a, bool c, long long bits,
                                        unsigned pos) {
  if (is_extreme(KIND)) {
    if (c) {
      const long long w = ordered_word<KIND>(bits);
      if (a.n == 0 || keeps<KIND>(w, pos, word_of(a), a.flags)) {
        a.i = static_cast<unsigned long long>(bits);
        a.f = __longlong_as_double(w);
        a.flags = pos;
      }
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

__device__ __forceinline__ void write_group(const Set& s, int kind, int k,
                                            int g, const Acc& a) {
  s.counts[k][g] = a.n;
  if (is_extreme(kind)) {
    // no contributor: null, canonical zero under it
    static_cast<long long*>(s.sums[k])[g] =
        a.n > 0 ? static_cast<long long>(a.i) : 0ll;
  } else if (kind == kSumInt) {
    static_cast<long long*>(s.sums[k])[g] = static_cast<long long>(a.i);
  } else if (kind == kSumFloat) {
    double x = a.f;
    if (a.n == 0)
      x = 0.0;
    else if ((a.flags & kNaN) || (a.flags & (kPosInf | kNegInf)) ==
                                     (kPosInf | kNegInf))
      x = __longlong_as_double(0x7ff8000000000000ll);
    else if (a.flags & kPosInf)
      x = __longlong_as_double(0x7ff0000000000000ll);
    else if (a.flags & kNegInf)
      x = __longlong_as_double(static_cast<long long>(0xfff0000000000000ull));
    static_cast<double*>(s.sums[k])[g] = x;
  }
}

// Inside a tile a count fits 32 bits, and each kind moves only the
// fields it folds.
template <int KIND>
__device__ __forceinline__ Acc shfl_up(const Acc& a, int off) {
  Acc r = zero_acc();
  if (KIND == kSumInt || is_extreme(KIND))
    r.i = __shfl_up_sync(0xffffffffu, a.i, off);
  if (KIND == kSumFloat || is_extreme(KIND)) {
    r.f = __shfl_up_sync(0xffffffffu, a.f, off);
    r.flags = __shfl_up_sync(0xffffffffu, a.flags, off);
  }
  r.n = __shfl_up_sync(0xffffffffu, static_cast<int>(a.n), off);
  return r;
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

// What a warp leaves of one op for the end of the tile: its inclusive
// fold, and the group open at its first starting thread, which needs the
// earlier warps (its warp-exclusive prefix, then that thread's first
// run) with where it goes: a group slot, -1 the tile's head partial, -2
// nothing (no thread of the warp starts a group).
struct Defer {
  Seg tot[kWarps];
  Acc open[kWarps];
  int slot[kWarps];
};

// Block-wide count of set start bits before this thread (exclusive);
// *total gets the block's count.
__device__ int block_exclusive_sum(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int in = srt::warp_inclusive_scan(v);
  if (lane == 31) s_warp[w] = in;
  __syncthreads();
  int pre = 0, all = 0;
  for (int q = 0; q < kWarps; ++q) {
    pre += q < w ? s_warp[q] : 0;
    all += s_warp[q];
  }
  __syncthreads();
  *total = all;
  return pre + in - v;
}

// varying[k] = 1 if key word k is not the same in every row (varying is
// zeroed first).  Its rows are read in input order, coalesced, two
// words a load where the word is 16-byte aligned; a thread stops at a
// difference, or once another has found one, so a word that varies
// costs a few reads and a constant one a full pass.  With an order,
// varying[words.count] counts its descents (order[i + 1] < order[i]),
// up to past kFewRuns: K2's order is stable, so a call with few groups
// reads its rows in a few increasing runs.
constexpr int kFewRuns = 64;

__global__ void __launch_bounds__(kThreads)
varying_kernel(Words words, const int* order, int n, int* varying) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  volatile int* seen = varying;
  for (int k = 0; k < words.count; ++k) {
    if (seen[k]) continue;
    const long long* w = words.w[k];
    const long long w0 = w[0];
    bool differs = false;
    int it = 0;
    long long done = 0;       // rows the paired loop covers
    if (reinterpret_cast<size_t>(w) % 16 == 0) {
      // four loads in flight a thread, then a look at the flag
      const longlong2* w2 = reinterpret_cast<const longlong2*>(w);
      const long long pairs = n / 2;
      done = pairs * 2;
      for (long long i = first; i < pairs && !differs; i += 4 * stride) {
        longlong2 x[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          x[u] = i + u * stride < pairs ? __ldg(w2 + i + u * stride)
                                        : make_longlong2(w0, w0);
#pragma unroll
        for (int u = 0; u < 4; ++u) differs |= (x[u].x != w0) | (x[u].y != w0);
        if ((++it & 3) == 0 && seen[k]) break;
      }
    }
    for (long long i = done + first; i < n && !differs; i += stride)
      differs |= w[i] != w0;
    if (differs) seen[k] = 1;
  }
  if (!order) return;
  int* runs = varying + words.count;
  volatile int* vruns = runs;
  // one atomic a warp's count, so the counter takes few of them
  auto add = [&](int mine) {
    const unsigned act = __activemask();
    const int sum = __reduce_add_sync(act, mine);
    if (sum && (threadIdx.x & 31) == __ffs(act) - 1) atomicAdd(runs, sum);
  };
  int mine = 0, it = 0;
  for (long long i = first; i + 1 < n; i += stride) {
    mine += __ldg(order + i + 1) < __ldg(order + i) ? 1 : 0;
    if ((++it & 3) == 0) {
      add(mine);
      mine = 0;
      if (*vruns > kFewRuns) return;
    }
  }
  add(mine);
}

// Records of R bytes, two input rows a thread (rows tid and tid + 256 of
// a block's 512), every load of both issued before any store: the lanes
// (8 bytes each from offset 0), the varying key words after them (first
// set) and the mask word after those, each read coalesced, then written
// as R / 16 16-byte stores a row, which the L2 cache joins into whole
// sectors.  Bytes a record does not use are zero.
constexpr int kPackRows = 2;

template <int R>
__global__ void __launch_bounds__(kThreads)
pack_kernel(int n, Set s, Keys keys, int with_keys,
            uint4* __restrict__ records) {
  constexpr int kSlots = R / 8;
  const long long base =
      (long long)blockIdx.x * kThreads * kPackRows + threadIdx.x;
  const int nk = with_keys ? keys.count : 0;
  unsigned long long slot[kPackRows][kSlots];
  unsigned m[kPackRows];
#pragma unroll
  for (int h = 0; h < kPackRows; ++h) {
    const long long row = base + h * kThreads;
    const bool in = row < n;
    m[h] = 0;
#pragma unroll
    for (int q = 0; q < kOpsPerLaunch; ++q)
      m[h] |= in && q < s.nmasks && __ldg(s.masks[q] + row) ? (1u << q) : 0u;
    if (in && with_keys && keys.live && __ldg(keys.live + row))
      m[h] |= kLiveBit;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const long long* src = j < s.nlanes ? s.lanes[j]
                             : j < s.nlanes + nk ? keys.w[j - s.nlanes]
                                                 : nullptr;
      slot[h][j] = in && src ? static_cast<unsigned long long>(
                                   __ldg(src + row))
                             : 0ull;
    }
  }
#pragma unroll
  for (int h = 0; h < kPackRows; ++h) {
    const long long row = base + h * kThreads;
    if (row >= n) continue;
    uint4* out = records + row * (R / 16);
#pragma unroll
    for (int c = 0; c < R / 16; ++c) {
      unsigned long long lo = slot[h][2 * c], hi = slot[h][2 * c + 1];
      if (2 * c == s.nlanes + nk) lo = m[h];
      if (2 * c + 1 == s.nlanes + nk) hi = m[h];
      out[c] = make_uint4(static_cast<unsigned>(lo),
                          static_cast<unsigned>(lo >> 32),
                          static_cast<unsigned>(hi),
                          static_cast<unsigned>(hi >> 32));
    }
  }
}

// A record tile in shared memory: thread t's K consecutive rows from
// byte t * (K * R + 16), 16-byte aligned for the asynchronous copies.
template <int K>
__device__ __forceinline__ int rec_at(int r, int R) {
  return (r / K) * (K * R + 16) + (r % K) * R;
}

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Shared copy of a direct tile's input rows, padded one int in 32 so
// that a thread's consecutive rows sit in distinct banks.
constexpr int kDirectTile = kThreads * kDirectRows;
constexpr int kPaddedTile = kDirectTile + kDirectTile / 32;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// Per thread: its rows in the tile and the group slots they write.
struct View {
  long long first;      // sorted position of the thread's first row
  unsigned valid;       // bit j: row first + j < n
  unsigned mask;        // bit j: row first + j starts a group
  int before;           // starts in the tile before this thread's
  int slot0;            // slot of this thread's first start
  long long part;       // this tile's partials: part + op
};

// The values of one lane for a thread's rows: on the direct path held in
// registers, on the record path read from the staged records.
struct RegValues {
  const long long* v;
  __device__ __forceinline__ long long operator()(int j) const {
    return v[j];
  }
};

struct RecValues {
  const unsigned char* at;   // the thread's first row, at the lane
  int R;
  __device__ __forceinline__ long long operator()(int j) const {
    return *reinterpret_cast<const long long*>(at + j * R);
  }
};

// Op k over the thread's rows: the groups that open and close among
// them are written; a warp-wide segmented scan (shuffles, no barrier)
// closes the group open at each thread's first start where an earlier
// thread of the warp holds a start, and leaves the rest to finish_op.
template <int KIND, int K, class Values>
__device__ void fold_op(const Set& s, int k, Values vals, unsigned c,
                        const View& v, Defer* d) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  c &= v.valid;
  Acc first_run = zero_acc(), run = zero_acc();
  int seen = 0;
  const unsigned pos0 = static_cast<unsigned>(v.first);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if ((v.mask >> j) & 1u) {
      if (seen == 0)
        first_run = run;
      else
        write_group(s, KIND, k, v.slot0 + seen - 1, run);
      ++seen;
      run = zero_acc();
    }
    add_row<KIND>(run, (c >> j) & 1u, KIND == kCount ? 0ll : vals(j),
                  pos0 + j);
  }
  Seg in{run, seen > 0};
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Seg y{shfl_up<KIND>(in.a, off),
                __shfl_up_sync(0xffffffffu, in.start, off)};
    if (lane >= off) in = seg_op<KIND>(y, in);
  }
  Seg before{shfl_up<KIND>(in.a, 1),
             __shfl_up_sync(0xffffffffu, in.start, 1)};
  if (lane == 0) before = Seg{zero_acc(), 0};
  if (lane == 31) d->tot[w] = in;
  // the group open at this thread's first start closes there
  const bool first_in_warp = seen > 0 && !before.start;
  if (seen > 0) {
    const Acc a = combine<KIND>(before.a, first_run);
    if (!first_in_warp) {
      write_group(s, KIND, k, v.slot0 - 1, a);
    } else {
      d->open[w] = a;
      d->slot[w] = v.before > 0 ? v.slot0 - 1 : -1;
    }
  }
  const unsigned opens = __ballot_sync(0xffffffffu, first_in_warp);
  if (lane == 0 && !opens) d->slot[w] = -2;
}

// After every op's fold and one barrier: the groups each warp left open
// (item w < kWarps), and the tile's head or tail partial (item kWarps).
template <int KIND>
__device__ void finish_op(const Set& s, int k, int item, const Defer* d,
                          long long part, Acc* head, Acc* tail) {
  Seg pre{zero_acc(), 0};
  if (item < kWarps) {
    const int slot = d->slot[item];
    if (slot == -2) return;
    for (int q = item - 1; q >= 0 && !pre.start; --q)
      pre = seg_op<KIND>(d->tot[q], pre);
    const Acc a = combine<KIND>(pre.a, d->open[item]);
    if (slot >= 0)
      write_group(s, KIND, k, slot, a);
    else
      head[part + k] = a;
    return;
  }
  for (int q = kWarps - 1; q >= 0 && !pre.start; --q)
    pre = seg_op<KIND>(d->tot[q], pre);
  if (pre.start)
    tail[part + k] = pre.a;
  else
    head[part + k] = pre.a;
}

#define SRT_KINDS(kind, CALL)         \
  switch (kind) {                     \
    case kSumInt: CALL(kSumInt); break;     \
    case kSumFloat: CALL(kSumFloat); break; \
    case kMinInt: CALL(kMinInt); break;     \
    case kMaxInt: CALL(kMaxInt); break;     \
    case kMinFloat: CALL(kMinFloat); break; \
    case kMaxFloat: CALL(kMaxFloat); break; \
    default: CALL(kCount);                  \
  }

struct Scratch {
  unsigned long long* state;   // [0] the tile counter, [1 + t] tile t
  unsigned short* masks;       // start bits, [tiles][kThreads]
  int* tile_counts;
  int* tile_offsets;
  Acc* head;                   // [tiles][ops of the set]
  Acc* tail;
  const uint4* records;        // record path
};

// The tile's start count through the earlier tiles' status words (warp
// 0): a tile publishes its own count, then its inclusive prefix once it
// knows it; a reader polls the 32 nearest earlier tiles at a time until
// one has its prefix.  Returns the tile's first slot (lane 0).
__device__ int look_back(int tile, int count,
                         volatile unsigned long long* status) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) status[0] = kDone | static_cast<unsigned long long>(count);
    return 0;
  }
  if (lane == 0) status[tile] = kReady | static_cast<unsigned long long>(count);
  long long before = 0;
  for (int base = tile - 1;; base -= 32) {
    const int t = base - lane;
    unsigned long long st = kDone;
    do {
      if (t >= 0) st = status[t];
    } while (__any_sync(0xffffffffu, (st >> 62) == 0));
    const unsigned done = __ballot_sync(0xffffffffu, (st >> 62) == 2);
    const int stop = done ? __ffs(done) - 1 : 31;
    long long x = lane <= stop ? static_cast<long long>(st & kCountBits) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    before += x;
    if (done) break;
  }
  if (lane == 0)
    status[tile] = kDone | static_cast<unsigned long long>(before + count);
  return static_cast<int>(before);
}

// Dynamic shared memory of a fold block: the record path's records, or
// the direct path's input rows and mask bits; then a Defer an op.
__host__ __device__ constexpr int stage_bytes(int K, int R) {
  return R > 0 ? kThreads * (K * R + 16)
               : kPaddedTile * 4 + kOpsPerLaunch * kThreads * 2;
}

// The fold of one set over one tile of 256 x K sorted rows: REC reads
// the rows' records of R bytes (the record path), else the inputs
// themselves (the direct path, K = 8).  The first set also finds the
// starts, the tile's group slots (look-back), first_row and the group
// count.  One barrier joins every op's warps at the end of the tile.
template <int K, bool REC>
__global__ void __launch_bounds__(kThreads, 3)
fold_kernel(Set s, Keys keys, const int* __restrict__ order, int n,
            int global_agg, int first_set, int R, Scratch sc, int tiles,
            int* first_row, int* groups) {
  constexpr int T = kThreads * K;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile, s_slot;
  const int tid = threadIdx.x;
  if (tid == 0)
    s_tile = first_set ? static_cast<int>(atomicAdd(
                             reinterpret_cast<unsigned*>(sc.state), 1u))
                       : static_cast<int>(blockIdx.x);
  __syncthreads();
  const int tile = s_tile;
  const long long base = (long long)tile * T;
  Defer* defer = reinterpret_cast<Defer*>(s_dyn + stage_bytes(K, REC ? R : 0));
  View v;
  v.first = base + (long long)tid * K;
  {
    const long long left = n - v.first;
    const int rows = left <= 0 ? 0 : (left >= K ? K : static_cast<int>(left));
    v.valid = (1u << rows) - 1u;
  }

  // the tile's rows: records into shared memory, or input rows
  const unsigned char* my_rec = s_dyn + tid * (K * R + 16);
  int* s_rows = reinterpret_cast<int*>(s_dyn);
  int in_row[REC ? 1 : K];
  unsigned mw[REC ? K : 1];          // the record path's mask words
  if (REC) {
    // each record's R / 16 pieces by neighbouring threads, copied
    // straight into shared memory
    constexpr int kPieces = kStage / kThreads / 16;
    const int chunks = R / 16;
    const int pieces = T * chunks;
    long long src[kPieces];
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int q = u * kThreads + tid;
      const int r = q / chunks;
      src[u] = q < pieces && base + r < n
                   ? (order ? __ldg(order + base + r) : base + r) : -1;
    }
#pragma unroll
    for (int u = 0; u < kPieces; ++u) {
      const int q = u * kThreads + tid;
      const int r = q / chunks;
      if (src[u] >= 0)
        copy16(s_dyn + rec_at<K>(r, R) + 16 * (q - r * chunks),
               sc.records + src[u] * chunks + (q - r * chunks));
    }
    copy_wait();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K; ++j)
      mw[REC ? j : 0] = ((v.valid >> j) & 1u)
          ? *reinterpret_cast<const unsigned*>(my_rec + j * R + s.mask_off)
          : 0u;
  } else {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int i = r * kThreads + tid;
      if (base + i < n)
        s_rows[padded(i)] = order ? __ldg(order + base + i)
                                  : static_cast<int>(base + i);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < K; ++j)
      in_row[REC ? 0 : j] = ((v.valid >> j) & 1u)
                                ? s_rows[padded(tid * K + j)] : 0;
  }

  // the starts
  if (first_set) {
    unsigned m = 0;
    if (global_agg) {
      m = v.first == 0 ? (v.valid & 1u) : 0u;
    } else if (v.valid) {
      unsigned diff = v.first == 0 ? 1u : 0u;
      if (REC && keys.count == 0) {
        // more varying words than a record carries: each read through
        // the order, as the direct path reads them
        const long long prev =
            v.first > 0 ? (order ? __ldg(order + v.first - 1) : v.first - 1)
                        : 0;
        for (int k = 0; k < keys.words.count; ++k) {
          if (!keys.varying[k]) continue;
          const long long* w = keys.words.w[k];
          long long p = w[prev];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const long long r =
                (v.valid >> j) & 1u
                    ? (order ? __ldg(order + v.first + j) : v.first + j)
                    : 0;
            const long long c = w[r];
            diff |= (c != p) ? (1u << j) : 0u;
            p = c;
          }
        }
      } else if (REC) {
        for (int k = 0; k < keys.count; ++k) {
          const int off = keys.off[k];
          long long p = 0;
          if (v.first > 0) {
            if (tid > 0) {
              p = *reinterpret_cast<const long long*>(my_rec - 16 - R + off);
            } else {
              const long long src = order ? __ldg(order + v.first - 1)
                                          : v.first - 1;
              p = __ldg(reinterpret_cast<const long long*>(
                  reinterpret_cast<const unsigned char*>(sc.records) +
                  src * R + off));
            }
          }
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const long long c =
                *reinterpret_cast<const long long*>(my_rec + j * R + off);
            diff |= (c != p) ? (1u << j) : 0u;
            p = c;
          }
        }
      } else {
        int prev = 0;
        if (v.first > 0)
          prev = tid > 0 ? s_rows[padded(tid * K - 1)]
                         : (order ? __ldg(order + v.first - 1)
                                  : static_cast<int>(v.first - 1));
        for (int k = 0; k < keys.words.count; ++k) {
          if (!keys.varying[k]) continue;   // a constant word starts none
          const long long* w = keys.words.w[k];
          long long p = w[prev];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const long long c = w[in_row[REC ? 0 : j]];
            diff |= (c != p) ? (1u << j) : 0u;
            p = c;
          }
        }
      }
      unsigned lv = 0xffffffffu;
      if (keys.live) {
        lv = 0;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const bool live = REC ? (mw[REC ? j : 0] & kLiveBit) != 0
                                : keys.live[in_row[REC ? 0 : j]] != 0;
          lv |= live ? (1u << j) : 0u;
        }
      }
      m = diff & lv & v.valid;
    }
    v.mask = m;
    sc.masks[(long long)tile * kThreads + tid] = static_cast<unsigned short>(m);
  } else {
    v.mask = sc.masks[(long long)tile * kThreads + tid];
  }
  int count;
  v.before = block_exclusive_sum(__popc(v.mask), s_warp, &count);
  if (first_set) {
    if (tid < 32) {
      const int slot = look_back(tile, count, sc.state + 1);
      if (tid == 0) {
        s_slot = slot;
        sc.tile_counts[tile] = count;
        sc.tile_offsets[tile] = slot;
        if (tile == tiles - 1) *groups = slot + count;
      }
    }
    __syncthreads();
    v.slot0 = s_slot + v.before;
    int q = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if ((v.mask >> j) & 1u) {
        const int row = REC ? (order ? __ldg(order + v.first + j)
                                     : static_cast<int>(v.first + j))
                            : in_row[REC ? 0 : j];
        first_row[v.slot0 + q++] = row;
      }
    }
  } else {
    v.slot0 = sc.tile_offsets[tile] + v.before;
  }
  v.part = (long long)tile * s.count;

  // every op of the set, each input read once a row
  if (REC) {
    for (int k = 0; k < s.count; ++k) {
      unsigned c = 0;
      const int bit = s.mask[k];
#pragma unroll
      for (int j = 0; j < K; ++j) c |= ((mw[REC ? j : 0] >> bit) & 1u) << j;
      const RecValues vals{my_rec + (s.lane[k] >= 0 ? s.lane_off[s.lane[k]]
                                                    : 0), R};
#define SRT_FOLD(KIND) fold_op<KIND, K>(s, k, vals, c, v, defer + k)
      SRT_KINDS(s.kind[k], SRT_FOLD)
#undef SRT_FOLD
    }
  } else {
    unsigned short* s_bits = reinterpret_cast<unsigned short*>(
        s_dyn + kPaddedTile * sizeof(int));
    for (int q = 0; q < s.nmasks; ++q) {
      const unsigned char* mk = s.masks[q];
      unsigned c = 0;
#pragma unroll
      for (int j = 0; j < K; ++j)
        c |= mk[in_row[REC ? 0 : j]] ? (1u << j) : 0u;
      s_bits[q * kThreads + tid] = static_cast<unsigned short>(c);
    }
    for (int l = -1; l < s.nlanes; ++l) {
      long long x[K];
      const long long* lane = l >= 0 ? s.lanes[l] : nullptr;
#pragma unroll
      for (int j = 0; j < K; ++j)
        x[j] = lane ? lane[in_row[REC ? 0 : j]] : 0ll;
      const RegValues vals{x};
      for (int k = 0; k < s.count; ++k) {
        if (s.lane[k] != l) continue;
        const unsigned c = s_bits[s.mask[k] * kThreads + tid];
#define SRT_FOLD(KIND) fold_op<KIND, K>(s, k, vals, c, v, defer + k)
        SRT_KINDS(s.kind[k], SRT_FOLD)
#undef SRT_FOLD
      }
    }
  }
  __syncthreads();
  for (int item = tid; item < s.count * (kWarps + 1); item += kThreads) {
    const int k = item / (kWarps + 1);
#define SRT_FINISH(KIND) \
  finish_op<KIND>(s, k, item - k * (kWarps + 1), defer + k, v.part, \
                  sc.head, sc.tail)
    SRT_KINDS(s.kind[k], SRT_FINISH)
#undef SRT_FINISH
  }
}

// Op k of the group begun at tile t's last start: the tail partial,
// then the head partials of tiles [lo, hi) of each thread, joined by a
// warp tree (WIDE: then across the block's warps).
template <int KIND, bool WIDE>
__device__ void fixup_op(const Set& s, int k, int t, int slot, int lo,
                         int hi, const Acc* head, const Acc* tail,
                         Acc* s_warp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  Acc a = zero_acc();
  for (int u = lo; u < hi; ++u)
    a = combine<KIND>(a, head[(long long)u * s.count + k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Acc b = shfl_down(a, off);
    if (lane + off < 32) a = combine<KIND>(a, b);
  }
  if (!WIDE) {
    if (lane == 0)
      write_group(s, s.kind[k], k, slot,
                  combine<KIND>(tail[(long long)t * s.count + k], a));
    return;
  }
  if (lane == 0) s_warp[w] = a;
  __syncthreads();
  if (tid == 0) {
    Acc r = tail[(long long)t * s.count + k];
    for (int q = 0; q < kWarps; ++q) r = combine<KIND>(r, s_warp[q]);
    write_group(s, s.kind[k], k, slot, r);
  }
  __syncthreads();
}

template <bool WIDE>
__device__ void fixup_ops(const Set& s, int t, int slot, int lo, int hi,
                          const Acc* head, const Acc* tail, Acc* s_warp) {
#pragma unroll 1
  for (int k = 0; k < s.count; ++k) {
#define SRT_FIX(KIND) \
  fixup_op<KIND, WIDE>(s, k, t, slot, lo, hi, head, tail, s_warp)
    switch (s.kind[k]) {
      case kMinInt: SRT_FIX(kMinInt); break;
      case kMaxInt: SRT_FIX(kMaxInt); break;
      case kMinFloat: SRT_FIX(kMinFloat); break;
      case kMaxFloat: SRT_FIX(kMaxFloat); break;
      default: SRT_FIX(kCount);  // counts and sums combine alike
    }
#undef SRT_FIX
  }
}

__global__ void __launch_bounds__(kThreads)
fixup_kernel(Set s, const int* tile_counts, const int* tile_offsets,
             int tiles, const Acc* head, const Acc* tail) {
  __shared__ int s_first;
  __shared__ Acc s_warp[kWarps];
  const int t = blockIdx.x;
  if (tile_counts[t] == 0) return;
  const int tid = threadIdx.x;
  // the group runs on through every tile up to and including the next
  // one that holds a start (or the last tile)
  int end = tiles;
  for (int c = t + 1; c < tiles; c += kThreads) {
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
  const int slot = tile_offsets[t] + tile_counts[t] - 1;
  const int lo_all = t + 1;
  if (end - lo_all <= 32) {
    // a short run of tiles: one warp, one partial a lane
    if (tid >= 32) return;
    fixup_ops<false>(s, t, slot, lo_all + tid, min(lo_all + tid + 1, end),
                     head, tail, s_warp);
    return;
  }
  const int per = (end - lo_all + kThreads - 1) / kThreads;
  const int lo = lo_all + tid * per;
  fixup_ops<true>(s, t, slot, lo, min(lo + per, end), head, tail, s_warp);
}

// An ungrouped aggregate over no rows: one group, every count 0.
__global__ void empty_global_kernel(Set s, int* first_row, int* groups) {
  *groups = 1;
  *first_row = 0;
  for (int k = 0; k < s.count; ++k)
    write_group(s, s.kind[k], k, 0, zero_acc());
}

long long up16(long long x) { return (x + 15) / 16 * 16; }

long long tiles_of(int n, int rows_per_thread) {
  const long long t = (long long)kThreads * rows_per_thread;
  return (n + t - 1) / t;
}

// The scratch regions, each 16-byte aligned: the look-back state (a tile
// counter and a status word a tile), the start bits, the tiles' start
// counts and first slots, the head and tail partials [tiles][ops], and
// the records (n of record_max bytes).  ops_per_set and record_max are
// the most any set of the call has.  Returns the bytes.
long long layout(char* base, int n, int rows_per_thread, int ops_per_set,
                 int record_max, Scratch* sc) {
  const long long tiles = tiles_of(n, rows_per_thread);
  const long long ops = ops_per_set > 0 ? ops_per_set : 1;
  long long off = 0;
  auto take = [&](long long bytes) {
    char* at = base + off;
    off = up16(off + bytes);
    return at;
  };
  Scratch s;
  s.state = reinterpret_cast<unsigned long long*>(take((1 + tiles) * 8));
  s.masks = reinterpret_cast<unsigned short*>(take(tiles * kThreads * 2));
  s.tile_counts = reinterpret_cast<int*>(take(tiles * 4));
  s.tile_offsets = reinterpret_cast<int*>(take(tiles * 4));
  s.head = reinterpret_cast<Acc*>(take(tiles * ops * sizeof(Acc)));
  s.tail = reinterpret_cast<Acc*>(take(tiles * ops * sizeof(Acc)));
  s.records = reinterpret_cast<const uint4*>(
      take((long long)n * record_max));
  if (sc) *sc = s;
  return off;
}

template <int K, bool REC>
int launch_fold(const Set& s, const Keys& keys, const int* order, int n,
                int global_agg, int first_set, int R, const Scratch& sc,
                int tiles, int* first_row, int* groups,
                cudaStream_t stream) {
  const int smem = stage_bytes(K, REC ? R : 0) +
                   (s.count > 0 ? s.count : 1) * static_cast<int>(sizeof(Defer));
  const cudaError_t err = cudaFuncSetAttribute(
      fold_kernel<K, REC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_kernel<K, REC><<<tiles, kThreads, smem, stream>>>(
      s, keys, order, n, global_agg, first_set, R, sc, tiles, first_row,
      groups);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_pack(int n, const Set& s, const Keys& keys, int with_keys,
                const uint4* records, cudaStream_t stream) {
  const long long rows = (long long)kThreads * kPackRows;
  pack_kernel<R><<<static_cast<int>((n + rows - 1) / rows), kThreads, 0,
                   stream>>>(n, s, keys, with_keys,
                             const_cast<uint4*>(records));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The start of a call: varying[k] = 1 where key word k (a device array of
// nwords device pointers to int64[n]) is not the same in every row, and
// with an order (int32[n], or null) varying[nwords] = its descents, exact
// up to 64.  varying: int32[nwords + 1].
extern "C" int srt_segment_reduce_varying(const long long* const* words,
                                          int nwords, const int* order,
                                          int n, int* varying,
                                          cudaStream_t stream) {
  if (nwords < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaMemsetAsync(varying, 0, (nwords + 1) * sizeof(int), stream);
  if (err != cudaSuccess || (nwords == 0 && !order) || n == 0)
    return static_cast<int>(err);
  const long long tiles = (n + kThreads - 1) / kThreads;
  varying_kernel<<<tiles < 1056 ? static_cast<int>(tiles) : 1056, kThreads,
                   0, stream>>>(Words{words, nwords}, order, n, varying);
  return static_cast<int>(cudaGetLastError());
}

// One set of ops.  Keys: words (device array of nwords device pointers)
// with varying (from srt_segment_reduce_varying) on the direct path;
// on the record path nkeys host pointers key_w to the varying words with
// their record offsets key_off.  live: bool[n] or null (every row live);
// order: int32[n] or null (the rows are already in key order); all
// inputs in input order, sorted row i being input row order[i].  Per op
// k < nops (<= 16): kind[k] (0 count, 1 int64 sum, 2 float64 sum, 3 / 4
// int64 min / max, 5 / 6 float64 min / max), op_lane[k] (index into
// lanes, -1 for a count), op_mask[k] (index into masks: its contributor
// mask, also its bit in a record's mask word), sums[k] (the lane's type,
// [max(n, 1)], null for a count; min and max write the kept value's bits,
// 0 where no row contributed), counts[k] (int64[max(n, 1)]).  lanes:
// nlanes (<= 16) int64 / float64 [n] device pointers, distinct, at
// lane_off in a record; masks: nmasks (<= 16) bool[n], distinct; the
// mask word at mask_off.  record_bytes: 16, 32, 64 or 128 (the record
// path), or 0 (the direct path, rows_per_thread 8); on the record path
// rows_per_thread is 256 / record_max and record_bytes <= record_max.
// The first set (first_set 1) finds the groups: they fill slots
// [0, *groups) in key order and first_row[g] is the input row of group
// g's first sorted row; rows before the first start belong to no group.
// Later sets read its start bits and slots, so each call of a set passes
// the same n, rows_per_thread, ops_per_set, record_max and scratch
// (scratch_bytes, 16-byte aligned, at least what layout() takes for
// them: exec/aggregate.py k3_scratch_bytes).
extern "C" int srt_segment_reduce_set(
    const long long* const* words, int nwords, const int* varying,
    int nkeys, const void* const* key_w, const int* key_off,
    const unsigned char* live, const int* order, int n, int global_agg,
    int first_set, int nops, const int* kind, const int* op_lane,
    const int* op_mask, void* const* sums, long long* const* counts,
    int nlanes, const void* const* lanes, const int* lane_off, int nmasks,
    const void* const* masks, int mask_off, int record_bytes,
    int rows_per_thread, int ops_per_set, int record_max, int* first_row,
    int* groups, void* scratch, long long scratch_bytes,
    cudaStream_t stream) {
  const bool rec = record_bytes > 0;
  if (n < 0 || nwords < 0 || nops < 0 || nops > kOpsPerLaunch ||
      nops > (ops_per_set > 0 ? ops_per_set : 1) || nlanes < 0 ||
      nlanes > kOpsPerLaunch || nmasks < 0 || nmasks > kOpsPerLaunch ||
      nkeys < 0 || nkeys > kMaxKeys || (nkeys > 0 && !(rec && first_set)) ||
      reinterpret_cast<size_t>(scratch) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rec ? ((record_bytes != 16 && record_bytes != 32 &&
              record_bytes != 64 && record_bytes != 128) ||
             record_bytes > record_max ||
             (rows_per_thread != 2 && rows_per_thread != 4 &&
              rows_per_thread != 8 && rows_per_thread != 16) ||
             rows_per_thread * record_max > kStage / kThreads)
          : rows_per_thread != kDirectRows)
    return static_cast<int>(cudaErrorInvalidValue);
  Set s;
  s.count = nops;
  for (int k = 0; k < nops; ++k) {
    if (kind[k] < kCount || kind[k] > kMaxFloat || op_lane[k] < -1 ||
        op_lane[k] >= nlanes || (kind[k] != kCount) != (op_lane[k] >= 0) ||
        op_mask[k] < 0 || op_mask[k] >= nmasks)
      return static_cast<int>(cudaErrorInvalidValue);
    s.kind[k] = kind[k];
    s.lane[k] = op_lane[k];
    s.mask[k] = op_mask[k];
    s.sums[k] = sums[k];
    s.counts[k] = counts[k];
  }
  // a record holds the lanes from offset 0, the varying key words after
  // them and then the mask word (exec/aggregate.py:_k3_set)
  const int nk = first_set ? nkeys : 0;
  if (rec && (8 * (nlanes + nk) + 4 > record_bytes ||
              mask_off != 8 * (nlanes + nk)))
    return static_cast<int>(cudaErrorInvalidValue);
  s.nlanes = nlanes;
  for (int l = 0; l < nlanes; ++l) {
    s.lanes[l] = static_cast<const long long*>(lanes[l]);
    s.lane_off[l] = 8 * l;
    if (rec && lane_off[l] != 8 * l)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  s.nmasks = nmasks;
  for (int q = 0; q < nmasks; ++q)
    s.masks[q] = static_cast<const unsigned char*>(masks[q]);
  s.mask_off = rec ? mask_off : 0;
  Keys keys;
  keys.words = Words{words, nwords};
  keys.varying = varying;
  keys.count = nkeys;
  for (int k = 0; k < nkeys; ++k) {
    keys.w[k] = static_cast<const long long*>(key_w[k]);
    keys.off[k] = 8 * (nlanes + k);
    if (key_off[k] != keys.off[k])
      return static_cast<int>(cudaErrorInvalidValue);
  }
  keys.live = live;
  Scratch sc;
  if (layout(static_cast<char*>(scratch), n, rows_per_thread, ops_per_set,
             rec ? record_max : 0, &sc) > scratch_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (n == 0) {
    if (global_agg) {
      empty_global_kernel<<<1, 1, 0, stream>>>(s, first_row, groups);
      return static_cast<int>(cudaGetLastError());
    }
    return first_set ? static_cast<int>(cudaMemsetAsync(groups, 0,
                                                        sizeof(int), stream))
                     : 0;
  }
  const int tiles = static_cast<int>(tiles_of(n, rows_per_thread));
  if (first_set) {
    err = cudaMemsetAsync(sc.state, 0, (1 + (size_t)tiles) * 8, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int rc = 0;
  if (rec) {
    switch (record_bytes) {
      case 16: rc = launch_pack<16>(n, s, keys, first_set, sc.records,
                                    stream); break;
      case 32: rc = launch_pack<32>(n, s, keys, first_set, sc.records,
                                    stream); break;
      case 64: rc = launch_pack<64>(n, s, keys, first_set, sc.records,
                                    stream); break;
      default: rc = launch_pack<128>(n, s, keys, first_set, sc.records,
                                     stream);
    }
    if (rc) return rc;
  }
  const int R = rec ? record_bytes : 0;
#define SRT_LAUNCH(K, REC)                                                  \
  launch_fold<K, REC>(s, keys, order, n, global_agg, first_set, R, sc,      \
                      tiles, first_row, groups, stream)
  if (!rec) {
    rc = SRT_LAUNCH(kDirectRows, false);
  } else {
    switch (rows_per_thread) {
      case 2: rc = SRT_LAUNCH(2, true); break;
      case 4: rc = SRT_LAUNCH(4, true); break;
      case 8: rc = SRT_LAUNCH(8, true); break;
      default: rc = SRT_LAUNCH(16, true);
    }
  }
#undef SRT_LAUNCH
  if (rc) return rc;
  fixup_kernel<<<tiles, kThreads, 0, stream>>>(
      s, sc.tile_counts, sc.tile_offsets, tiles, sc.head, sc.tail);
  return static_cast<int>(cudaGetLastError());
}

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
//     records would move more bytes.  A set of contributor masks and no
//     value lane (first, last and counts) runs the LIGHT fold, with the
//     value kinds' code compiled out;
//   - the run path, for an order of at most kFewRuns increasing runs
//     (K2's stable order over a few groups: TPC-H Q1's six), whatever
//     the inputs' size: each block takes a tile of 2,048 input rows and
//     the sorted rows of each run that lie there (see "The run path"
//     below), so every input is read in input order, coalesced, each
//     byte once.  Through the order, a sorted row of a group with share
//     d lies 1 / d input rows from the next, so each 8-byte value pulled
//     its own 32-byte sector: on the H100 the tiles of sorted rows were
//     held by the count of sector requests the L2 cache serves, not by
//     device memory (PERF.md, K3's 128-bit row).
// Launches, for each set of ops:
//   1. varying_kernel (once, before the first set): which key words are
//      not the same in every row, read in input order; a constant word
//      (the null word of a key with no nulls) can start no group and is
//      neither packed nor compared.  It also counts the order's descents
//      up to kFewRuns and keeps where they are.  The host reads these
//      once where the record path or the run path may pay, to lay out
//      the record or the runs; an order of a few increasing runs (a few
//      groups: K2's order is stable) takes the run path.
//   1r. the run path, first set: pieces_kernel, run_starts_kernel and
//      one block's scan of the pieces' start counts into their first
//      slots (partition.cuh's scan_kernel); then run_fold_kernel for
//      every set, and the fixup over the pieces.
//   2. pack_kernel (record path).
//   3. fold_kernel: in the first set a row starts a group if it is live
//      and is the first row or differs from the previous sorted row in a
//      varying word; the tile's start count goes through a decoupled
//      look-back over the earlier tiles (a status word a tile, tiles
//      numbered in the order the blocks start, so a tile waits only on
//      running ones) to the tile's first group slot, and the start bits
//      are kept for the later sets.  Then every op of the set: each
//      thread folds its K rows serially, a warp-wide segmented scan
//      (shuffles) closes the groups whose start lies in the same warp (a
//      warp that holds no start folds its rows by a plain shuffle
//      reduction), and what each warp leaves open waits in shared
//      memory; after one barrier for all the ops, the warps' folds join
//      in a fixed order.
//      A group that opens and closes inside the tile is written to its
//      slot; the tile's open head segment (a group begun in an earlier
//      tile) and open tail segment go to per-tile partials.
//   4. fixup_kernel: for each tile that holds a start, the group begun
//      at that tile's last start: its tail partial, then the head partials
//      of the following tiles up to and including the next tile with a
//      start, folded by a fixed tree that keeps their order (a warp when
//      they are at most 32, a block past that; a warp a tile, 8 tiles a
//      block, over tiles of sorted rows, which mostly hold a start; 64
//      tiles a block over the run path's pieces, which mostly hold none).
//   5. bounds_kernel, where a set holds an op over every row (below).
// The op's kind is a warp-uniform switch inside the one fold launch.
//
// Min and max (kinds 3-6) replace the reference's ops/segmented.py
// segment_reduce(xp, "min"|"max") on its jax branch (_argext_rows over
// _ordered_words32): per group, the row of the extreme ordered word
// among the contributing rows, the earliest in sorted order on a tie,
// and that row's value bit for bit (so -0.0 stays -0.0).  An int64 lane
// is its own word; a float64 lane's word is Spark's total order of
// encode_float_ordered (-0.0 equals 0.0, NaN canonical and greatest).
// The fold state is (the kept value's bits, its ordered word -- an int64
// lane's is the value itself): a row's word is computed once, when the
// row is folded, and two states combine by word, strictly, a tie keeping
// the earlier rows' state.  Every combination (a thread's rows, the
// shuffle scans and trees, the warps' join, the fixup's tree) takes its
// operands in sorted order, so that is the earliest sorted row, with no
// position in the state; the combination is associative, so the fold, the
// head/tail partials and the fixup carry it as they carry the sums, and
// the result is the same bits on every run.  Max compares the other way;
// there is no inverted lane.
// So every thread folds K rows whatever the key skew: a hot key that
// holds 10M rows spans thousands of tiles and costs a tree over their
// partials in step 4, not a 10M-row loop on one thread.  No float
// atomics: every combination order is fixed by the sorted layout and the
// tile shape, so a result is the same bits from run to run, which the
// aggregate's stable_merge determinism relies on.
//
// The positional kinds, first and last (10 and 11), replace the
// reference's segment_reduce(xp, "first"|"last", pos, ...) (ops/
// segmented.py:251; the index that exec/aggregate.py then gathers the
// column at): per group, the least (greatest) sorted position among the
// contributing rows.  They read no value lane, only the contributor mask
// (a bit of the record's mask word, or the mask itself), and fold the
// sorted position -- never the input row: in the merge stage the order
// is the canonical one, along which input rows do not increase, and on
// the run path a group's pieces lie in different runs.  A min (max) of
// positions is associative and commutative, so the records, direct and
// run paths, the head and tail partials and the fixup give the same
// position in any order.  The state is (position, count), as an int64
// min or max's (value, count); the result is int32 a group: the input
// row at that position (write_group reads it through the order), 0
// where no row contributed.  The run fold has an instantiation without
// them (POS false) for the sets that hold none: compiled in, their code
// cost that fold 4-5 % at q1x's and q1d's calls.
//
// An op over every row -- first and last counting nulls, count(*), a
// count of a column valid in every row -- has no mask (op_mask -1) and
// is never folded: its group is the sorted rows [starts[g], starts[g +
// 1]) between two starts (the last group's end is n), so the count is
// the group's length, first its first row (first_row[g]) and last its
// last row through the order.  The first set's fold writes each group's
// first sorted position beside first_row, on every path (records,
// direct, run), so a group that spans tiles or runs needs no partial;
// bounds_kernel then writes those ops, a thread a group.
//
// The 128-bit kinds (7-9) carry a DECIMAL of more than 18 digits, two
// lanes an op: the low words (unsigned) and the signed high words.  Sum
// (kind 7) replaces the reference's ops/segmented.py segment_sum128 (three
// 32-bit-limb sums and a carry join): the fold keeps the low word in Acc.i
// and the high word's bits in Acc.f, and every add -- a row, two partials
// in the shuffle scan, the head/tail partials, the fixup tree -- carries
// out of the low word into the high one, so the sum is exact modulo 2^128
// in any order and the same bits on every run.  Min and max (kinds 8 and
// 9) replace the reference's ordered gather for DECIMAL128 (a second
// lexsort per op and first_index_per_segment, exec/aggregate.py): the
// state is (low word, high word), compared by (high signed, low
// unsigned), a tie keeping the earlier rows.  A DECIMAL of at most
// 18 digits is one int64 lane and takes kinds 1, 3 and 4.  The
// reference's Sum casts a DECIMAL64 input to its 128-bit buffer type; here
// such a sum is kind 7 over the DECIMAL64 lane alone, its high lane -2:
// each row's high word is its low word's sign, taken in registers, so no
// pair is built and no lane of signs is read (exec/aggregate.py hands K3
// the cast's input).  A set that holds a 128-bit op runs its own
// instantiation of the fold and the fixup (W128); a set of 64-bit ops
// alone compiles without them, so the 128-bit kinds' registers cost it
// nothing, and a W128 fold may take 128 registers (two blocks an SM) so
// that it does not spill.
//
// Bound: device-memory bytes.  Least traffic is order (4 B/row), each
// key word (8 B/row), the live flags where given (1 B/row), each
// distinct value lane and contributor mask once (an op over every row
// reads none), and the per-group outputs written once, over 3.35 TB/s.  A read through the order moves
// a whole 32-byte sector: the direct path pays one a row for each input,
// the record path one (two at 64 bytes) a row for the record, plus the
// pack's coalesced read of the inputs and write of the records.  Such
// reads are bound by their count of sectors, so a 64-byte record (two
// sectors) costs about twice a 32-byte one.  The run path moves about the
// least traffic: the order twice (the starts, then the fold), each key
// word, input lane and mask once, and the pieces' partials.

#include <cstring>

#include "partition.cuh"

namespace {

constexpr int kThreads = srt::kThreads;      // 256
constexpr int kWarps = srt::kWarps;
constexpr int kOpsPerLaunch = 16;            // ops, lanes and masks a set
constexpr int kMaxKeys = 15;                 // varying words in a record
constexpr int kDirectRows = 8;               // rows a thread, direct path
constexpr int kFewRuns = 64;                 // runs of the run path
constexpr int kStage = 65536;                // a record tile's records
constexpr int kCount = 0;
constexpr int kSumInt = 1;
constexpr int kSumFloat = 2;
constexpr int kMinInt = 3;
constexpr int kMaxInt = 4;
constexpr int kMinFloat = 5;
constexpr int kMaxFloat = 6;
constexpr int kSum128 = 7;
constexpr int kMin128 = 8;
constexpr int kMax128 = 9;
constexpr int kFirst = 10;
constexpr int kLast = 11;
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
  int lane[kOpsPerLaunch];                 // index into lanes, -1: a count
                                           // or a positional kind
  int mask[kOpsPerLaunch];                 // index into masks
  int lane_hi[kOpsPerLaunch];              // 128-bit kinds: the high words
                                           // (-2: the low words' signs)
  void* sums[kOpsPerLaunch];
  long long* sums_hi[kOpsPerLaunch];       // 128-bit kinds
  long long* counts[kOpsPerLaunch];
  int nlanes;
  const long long* lanes[kOpsPerLaunch];   // int64 or float64 bits
  int lane_off[kOpsPerLaunch];             // byte offset in a record
  int nmasks;
  const unsigned char* masks[kOpsPerLaunch];
  int mask_off;                            // the mask word's byte offset
  const int* order;                        // a pick's sorted position ->
                                           // its input row (null: itself)
};

// An op whose mask is -1 (every row contributes: a count, first or last)
// is derived from its group's bounds (bounds_kernel), never folded.
__host__ __device__ __forceinline__ bool derived(const Set& s, int k) {
  return s.mask[k] < 0;
}

// What starts a group (the first set only).
struct Keys {
  Words words;                             // direct path
  const int* varying;                      // direct path: [words.count]
  int count;                               // record path: varying words
  const long long* w[kMaxKeys];
  int off[kMaxKeys];                       // byte offset in a record
  const unsigned char* live;               // or null
};

__host__ __device__ constexpr bool is_pos(int kind) {
  return kind == kFirst || kind == kLast;
}

// the kinds whose state is a kept value and its count: min, max, and the
// positional kinds (a min or max of positions)
__host__ __device__ constexpr bool is_extreme(int kind) {
  return (kind >= kMinInt && kind <= kMaxFloat) || kind == kMin128 ||
         kind == kMax128 || is_pos(kind);
}

// the kinds whose kept value is its own ordered word (Acc.i)
__host__ __device__ constexpr bool int_word(int kind) {
  return kind == kMinInt || kind == kMaxInt || is_pos(kind);
}

__host__ __device__ constexpr bool is128(int kind) {
  return kind >= kSum128 && kind <= kMax128;
}

// A fold of some rows of one op: wrapping int sum, finite float sum,
// contributor count, and which of +inf / -inf / NaN contributed.  For
// min/max: the kept value's bits (i) and, for a float64 lane, its ordered
// word (f's bits).  Also the layout of a per-tile partial.
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

// A min/max state's ordered word: an int64 lane's value itself (Acc.i),
// a float64 lane's word (Acc.f's bits); a 128-bit kind's high word.
template <int KIND = kMinFloat>
__device__ __forceinline__ long long word_of(const Acc& a) {
  return int_word(KIND) ? static_cast<long long>(a.i)
                        : __double_as_longlong(a.f);
}

// a 128-bit kind's high word, kept as Acc.f's bits
__device__ __forceinline__ double as_hi(long long hi) {
  return __longlong_as_double(hi);
}

// Whether word wb is strictly more extreme than wa.
template <int KIND>
__device__ __forceinline__ bool keeps(long long wb, long long wa) {
  return (KIND == kMinInt || KIND == kMinFloat || KIND == kFirst) ? wb < wa
                                                                 : wb > wa;
}

// Whether state b (the later rows) replaces a (both with contributors):
// the 128-bit kinds by (high signed, low unsigned), the others by ordered
// word, strictly.  A tie keeps a, the earlier rows: every combination
// takes its operands in sorted order, so the earliest sorted row of the
// extreme word is kept, as the reference keeps it, and no position rides
// in the state.
template <int KIND>
__device__ __forceinline__ bool better(const Acc& b, const Acc& a) {
  if (is128(KIND)) {
    const long long hb = word_of(b), ha = word_of(a);
    const bool less = hb != ha ? hb < ha : b.i < a.i;
    const bool more = hb != ha ? hb > ha : b.i > a.i;
    return KIND == kMin128 ? less : more;
  }
  return keeps<KIND>(word_of<KIND>(b), word_of<KIND>(a));
}

// a then b: a holds the earlier rows
template <int KIND>
__device__ __forceinline__ Acc combine(const Acc& a, const Acc& b) {
  if (is_extreme(KIND)) {
    const bool take_b = b.n > 0 && (a.n == 0 || better<KIND>(b, a));
    return take_b ? Acc{b.i, b.f, a.n + b.n, 0u}
                  : Acc{a.i, a.f, a.n + b.n, 0u};
  }
  if (KIND == kSum128) {
    const unsigned long long lo = a.i + b.i;
    return Acc{lo, as_hi(word_of(a) + word_of(b) + (lo < a.i ? 1 : 0)),
               a.n + b.n, 0u};
  }
  return Acc{a.i + b.i, a.f + b.f, a.n + b.n, a.flags | b.flags};
}

// One row after every row already in a: c says whether it contributes,
// bits are its value's 64 bits (a 128-bit kind's low word; hib its high
// word).
template <int KIND>
__device__ __forceinline__ void add_row(Acc& a, bool c, long long bits,
                                        long long hib) {
  if (KIND == kSum128) {
    if (c) {
      const unsigned long long lo =
          a.i + static_cast<unsigned long long>(bits);
      a.f = as_hi(word_of(a) + hib + (lo < a.i ? 1 : 0));
      a.i = lo;
    }
    a.n += c ? 1 : 0;
    return;
  }
  if (KIND == kMin128 || KIND == kMax128) {
    if (c) {
      const Acc r{static_cast<unsigned long long>(bits), as_hi(hib), 1, 0u};
      if (a.n == 0 || better<KIND>(r, a)) {
        a.i = r.i;
        a.f = r.f;
      }
    }
    a.n += c ? 1 : 0;
    return;
  }
  if (int_word(KIND)) {
    if (c && (a.n == 0 || keeps<KIND>(bits, static_cast<long long>(a.i))))
      a.i = static_cast<unsigned long long>(bits);
    a.n += c ? 1 : 0;
    return;
  }
  if (is_extreme(KIND)) {
    const long long w = ordered_word<KIND>(bits);
    if (c && (a.n == 0 || keeps<KIND>(w, word_of(a)))) {
      a.i = static_cast<unsigned long long>(bits);
      a.f = __longlong_as_double(w);
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

// W128: the kind may be a 128-bit one (else the 64-bit kinds alone).
template <bool W128>
__device__ __forceinline__ void write_group(const Set& s, int kind, int k,
                                            int g, const Acc& a) {
  s.counts[k][g] = a.n;
  if (is_pos(kind)) {
    const int pos = static_cast<int>(a.i);
    static_cast<int*>(s.sums[k])[g] =
        a.n > 0 ? (s.order ? __ldg(s.order + pos) : pos) : 0;
  } else if (W128 && is128(kind)) {
    // no contributor: null, canonical zero under it
    static_cast<long long*>(s.sums[k])[g] =
        a.n > 0 ? static_cast<long long>(a.i) : 0ll;
    s.sums_hi[k][g] = a.n > 0 ? word_of(a) : 0ll;
  } else if (W128 ? is_extreme(kind) : kind >= kMinInt) {
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
  if (KIND == kSumInt || KIND == kSum128 || is_extreme(KIND))
    r.i = __shfl_up_sync(0xffffffffu, a.i, off);
  if (KIND == kSum128 || KIND == kSumFloat ||
      (is_extreme(KIND) && !int_word(KIND)))
    r.f = __shfl_up_sync(0xffffffffu, a.f, off);
  if (KIND == kSumFloat)
    r.flags = __shfl_up_sync(0xffffffffu, a.flags, off);
  r.n = __shfl_up_sync(0xffffffffu, static_cast<int>(a.n), off);
  return r;
}

template <int KIND>
__device__ __forceinline__ Acc shfl_down_k(const Acc& a, int off) {
  Acc r = zero_acc();
  if (KIND == kSumInt || KIND == kSum128 || is_extreme(KIND))
    r.i = __shfl_down_sync(0xffffffffu, a.i, off);
  if (KIND == kSum128 || KIND == kSumFloat ||
      (is_extreme(KIND) && !int_word(KIND)))
    r.f = __shfl_down_sync(0xffffffffu, a.f, off);
  if (KIND == kSumFloat)
    r.flags = __shfl_down_sync(0xffffffffu, a.flags, off);
  r.n = __shfl_down_sync(0xffffffffu, static_cast<int>(a.n), off);
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
// up to past kFewRuns, and varying[words.count + 1 + q] for q <
// kFewRuns holds the positions i of the first ones found, in no order:
// K2's order is stable, so a call with few groups reads its rows in a few
// increasing runs, and the host reads where they begin.

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
  const int lane = threadIdx.x & 31;
  int it = 0;
  for (long long i = first; i + 1 < n; i += stride) {
    // one atomic a warp's descents, so the counter takes few of them
    const unsigned act = __activemask();
    const bool down = __ldg(order + i + 1) < __ldg(order + i);
    const unsigned m = __ballot_sync(act, down);
    if (m) {
      const int leader = __ffs(m) - 1;
      int at = 0;
      if (lane == leader) at = atomicAdd(runs, __popc(m));
      at = __shfl_sync(act, at, leader);
      if (at > kFewRuns) return;
      at += __popc(m & ((1u << lane) - 1u));
      if (down && at < kFewRuns) runs[1 + at] = static_cast<int>(i);
    }
    if ((++it & 3) == 0 && *vruns > kFewRuns) return;
  }
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

// A staged 8-byte word's place on the run path (see kSlotWords): 2 words
// of padding after each 32.
__device__ __forceinline__ int sw(int x) { return x + 2 * (x >> 5); }

// Per thread: its rows in the tile.
struct View {
  long long first;      // sorted position of the thread's first row
  unsigned valid;       // bit j: row j is below n
  unsigned mask;        // bit j: row j begins a segment (a boundary)
  int before;           // boundaries in the block before this thread's
};

// Where a block's closed segments go.  A segment is the rows from one
// boundary to the next; segment i begins at the block's boundary i (i =
// -1: the rows before its first).
//
// Tiles (the record path, and the direct one in sorted order): every
// boundary starts a group, segment i < count - 1 closes in group slot
// slot0 + i, the last one is the tile's tail partial and segment -1 its
// head.
struct TileDest {
  int count;                   // boundaries in the tile
  int slot0;                   // the tile's first group slot
  long long part;              // the tile's partials: part + op
  Acc* head;
  Acc* tail;

  template <int KIND>
  __device__ __forceinline__ void close(const Set& s, int k, int i,
                                        const Acc& a) const {
    if (i < 0)
      head[part + k] = a;
    else if (i < count - 1)
      write_group<is128(KIND)>(s, KIND, k, slot0 + i, a);
    else
      tail[part + k] = a;
  }
};

// Input tiles (the run path): the boundaries are the starts and each
// piece's first row, and piece[i] and slot[i] (-1 for a piece's first row
// that starts no group) say where segment i goes: from a piece's first
// row to the piece's head partial, a group that closes inside its piece
// to its slot, one still open at the end of its piece to the piece's tail
// partial.
struct RunDest {
  int count;                   // boundaries in the block
  long long part;              // piece r's partials: part + r * stride
  long long stride;            //   + op
  const unsigned char* piece;
  const int* slot;
  Acc* head;
  Acc* tail;

  template <int KIND>
  __device__ __forceinline__ void close(const Set& s, int k, int i,
                                        const Acc& a) const {
    if (i < 0) return;         // a block of input rows begins a segment
    const int r = piece[i];
    const long long at = part + r * stride + k;
    if (slot[i] < 0)
      head[at] = a;
    else if (i + 1 < count && piece[i + 1] == r)
      write_group<is128(KIND)>(s, KIND, k, slot[i], a);
    else
      tail[at] = a;
  }
};

// The values of one lane for a thread's rows: on the direct path held in
// registers, on the record path read from the staged records, on the run
// path from the block's input rows staged in shared memory.
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

struct RunValues {
  const long long* lane;     // the block's input rows of the lane (sw)
  const int* rows;           // the thread's rows' offsets in s_rows
  __device__ __forceinline__ long long operator()(int j) const {
    return lane[sw(rows[j])];
  }
};

// The sorted positions of a thread's rows: consecutive in a tile of
// sorted rows; on the run path each virtual row's, from its piece
// (RunPos, after the piece table).
struct TilePos {
  int first;                 // positions fit 32 bits: n is an int
  __device__ __forceinline__ long long operator()(int j) const {
    return first + j;
  }
};


// Op k over the thread's rows: the segments that open and close among
// them are closed; a warp-wide segmented scan (shuffles, no barrier)
// closes the segment open at each thread's first boundary where an
// earlier thread of the warp holds one, and leaves the rest to
// finish_op.  A warp with no boundary only reduces its rows for the
// block's end.  hvals: a 128-bit kind's high words (unread by the other
// kinds), or with sign the signs of vals; pos: the rows' sorted positions,
// which a positional kind folds in place of a value.
template <int KIND, int K, class Values, class Pos, class Dest>
__device__ void fold_op(const Set& s, int k, Values vals, Values hvals,
                        bool sign, Pos pos, unsigned c, const View& v,
                        const Dest& dst, Defer* d) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  c &= v.valid;
  Acc first_run = zero_acc(), run = zero_acc();
  int seen = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if ((v.mask >> j) & 1u) {
      if (seen == 0)
        first_run = run;
      else
        dst.template close<KIND>(s, k, v.before + seen - 1, run);
      ++seen;
      run = zero_acc();
    }
    const long long x = KIND == kCount ? 0ll : is_pos(KIND) ? pos(j)
                                                            : vals(j);
    add_row<KIND>(run, (c >> j) & 1u, x,
                  is128(KIND) ? (sign ? x >> 63 : hvals(j)) : 0ll);
  }
  if (!__any_sync(0xffffffffu, seen > 0)) {
    // no boundary in the warp: its rows in order, lanes paired by a tree
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Acc b = shfl_down_k<KIND>(run, off);
      if ((lane & (2 * off - 1)) == 0) run = combine<KIND>(run, b);
    }
    if (lane == 0) {
      d->tot[w] = Seg{run, 0};
      d->slot[w] = -2;
    }
    return;
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
  // the segment open at this thread's first boundary closes there
  const bool first_in_warp = seen > 0 && !before.start;
  if (seen > 0) {
    const Acc a = combine<KIND>(before.a, first_run);
    if (!first_in_warp) {
      dst.template close<KIND>(s, k, v.before - 1, a);
    } else {
      d->open[w] = a;
      d->slot[w] = v.before - 1;
    }
  }
  const unsigned opens = __ballot_sync(0xffffffffu, first_in_warp);
  if (lane == 0 && !opens) d->slot[w] = -2;
}

// After every op's fold and one barrier: the segments each warp left open
// (item w < kWarps), and the block's last segment (item kWarps).
template <int KIND, class Dest>
__device__ void finish_op(const Set& s, int k, int item, const Defer* d,
                          const Dest& dst) {
  Seg pre{zero_acc(), 0};
  if (item < kWarps) {
    const int i = d->slot[item];
    if (i == -2) return;
    for (int q = item - 1; q >= 0 && !pre.start; --q)
      pre = seg_op<KIND>(d->tot[q], pre);
    dst.template close<KIND>(s, k, i, combine<KIND>(pre.a, d->open[item]));
    return;
  }
  for (int q = kWarps - 1; q >= 0 && !pre.start; --q)
    pre = seg_op<KIND>(d->tot[q], pre);
  dst.template close<KIND>(s, k, dst.count - 1, pre.a);
}

// The kinds without the positional ones (the run fold's instantiation
// for sets that hold none, RUN_FOLD_POS below), then with them.
#define SRT_KINDS64_BASE(kind, CALL)        \
  switch (kind) {                           \
    case kSumInt: CALL(kSumInt); break;     \
    case kSumFloat: CALL(kSumFloat); break; \
    case kMinInt: CALL(kMinInt); break;     \
    case kMaxInt: CALL(kMaxInt); break;     \
    case kMinFloat: CALL(kMinFloat); break; \
    case kMaxFloat: CALL(kMaxFloat); break; \
    default: CALL(kCount);                  \
  }

#define SRT_KINDS64(kind, CALL)             \
  switch (kind) {                           \
    case kFirst: CALL(kFirst); break;       \
    case kLast: CALL(kLast); break;         \
    default: SRT_KINDS64_BASE(kind, CALL)   \
  }

// A set of counts and positional kinds alone (no value lane: LIGHT).
#define SRT_KINDS_LIGHT(kind, CALL)         \
  switch (kind) {                           \
    case kFirst: CALL(kFirst); break;       \
    case kLast: CALL(kLast); break;         \
    default: CALL(kCount);                  \
  }

#define SRT_KINDS_BASE(kind, CALL)          \
  switch (kind) {                           \
    case kSum128: CALL(kSum128); break;     \
    case kMin128: CALL(kMin128); break;     \
    case kMax128: CALL(kMax128); break;     \
    default: SRT_KINDS64_BASE(kind, CALL)   \
  }

#define SRT_KINDS(kind, CALL)               \
  switch (kind) {                           \
    case kSum128: CALL(kSum128); break;     \
    case kMin128: CALL(kMin128); break;     \
    case kMax128: CALL(kMax128); break;     \
    default: SRT_KINDS64(kind, CALL)        \
  }

struct Scratch {
  unsigned long long* state;   // [0] the tile counter, [1 + t] tile t
  int* starts;                 // [n]: group g's first sorted position,
                               // where the call derives ops (else null)
  unsigned short* masks;       // start bits, [tiles][kThreads]
  int* tile_counts;            // [tiles], the run path [pieces]
  int* tile_offsets;
  Acc* head;                   // [tiles or pieces][ops of the set]
  Acc* tail;
  const uint4* records;        // record path
  int* pieces;                 // the run path: [runs][blocks + 1]
  Acc* block_heads;            // [ceil(tiles or pieces / kFixTiles)][ops]
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
// W128: the set holds a 128-bit op; a set of 64-bit ops alone compiles
// without the 128-bit kinds' code and registers, in three blocks an SM
// (80 registers); a W128 one may take 128 registers (two blocks), so it
// does not spill.  LIGHT (the direct path): the set reads no value lane,
// only masks (counts, first and last: qg2's), and compiles without the
// value kinds' code, in three blocks an SM (on the H100, four blocks an
// SM of 64 registers were faster at qg2's near-sorted order but slower
// than the full fold over a random one; 16 rows a thread were slower at
// qg2).
template <int K, bool REC, bool W128, bool LIGHT = false>
__global__ void __launch_bounds__(kThreads, W128 ? 2 : 3)
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
  TileDest dst{count, 0, (long long)tile * s.count, sc.head, sc.tail};
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
    dst.slot0 = s_slot;
    int q = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if ((v.mask >> j) & 1u) {
        const int row = REC ? (order ? __ldg(order + v.first + j)
                                     : static_cast<int>(v.first + j))
                            : in_row[REC ? 0 : j];
        if (sc.starts)
          sc.starts[s_slot + v.before + q] = static_cast<int>(v.first + j);
        first_row[s_slot + v.before + q++] = row;
      }
    }
  } else {
    dst.slot0 = sc.tile_offsets[tile];
  }

  // every op of the set, each input read once a row
  const TilePos tpos{static_cast<int>(v.first)};
  if (REC) {
    for (int k = 0; k < s.count; ++k) {
      if (derived(s, k)) continue;
      unsigned c = 0;
      const int bit = s.mask[k];
#pragma unroll
      for (int j = 0; j < K; ++j) c |= ((mw[REC ? j : 0] >> bit) & 1u) << j;
      const RecValues vals{my_rec + (s.lane[k] >= 0 ? s.lane_off[s.lane[k]]
                                                    : 0), R};
      const RecValues hvals{
          my_rec + (s.lane_hi[k] >= 0 ? s.lane_off[s.lane_hi[k]] : 0), R};
      const bool sign = s.lane_hi[k] == -2;
#define SRT_FOLD(KIND) \
  fold_op<KIND, K>(s, k, vals, hvals, sign, tpos, c, v, dst, defer + k)
      if constexpr (W128) {
        SRT_KINDS(s.kind[k], SRT_FOLD)
      } else {
        SRT_KINDS64(s.kind[k], SRT_FOLD)
      }
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
    for (int l = -1; l < (LIGHT ? 0 : s.nlanes); ++l) {
      if constexpr (W128) {
        // the 64-bit ops and the sums through signs over lane l; the
        // other 128-bit ops' lanes come below
        bool used = false;
        for (int k = 0; k < s.count; ++k)
          used |= s.lane[k] == l && s.lane_hi[k] < 0 && !derived(s, k);
        if (!used) continue;
      }
      long long x[K];
      const long long* lane = l >= 0 ? s.lanes[l] : nullptr;
#pragma unroll
      for (int j = 0; j < K; ++j)
        x[j] = lane ? lane[in_row[REC ? 0 : j]] : 0ll;
      const RegValues vals{x};
      for (int k = 0; k < s.count; ++k) {
        if (s.lane[k] != l || s.lane_hi[k] >= 0 || derived(s, k)) continue;
        const unsigned c = s_bits[s.mask[k] * kThreads + tid];
        const bool sign = s.lane_hi[k] == -2;
#define SRT_FOLD(KIND) \
  fold_op<KIND, K>(s, k, vals, vals, sign, tpos, c, v, dst, defer + k)
        if constexpr (LIGHT) {
          SRT_KINDS_LIGHT(s.kind[k], SRT_FOLD)
        } else if constexpr (W128) {
          SRT_KINDS(s.kind[k], SRT_FOLD)
        } else {
          SRT_KINDS64(s.kind[k], SRT_FOLD)
        }
#undef SRT_FOLD
      }
    }
    // the 128-bit ops over a pair of lanes: both words in registers, read
    // again only where the pair changes
    if constexpr (W128 && !LIGHT) {
      int at_lo = -1, at_hi = -1;
      long long x[K], xh[K];
      for (int k = 0; k < s.count; ++k) {
        if (s.lane_hi[k] < 0) continue;
        if (s.lane[k] != at_lo || s.lane_hi[k] != at_hi) {
          at_lo = s.lane[k];
          at_hi = s.lane_hi[k];
          const long long* lo = s.lanes[at_lo];
          const long long* hi = s.lanes[at_hi];
#pragma unroll
          for (int j = 0; j < K; ++j) {
            x[j] = lo[in_row[REC ? 0 : j]];
            xh[j] = hi[in_row[REC ? 0 : j]];
          }
        }
        const RegValues vals{x}, hvals{xh};
        const unsigned c = s_bits[s.mask[k] * kThreads + tid];
        switch (s.kind[k]) {
          case kSum128:
            fold_op<kSum128, K>(s, k, vals, hvals, false, tpos, c, v, dst,
                                defer + k);
            break;
          case kMin128:
            fold_op<kMin128, K>(s, k, vals, hvals, false, tpos, c, v, dst,
                                defer + k);
            break;
          default:
            fold_op<kMax128, K>(s, k, vals, hvals, false, tpos, c, v, dst,
                                defer + k);
        }
      }
    }
  }
  __syncthreads();
  for (int item = tid; item < s.count * (kWarps + 1); item += kThreads) {
    const int k = item / (kWarps + 1);
    if (derived(s, k)) continue;
#define SRT_FINISH(KIND) \
  finish_op<KIND>(s, k, item - k * (kWarps + 1), defer + k, dst)
    if constexpr (LIGHT) {
      SRT_KINDS_LIGHT(s.kind[k], SRT_FINISH)
    } else if constexpr (W128) {
      SRT_KINDS(s.kind[k], SRT_FINISH)
    } else {
      SRT_KINDS64(s.kind[k], SRT_FINISH)
    }
#undef SRT_FINISH
  }
}

// ---------------------------------------------------------------------------
// The run path: input tiles split by the order's runs.
//
// Over an order of R <= kFewRuns increasing runs (K2's stable order over a
// few groups), block b takes the input rows [b * 2048, (b + 1) * 2048)
// and, for each run r, the sorted rows of run r whose input rows lie
// there: a contiguous stretch of sorted rows, piece (r, b), found by a
// binary search over the run (pieces_kernel).  The block's virtual rows
// are its pieces one after another; thread t folds virtual rows 8t to 8t
// + 7.  Every input the block reads lies in its input rows, so it copies
// them (the lanes, the masks, the key words, the live flags) into shared
// memory with coalesced 16-byte copies, each byte once, and the fold
// gathers from there: reading through the order pulled a 32-byte sector
// for each 8-byte value.  The pieces are the partials' tiles, numbered r
// * blocks + b, which is sorted order: a group open at the end of piece
// (r, b) goes on in piece (r, b + 1), and the fixup joins them as it
// joins tiles.  run_starts_kernel finds the starts and each piece's count
// first; one block scans the counts into the pieces' first slots.
// ---------------------------------------------------------------------------

constexpr int kInputTile = kDirectTile;   // input rows a block
constexpr int kRunSlots = 2;              // lanes staged a batch
constexpr int kKeySlots = 2;              // key words staged a batch

// The run path's staging of a set's values: each distinct (lane, high
// lane) pair the ops read is copied once, a batch of at most kRunSlots
// lanes at a time (a pair takes two slots); an op reads its pair's slots
// in its batch.
struct StepPlan {
  int batches;
  unsigned opens;                          // ops whose pair is staged
  signed char batch[kOpsPerLaunch];        // -1: a count
  signed char lo[kOpsPerLaunch];           // slot of the low (only) lane
  signed char hi[kOpsPerLaunch];           // slot of the high lane, or -1
};

__device__ void plan_steps(const Set& s, StepPlan* p) {
  int batch = 0, used = 0;
  p->opens = 0;
  p->batches = 0;
  for (int k = 0; k < s.count; ++k) {
    p->batch[k] = p->lo[k] = p->hi[k] = -1;
    if (s.lane[k] < 0) continue;
    const int hk = s.lane_hi[k] >= 0 ? s.lane_hi[k] : -1;
    int same = -1;
    for (int q = 0; q < k && same < 0; ++q)
      if (s.lane[q] == s.lane[k] &&
          (s.lane_hi[q] >= 0 ? s.lane_hi[q] : -1) == hk)
        same = q;
    if (same >= 0) {
      p->batch[k] = p->batch[same];
      p->lo[k] = p->lo[same];
      p->hi[k] = p->hi[same];
      continue;
    }
    const int need = hk >= 0 ? 2 : 1;
    if (used + need > kRunSlots) {
      ++batch;
      used = 0;
    }
    p->batch[k] = static_cast<signed char>(batch);
    p->lo[k] = static_cast<signed char>(used);
    p->hi[k] = static_cast<signed char>(hk >= 0 ? used + 1 : -1);
    used += need;
    p->opens |= 1u << k;
    p->batches = batch + 1;
  }
}


struct Runs {
  int count;                     // at most kFewRuns
  int begin[kFewRuns + 1];       // begin[count] = n
};

// pieces[r * (blocks + 1) + b]: the first sorted row of run r whose input
// row is b * kInputTile or more (b = blocks: the run's end).
__global__ void __launch_bounds__(kThreads)
pieces_kernel(const int* __restrict__ order, Runs runs, int blocks,
              int* pieces) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)runs.count * (blocks + 1)) return;
  const int r = static_cast<int>(idx / (blocks + 1));
  const long long x = (idx % (blocks + 1)) * (long long)kInputTile;
  int lo = runs.begin[r], hi = runs.begin[r + 1];
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(order + mid) < x) lo = mid + 1; else hi = mid;
  }
  pieces[idx] = lo;
}

// A block's pieces: piece r holds its virtual rows [at[r], at[r + 1]),
// the sorted rows from lo[r]; prev[r] is the input row of the sorted row
// before lo[r] (-1: none).
struct PieceTable {
  int count;
  int lo[kFewRuns];
  int at[kFewRuns + 1];
  int prev[kFewRuns];
};


__device__ void load_pieces(const Scratch& sc, const int* __restrict__ order,
                            int nruns, int blocks, PieceTable* t) {
  const int tid = threadIdx.x;
  if (tid < nruns) {
    const int* p = sc.pieces + (long long)tid * (blocks + 1) + blockIdx.x;
    const int lo = p[0];
    t->lo[tid] = lo;
    t->at[tid + 1] = p[1] - lo;
    t->prev[tid] = order && lo > 0 ? __ldg(order + lo - 1) : -1;
  }
  __syncthreads();
  if (tid == 0) {
    t->count = nruns;
    t->at[0] = 0;
    for (int r = 0; r < nruns; ++r) t->at[r + 1] += t->at[r];
  }
  __syncthreads();
}

// The piece that holds virtual row v: the first r with at[r + 1] > v.
__device__ __forceinline__ int piece_of(const PieceTable* t, int v) {
  int lo = 0, hi = t->count;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t->at[mid + 1] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A run-path thread's sorted positions, found only where a positional
// kind reads them (a search of the piece table a row), so the fold keeps
// no register for them.
struct RunPos {
  const PieceTable* t;
  __device__ __forceinline__ long long operator()(int j) const {
    const int v = static_cast<int>(threadIdx.x) * kDirectRows + j;
    if (v >= t->at[t->count]) return 0;          // past the block's rows
    const int r = piece_of(t, v);
    return t->lo[r] + (v - t->at[r]);
  }
};

// The block's virtual rows' input rows, less the block's first, into
// s_rows: read through the order, coalesced (a piece is a stretch of
// sorted rows), a thread's loads in flight together; 0 past its rows.
__device__ void load_run_rows(const PieceTable* t,
                              const int* __restrict__ order, int base,
                              int* s_rows) {
  constexpr int kPer = kInputTile / kThreads;
  const int rows = t->at[t->count];
  int rel[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = u * kThreads + threadIdx.x;
    rel[u] = base;               // past the block's rows: row 0
    if (i < rows) {
      const int r = piece_of(t, i);
      rel[u] = __ldg(order + t->lo[r] + (i - t->at[r]));
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    s_rows[padded(u * kThreads + threadIdx.x)] = rel[u] - base;
}

// A staged 8-byte word's place: 2 words of padding after each 32, so the
// threads of a warp, whose rows lie 8 / d input rows apart (d: their
// group's share), hit distinct banks; 16-byte copies stay aligned.
constexpr int kSlotWords = kInputTile + kInputTile / 16;

// rows bytes (width 1) or 8-byte words (width 8, placed by sw) of src
// from row base into shared memory: 16-byte copies in flight together
// where aligned (the caller waits), else plain.
__device__ void stage_range(void* smem, const void* src, long long base,
                            int rows, int width) {
  const unsigned char* g =
      static_cast<const unsigned char*>(src) + base * width;
  const int whole = reinterpret_cast<size_t>(g) % 16 == 0
                        ? rows * width / 16 : 0;
  if (width == 8) {
    long long* d = static_cast<long long*>(smem);
    const long long* g8 = reinterpret_cast<const long long*>(g);
    for (int c = threadIdx.x; c < whole; c += kThreads)
      copy16(d + sw(2 * c), g8 + 2 * c);
    for (int i = whole * 2 + threadIdx.x; i < rows; i += kThreads)
      d[sw(i)] = __ldg(g8 + i);
    return;
  }
  unsigned char* d = static_cast<unsigned char*>(smem);
  for (int c = threadIdx.x; c < whole; c += kThreads)
    copy16(d + 16 * c, g + 16 * c);
  for (int i = whole * 16 + threadIdx.x; i < rows; i += kThreads)
    d[i] = __ldg(g + i);
}

// Each thread's virtual rows: rel[j] (the input row less the block's
// first), and the bits of the rows below the block's count and of the
// rows that begin a piece.
template <int K>
__device__ __forceinline__ void run_view(const PieceTable* t,
                                         const int* s_rows, int (&rel)[K],
                                         unsigned* valid, unsigned* brk) {
  const int rows = t->at[t->count];
  const int v0 = threadIdx.x * K;
  int r = v0 < rows ? piece_of(t, v0) : 0;
  *valid = 0;
  *brk = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int v = v0 + j;
    rel[j] = 0;
    if (v < rows) {
      while (t->at[r + 1] <= v) ++r;
      rel[j] = s_rows[padded(v)];
      *valid |= 1u << j;
      *brk |= v == t->at[r] ? (1u << j) : 0u;
    }
  }
}

// The starts of the run path: block b's rows' start bits
// (sc.masks[b][thread]) and each piece's start count.  *flag is set and
// nothing written when a block holds more than kInputTile rows (an order
// that is not a permutation).  Four blocks an SM (two key words staged a
// batch): 10 % faster than three at q1d's call.
template <int K>
__global__ void __launch_bounds__(kThreads, 4)
run_starts_kernel(Keys keys, const int* __restrict__ order, int n,
                  int nruns, int blocks, Scratch sc, int* flag) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ PieceTable s_t;
  __shared__ int s_rows[kPaddedTile];
  __shared__ int s_warp[kWarps];
  __shared__ int s_cnt[kFewRuns];
  __shared__ long long s_pk[kKeySlots * kFewRuns];   // the row before a piece
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * kInputTile;
  const int in_rows = n - base < kInputTile ? static_cast<int>(n - base)
                                            : kInputTile;
  long long* s_key = reinterpret_cast<long long*>(s_dyn);
  unsigned char* s_live = s_dyn + kKeySlots * kSlotWords * 8;
  // the varying key words, kKeySlots at a time: the first batch and the
  // live flags in flight while the pieces and the rows load
  int k = 0;
  int words[kKeySlots];
  auto next_batch = [&]() {
    int nw = 0;
    for (; k < keys.words.count && nw < kKeySlots; ++k)
      if (keys.varying[k]) words[nw++] = k;
    for (int q = 0; q < nw; ++q)
      stage_range(s_key + q * kSlotWords, keys.words.w[words[q]], base,
                  in_rows, 8);
    return nw;
  };
  int nw = next_batch();
  if (keys.live) stage_range(s_live, keys.live, base, in_rows, 1);
  load_pieces(sc, order, nruns, blocks, &s_t);
  if (s_t.at[nruns] > kInputTile) {
    if (tid == 0) atomicOr(flag, 1);
    return;
  }
  load_run_rows(&s_t, order, static_cast<int>(base), s_rows);
  if (tid < kFewRuns) s_cnt[tid] = 0;
  __syncthreads();
  int rel[K];
  unsigned valid, brk;
  run_view<K>(&s_t, s_rows, rel, &valid, &brk);
  const int v0 = tid * K;
  const int r0 = v0 < s_t.at[nruns] ? piece_of(&s_t, v0) : 0;
  // a row with no sorted row before it starts a group
  unsigned diff = 0;
  {
    int r = r0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!((brk >> j) & 1u)) continue;
      while (s_t.at[r + 1] <= v0 + j) ++r;
      if (s_t.prev[r] < 0) diff |= 1u << j;
    }
  }
  // each varying word compared with the sorted row before: in the
  // thread, in the block, or the row before the piece
  while (nw > 0) {
    if (tid < nruns)
      for (int q = 0; q < nw; ++q)
        s_pk[q * kFewRuns + tid] =
            s_t.prev[tid] >= 0 ? keys.words.w[words[q]][s_t.prev[tid]] : 0;
    copy_wait();
    __syncthreads();
    if (valid) {
      for (int q = 0; q < nw; ++q) {
        const long long* sk = s_key + q * kSlotWords;
        int r = r0;
        long long p = 0;
        if (!(brk & 1u)) p = sk[sw(s_rows[padded(v0 - 1)])];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (!((valid >> j) & 1u)) break;
          if ((brk >> j) & 1u) {
            while (s_t.at[r + 1] <= v0 + j) ++r;
            p = s_pk[q * kFewRuns + r];
          }
          const long long c = sk[sw(rel[j])];
          diff |= c != p ? (1u << j) : 0u;
          p = c;
        }
      }
    }
    __syncthreads();                      // the batch is read
    nw = next_batch();
  }
  unsigned lv = 0xffffffffu;
  if (keys.live) {
    copy_wait();
    __syncthreads();
    lv = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) lv |= s_live[rel[j]] ? (1u << j) : 0u;
  }
  const unsigned m = diff & lv & valid;
  sc.masks[(long long)blockIdx.x * kThreads + tid] =
      static_cast<unsigned short>(m);
  if (m) {
    int r = r0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!((valid >> j) & 1u)) break;
      while (s_t.at[r + 1] <= v0 + j) ++r;
      if ((m >> j) & 1u) atomicAdd(&s_cnt[r], 1);
    }
  }
  __syncthreads();
  if (tid < nruns)
    sc.tile_counts[(long long)tid * blocks + blockIdx.x] = s_cnt[tid];
}

// Dynamic shared memory of a run fold block: kRunSlots lanes of the
// block's input rows, its masks (kInputTile bytes each) and their bits a
// thread, then a Defer an op.
constexpr int kRunStage = kRunSlots * kSlotWords * 8;

__host__ __device__ constexpr int run_stage_bytes(int nmasks) {
  return kRunStage + nmasks * (kInputTile + kThreads * 2);
}

// The fold of one set over block b's input rows (the run path): its
// pieces' virtual rows, their boundaries (the starts run_starts_kernel
// found, and each piece's first row), the lanes staged from the block's
// input rows a batch at a time.  The first set writes first_row.  Three
// blocks an SM (85 registers, two lanes staged a batch): the op folds
// are chains of dependent shuffles and adds, and the third block's warps
// fill their stalls (two blocks of four staged lanes took 28 % longer at
// q1d's call).  POS: the set holds a positional kind; a set without one
// runs an instantiation without their code (compiled in, it cost the
// fold 4-5 % at q1x's and q1d's calls, k3_ab.py).
template <bool W128, bool POS>
__global__ void __launch_bounds__(kThreads, 3)
run_fold_kernel(Set s, const int* __restrict__ order, int n, int first_set,
                int nruns, int blocks, Scratch sc, int* first_row,
                int* flag) {
  constexpr int K = kDirectRows;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ PieceTable s_t;
  __shared__ int s_rows[kPaddedTile];
  __shared__ int s_slot[kInputTile];
  __shared__ unsigned char s_piece[kInputTile];
  __shared__ int s_warp[kWarps];
  __shared__ int s_first[kFewRuns];
  __shared__ StepPlan s_plan;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const long long base = (long long)b * kInputTile;
  const int in_rows = n - base < kInputTile ? static_cast<int>(n - base)
                                            : kInputTile;
  long long* s_val = reinterpret_cast<long long*>(s_dyn);
  unsigned char* s_mask = s_dyn + kRunStage;
  unsigned short* s_bits = reinterpret_cast<unsigned short*>(
      s_mask + s.nmasks * kInputTile);
  Defer* defer = reinterpret_cast<Defer*>(s_dyn + run_stage_bytes(s.nmasks));
  if (tid == 0) plan_steps(s, &s_plan);
  __syncthreads();
  auto stage = [&](int bt) {
    for (int k = 0; k < s.count; ++k) {
      if (!((s_plan.opens >> k) & 1u) || s_plan.batch[k] != bt) continue;
      stage_range(s_val + s_plan.lo[k] * kSlotWords, s.lanes[s.lane[k]],
                  base, in_rows, 8);
      if (s_plan.hi[k] >= 0)
        stage_range(s_val + s_plan.hi[k] * kSlotWords,
                    s.lanes[s.lane_hi[k]], base, in_rows, 8);
    }
  };
  // the block's input rows of the masks and the first lanes: in flight
  // while the pieces and the rows load
  for (int q = 0; q < s.nmasks; ++q)
    stage_range(s_mask + q * kInputTile, s.masks[q], base, in_rows, 1);
  if (s_plan.batches > 0) stage(0);
  load_pieces(sc, nullptr, nruns, blocks, &s_t);
  if (s_t.at[nruns] > kInputTile) {
    if (tid == 0) atomicOr(flag, 1);
    return;
  }
  load_run_rows(&s_t, order, static_cast<int>(base), s_rows);
  copy_wait();
  __syncthreads();
  int rel[K];
  unsigned valid, brk;
  run_view<K>(&s_t, s_rows, rel, &valid, &brk);
  for (int q = 0; q < s.nmasks; ++q) {
    unsigned c = 0;
#pragma unroll
    for (int j = 0; j < K; ++j)
      c |= s_mask[q * kInputTile + rel[j]] ? (1u << j) : 0u;
    s_bits[q * kThreads + tid] = static_cast<unsigned short>(c & valid);
  }
  // the boundaries: the starts and each piece's first row
  const unsigned mk =
      sc.masks[(long long)b * kThreads + tid] & valid;
  const unsigned bnd = mk | brk;
  View v;
  v.first = 0;
  v.valid = valid;
  v.mask = bnd;
  int nb, ns;
  v.before = block_exclusive_sum(__popc(bnd), s_warp, &nb);
  const int sbefore = block_exclusive_sum(__popc(mk), s_warp, &ns);
  const int v0 = tid * K;
  const int r0 = v0 < s_t.at[nruns] ? piece_of(&s_t, v0) : 0;
  {
    int r = r0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!((brk >> j) & 1u)) continue;
      while (s_t.at[r + 1] <= v0 + j) ++r;
      s_first[r] = sbefore + __popc(mk & ((1u << j) - 1u));
    }
  }
  __syncthreads();
  {
    int r = r0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (!((bnd >> j) & 1u)) continue;
      while (s_t.at[r + 1] <= v0 + j) ++r;
      const int i = v.before + __popc(bnd & ((1u << j) - 1u));
      s_piece[i] = static_cast<unsigned char>(r);
      int slot = -1;
      const long long piece = (long long)r * blocks + b;
      if ((mk >> j) & 1u) {
        slot = sc.tile_offsets[piece] + sbefore +
               __popc(mk & ((1u << j) - 1u)) - s_first[r];
        if (first_set) {
          first_row[slot] = static_cast<int>(base) + rel[j];
          if (sc.starts) sc.starts[slot] = s_t.lo[r] + (v0 + j - s_t.at[r]);
        }
        if ((brk >> j) & 1u)             // the piece's head is empty
          for (int k = 0; k < s.count; ++k)
            sc.head[piece * s.count + k] = zero_acc();
      }
      s_slot[i] = slot;
    }
  }
  if (tid < nruns && s_t.at[tid] == s_t.at[tid + 1])
    for (int k = 0; k < s.count; ++k)     // an empty piece
      sc.head[((long long)tid * blocks + b) * s.count + k] = zero_acc();
  __syncthreads();
  const RunDest dst{nb, (long long)b * s.count,
                    (long long)blocks * s.count, s_piece, s_slot, sc.head,
                    sc.tail};
  const RunPos rpos{&s_t};
  const int* my_rows = s_rows + padded(v0);   // a thread's 8 rows are
                                              // contiguous in s_rows
  for (int bt = -1; bt < s_plan.batches; ++bt) {
    // bt = -1: the counts, which read no value
    if (bt > 0) {
      __syncthreads();                          // the last batch is read
      stage(bt);
    }
    if (bt > 0) {
      copy_wait();
      __syncthreads();
    }
    for (int k = 0; k < s.count; ++k) {
      if (s_plan.batch[k] != bt || derived(s, k)) continue;
      const RunValues vals{s_val + (bt >= 0 ? s_plan.lo[k] : 0) * kSlotWords,
                           my_rows};
      const RunValues hvals{
          s_val + (s_plan.hi[k] >= 0 ? s_plan.hi[k] : 0) * kSlotWords,
          my_rows};
      const bool sign = s.lane_hi[k] == -2;
      const unsigned c = s_bits[s.mask[k] * kThreads + tid];
#define SRT_FOLD(KIND) \
  fold_op<KIND, K>(s, k, vals, hvals, sign, rpos, c, v, dst, defer + k)
      if constexpr (W128 && POS) {
        SRT_KINDS(s.kind[k], SRT_FOLD)
      } else if constexpr (W128) {
        SRT_KINDS_BASE(s.kind[k], SRT_FOLD)
      } else if constexpr (POS) {
        SRT_KINDS64(s.kind[k], SRT_FOLD)
      } else {
        SRT_KINDS64_BASE(s.kind[k], SRT_FOLD)
      }
#undef SRT_FOLD
    }
  }
  __syncthreads();
  for (int item = tid; item < s.count * (kWarps + 1); item += kThreads) {
    const int k = item / (kWarps + 1);
    if (derived(s, k)) continue;
#define SRT_FINISH(KIND) \
  finish_op<KIND>(s, k, item - k * (kWarps + 1), defer + k, dst)
    if constexpr (W128 && POS) {
      SRT_KINDS(s.kind[k], SRT_FINISH)
    } else if constexpr (W128) {
      SRT_KINDS_BASE(s.kind[k], SRT_FINISH)
    } else if constexpr (POS) {
      SRT_KINDS64(s.kind[k], SRT_FINISH)
    } else {
      SRT_KINDS64_BASE(s.kind[k], SRT_FINISH)
    }
#undef SRT_FINISH
  }
}

// Op k of the group begun at tile t's last start: the tail partial,
// then the head partials of tiles [lo, hi) of each thread, joined by a
// warp tree (WIDE: then across the block's warps).
// The partials a fixup joins after tile t's tail: item i < direct is
// tile t + 1 + i's head, item i past it the head of block bt + 1 + i -
// direct of kFixTiles tiles (fixup_heads_kernel).
struct Partials {
  const Acc* head;
  const Acc* block_heads;
  int first;                   // t + 1
  int direct;
  int first_block;             // bt + 1
  __device__ __forceinline__ Acc operator()(const Set& s, int k,
                                            int i) const {
    return i < direct
               ? head[(long long)(first + i) * s.count + k]
               : block_heads[(long long)(first_block + i - direct) *
                                 s.count + k];
  }
};

template <int KIND, bool WIDE>
__device__ void fixup_op(const Set& s, int k, int t, int slot, int lo,
                         int hi, const Partials& parts, const Acc* tail,
                         Acc* s_warp) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  Acc a = zero_acc();
  // a thread's partials 8 loads at a time, all in flight together
  for (int u = lo; u < hi; u += 8) {
    Acc x[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      x[q] = u + q < hi ? parts(s, k, u + q) : zero_acc();
#pragma unroll
    for (int q = 0; q < 8; ++q) a = combine<KIND>(a, x[q]);
  }
  // lanes paired in order, so a tie keeps the earlier partial
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Acc b = shfl_down(a, off);
    if ((lane & (2 * off - 1)) == 0) a = combine<KIND>(a, b);
  }
  if (!WIDE) {
    if (lane == 0)
      write_group<is128(KIND)>(
          s, s.kind[k], k, slot,
          combine<KIND>(tail[(long long)t * s.count + k], a));
    return;
  }
  if (lane == 0) s_warp[w] = a;
  __syncthreads();
  if (tid == 0) {
    Acc r = tail[(long long)t * s.count + k];
    for (int q = 0; q < kWarps; ++q) r = combine<KIND>(r, s_warp[q]);
    write_group<is128(KIND)>(s, s.kind[k], k, slot, r);
  }
  __syncthreads();
}

template <bool WIDE, bool W128>
__device__ void fixup_ops(const Set& s, int t, int slot, int lo, int hi,
                          const Partials& parts, const Acc* tail,
                          Acc* s_warp) {
#pragma unroll 1
  for (int k = 0; k < s.count; ++k) {
    if (derived(s, k)) continue;
#define SRT_FIX(KIND) \
  fixup_op<KIND, WIDE>(s, k, t, slot, lo, hi, parts, tail, s_warp)
    switch (s.kind[k]) {
      case kFirst: SRT_FIX(kFirst); break;
      case kLast: SRT_FIX(kLast); break;
      case kMinInt: SRT_FIX(kMinInt); break;
      case kMaxInt: SRT_FIX(kMaxInt); break;
      case kMinFloat: SRT_FIX(kMinFloat); break;
      case kMaxFloat: SRT_FIX(kMaxFloat); break;
      case kSum128: if constexpr (W128) SRT_FIX(kSum128); break;
      case kMin128: if constexpr (W128) SRT_FIX(kMin128); break;
      case kMax128: if constexpr (W128) SRT_FIX(kMax128); break;
      default: SRT_FIX(kCount);  // counts and 64-bit sums combine alike
    }
#undef SRT_FIX
  }
}

// The fixup over a chunk of tiles a block (kFixTiles on the run path, a
// tile a warp over tiles of sorted rows: 64 tiles a block left a warp
// walking 8 tiles' groups in turn, 52 us of qg2's call on the H100, 13
// with 8): one load a tile finds those that
// hold a start; a warp finishes each whose group closes within the next
// 32 tiles (one partial a lane), and the block together each of the
// others (a group over many tiles: a hot key, or few groups), whose end a
// binary search over the tiles' first slots finds, joining the heads of
// its own block's later tiles and then whole blocks' heads
// (fixup_heads_kernel): a group over 15,800 pieces (a group of TPC-H Q1's
// six on the run path) joins about 310 partials, not 15,800.  Blocks for
// tiles without a start cost one read, so pieces without a start (the
// run path's) cost little.
constexpr int kFixTiles = 64;

// block_heads[b][op]: block b's tiles' heads joined in order, from its
// first tile through its first tile that holds a start (all of them if
// none does): what a group begun before block b takes from it when it
// closes inside block b or runs through it.  A warp an op.
template <bool W128>
__global__ void __launch_bounds__(kThreads)
fixup_heads_kernel(Set s, const int* tile_counts, int tiles,
                   const Acc* head, Acc* block_heads) {
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int t0 = blockIdx.x * kFixTiles;
  if (tid < 32) {
    int last = kFixTiles - 1;
    for (int c = kFixTiles - 32; c >= 0; c -= 32) {
      const int t = t0 + c + lane;
      const unsigned m =
          __ballot_sync(0xffffffffu, t < tiles && tile_counts[t] > 0);
      if (m) last = c + __ffs(m) - 1;
    }
    if (lane == 0) s_last = min(last, tiles - 1 - t0);
  }
  __syncthreads();
  const int n = s_last + 1;                    // tiles joined
  for (int k = tid >> 5; k < s.count; k += kWarps) {
    if (derived(s, k)) continue;
    const Partials parts{head, nullptr, t0, kFixTiles, 0};
#define SRT_HEADS(KIND)                                                     \
  {                                                                         \
    Acc a = zero_acc();                                                     \
    for (int i = 2 * lane; i < 2 * lane + 2; ++i)                           \
      a = combine<KIND>(a, i < n ? parts(s, k, i) : zero_acc());            \
    for (int off = 1; off < 32; off <<= 1) {                                \
      const Acc b = shfl_down(a, off);                                      \
      if ((lane & (2 * off - 1)) == 0) a = combine<KIND>(a, b);             \
    }                                                                       \
    if (lane == 0) block_heads[(long long)blockIdx.x * s.count + k] = a;    \
  }
    switch (s.kind[k]) {
      case kFirst: SRT_HEADS(kFirst); break;
      case kLast: SRT_HEADS(kLast); break;
      case kMinInt: SRT_HEADS(kMinInt); break;
      case kMaxInt: SRT_HEADS(kMaxInt); break;
      case kMinFloat: SRT_HEADS(kMinFloat); break;
      case kMaxFloat: SRT_HEADS(kMaxFloat); break;
      case kSum128: if constexpr (W128) SRT_HEADS(kSum128); break;
      case kMin128: if constexpr (W128) SRT_HEADS(kMin128); break;
      case kMax128: if constexpr (W128) SRT_HEADS(kMax128); break;
      default: SRT_HEADS(kCount);
    }
#undef SRT_HEADS
  }
}

// The first u in (t, tiles) whose first slot passes v, else tiles: past
// the next tile holding a start after one whose last slot is v - 1.
__device__ int next_start(const int* offsets, int t, int tiles, int v) {
  int lo = t + 1, hi = tiles;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offsets[mid] > v) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// chunk: the tiles a block takes, kWarps (a warp a tile: the tile paths,
// whose tiles mostly hold a start) or kFixTiles (the run path's pieces,
// which mostly hold none).
template <bool W128>
__global__ void __launch_bounds__(kThreads)
fixup_kernel(Set s, const int* tile_counts, const int* tile_offsets,
             int tiles, int chunk, const Acc* head, const Acc* tail,
             const Acc* block_heads) {
  __shared__ int s_list[kFixTiles], s_wide[kFixTiles];
  __shared__ int s_n, s_nwide, s_end;
  __shared__ Acc s_warp[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int t0 = blockIdx.x * chunk;
  if (tid < 32) {
    // the block's tiles that hold a start, in order
    int n = 0;
    for (int c = 0; c < chunk; c += 32) {
      const int t = t0 + c + lane;
      const bool has = c + lane < chunk && t < tiles && tile_counts[t] > 0;
      const unsigned m = __ballot_sync(0xffffffffu, has);
      if (has) s_list[n + __popc(m & ((1u << lane) - 1u))] = t;
      n += __popc(m);
    }
    if (lane == 0) {
      s_n = n;
      s_nwide = 0;
    }
  }
  __syncthreads();
  // a warp a tile where the group closes within the next 32 tiles
  for (int q = w; q < s_n; q += kWarps) {
    const int t = s_list[q];
    const int u = t + 1 + lane;
    const unsigned m =
        __ballot_sync(0xffffffffu, u < tiles && tile_counts[u] > 0);
    const int end = m ? t + 1 + __ffs(m) : (t + 33 >= tiles ? tiles : -1);
    if (end < 0) {
      if (lane == 0) s_wide[atomicAdd(&s_nwide, 1)] = t;
      continue;
    }
    const int slot = tile_offsets[t] + tile_counts[t] - 1;
    const Partials parts{head, nullptr, t + 1, 32, 0};
    fixup_ops<false, W128>(s, t, slot, lane, min(lane + 1, end - t - 1),
                           parts, tail, s_warp);
  }
  __syncthreads();
  // the block a tile whose group runs on further
  for (int q = 0; q < s_nwide; ++q) {
    const int t = s_wide[q];
    const int slot = tile_offsets[t] + tile_counts[t] - 1;
    if (tid == 0) s_end = next_start(tile_offsets, t, tiles, slot + 1);
    __syncthreads();
    const int end = s_end;
    // this block's later tiles, then whole blocks through the one that
    // holds the group's last tile
    const int bt = t / kFixTiles, be = (end - 1) / kFixTiles;
    const int direct = be > bt ? (bt + 1) * kFixTiles - t - 1 : end - t - 1;
    const int count = direct + (be > bt ? be - bt : 0);
    const Partials parts{head, block_heads, t + 1, direct, bt + 1};
    const int per = (count + kThreads - 1) / kThreads;
    const int lo = tid * per;
    fixup_ops<true, W128>(s, t, slot, lo, min(lo + per, count), parts, tail,
                          s_warp);
  }
}

// An ungrouped aggregate over no rows: one group, every count 0.
__global__ void empty_global_kernel(Set s, int* first_row, int* groups) {
  *groups = 1;
  *first_row = 0;
  for (int k = 0; k < s.count; ++k)
    write_group<true>(s, s.kind[k], k, 0, zero_acc());
}

// The ops derived from the groups' bounds (mask -1: every row
// contributes), after the set's fold, a thread a group: group g holds the
// sorted rows [starts[g], starts[g + 1]), the last group through n - 1,
// so a count is its length and first and last its first and last rows,
// mapped through the order to input rows (first is the group's first
// row, which the fold wrote).  Rows before the first start belong to no
// group, as in the fold.
__global__ void __launch_bounds__(kThreads)
bounds_kernel(Set s, const int* __restrict__ starts,
              const int* __restrict__ groups,
              const int* __restrict__ first_row, int n) {
  const int count = *groups;
  const int stride = gridDim.x * kThreads;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < count;
       g += stride) {
    for (int k = 0; k < s.count; ++k) {
      if (!derived(s, k)) continue;
      int* pick = static_cast<int*>(s.sums[k]);
      const int lo = starts[g];
      const int hi = g + 1 < count ? starts[g + 1] : n;
      s.counts[k][g] = hi - lo;
      if (s.kind[k] == kFirst)
        pick[g] = first_row[g];
      else if (s.kind[k] == kLast)
        pick[g] = s.order ? __ldg(s.order + hi - 1) : hi - 1;
    }
  }
}

long long up16(long long x) { return (x + 15) / 16 * 16; }

long long tiles_of(int n, int rows_per_thread) {
  const long long t = (long long)kThreads * rows_per_thread;
  return (n + t - 1) / t;
}

// The scratch regions, each 16-byte aligned: the look-back state (a tile
// counter and a status word a tile), the start bits, the tiles' start
// counts and first slots, the head and tail partials [tiles][ops], the
// records (n of record_max bytes), on the run path (runs > 0) the
// pieces' sorted rows [runs][tiles + 1], the counts, slots and partials
// being the pieces' (runs x tiles), the fixup's block heads, and with
// bounds the groups' first sorted positions (n ints).  ops_per_set and
// record_max are the most any set of the call has.  Returns the bytes.
long long layout(char* base, int n, int rows_per_thread, int ops_per_set,
                 int record_max, int runs, int bounds, Scratch* sc) {
  const long long tiles = tiles_of(n, rows_per_thread);
  const long long parts = runs > 0 ? runs * tiles : tiles;
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
  s.tile_counts = reinterpret_cast<int*>(take(parts * 4));
  s.tile_offsets = reinterpret_cast<int*>(take(parts * 4));
  s.head = reinterpret_cast<Acc*>(take(parts * ops * sizeof(Acc)));
  s.tail = reinterpret_cast<Acc*>(take(parts * ops * sizeof(Acc)));
  s.records = reinterpret_cast<const uint4*>(
      take((long long)n * record_max));
  s.pieces = reinterpret_cast<int*>(take(runs * (tiles + 1) * 4));
  s.block_heads = reinterpret_cast<Acc*>(
      take((parts + kFixTiles - 1) / kFixTiles * ops * sizeof(Acc)));
  s.starts = bounds ? reinterpret_cast<int*>(take((long long)n * 4))
                   : nullptr;
  if (sc) *sc = s;
  return off;
}

template <int K, bool REC, bool W128, bool LIGHT = false>
int launch_fold(const Set& s, const Keys& keys, const int* order, int n,
                int global_agg, int first_set, int R, const Scratch& sc,
                int tiles, int* first_row, int* groups,
                cudaStream_t stream) {
  const int smem = stage_bytes(K, REC ? R : 0) +
                   (s.count > 0 ? s.count : 1) * static_cast<int>(sizeof(Defer));
  const cudaError_t err = cudaFuncSetAttribute(
      fold_kernel<K, REC, W128, LIGHT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_kernel<K, REC, W128, LIGHT><<<tiles, kThreads, smem, stream>>>(
      s, keys, order, n, global_agg, first_set, R, sc, tiles, first_row,
      groups);
  return static_cast<int>(cudaGetLastError());
}

// A run-path kernel's dynamic shared memory, with all of the SM's shared
// memory for its blocks.
template <class Kernel>
cudaError_t run_smem(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// The run path's launches for one set: on the first set the pieces, the
// starts and the pieces' first slots (flag: groups + 1), then the fold
// and the fixup over the pieces.
template <bool W128, bool POS>
int launch_runs(const Set& s, const Keys& keys, const int* order, int n,
                int first_set, const Runs& runs, const Scratch& sc,
                int blocks, int* first_row, int* groups,
                cudaStream_t stream) {
  const int pieces = runs.count * blocks;
  cudaError_t err = cudaSuccess;
  if (first_set) {
    err = cudaMemsetAsync(groups + 1, 0, sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long bounds = (long long)runs.count * (blocks + 1);
    pieces_kernel<<<static_cast<unsigned>((bounds + kThreads - 1) / kThreads),
                    kThreads, 0, stream>>>(order, runs, blocks, sc.pieces);
    const int key_smem = kKeySlots * kSlotWords * 8 + kInputTile;
    err = run_smem(run_starts_kernel<kDirectRows>, key_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    run_starts_kernel<kDirectRows><<<blocks, kThreads, key_smem, stream>>>(
        keys, order, n, runs.count, blocks, sc, groups + 1);
    srt::scan_kernel<<<1, srt::kScanThreads, 0, stream>>>(
        sc.tile_counts, pieces, sc.tile_offsets, groups);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int smem = run_stage_bytes(s.nmasks) +
                   (s.count > 0 ? s.count : 1) * static_cast<int>(sizeof(Defer));
  err = run_smem(run_fold_kernel<W128, POS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  run_fold_kernel<W128, POS><<<blocks, kThreads, smem, stream>>>(
      s, order, n, first_set, runs.count, blocks, sc, first_row, groups + 1);
  const int fix_blocks = (pieces + kFixTiles - 1) / kFixTiles;
  fixup_heads_kernel<W128><<<fix_blocks, kThreads, 0, stream>>>(
      s, sc.tile_counts, pieces, sc.head, sc.block_heads);
  fixup_kernel<W128><<<fix_blocks, kThreads, 0, stream>>>(
      s, sc.tile_counts, sc.tile_offsets, pieces, kFixTiles, sc.head,
      sc.tail, sc.block_heads);
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
// up to 64, and varying[nwords + 1 + q], q < min(descents, 64), the
// positions i of those descents (order[i + 1] < order[i]) in no order.
// varying: int32[nwords + 65].
extern "C" int srt_segment_reduce_varying(const long long* const* words,
                                          int nwords, const int* order,
                                          int n, int* varying,
                                          cudaStream_t stream) {
  if (nwords < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaMemsetAsync(varying, 0, (nwords + 1 + kFewRuns) * sizeof(int),
                      stream);
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
// int64 min / max, 5 / 6 float64 min / max, 7 128-bit sum, 8 / 9 128-bit
// min / max, 10 / 11 first / last: the input row of the least / greatest
// sorted position of a contributing row, int32 into sums[k]), op_lane[k]
// (index into lanes, -1 for a count or a positional kind; a 128-bit
// kind's low words), op_lane_hi[k] (a 128-bit kind's high words; -2 for
// a 128-bit sum whose high words are the low words' signs, a DECIMAL64
// input; else -1), op_mask[k] (index into masks: its contributor mask,
// also its bit in a record's mask word; -1 for a count, first or last
// over every row, derived from the group's bounds and never folded),
// sums[k] (the lane's type, [max(n, 1)], null for a count; min and max
// write the kept value's bits, 0 where no row contributed; a 128-bit kind
// the low words), sums_hi[k] (a 128-bit kind's high words,
// int64[max(n, 1)]), counts[k] (int64[max(n, 1)]).  lanes:
// nlanes (<= 16) int64 / float64 [n] device pointers, distinct, at
// lane_off in a record; masks: nmasks (<= 16) bool[n], distinct; the
// mask word at mask_off.  record_bytes: 16, 32, 64 or 128 (the record
// path), or 0 (the direct path, rows_per_thread 8); on the record path
// rows_per_thread is 256 / record_max and record_bytes <= record_max.
// The first set (first_set 1) finds the groups: they fill slots
// [0, *groups) in key order and first_row[g] is the input row of group
// g's first sorted row; rows before the first start belong to no group.
// Later sets read its start bits, slots and starts, so each call of a
// set passes the same n, rows_per_thread, ops_per_set, record_max,
// bounds_max (1 where any set derives an op from the bounds) and scratch
// (scratch_bytes, 16-byte aligned, at least what layout() takes for
// them: exec/aggregate.py k3_scratch_bytes).  run_begin (host, nruns + 1
// ints, 0 = run_begin[0] < ... < run_begin[nruns] = n) with nruns in
// [1, 64]: the increasing runs of the order (a permutation), which send
// the direct path through input tiles (the run path; every set of the
// call passes them, and the scratch is laid out for them); nruns 0: tiles
// of sorted rows.  groups: int32[2]; on the run path groups[1] is set
// when a block found more rows than it takes (the order is no
// permutation), and the call's results are then void.
extern "C" int srt_segment_reduce_set(
    const long long* const* words, int nwords, const int* varying,
    int nkeys, const void* const* key_w, const int* key_off,
    const unsigned char* live, const int* order, int n, int global_agg,
    int first_set, int nops, const int* kind, const int* op_lane,
    const int* op_lane_hi, const int* op_mask, void* const* sums,
    void* const* sums_hi, long long* const* counts,
    int nlanes, const void* const* lanes, const int* lane_off, int nmasks,
    const void* const* masks, int mask_off, int record_bytes,
    int rows_per_thread, int ops_per_set, int record_max, int bounds_max,
    int* first_row, int* groups, void* scratch, long long scratch_bytes,
    const int* run_begin, int nruns, cudaStream_t stream) {
  const bool rec = record_bytes > 0;
  const bool sched = nruns > 0 && n > 0;
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
  bool folded = false, bounds = false;
  for (int k = 0; k < nops; ++k) {
    const bool every = op_mask[k] == -1;
    if (kind[k] < kCount || kind[k] > kLast || op_lane[k] < -1 ||
        op_lane[k] >= nlanes ||
        (kind[k] != kCount && !is_pos(kind[k])) != (op_lane[k] >= 0) ||
        op_mask[k] < -1 || op_mask[k] >= nmasks ||
        (every && op_lane[k] >= 0) ||
        (is128(kind[k])
             ? (!sums_hi[k] ||
                (op_lane_hi[k] == -2
                     ? kind[k] != kSum128
                     : (op_lane_hi[k] < 0 || op_lane_hi[k] >= nlanes ||
                        op_lane_hi[k] == op_lane[k])))
             : op_lane_hi[k] != -1))
      return static_cast<int>(cudaErrorInvalidValue);
    s.kind[k] = kind[k];
    s.lane[k] = op_lane[k];
    s.lane_hi[k] = op_lane_hi[k];
    s.mask[k] = op_mask[k];
    s.sums[k] = sums[k];
    s.sums_hi[k] = static_cast<long long*>(sums_hi[k]);
    s.counts[k] = counts[k];
    bounds |= every;
    folded |= !every;
  }
  if (bounds && !bounds_max) return static_cast<int>(cudaErrorInvalidValue);
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
  s.order = order;
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
             rec ? record_max : 0, sched ? nruns : 0, bounds_max, &sc) >
      scratch_bytes)
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
  // the ops from the groups' bounds, after the set's fold (the first
  // set's finds the starts; a later set of such ops alone folds nothing)
  auto run_bounds = [&]() {
    if (!bounds) return static_cast<int>(cudaGetLastError());
    const long long blocks = (n + kThreads - 1) / kThreads;
    bounds_kernel<<<blocks < 4096 ? static_cast<int>(blocks) : 4096,
                    kThreads, 0, stream>>>(s, sc.starts, groups,
                                           first_row, n);
    return static_cast<int>(cudaGetLastError());
  };
  if (!first_set && !folded) return run_bounds();
  bool w128 = false;
  for (int k = 0; k < nops; ++k) w128 |= is128(kind[k]);
  if (sched) {
    if (rec || global_agg || !order || nruns > kFewRuns || run_begin[0] != 0
        || run_begin[nruns] != n)
      return static_cast<int>(cudaErrorInvalidValue);
    Runs runs;
    runs.count = nruns;
    for (int r = 0; r <= nruns; ++r) {
      if (r > 0 && run_begin[r] <= run_begin[r - 1])
        return static_cast<int>(cudaErrorInvalidValue);
      runs.begin[r] = run_begin[r];
    }
    bool pos = false;
    for (int k = 0; k < nops; ++k) pos |= is_pos(kind[k]) && !derived(s, k);
#define SRT_RUNS(W, P)                                                     \
  launch_runs<W, P>(s, keys, order, n, first_set, runs, sc, tiles, first_row, \
                    groups, stream)
    const int rc = w128 ? (pos ? SRT_RUNS(true, true) : SRT_RUNS(true, false))
                        : (pos ? SRT_RUNS(false, true)
                               : SRT_RUNS(false, false));
#undef SRT_RUNS
    return rc ? rc : run_bounds();
  }
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
  (w128 ? launch_fold<K, REC, true>(s, keys, order, n, global_agg,          \
                                    first_set, R, sc, tiles, first_row,     \
                                    groups, stream)                         \
        : launch_fold<K, REC, false>(s, keys, order, n, global_agg,         \
                                     first_set, R, sc, tiles, first_row,    \
                                     groups, stream))
  if (!rec && nlanes == 0 && !w128) {
    rc = launch_fold<kDirectRows, false, false, true>(
        s, keys, order, n, global_agg, first_set, R, sc, tiles, first_row,
        groups, stream);
  } else if (!rec) {
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
  if (folded) {
    const int fix_blocks = (tiles + kFixTiles - 1) / kFixTiles;
    const int fix_chunks = (tiles + kWarps - 1) / kWarps;
    if (w128) {
      fixup_heads_kernel<true><<<fix_blocks, kThreads, 0, stream>>>(
          s, sc.tile_counts, tiles, sc.head, sc.block_heads);
      fixup_kernel<true><<<fix_chunks, kThreads, 0, stream>>>(
          s, sc.tile_counts, sc.tile_offsets, tiles, kWarps, sc.head,
          sc.tail, sc.block_heads);
    } else {
      fixup_heads_kernel<false><<<fix_blocks, kThreads, 0, stream>>>(
          s, sc.tile_counts, tiles, sc.head, sc.block_heads);
      fixup_kernel<false><<<fix_chunks, kThreads, 0, stream>>>(
          s, sc.tile_counts, sc.tile_offsets, tiles, kWarps, sc.head,
          sc.tail, sc.block_heads);
    }
  }
  return run_bounds();
}

// srt_segment_reduce_set with its arguments in one block of int64 slots
// (a pointer as its 64 bits), so the host builds one array a set in
// place of some forty foreign-call arguments: slots [0, 32) the scalars
// and single pointers (kArg* below), then fixed-size arrays of key word
// pointers and their record offsets, the ops' kinds, lanes, high lanes
// and masks, their results' and counts' pointers, the lanes and their
// record offsets, the masks, and the runs' beginnings.  This file owns
// the layout: the host asks each slot's index by name
// (srt_segment_reduce_slot; exec/aggregate.py _k3_slots).
namespace {
enum : int {
  kArgWords, kArgNwords, kArgVarying, kArgNkeys, kArgLive, kArgOrder,
  kArgN, kArgGlobal, kArgFirstSet, kArgNops, kArgNlanes, kArgNmasks,
  kArgMaskOff, kArgRecordBytes, kArgRows, kArgOpsPerSet, kArgRecordMax,
  kArgBoundsMax, kArgFirstRow, kArgGroups, kArgScratch, kArgScratchBytes,
  kArgNruns,
  kArgKeyW = 32,
  kArgKeyOff = kArgKeyW + kMaxKeys,
  kArgKind = kArgKeyOff + kMaxKeys,
  kArgLane = kArgKind + kOpsPerLaunch,
  kArgLaneHi = kArgLane + kOpsPerLaunch,
  kArgMask = kArgLaneHi + kOpsPerLaunch,
  kArgSums = kArgMask + kOpsPerLaunch,
  kArgSumsHi = kArgSums + kOpsPerLaunch,
  kArgCounts = kArgSumsHi + kOpsPerLaunch,
  kArgLanes = kArgCounts + kOpsPerLaunch,
  kArgLaneOff = kArgLanes + kOpsPerLaunch,
  kArgMasks = kArgLaneOff + kOpsPerLaunch,
  kArgRunBegin = kArgMasks + kOpsPerLaunch,
  kArgSlots = kArgRunBegin + kFewRuns + 1
};

// Each slot's name; an array's stands for its first slot.
struct SlotName {
  const char* name;
  int at;
};
constexpr SlotName kSlotNames[] = {
    {"words", kArgWords},         {"nwords", kArgNwords},
    {"varying", kArgVarying},     {"nkeys", kArgNkeys},
    {"live", kArgLive},           {"order", kArgOrder},
    {"n", kArgN},                 {"global_agg", kArgGlobal},
    {"first_set", kArgFirstSet},  {"nops", kArgNops},
    {"nlanes", kArgNlanes},       {"nmasks", kArgNmasks},
    {"mask_off", kArgMaskOff},    {"record_bytes", kArgRecordBytes},
    {"rows", kArgRows},           {"ops_per_set", kArgOpsPerSet},
    {"record_max", kArgRecordMax}, {"bounds_max", kArgBoundsMax},
    {"first_row", kArgFirstRow},  {"groups", kArgGroups},
    {"scratch", kArgScratch},     {"scratch_bytes", kArgScratchBytes},
    {"nruns", kArgNruns},         {"key_w", kArgKeyW},
    {"key_off", kArgKeyOff},      {"kind", kArgKind},
    {"lane", kArgLane},           {"lane_hi", kArgLaneHi},
    {"mask", kArgMask},           {"sums", kArgSums},
    {"sums_hi", kArgSumsHi},      {"counts", kArgCounts},
    {"lanes", kArgLanes},         {"lane_off", kArgLaneOff},
    {"masks", kArgMasks},         {"run_begin", kArgRunBegin},
    {"slots", kArgSlots}};

template <class T>
const T* slots_as(const long long* a, int at) {
  return reinterpret_cast<const T*>(a + at);
}
}  // namespace

// The index of the slot called name (an array's first; "slots": the
// block's length), or -1 for a name the block has not.
extern "C" int srt_segment_reduce_slot(const char* name) {
  for (const SlotName& s : kSlotNames)
    if (std::strcmp(s.name, name) == 0) return s.at;
  return -1;
}

extern "C" int srt_segment_reduce_packed(const long long* a,
                                         cudaStream_t stream) {
  const long long nkeys = a[kArgNkeys], nops = a[kArgNops],
                  nlanes = a[kArgNlanes], nruns = a[kArgNruns];
  if (nkeys < 0 || nkeys > kMaxKeys || nops < 0 || nops > kOpsPerLaunch ||
      nlanes < 0 || nlanes > kOpsPerLaunch || nruns < 0 || nruns > kFewRuns)
    return static_cast<int>(cudaErrorInvalidValue);
  int key_off[kMaxKeys], kind[kOpsPerLaunch], lane[kOpsPerLaunch],
      lane_hi[kOpsPerLaunch], mask[kOpsPerLaunch], lane_off[kOpsPerLaunch],
      run_begin[kFewRuns + 1];
  for (int k = 0; k < nkeys; ++k)
    key_off[k] = static_cast<int>(a[kArgKeyOff + k]);
  for (int k = 0; k < nops; ++k) {
    kind[k] = static_cast<int>(a[kArgKind + k]);
    lane[k] = static_cast<int>(a[kArgLane + k]);
    lane_hi[k] = static_cast<int>(a[kArgLaneHi + k]);
    mask[k] = static_cast<int>(a[kArgMask + k]);
  }
  for (int l = 0; l < nlanes; ++l)
    lane_off[l] = static_cast<int>(a[kArgLaneOff + l]);
  for (int r = 0; r <= nruns && nruns > 0; ++r)
    run_begin[r] = static_cast<int>(a[kArgRunBegin + r]);
  return srt_segment_reduce_set(
      reinterpret_cast<const long long* const*>(a[kArgWords]),
      static_cast<int>(a[kArgNwords]),
      reinterpret_cast<const int*>(a[kArgVarying]), static_cast<int>(nkeys),
      slots_as<const void*>(a, kArgKeyW), key_off,
      reinterpret_cast<const unsigned char*>(a[kArgLive]),
      reinterpret_cast<const int*>(a[kArgOrder]),
      static_cast<int>(a[kArgN]), static_cast<int>(a[kArgGlobal]),
      static_cast<int>(a[kArgFirstSet]), static_cast<int>(nops), kind, lane,
      lane_hi, mask, slots_as<void*>(a, kArgSums),
      slots_as<void*>(a, kArgSumsHi), slots_as<long long*>(a, kArgCounts),
      static_cast<int>(nlanes), slots_as<const void*>(a, kArgLanes), lane_off,
      static_cast<int>(a[kArgNmasks]), slots_as<const void*>(a, kArgMasks),
      static_cast<int>(a[kArgMaskOff]), static_cast<int>(a[kArgRecordBytes]),
      static_cast<int>(a[kArgRows]), static_cast<int>(a[kArgOpsPerSet]),
      static_cast<int>(a[kArgRecordMax]), static_cast<int>(a[kArgBoundsMax]),
      reinterpret_cast<int*>(a[kArgFirstRow]),
      reinterpret_cast<int*>(a[kArgGroups]),
      reinterpret_cast<void*>(a[kArgScratch]), a[kArgScratchBytes],
      run_begin, static_cast<int>(nruns), stream);
}

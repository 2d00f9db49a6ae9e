// K19: literal search in every string row, and the match mask of a
// replace.
//
// Replaces the reference's expr/strings.py _match_positions (a bool per
// byte of the whole buffer, one shifted compare per needle byte) and the
// prefix count plus searchsorted that turn it into each row's first
// match: _contains_impl, _eval_like (its tokens between '%', each found
// at or after the end of the one before), _eval_locate and
// _eval_substring_index's count of delimiters.  The pattern (tokens, the
// wildcard flags of LIKE's '_', each token's anchor and the bytes it
// keeps free after it) is compiled on the host.
//
// Tiles (csrc/row_tiles.cuh): a block takes the rows that start in one
// merge-path tile of rows and bytes (at most kTile of each, so runs of
// empty rows spread over many blocks).  Thread 0 loads their bytes into
// shared memory with one bulk asynchronous copy (cp.async.bulk, completed
// on an mbarrier), widened to 16-byte aligned bounds inside the rows'
// bytes; the few bytes at the buffer's two ends that no aligned window
// reaches are loaded by that thread; nothing past offsets[cap] is read.
// While the copy is in flight the block reads its rows' offsets.  Four
// or more blocks on each SM keep their copies in flight while the others
// compare: a persistent block walking a ring of two stages measured
// slower (PERF.md), since the search, not the copy, bounds it.
//
// The search is byte-parallel, then a row reads only the result:
// 1. By bytes: a thread takes 16 consecutive staged bytes (no bank
//    conflict, no divergence by row length) and, for each token not
//    anchored, sets one bit a byte in the token's match bitmap.  A token
//    of at most 4 bytes is compared exactly, four positions at a time:
//    the XORs of its bytes with the words shifted by each byte's place,
//    ORed, are zero in a byte where all match (a wildcard byte masked
//    out).  A longer token's first 4 bytes filter so, and the rare
//    matches are compared whole from registers (8 bytes in two funnel
//    shifts) and past 8 bytes from shared memory.  The integer pipes
//    bound this pass, so no compare or packing is issued that a token
//    does not need.  A match that runs past its row's end is harmless:
//    no row looks past its limit.
// 2. By rows: a thread a row runs the pattern over the bitmaps: the first
//    set bit in [cur, limit] by __ffs over 32-bit words (the last by
//    __clz for a reverse search), each repetition from where the last
//    match ended (so "aa" counts twice in "aaaa", not three times); an
//    anchored token is compared in place, once.  A row costs a few bitmap
//    words.
// A pattern of more than kMaxTokens tokens has no room for its bitmaps
// and takes the per-row path: each thread compares its row's staged
// bytes.  The wrapper chooses (ops/strings.py:find_plan).  A row longer
// than kTile is not staged: its warp searches it in device memory, 32
// candidate positions a step with a ballot, so a 1 MB row costs its warp
// about 32 KB of steps a lane and no other warp waits on it.  The mask
// mode of a replace shares the tile: its one token's bitmap is written
// out as a bool per byte for the matches that end inside their row.  The
// pattern is read through the read-only cache (kernel arguments point at
// it) and copied into a token table in shared memory; no stack frame.
//
// Bound: device-memory bytes, each row's bytes read once, 4 B of
// offsets, 4 B of start where a caller gives one, and 4 B written: the
// last token's position, the one answer every caller reads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16384;                    // items (rows, bytes) a tile
constexpr int kStage = 2 * kTile + 32;              // a tile's bytes, aligned
constexpr int kStageBuf = (kStage + 127) & ~127;    // the stage's bytes
constexpr int kBmWords = ((kStage / 32 + 1) + 1) & ~1;  // bits of a stage
constexpr int kMaxTokens = 8;                       // bitmaps phase 1 keeps
constexpr int kPre = 8;                     // bytes compared in registers

constexpr int kAtStart = 1;
constexpr int kAtEnd = 2;
constexpr unsigned kFull = 0xffffffffu;
enum Path { kBitmaps = 0, kRows = 1, kMask = 2 };

struct Pattern {
  const unsigned char* bytes;  // the tokens laid end to end
  const unsigned char* wild;   // 1 where a byte matches any byte
  const int* tok_off;          // int32[ntok + 1]
  const int* mode;             // int32[ntok]
  const int* reserve;          // int32[ntok]
  int ntok;
  int has_wild;
  int repeat;
  int reverse;
};

// The tokens of a pattern of at most kMaxTokens, in shared memory: each
// token's first 4 bytes as replicated words (b; cmp: bit j where byte j
// is compared, not a wildcard and inside the token), its first kPre
// bytes as two words under their masks, its start, length, anchor and
// reserve.
struct TokTab {
  unsigned b[kMaxTokens][4];
  unsigned cmp[kMaxTokens];
  unsigned v0[kMaxTokens], v1[kMaxTokens];  // bytes 0-3, 4-7 of the token
  unsigned m0[kMaxTokens], m1[kMaxTokens];  // 0xff a compared byte
  int t0[kMaxTokens];
  int len[kMaxTokens];
  int mode[kMaxTokens];
  int reserve[kMaxTokens];
};

// ---- the pattern -------------------------------------------------------------

__device__ __forceinline__ int tok_start(const Pattern& pt, int k) {
  return __ldg(pt.tok_off + k);
}

__device__ __forceinline__ int tok_len(const Pattern& pt, int k) {
  return __ldg(pt.tok_off + k + 1) - __ldg(pt.tok_off + k);
}

__device__ __forceinline__ bool is_wild(const Pattern& pt, int j) {
  return pt.has_wild && __ldg(pt.wild + j);
}

// Token bytes [from, len) of the token at t0 against src[0, len).
__device__ __forceinline__ bool match_from(const unsigned char* src,
                                           const Pattern& pt, int t0,
                                           int len, int from) {
  for (int j = from; j < len; ++j)
    if (!is_wild(pt, t0 + j) && src[j] != __ldg(pt.bytes + t0 + j))
      return false;
  return true;
}

__device__ void fill_tab(TokTab& tab, const Pattern& pt) {
  const int k = threadIdx.x;
  if (k >= pt.ntok || k >= kMaxTokens) return;
  const int t0 = tok_start(pt, k);
  const int len = tok_len(pt, k);
  unsigned cmp = 0;
  unsigned long long v = 0, m = 0;
  for (int j = 0; j < kPre; ++j) {
    const bool on = j < len && !is_wild(pt, t0 + j);
    const unsigned char c = on ? __ldg(pt.bytes + t0 + j) : 0;
    if (j < 4) tab.b[k][j] = c * 0x01010101u;
    if (!on) continue;
    cmp |= 1u << j;
    v |= static_cast<unsigned long long>(c) << (8 * j);
    m |= 0xffull << (8 * j);
  }
  tab.cmp[k] = cmp;
  tab.v0[k] = static_cast<unsigned>(v);
  tab.v1[k] = static_cast<unsigned>(v >> 32);
  tab.m0[k] = static_cast<unsigned>(m);
  tab.m1[k] = static_cast<unsigned>(m >> 32);
  tab.t0[k] = t0;
  tab.len[k] = len;
  tab.mode[k] = __ldg(pt.mode + k);
  tab.reserve[k] = __ldg(pt.reserve + k);
}

// The runner of a pattern over one row's window [cur, hi): each token
// found by find(k, cur, limit) (-1 if none), the next searched from where
// it ended (or, reversed, before where it began); the last repetition's
// last position, -1 once a token does not match.  tab: the token table,
// or null to read the pattern in device memory.
template <class Find>
__device__ __forceinline__ int run_pattern(const Pattern& pt,
                                           const TokTab* tab, Find find,
                                           int cur, int hi) {
  int p = -1;
  for (int rep = 0; rep < pt.repeat; ++rep) {
    for (int k = 0; k < pt.ntok; ++k) {
      const int len = tab ? tab->len[k] : tok_len(pt, k);
      const int limit =
          hi - (tab ? tab->reserve[k] : __ldg(pt.reserve + k)) - len;
      p = find(k, cur, limit);
      if (p < 0) return -1;
      if (pt.reverse) {
        hi = p;
      } else {
        cur = p + len;
      }
    }
  }
  return p;
}

// ---- phase 1: the match bitmaps by bytes -------------------------------------

// 0xff in each byte of the word at w whose position lies in [a, z].
__device__ __forceinline__ unsigned range_mask(int w, int a, int z) {
  unsigned m = kFull;
  if (w < a) m = a - w >= 4 ? 0u : m << (8 * (a - w));
  if (w + 3 > z) m &= z < w ? 0u : kFull >> (8 * (w + 3 - z));
  return m;
}

// The bytes of a 0xff-per-byte mask as 4 bits.
__device__ __forceinline__ unsigned byte_bits(unsigned m) {
  return ((m & 0x01010101u) * 0x01020408u) >> 24;
}

// 0x80 in each zero byte of z, exactly (no borrow crosses a byte).
__device__ __forceinline__ unsigned zero_bytes(unsigned z) {
  return ~(((z & 0x7f7f7f7fu) + 0x7f7f7f7fu) | z) & 0x80808080u;
}

// Bitmap k: bit p set where token k matches at staged byte p, for every
// p in [lo, hi - len] (the tile's bytes, st[lo, hi)).  A thread takes 16
// bytes a step (no bank conflict: consecutive lanes, consecutive chunks)
// and the 8 after them from the next lane.  The XORs of the token's first
// N bytes (at most 4, held in registers for the whole tile) with the
// words shifted by each byte's place, ORed, are zero in a byte exactly
// where those bytes match, four positions at a time; a wildcard byte is
// masked out where kWild.  A token of at most 4 bytes is then exact.  A
// longer one (kLong) has only its rare matches of the first 4 bytes
// compared whole: its first 8 bytes as two funnel shifts of the words
// against the prefix words under their masks, and bytes past 8 one by
// one.  The integer pipes bound this pass, so no compare or packing is
// issued that the token does not need.  Two neighbouring lanes fill one
// 32-bit word of the bitmap.
template <int N, bool kWild>
__device__ __forceinline__ void mark_token(
    const unsigned char* __restrict__ st, unsigned* __restrict__ bm,
    const Pattern& pt, const TokTab& tab, int k, int lo, int hi) {
  constexpr bool kLong = N > 4;
  constexpr int kCmp = kLong ? 4 : N;
  unsigned tb[kCmp], care[kCmp];
#pragma unroll
  for (int j = 0; j < kCmp; ++j) {
    tb[j] = tab.b[k][j];
    care[j] = kWild ? ((tab.cmp[k] >> j) & 1u ? kFull : 0u) : kFull;
  }
  const unsigned v0 = tab.v0[k], v1 = tab.v1[k], m0 = tab.m0[k],
                 m1 = tab.m1[k];
  const int len = tab.len[k];
  const int t0 = tab.t0[k];
  const int z_hi = hi - len;
  const int c0 = (lo >> 4) & ~1;
  const int c1 = (hi + 15) >> 4;
  const int lane = threadIdx.x & 31;
  for (int base = c0; base < c1; base += kThreads) {
    const int c = base + threadIdx.x;
    const bool live = c < c1;
    const int pos = 16 * c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (live) v = *reinterpret_cast<const uint4*>(st + pos);
    // the two words after the chunk: the next lane's first, or read
    unsigned n0 = __shfl_down_sync(kFull, v.x, 1);
    unsigned n1 = __shfl_down_sync(kFull, v.y, 1);
    if (live && lane == 31) {
      n0 = *reinterpret_cast<const unsigned*>(st + pos + 16);
      n1 = *reinterpret_cast<const unsigned*>(st + pos + 20);
    }
    const unsigned w[6] = {v.x, v.y, v.z, v.w, n0, n1};
    const bool edge = pos < lo || pos + 15 > z_hi;
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned z = 0;
#pragma unroll
      for (int j = 0; j < kCmp; ++j) {
        const unsigned x = j ? __funnelshift_r(w[i], w[i + 1], 8 * j) : w[i];
        z |= kWild ? (x ^ tb[j]) & care[j] : x ^ tb[j];
      }
      unsigned m = zero_bytes(z);
      if (edge) m &= range_mask(pos + 4 * i, lo, z_hi);
      if (!kLong) {
        bits |= byte_bits(m >> 7) << (4 * i);
        continue;
      }
      while (m) {
        const int b = (__ffs(m) - 1) >> 3;
        const unsigned x0 = __funnelshift_r(w[i], w[i + 1], 8 * b);
        const unsigned x1 = __funnelshift_r(w[i + 1], w[i + 2], 8 * b);
        if ((((x0 ^ v0) & m0) | ((x1 ^ v1) & m1)) == 0 &&
            (len <= kPre || match_from(st + pos + 4 * i + b, pt, t0, len, kPre)))
          bits |= 1u << (4 * i + b);
        m &= m - 1;
      }
    }
    if (!live) bits = 0;
    unsigned x = bits << (16 * (c & 1));
    x |= __shfl_xor_sync(kFull, x, 1);
    if (live && !(c & 1)) bm[k * kBmWords + (c >> 1)] = x;
  }
}

template <bool kWild>
__device__ __forceinline__ void mark_tokens(
    const unsigned char* __restrict__ st, unsigned* __restrict__ bm,
    const Pattern& pt, const TokTab& tab, int nbm, int lo, int hi) {
  for (int k = 0; k < nbm; ++k) {
    if (tab.mode[k]) continue;  // anchored: compared in place by its rows
    switch (tab.len[k]) {
      case 1: mark_token<1, kWild>(st, bm, pt, tab, k, lo, hi); break;
      case 2: mark_token<2, kWild>(st, bm, pt, tab, k, lo, hi); break;
      case 3: mark_token<3, kWild>(st, bm, pt, tab, k, lo, hi); break;
      case 4: mark_token<4, kWild>(st, bm, pt, tab, k, lo, hi); break;
      default: mark_token<5, kWild>(st, bm, pt, tab, k, lo, hi); break;
    }
  }
}

// ---- phase 2: the rows over the bitmaps --------------------------------------

// The lowest (highest) set bit of b in [a, z], -1 if none.
__device__ __forceinline__ int first_bit(const unsigned* b, int a, int z) {
  int w = a >> 5;
  const int wz = z >> 5;
  unsigned x = b[w] & (kFull << (a & 31));
  for (;;) {
    if (w == wz) x &= kFull >> (31 - (z & 31));
    if (x) return (w << 5) + __ffs(x) - 1;
    if (w == wz) return -1;
    x = b[++w];
  }
}

__device__ __forceinline__ int last_bit(const unsigned* b, int a, int z) {
  int w = z >> 5;
  const int wa = a >> 5;
  unsigned x = b[w] & (kFull >> (31 - (z & 31)));
  for (;;) {
    if (w == wa) x &= kFull << (a & 31);
    if (x) return (w << 5) + 31 - __clz(x);
    if (w == wa) return -1;
    x = b[--w];
  }
}

// Token k in [cur, limit] (absolute positions) over its bitmap.
__device__ __forceinline__ int find_bits(const unsigned* bm,
                                         const unsigned char* st,
                                         const Pattern& pt, const TokTab& tab,
                                         int k, int abase, int cur,
                                         int limit) {
  if (limit < cur) return -1;
  const int mode = tab.mode[k];
  if (mode & (kAtStart | kAtEnd)) {
    // an anchored token has no bitmap: one compare at its place
    if ((mode & kAtStart) && (mode & kAtEnd) && cur != limit) return -1;
    const int at = (mode & kAtStart) ? cur : limit;
    return match_from(st + (at - abase), pt, tab.t0[k], tab.len[k], 0) ? at
                                                                        : -1;
  }
  const unsigned* b = bm + k * kBmWords;
  const int r = pt.reverse ? last_bit(b, cur - abase, limit - abase)
                           : first_bit(b, cur - abase, limit - abase);
  return r < 0 ? -1 : r + abase;
}

// The same search by comparing the row's staged bytes (the per-row path).
__device__ __forceinline__ int find_bytes(const unsigned char* st,
                                          const Pattern& pt, int k, int abase,
                                          int cur, int limit) {
  if (limit < cur) return -1;
  const int t0 = tok_start(pt, k);
  const int len = tok_len(pt, k);
  const int mode = __ldg(pt.mode + k);
  if (mode & kAtStart) {
    if ((mode & kAtEnd) && cur != limit) return -1;
    return match_from(st + (cur - abase), pt, t0, len, 0) ? cur : -1;
  }
  if (mode & kAtEnd)
    return match_from(st + (limit - abase), pt, t0, len, 0) ? limit : -1;
  if (pt.reverse) {
    for (int q = limit; q >= cur; --q)
      if (match_from(st + (q - abase), pt, t0, len, 0)) return q;
  } else {
    for (int q = cur; q <= limit; ++q)
      if (match_from(st + (q - abase), pt, t0, len, 0)) return q;
  }
  return -1;
}

// The same search in device memory by the whole warp: 32 candidates a
// step (a row longer than kTile).
__device__ __forceinline__ int find_warp(const unsigned char* __restrict__ chars,
                                         const Pattern& pt, int k, int cur,
                                         int limit, int lane) {
  if (limit < cur) return -1;
  const int t0 = tok_start(pt, k);
  const int len = tok_len(pt, k);
  const int mode = __ldg(pt.mode + k);
  if (mode & (kAtStart | kAtEnd)) {
    if ((mode & kAtStart) && (mode & kAtEnd) && cur != limit) return -1;
    const int at = (mode & kAtStart) ? cur : limit;
    const bool hit = lane == 0 && match_from(chars + at, pt, t0, len, 0);
    return __ballot_sync(kFull, hit) ? at : -1;
  }
  if (pt.reverse) {
    for (int base = limit; base >= cur; base -= 32) {
      const int q = base - lane;
      const unsigned b = __ballot_sync(
          kFull, q >= cur && match_from(chars + q, pt, t0, len, 0));
      if (b) return base - (__ffs(b) - 1);
    }
  } else {
    for (int base = cur; base <= limit; base += 32) {
      const int q = base + lane;
      const unsigned b = __ballot_sync(
          kFull, q <= limit && match_from(chars + q, pt, t0, len, 0));
      if (b) return base + (__ffs(b) - 1);
    }
  }
  return -1;
}

// The mask mode: each set bit of the row's [s, e - len] written as true.
__device__ __forceinline__ void mask_row(const unsigned* bm, int abase, int s,
                                         int e, int len,
                                         bool* __restrict__ out) {
  const int a = s - abase, z = e - len - abase;
  if (z < a) return;
  int w = a >> 5;
  const int wz = z >> 5;
  unsigned x = bm[w] & (kFull << (a & 31));
  for (;;) {
    if (w == wz) x &= kFull >> (31 - (z & 31));
    while (x) {
      out[abase + (w << 5) + __ffs(x) - 1] = true;
      x &= x - 1;
    }
    if (w == wz) return;
    x = bm[++w];
  }
}

// ---- the kernel ----------------------------------------------------------------

// Row i's window [from, e) and its start s0 (0s past the tile's rows).
struct RowSpan {
  int s0, e, from;
};

__device__ __forceinline__ RowSpan load_row(const int* __restrict__ offsets,
                                            const int* __restrict__ starts,
                                            int i, int r1) {
  RowSpan r = {0, 0, 0};
  if (i < r1) {
    r.s0 = __ldg(offsets + i);
    r.e = __ldg(offsets + i + 1);
    r.from = r.s0;
    if (starts != nullptr) {
      const int a = __ldg(starts + i);
      if (a > r.from) r.from = a;
    }
  }
  return r;
}

// A block a tile: its rows' bytes staged in shared memory by one bulk
// copy, marked in the token bitmaps (phase 1), then its rows searched over
// them (phase 2).  Several blocks on each SM keep their copies in flight
// while others compare.
// One tile's search once its bytes are staged in st: the token bitmaps
// (phase 1), then its rows over them (phase 2).  row, row2: the windows
// of the tile's first 2 * kThreads rows, read before the bytes arrived.
template <int kPath, bool kWild>
__device__ __forceinline__ void search_tile(
    const int* __restrict__ offsets, const unsigned char* __restrict__ chars,
    const Pattern& pt, const int* from, const TokTab& tab,
    const srt::RowTile& rt, const unsigned char* st, unsigned* bm,
    RowSpan row, RowSpan row2, int* __restrict__ out,
    bool* __restrict__ mask) {
  const int nbm = kPath == kRows ? 0 : (kPath == kMask ? 1 : pt.ntok);
  const int lane = threadIdx.x & 31;
  const TokTab* tp = kPath == kRows ? nullptr : &tab;
  const int abase = static_cast<int>(srt::align_down(chars, rt.b0));
  if (kPath != kRows && rt.bend > rt.b0) {
    mark_tokens<kWild>(st, bm, pt, tab, nbm, rt.b0 - abase, rt.bend - abase);
    __syncthreads();
  }
  for (int base = rt.r0; base < rt.r1; base += kThreads) {
    const int i = base + threadIdx.x;
    const bool live = i < rt.r1;
    if (base == rt.r0 + kThreads) {
      row = row2;
    } else if (base != rt.r0) {
      row = load_row(offsets, from, i, rt.r1);
    }
    const bool long_row = row.e - row.s0 > kTile;
    if (live && !long_row) {
      if (kPath == kMask) {
        mask_row(bm, abase, row.s0, row.e, tab.len[0], mask);
      } else if (kPath == kBitmaps) {
        out[i] = run_pattern(
            pt, tp,
            [&](int k, int c, int limit) {
              return find_bits(bm, st, pt, tab, k, abase, c, limit);
            },
            row.from, row.e);
      } else {
        out[i] = run_pattern(
            pt, tp,
            [&](int k, int c, int limit) {
              return find_bytes(st, pt, k, abase, c, limit);
            },
            row.from, row.e);
      }
    }
    unsigned todo = __ballot_sync(kFull, live && long_row);
    while (todo) {
      const int owner = __ffs(todo) - 1;
      todo &= todo - 1;
      const int rs = __shfl_sync(kFull, row.from, owner);
      const int r0 = __shfl_sync(kFull, row.s0, owner);
      const int re = __shfl_sync(kFull, row.e, owner);
      if (kPath == kMask) {
        const int len = tab.len[0];
        for (int q = r0 + lane; q + len <= re; q += 32)
          if (match_from(chars + q, pt, 0, len, 0)) mask[q] = true;
      } else {
        const int p = run_pattern(
            pt, tp,
            [&](int k, int c, int limit) {
              return find_warp(chars, pt, k, c, limit, lane);
            },
            rs, re);
        if (lane == owner) out[i] = p;
      }
    }
  }
}

// A block a tile: its rows' bytes staged in shared memory by one bulk
// copy, then searched (search_tile).  Several blocks on each SM keep
// their copies in flight while others compare.
template <int kPath, bool kWild>
__global__ void __launch_bounds__(kThreads, 4)
find_kernel(const int* __restrict__ offsets,
            const unsigned char* __restrict__ chars, int cap, Pattern pt,
            const int* __restrict__ starts,
            const srt::RowTile* __restrict__ tiles,
            int* __restrict__ out, bool* __restrict__ mask) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ TokTab tab;
  const int nbm = kPath == kRows ? 0 : (kPath == kMask ? 1 : pt.ntok);
  unsigned char* st = smem;
  unsigned* bm = reinterpret_cast<unsigned*>(smem + kStageBuf);
  uint64_t* bar = reinterpret_cast<uint64_t*>(bm + nbm * kBmWords);
  const srt::RowTile rt = tiles[blockIdx.x];
  if (rt.r1 <= rt.r0) return;
  if (threadIdx.x == 0) {
    srt::mbar_init(bar, 1);
    srt::mbar_fence_init();
    srt::stage_tile(rt, chars, __ldg(offsets + cap), st, bar);
  }
  if (kPath != kRows) fill_tab(tab, pt);
  const int* from = kPath == kMask ? nullptr : starts;
  const RowSpan row = load_row(offsets, from, rt.r0 + threadIdx.x, rt.r1);
  const RowSpan row2 = load_row(offsets, from, rt.r0 + kThreads +
                                threadIdx.x, rt.r1);
  __syncthreads();
  srt::mbar_wait(bar, 0);
  search_tile<kPath, kWild>(offsets, chars, pt, from, tab, rt, st, bm, row,
                            row2, out, mask);
}

template <int kPath, bool kWild>
cudaError_t launch_find(const int* offsets, const unsigned char* chars,
                        int cap, long long n, const Pattern& pt,
                        const int* starts, srt::RowTile* tiles, int* out,
                        bool* mask, cudaStream_t stream) {
  cudaError_t err = srt::launch_row_tiles<kTile>(offsets, cap, n, tiles,
                                                 stream);
  if (err != cudaSuccess) return err;
  const long long ntiles = srt::row_tile_count<kTile>(cap, n);
  const int nbm = kPath == kRows ? 0 : (kPath == kMask ? 1 : pt.ntok);
  const int smem = kStageBuf + nbm * kBmWords * 4 + 16;
  err = cudaFuncSetAttribute(find_kernel<kPath, kWild>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  find_kernel<kPath, kWild><<<static_cast<unsigned>(ntiles), kThreads, smem,
                              stream>>>(offsets, chars, cap, pt, starts,
                                        tiles, out, mask);
  return cudaGetLastError();
}

Pattern make_pattern(const unsigned char* packed, int nbytes, const int* ints,
                     int ntok, int has_wild, int repeat, int reverse) {
  Pattern pt;
  pt.bytes = packed;
  pt.wild = packed + nbytes;
  pt.tok_off = ints;
  pt.mode = ints + ntok + 1;
  pt.reserve = ints + 2 * ntok + 1;
  pt.ntok = ntok;
  pt.has_wild = has_wild;
  pt.repeat = repeat;
  pt.reverse = reverse;
  return pt;
}

}  // namespace

// offsets: int32[cap + 1]; chars: uint8[n]; packed: the tokens' nbytes
// bytes, then as many wildcard flags; ints: int32 token offsets[ntok + 1],
// modes[ntok], reserves[ntok]; starts: int32[cap] where each row's search
// begins (raised to the row start), or null for the row start; path: 0
// the match bitmaps (at most srt_max_tokens() tokens), 1 the per-row
// compare; tiles: scratch of srt_tile_count(cap, n) * 16 bytes; out:
// int32[cap].
extern "C" int srt_string_find(const int* offsets, const unsigned char* chars,
                               int cap, long long n,
                               const unsigned char* packed, int nbytes,
                               const int* ints, int ntok, int has_wild,
                               int repeat, int reverse, const int* starts,
                               int path, void* tiles, int* out,
                               cudaStream_t stream) {
  if (cap < 0 || n < 0 || ntok <= 0 || repeat <= 0 || nbytes <= 0 ||
      path < kBitmaps || path > kRows ||
      (path == kBitmaps && ntok > kMaxTokens))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cap == 0) return static_cast<int>(cudaSuccess);
  const Pattern pt = make_pattern(packed, nbytes, ints, ntok, has_wild,
                                  repeat, reverse);
  srt::RowTile* rt = static_cast<srt::RowTile*>(tiles);
  const cudaError_t err =
      path == kRows ? launch_find<kRows, false>(offsets, chars, cap, n, pt,
                                                starts, rt, out, nullptr,
                                                stream)
      : has_wild    ? launch_find<kBitmaps, true>(offsets, chars, cap, n, pt,
                                                  starts, rt, out, nullptr,
                                                  stream)
                    : launch_find<kBitmaps, false>(offsets, chars, cap, n, pt,
                                                   starts, rt, out, nullptr,
                                                   stream);
  return static_cast<int>(err);
}

// The mask mode: out (bool[n], zeroed by the wrapper) is set where the
// one token of packed/ints (no wildcard, no anchor) matches and ends
// inside the byte's row.
extern "C" int srt_string_match_mask(const int* offsets,
                                     const unsigned char* chars, int cap,
                                     long long n, const unsigned char* packed,
                                     int nbytes, const int* ints, void* tiles,
                                     bool* out, cudaStream_t stream) {
  if (cap < 0 || n < 0 || nbytes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cap == 0) return static_cast<int>(cudaSuccess);
  const Pattern pt = make_pattern(packed, nbytes, ints, 1, 0, 1, 0);
  return static_cast<int>(launch_find<kMask, false>(
      offsets, chars, cap, n, pt, nullptr, static_cast<srt::RowTile*>(tiles),
      nullptr, out, stream));
}

extern "C" int srt_tile_count(int cap, long long n) {
  return static_cast<int>(srt::row_tile_count<kTile>(cap, n));
}

extern "C" int srt_tile_bytes() { return kTile; }

extern "C" int srt_max_tokens() { return kMaxTokens; }

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

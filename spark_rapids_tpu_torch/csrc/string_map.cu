// K21: a byte map of every string row into a new chars buffer under the
// same offsets: ASCII upper and lower case, initcap, and a reverse by
// UTF-8 character.
//
// Replaces the reference's expr/strings.py _case_map (a where over the
// whole buffer), _eval_initcap (the byte before each byte, and a scatter
// of the row starts) and _eval_reverse (a searchsorted of every byte's
// row, then a gather that reverses bytes; here the characters are
// reversed and the bytes inside a character keep their order, Spark's
// answer).  Bytes past the total are zero: the chars layout's invariant
// (columnar/device.py), written by 16-byte stores of zero without a read.
//
// Upper, lower and initcap are one byte pass: a block takes a kTile-byte
// stretch of the output (initcap: a row tile's bytes, csrc/row_tiles.cuh),
// a thread 16 bytes a step, read as the two aligned
// 16-byte blocks that hold them and the byte before (the input may sit at
// any alignment: a column's chars follow its offsets in one buffer), and
// mapped four bytes at a time (each byte's letter test by two adds of its
// low seven bits, then one add or subtract of 0x20 a byte; no carry
// crosses a byte; the input's offset in its aligned block is one switch
// that every thread takes alike).  Initcap upper-cases a byte whose byte
// before is a space or which starts a row: the starts of the tile's rows
// (at most kTile, however many rows are empty) are marked in a
// shared-memory bitmap.  Nothing walks a row.
//
// Reverse stages a tile's rows (at most 2 * kTile bytes) in shared
// memory by one bulk copy (csrc/row_tiles.cuh), in flight while the
// block writes the zero tail among its bytes, and marks two bitmaps: the
// lead bytes with the row starts, and the row starts alone, each with
// the span's end; a summary bit for each nonzero 32-bit word makes every
// search a few words.  A thread takes 16 bytes: each finds its
// character's first byte (the last mark at or before it) and end (the
// next mark after it), and its row's, in the 32 bits of each bitmap from
// the chunk's first byte, searching further only where a bound lies
// outside them, and is written to o0 + (o1 - end) + (byte - start) in a
// second stage, which the block stores contiguously.  Invalid UTF-8
// costs nothing more: a run of
// continuation bytes, up to a whole row of them, is one character as in
// the plain version, found by the same searches.  A row longer than
// kTile is reversed by a warp in device memory, 32 bytes a step: each
// lead byte's lane writes the character that ends in the step, and the
// warp writes the character still open at the row's end, so a 1 MB row
// of continuation bytes is written by 32 lanes.
//
// Bound: device-memory bytes: each row byte read once and written once,
// and the offsets (the zero tail is the layout's, not the function's).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16384;
constexpr int kStage = 2 * kTile + 32;
constexpr int kStageBuf = (kStage + 127) & ~127;
constexpr int kBmWords = ((kStage / 32 + 1) + 1) & ~1;
constexpr int kSumWords = ((kBmWords + 31) / 32 + 1) & ~1;
constexpr unsigned kFull = 0xffffffffu;
enum { kUpper = 0, kLower = 1, kInitCap = 2, kReverse = 3 };

// ---- the byte pass ---------------------------------------------------------

// Bytes [off, off + 16) of a:b, 0 <= off <= 16: a switch on the word
// offset, which every thread of a launch takes alike (the input's
// alignment), then four funnel shifts.
__device__ __forceinline__ uint4 window(const uint4& a, const uint4& b,
                                        int off) {
  const unsigned sh = 8 * (off & 3);
  unsigned w0, w1, w2, w3, w4;
  switch (off >> 2) {
    case 0: w0 = a.x; w1 = a.y; w2 = a.z; w3 = a.w; w4 = b.x; break;
    case 1: w0 = a.y; w1 = a.z; w2 = a.w; w3 = b.x; w4 = b.y; break;
    case 2: w0 = a.z; w1 = a.w; w2 = b.x; w3 = b.y; w4 = b.z; break;
    case 3: w0 = a.w; w1 = b.x; w2 = b.y; w3 = b.z; w4 = b.w; break;
    default: w0 = b.x; w1 = b.y; w2 = b.z; w3 = b.w; w4 = 0u; break;
  }
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// 0x80 in each byte of w in 'a'..'z' ('A'..'Z'): two adds of the low
// seven bits, which never carry into the next byte.
__device__ __forceinline__ unsigned lower_bytes(unsigned w) {
  const unsigned x = w & 0x7f7f7f7fu;
  return (x + 0x1f1f1f1fu) & ~(x + 0x05050505u) & ~w & 0x80808080u;
}

__device__ __forceinline__ unsigned upper_bytes(unsigned w) {
  const unsigned x = w & 0x7f7f7f7fu;
  return (x + 0x3f3f3f3fu) & ~(x + 0x25252525u) & ~w & 0x80808080u;
}

// 0x80 in each zero byte of z.
__device__ __forceinline__ unsigned zero_bytes(unsigned z) {
  return ~(((z & 0x7f7f7f7fu) + 0x7f7f7f7fu) | z) & 0x80808080u;
}

// One word of the map (0x80 >> 2 is the 0x20 a letter's case moves by);
// prev holds each byte's byte before, starts the word's four row-start
// flags as bits.
template <int kMode>
__device__ __forceinline__ unsigned map_word(unsigned w, unsigned prev,
                                             unsigned starts) {
  if (kMode == kUpper) return w - (lower_bytes(w) >> 2);
  if (kMode == kLower) return w + (upper_bytes(w) >> 2);
  const unsigned rs = ((starts * 0x00204081u) & 0x01010101u) << 7;
  const unsigned word = zero_bytes(prev ^ 0x20202020u) | rs;
  return w - ((lower_bytes(w) & word) >> 2) + ((upper_bytes(w) & ~word) >> 2);
}

// The bytes of word i (bytes 4i..4i+3 of a chunk) below keep.
__device__ __forceinline__ unsigned keep_mask(int i, long long keep) {
  const long long k = keep - 4 * i;
  return k >= 4 ? kFull : k <= 0 ? 0u : kFull >> (8 * (4 - k));
}

// Upper and lower: a block a kTile-byte stretch of the output.  Initcap:
// a block a row tile (csrc/row_tiles.cuh), its bytes [lo, hi) and the
// starts of its rows (at most kTile) marked in a shared-memory bitmap
// relative to lo rounded down to 16; byte lo is also a start where the
// row before the tile starts there.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
map_kernel(const int* __restrict__ offsets, int cap,
           const unsigned char* __restrict__ chars, long long n,
           const srt::RowTile* __restrict__ tiles,
           unsigned char* __restrict__ out) {
  __shared__ unsigned starts_bm[kTile / 32 + 2];
  const long long total = __ldg(offsets + cap);
  long long lo = (long long)blockIdx.x * kTile;
  long long hi = lo + kTile < n ? lo + kTile : n;
  if (kMode == kInitCap) {
    const srt::RowTile rt = tiles[blockIdx.x];
    srt::tile_bytes<kTile>(blockIdx.x, rt, n, &lo, &hi);
    for (int w = threadIdx.x; w < kTile / 32 + 2; w += kThreads)
      starts_bm[w] = 0;
    __syncthreads();
    const long long lo16 = lo & ~15ll;
    for (int r = rt.r0 - 1 + threadIdx.x; r < rt.r1; r += kThreads) {
      if (r < 0) continue;
      const long long q = __ldg(offsets + r);
      if (q < lo || q >= hi) continue;
      const int pos = static_cast<int>(q - lo16);
      atomicOr(&starts_bm[pos >> 5], 1u << (pos & 31));
    }
    __syncthreads();
  }
  // chars + p - 1 sits at offset o of its aligned block, for every p of a
  // 16-byte step
  const int o = static_cast<int>((reinterpret_cast<uintptr_t>(chars) + 15) & 15);
  for (long long p = (lo & ~15ll) + 16ll * threadIdx.x; p < hi;
       p += 16ll * kThreads) {
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (p < total) {
      const long long a0 = p - 1 - o;
      const uint4 a = srt::load_block(chars, a0, total);
      const uint4 b = srt::load_block(chars, a0 + 16, total);
      const uint4 d = window(a, b, o + 1);
      uint4 pv = make_uint4(0u, 0u, 0u, 0u);
      unsigned sb = 0;
      if (kMode == kInitCap) {
        pv = window(a, b, o);
        const int rel = static_cast<int>(p - (lo & ~15ll));
        sb = starts_bm[rel >> 5] >> (rel & 31);
      }
      r.x = map_word<kMode>(d.x, pv.x, sb & 15u);
      r.y = map_word<kMode>(d.y, pv.y, (sb >> 4) & 15u);
      r.z = map_word<kMode>(d.z, pv.z, (sb >> 8) & 15u);
      r.w = map_word<kMode>(d.w, pv.w, (sb >> 12) & 15u);
      if (p + 16 > total) {
        const long long keep = total - p;
        r.x &= keep_mask(0, keep);
        r.y &= keep_mask(1, keep);
        r.z &= keep_mask(2, keep);
        r.w &= keep_mask(3, keep);
      }
    }
    if (p >= lo && p + 16 <= hi) {
      *reinterpret_cast<uint4*>(out + p) = r;
    } else {
      // the tile's first or last bytes: its neighbour writes the rest
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (p + j >= lo && p + j < hi)
          out[p + j] = static_cast<unsigned char>(w[j >> 2] >> (8 * (j & 3)));
    }
  }
}

// ---- reverse -------------------------------------------------------------------

// The highest set bit at or below q (one exists), through the summary of
// nonzero words.
__device__ __forceinline__ int prev_set(const unsigned* bm, const unsigned* sum,
                                        int q) {
  int w = q >> 5;
  const unsigned x = bm[w] & (kFull >> (31 - (q & 31)));
  if (x) return (w << 5) + 31 - __clz(x);
  const int s = w - 1;
  int sw = s >> 5;
  unsigned y = sum[sw] & (kFull >> (31 - (s & 31)));
  while (!y) y = sum[--sw];
  w = (sw << 5) + 31 - __clz(y);
  return (w << 5) + 31 - __clz(bm[w]);
}

// The lowest set bit at or above q (one exists).
__device__ __forceinline__ int next_set(const unsigned* bm, const unsigned* sum,
                                        int q) {
  int w = q >> 5;
  const unsigned x = bm[w] & (kFull << (q & 31));
  if (x) return (w << 5) + __ffs(x) - 1;
  const int s = w + 1;
  int sw = s >> 5;
  unsigned y = sum[sw] & (kFull << (s & 31));
  while (!y) y = sum[++sw];
  w = (sw << 5) + __ffs(y) - 1;
  return (w << 5) + __ffs(bm[w]) - 1;
}

// The lead bytes (no UTF-8 continuation byte) of a word as 4 bits.
__device__ __forceinline__ unsigned lead_bits(unsigned w) {
  const unsigned m =
      ~zero_bytes((w & 0xC0C0C0C0u) ^ 0x80808080u) & 0x80808080u;
  return (((m >> 7) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ bool is_lead(unsigned char b) {
  return (b & 0xC0) != 0x80;
}

// Bytes [s, e) of a character of the row [o0, o1) to their reversed place,
// lane-strided over the warp's lanes (step 32) or by one thread (step 1).
__device__ __forceinline__ void put_char(const unsigned char* __restrict__ chars,
                                         int o0, int o1, int s, int e,
                                         int first, int step,
                                         unsigned char* __restrict__ out) {
  for (int q = s + first; q < e; q += step)
    out[o0 + (o1 - e) + (q - s)] = chars[q];
}

// A row longer than kTile, by its warp in device memory.
__device__ void reverse_warp(const unsigned char* __restrict__ chars, int o0,
                             int o1, int lane,
                             unsigned char* __restrict__ out) {
  int open = o0;  // the first byte of the character not yet written
  for (int base = o0; base < o1; base += 32) {
    const int q = base + lane;
    const bool lead = q < o1 && q > o0 && is_lead(chars[q]);
    const unsigned m = __ballot_sync(kFull, lead);
    if (!m) continue;
    // the open character ends at this step's first lead byte
    const int first = base + __ffs(m) - 1;
    put_char(chars, o0, o1, open, first, lane, 32, out);
    // each lead byte's character that ends at the next lead in this step
    if (lead) {
      const unsigned above = m & ~((2u << lane) - 1u);
      if (above) put_char(chars, o0, o1, q, base + __ffs(above) - 1, 0, 1, out);
    }
    open = base + 31 - __clz(m);
  }
  put_char(chars, o0, o1, open, o1, lane, 32, out);
}

// Bytes [lo, hi) of out from src (src[g - sbase] for out byte g; null:
// zeros): 16-byte stores over out's aligned blocks, byte stores at the
// ends, which neighbouring tiles share.
__device__ __forceinline__ void store_range(unsigned char* __restrict__ out,
                                            long long lo, long long hi,
                                            const unsigned char* src,
                                            long long sbase) {
  if (hi <= lo) return;
  const long long hb = (lo + 15) & ~15ll, tb = hi & ~15ll;
  if (hb >= tb) {
    for (long long g = lo + threadIdx.x; g < hi; g += kThreads)
      out[g] = src ? src[g - sbase] : 0;
    return;
  }
  for (long long g = lo + threadIdx.x; g < hb; g += kThreads)
    out[g] = src ? src[g - sbase] : 0;
  for (long long g = hb + 16ll * threadIdx.x; g < tb; g += 16ll * kThreads)
    *reinterpret_cast<uint4*>(out + g) =
        src ? *reinterpret_cast<const uint4*>(src + (g - sbase))
            : make_uint4(0u, 0u, 0u, 0u);
  for (long long g = tb + threadIdx.x; g < hi; g += kThreads)
    out[g] = src ? src[g - sbase] : 0;
}

// A block a row tile: the zero tail among its bytes, its rows' bytes staged
// and reversed through the two bitmaps, a long last row by warp 0.
__global__ void __launch_bounds__(kThreads)
reverse_kernel(const int* __restrict__ offsets, int cap,
               const unsigned char* __restrict__ chars, long long n,
               const srt::RowTile* __restrict__ tiles,
               unsigned char* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* in = smem;
  unsigned char* ob = smem + kStageBuf;
  unsigned* lead = reinterpret_cast<unsigned*>(smem + 2 * kStageBuf);
  unsigned* rows = lead + kBmWords;
  unsigned* lead_sum = rows + kBmWords;
  unsigned* rows_sum = lead_sum + kSumWords;
  const int lane = threadIdx.x & 31;
  const long long total = __ldg(offsets + cap);
  uint64_t* bar = reinterpret_cast<uint64_t*>(rows_sum + kSumWords);
  const srt::RowTile rt = tiles[blockIdx.x];
  long long blo, bhi;  // the tile's bytes
  srt::tile_bytes<kTile>(blockIdx.x, rt, n, &blo, &bhi);
  if (rt.bend > rt.b0 && threadIdx.x == 0) {
    // the tile's rows' bytes, in flight while the zero tail is written
    srt::mbar_init(bar, 1);
    srt::mbar_fence_init();
    srt::stage_tile(rt, chars, total, in, bar);
  }
  store_range(out, blo > total ? blo : total, bhi, nullptr, 0);
  if (rt.bend > rt.b0) {
    const long long abase = srt::align_down(chars, rt.b0);
    const int lo = static_cast<int>(rt.b0 - abase);
    const int hi = static_cast<int>(rt.bend - abase);
    for (int w = threadIdx.x; w < kBmWords; w += kThreads) {
      lead[w] = 0;
      rows[w] = 0;
    }
    __syncthreads();
    srt::mbar_wait(bar, 0);
    // the lead bytes, 16 a thread, two lanes a word
    const int c0 = (lo >> 4) & ~1, c1 = (hi + 15) >> 4;
    for (int cb = c0; cb < c1; cb += kThreads) {
      const int c = cb + threadIdx.x;
      unsigned bits = 0;
      if (c < c1) {
        const uint4 cw = *reinterpret_cast<const uint4*>(in + 16 * c);
        bits = lead_bits(cw.x) | lead_bits(cw.y) << 4 | lead_bits(cw.z) << 8 |
               lead_bits(cw.w) << 12;
      }
      unsigned x = bits << (16 * (c & 1));
      x |= __shfl_xor_sync(kFull, x, 1);
      if (c < c1 && !(c & 1)) lead[c >> 1] = x;
    }
    __syncthreads();
    // the row starts, and the span's end, in both
    for (int r = rt.r0 + threadIdx.x; r < rt.r1; r += kThreads) {
      const int q = static_cast<int>(__ldg(offsets + r) - abase);
      if (q < hi) {
        atomicOr(&lead[q >> 5], 1u << (q & 31));
        atomicOr(&rows[q >> 5], 1u << (q & 31));
      }
    }
    if (threadIdx.x == 0) {
      atomicOr(&lead[hi >> 5], 1u << (hi & 31));
      atomicOr(&rows[hi >> 5], 1u << (hi & 31));
    }
    __syncthreads();
    const int words = (hi >> 5) + 1;
    for (int wb = threadIdx.x & ~31; wb < words; wb += kThreads) {
      const int w = wb + lane;
      const unsigned sl = __ballot_sync(kFull, w < words && lead[w] != 0);
      const unsigned sr = __ballot_sync(kFull, w < words && rows[w] != 0);
      if (lane == 0) {
        lead_sum[wb >> 5] = sl;
        rows_sum[wb >> 5] = sr;
      }
    }
    __syncthreads();
    // each byte to its place in the second stage (out byte g at
    // ob[g - obase])
    const long long obase = rt.b0 & ~15ll;
    // 16 bytes a thread: the 32 bits of both bitmaps from the chunk's
    // first byte give most bytes their character's and their row's
    // bounds; the searches run only where a bound lies outside them
    for (int c = (lo >> 4) + threadIdx.x; c < (hi + 15) >> 4; c += kThreads) {
      const int q0 = 16 * c;
      const int w = q0 >> 5, sft = q0 & 31;
      const unsigned lb = __funnelshift_r(lead[w], lead[w + 1], sft);
      const unsigned rb = __funnelshift_r(rows[w], rows[w + 1], sft);
      const uint4 cv = *reinterpret_cast<const uint4*>(in + q0);
      const unsigned vw[4] = {cv.x, cv.y, cv.z, cv.w};
      int o0 = 0, o1 = -1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int q = q0 + j;
        if (q < lo || q >= hi) continue;
        const unsigned upto = kFull >> (31 - j);  // bits 0..j
        const unsigned above = kFull << (j + 1);  // bits j+1..31
        if (q >= o1) {
          o0 = (rb & upto) ? q0 + 31 - __clz(rb & upto)
                           : prev_set(rows, rows_sum, q);
          o1 = (rb & above) ? q0 + __ffs(rb & above) - 1
                            : next_set(rows, rows_sum, q0 + 32);
        }
        const int s = (lb & upto) ? q0 + 31 - __clz(lb & upto)
                                  : prev_set(lead, lead_sum, q);
        const int e = (lb & above) ? q0 + __ffs(lb & above) - 1
                                   : next_set(lead, lead_sum, q0 + 32);
        ob[abase + o0 + (o1 - e) + (q - s) - obase] =
            static_cast<unsigned char>(vw[j >> 2] >> (8 * (j & 3)));
      }
    }
    __syncthreads();
    store_range(out, rt.b0, rt.bend, ob, obase);
  }
  // a last row longer than kTile: its warp, in device memory
  if (rt.r1 > rt.r0 && threadIdx.x < 32) {
    const int s0 = __ldg(offsets + rt.r1 - 1), e = __ldg(offsets + rt.r1);
    if (e - s0 > kTile) reverse_warp(chars, s0, e, lane, out);
  }
  // a last row longer than kTile: its warp, in device memory
  if (rt.r1 > rt.r0 && threadIdx.x < 32) {
    const int s0 = __ldg(offsets + rt.r1 - 1), e = __ldg(offsets + rt.r1);
    if (e - s0 > kTile) reverse_warp(chars, s0, e, lane, out);
  }
}

}  // namespace

// offsets: int32[cap + 1]; chars: uint8[n]; mode: 0 upper, 1 lower,
// 2 initcap, 3 reverse; tiles: scratch of srt_tile_count(cap, n) * 16 bytes
// (initcap and reverse; null for upper and lower); out: uint8[n], 16-byte
// aligned.
extern "C" int srt_string_map(const int* offsets, const unsigned char* chars,
                              int cap, long long n, int mode, void* tiles,
                              unsigned char* out, cudaStream_t stream) {
  if (cap < 0 || n < 0 || mode < kUpper || mode > kReverse ||
      (mode >= kInitCap && tiles == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long ntiles = srt::row_tile_count<kTile>(cap, n);
  const unsigned stretches = static_cast<unsigned>((n + kTile - 1) / kTile);
  const unsigned blocks = static_cast<unsigned>(ntiles);
  srt::RowTile* rt = static_cast<srt::RowTile*>(tiles);
  cudaError_t err = cudaSuccess;
  if (mode >= kInitCap)
    err = srt::launch_row_tiles<kTile>(offsets, cap, n, rt, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mode == kUpper) {
    map_kernel<kUpper><<<stretches, kThreads, 0, stream>>>(offsets, cap,
                                                            chars, n, rt, out);
  } else if (mode == kLower) {
    map_kernel<kLower><<<stretches, kThreads, 0, stream>>>(offsets, cap,
                                                            chars, n, rt, out);
  } else if (mode == kInitCap) {
    map_kernel<kInitCap><<<blocks, kThreads, 0, stream>>>(offsets, cap,
                                                          chars, n, rt, out);
  } else {
    const int smem =
        2 * kStageBuf + 2 * kBmWords * 4 + 2 * kSumWords * 4 + 16;
    err = cudaFuncSetAttribute(reverse_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    reverse_kernel<<<blocks, kThreads, smem, stream>>>(offsets, cap, chars, n,
                                                       rt, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_tile_count(int cap, long long n) {
  return static_cast<int>(srt::row_tile_count<kTile>(cap, n));
}

extern "C" int srt_tile_bytes() { return kTile; }

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

// K19: literal search in every string row, and the match mask of a
// replace.
//
// Replaces the reference's expr/strings.py _match_positions (a bool per
// byte of the whole buffer, one shifted compare per needle byte) and the
// prefix count plus searchsorted that turn it into each row's first
// match: _contains_impl, _eval_like (its tokens between '%', each found
// at or after the end of the one before), _eval_locate and
// _eval_substring_index's count of delimiters.  Here each row searches
// its own bytes once: a token is compared at successive positions of the
// row's window, and the next token starts where the found one ends, so a
// whole LIKE pattern is one launch.  The pattern (tokens, the wildcard
// flags of LIKE's '_', each token's anchor and the bytes it keeps free
// after it) is compiled on the host and read through the read-only cache,
// where every thread reads the same few bytes.
//
// Staging: a block's 256 rows are contiguous bytes; where they hold at
// most kStage bytes the block first copies them into shared memory,
// 16 bytes a thread where the addresses allow, so the byte-by-byte
// compares of its threads read shared memory and device memory is read
// once, coalesced.  A block whose rows hold more reads device memory
// through the L1 cache, as a thread a row reads its row.
//
// Skew: a thread searches a row of at most kShort bytes alone; a warp's
// longer rows are searched one after another by all 32 lanes, 32
// candidate positions a step with a ballot, so a 1 MB row costs its warp
// about 32 KB of steps a lane and no other warp waits on it.  Every read
// stays inside the row (the staging copy inside the block's rows), so
// nothing past offsets[cap] is read.
//
// Bound: device-memory bytes, each row's bytes read once, 4 B of
// offsets, 4 B of start where a caller gives one, and 4 B written: the
// last token's position, the one answer every caller reads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kShort = 128;  // bytes a thread searches alone
constexpr int kStage = 32768;  // bytes of a block's rows staged
constexpr int kAtStart = 1;
constexpr int kAtEnd = 2;
constexpr unsigned kFull = 0xffffffffu;

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

// The row bytes: device memory, or the block's staged copy (byte p of the
// buffer at src[p - shift]); a staged copy is also read as 4-byte words,
// which start at the positions w with (w - base) % 4 == 0.
struct Src {
  const unsigned char* src;
  long long shift;
  long long base;
  bool staged;
  __device__ __forceinline__ unsigned char at(long long p) const {
    return src[p - shift];
  }
  __device__ __forceinline__ unsigned word(long long w) const {
    return *reinterpret_cast<const unsigned*>(src + (w - shift));
  }
};

__device__ __forceinline__ bool match_at(const Src chars, long long p,
                                         const Pattern& pt, int t0,
                                         int len) {
  for (int j = 0; j < len; ++j) {
    const unsigned char b = __ldg(pt.bytes + t0 + j);
    if (pt.has_wild && __ldg(pt.wild + t0 + j)) continue;
    if (chars.at(p + j) != b) return false;
  }
  return true;
}

// One token searched by one thread in [cur, limit]; -1 if none.
__device__ __forceinline__ long long find_thread(const Src chars,
                                 const Pattern& pt, int k, long long cur,
                                 long long limit) {
  const int t0 = __ldg(pt.tok_off + k);
  const int len = __ldg(pt.tok_off + k + 1) - t0;
  const int mode = __ldg(pt.mode + k);
  if (limit < cur) return -1;
  if (mode & kAtStart) {
    if ((mode & kAtEnd) && cur != limit) return -1;
    return match_at(chars, cur, pt, t0, len) ? cur : -1;
  }
  if (mode & kAtEnd) return match_at(chars, limit, pt, t0, len) ? limit : -1;
  const bool first_wild = pt.has_wild && __ldg(pt.wild + t0);
  if (chars.staged && !first_wild) {
    // 4 candidates a step: the bytes of a staged word equal to the
    // token's first byte (__vcmpeq4) and followed by its second (the
    // word shifted a byte against the next one), each then matched in
    // full; the word's bytes outside [cur, limit] are masked off.  The
    // words read reach 7 bytes past limit, inside the stage's slack.
    const unsigned first = __ldg(pt.bytes + t0) * 0x01010101u;
    const bool two = len > 1 && !(pt.has_wild && __ldg(pt.wild + t0 + 1));
    const unsigned second = two ? __ldg(pt.bytes + t0 + 1) * 0x01010101u
                                : 0u;
    if (pt.reverse) {
      long long w = limit - ((limit - chars.base) & 3);
      unsigned next = chars.word(w + 4);
      for (; w + 3 >= cur; w -= 4) {
        const unsigned here = chars.word(w);
        unsigned m = __vcmpeq4(here, first);
        if (two) m &= __vcmpeq4(__funnelshift_r(here, next, 8), second);
        next = here;
        if (w + 3 > limit) m &= 0xffffffffu >> (8 * (w + 3 - limit));
        if (w < cur) m &= 0xffffffffu << (8 * (cur - w));
        while (m) {
          const int b = (31 - __clz(m)) >> 3;
          if (match_at(chars, w + b, pt, t0, len)) return w + b;
          m &= ~(0xffu << (8 * b));
        }
      }
    } else {
      long long w = cur - ((cur - chars.base) & 3);
      unsigned here = chars.word(w);
      for (; w <= limit; w += 4) {
        const unsigned next = chars.word(w + 4);
        unsigned m = __vcmpeq4(here, first);
        if (two) m &= __vcmpeq4(__funnelshift_r(here, next, 8), second);
        here = next;
        if (w < cur) m &= 0xffffffffu << (8 * (cur - w));
        if (w + 3 > limit) m &= 0xffffffffu >> (8 * (w + 3 - limit));
        while (m) {
          const int b = (__ffs(m) - 1) >> 3;
          if (match_at(chars, w + b, pt, t0, len)) return w + b;
          m &= ~(0xffu << (8 * b));
        }
      }
    }
    return -1;
  }
  if (pt.reverse) {
    for (long long q = limit; q >= cur; --q)
      if (match_at(chars, q, pt, t0, len)) return q;
  } else {
    for (long long q = cur; q <= limit; ++q)
      if (match_at(chars, q, pt, t0, len)) return q;
  }
  return -1;
}

// The same search by the whole warp: 32 candidates a step.
__device__ __forceinline__ long long find_warp(const Src chars,
                               const Pattern& pt, int k, long long cur,
                               long long limit, int lane) {
  const int t0 = __ldg(pt.tok_off + k);
  const int len = __ldg(pt.tok_off + k + 1) - t0;
  const int mode = __ldg(pt.mode + k);
  if (limit < cur) return -1;
  if (mode & (kAtStart | kAtEnd)) {
    if ((mode & kAtStart) && (mode & kAtEnd) && cur != limit) return -1;
    const long long at = (mode & kAtStart) ? cur : limit;
    const bool hit = lane == 0 && match_at(chars, at, pt, t0, len);
    return __ballot_sync(kFull, hit) ? at : -1;
  }
  if (pt.reverse) {
    for (long long base = limit; base >= cur; base -= 32) {
      const long long q = base - lane;
      const unsigned b =
          __ballot_sync(kFull, q >= cur && match_at(chars, q, pt, t0, len));
      if (b) return base - (__ffs(b) - 1);
    }
  } else {
    for (long long base = cur; base <= limit; base += 32) {
      const long long q = base + lane;
      const unsigned b =
          __ballot_sync(kFull, q <= limit && match_at(chars, q, pt, t0, len));
      if (b) return base + (__ffs(b) - 1);
    }
  }
  return -1;
}

// Runs the pattern over one row's window and returns the last
// repetition's last token's position, -1 once a token does not match.
template <bool kWarp>
__device__ __forceinline__ long long run_pattern(const Src chars,
                                 const Pattern& pt, long long cur,
                                 long long hi, int lane) {
  long long p = -1;
  for (int rep = 0; rep < pt.repeat; ++rep) {
    for (int k = 0; k < pt.ntok; ++k) {
      const int len = __ldg(pt.tok_off + k + 1) - __ldg(pt.tok_off + k);
      const long long limit = hi - __ldg(pt.reserve + k) - len;
      p = kWarp ? find_warp(chars, pt, k, cur, limit, lane)
                : find_thread(chars, pt, k, cur, limit);
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

__global__ void __launch_bounds__(kThreads)
find_kernel(const int* __restrict__ offsets,
            const unsigned char* __restrict__ chars, int cap, Pattern pt,
            const int* __restrict__ starts, int* __restrict__ out) {
  __shared__ __align__(16) unsigned char stage[kStage + 16];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  // the block's rows [r0, r1) and their bytes [b0, b1)
  const long long r0 = (long long)blockIdx.x * kThreads;
  const long long r1 = r0 + kThreads < cap ? r0 + kThreads : cap;
  const long long b0 = offsets[r0], b1 = offsets[r1];
  // positions q whose address chars + q is 16-byte aligned: q + mis = 0
  // mod 16; stage[k] holds byte a0 + k, so those land aligned there too
  const long long mis =
      static_cast<long long>(reinterpret_cast<uintptr_t>(chars) & 15);
  const long long a0 = ((b0 + mis) & ~15ll) - mis;
  Src src{chars, 0, a0, false};
  if (b1 - a0 <= kStage) {
    const long long h = ((b0 + mis + 15) & ~15ll) - mis;  // first aligned
    const long long t = ((b1 + mis) & ~15ll) - mis;       // last's end
    for (long long q = b0 + threadIdx.x; q < (h < b1 ? h : b1);
         q += kThreads)
      stage[q - a0] = chars[q];
    for (long long q = h + 16ll * threadIdx.x; q + 16 <= t;
         q += 16ll * kThreads)
      *reinterpret_cast<uint4*>(stage + (q - a0)) =
          __ldg(reinterpret_cast<const uint4*>(chars + q));
    for (long long q = (t > h ? t : h) + threadIdx.x; q < b1; q += kThreads)
      stage[q - a0] = chars[q];
    src = Src{stage, a0, a0, true};
  }
  __syncthreads();
  long long s = 0, e = 0;
  if (i < cap) {
    s = offsets[i];
    e = offsets[i + 1];
    if (starts != nullptr && starts[i] > s) s = starts[i];
  }
  const bool long_row = e - s > kShort;
  long long hit = -1;
  if (i < cap && !long_row) hit = run_pattern<false>(src, pt, s, e, lane);
  unsigned todo = __ballot_sync(kFull, i < cap && long_row);
  while (todo) {
    const int owner = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long rs = __shfl_sync(kFull, s, owner);
    const long long re = __shfl_sync(kFull, e, owner);
    const long long p = run_pattern<true>(src, pt, rs, re, lane);
    if (lane == owner) hit = p;
  }
  if (i < cap) out[i] = static_cast<int>(hit);
}

__device__ __forceinline__ void mask_at(const unsigned char* __restrict__ chars,
                                        long long q, long long last,
                                        const unsigned char* __restrict__ pat,
                                        int len, bool* __restrict__ out) {
  if (q > last) return;
  for (int j = 0; j < len; ++j)
    if (__ldg(chars + q + j) != __ldg(pat + j)) return;
  out[q] = true;
}

__global__ void __launch_bounds__(kThreads)
mask_kernel(const int* __restrict__ offsets,
            const unsigned char* __restrict__ chars, int cap,
            const unsigned char* __restrict__ pat, int len,
            bool* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long s = 0, e = 0;
  if (i < cap) {
    s = offsets[i];
    e = offsets[i + 1];
  }
  const bool long_row = e - s > kShort;
  if (i < cap && !long_row)
    for (long long q = s; q + len <= e; ++q)
      mask_at(chars, q, e - len, pat, len, out);
  unsigned todo = __ballot_sync(kFull, i < cap && long_row);
  while (todo) {
    const int owner = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long rs = __shfl_sync(kFull, s, owner);
    const long long re = __shfl_sync(kFull, e, owner);
    for (long long q = rs + lane; q + len <= re; q += 32)
      mask_at(chars, q, re - len, pat, len, out);
  }
}

}  // namespace

// offsets: int32[cap + 1]; chars: the bytes; packed: the tokens' nbytes
// bytes, then as many wildcard flags; ints: int32 token offsets[ntok + 1],
// modes[ntok], reserves[ntok]; starts: int32[cap] where each row's search
// begins (raised to the row start), or null for the row start; out:
// int32[cap].
extern "C" int srt_string_find(const int* offsets, const unsigned char* chars,
                               int cap, const unsigned char* packed,
                               int nbytes, const int* ints, int ntok,
                               int has_wild, int repeat, int reverse,
                               const int* starts, int* out,
                               cudaStream_t stream) {
  if (cap < 0 || ntok <= 0 || repeat <= 0 || nbytes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cap == 0) return static_cast<int>(cudaSuccess);
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
  const int blocks = (cap + kThreads - 1) / kThreads;
  find_kernel<<<blocks, kThreads, 0, stream>>>(offsets, chars, cap, pt,
                                               starts, out);
  return static_cast<int>(cudaGetLastError());
}

// The mask mode: out (bool[char_cap], zeroed by the wrapper) is set where
// the needle pat[0, len) matches and ends inside the byte's row.
extern "C" int srt_string_match_mask(const int* offsets,
                                     const unsigned char* chars, int cap,
                                     const unsigned char* pat, int len,
                                     bool* out, cudaStream_t stream) {
  if (cap < 0 || len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cap == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (cap + kThreads - 1) / kThreads;
  mask_kernel<<<blocks, kThreads, 0, stream>>>(offsets, chars, cap, pat, len,
                                               out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

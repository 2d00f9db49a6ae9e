// K20: each string row's UTF-8 character count, and the byte cut of a
// substring or a trim.
//
// Replaces the reference's expr/strings.py _char_starts plus a cumsum
// over the whole char buffer plus searchsorted per row, in _eval_length,
// _eval_substring (Spark's pos rules: 1-based, 0 taken as 1, negative
// counted from the end; the end from the raw start, both clamped into
// the row's characters) and the nonspace prefix count and searches of
// _trim_impl.  Here each row walks its own bytes: a length counts its
// lead bytes (a byte that is no continuation, 10xxxxxx); a substring
// walks to the lead bytes of the cut's first and end characters, and
// counts the row's characters first only where pos is negative (counted
// from the end); a trim looks for the first and the last byte that is no
// space (0x20).  The cut's bytes are then copied by K16's copy
// (ops/strings.py:gather_chars).  A literal pos or length comes as a
// scalar, a column's as int64[cap].
//
// Skew: a thread walks a row of at most kShort bytes alone; a warp's
// longer rows are walked one after another by all 32 lanes, 32 bytes a
// step with a ballot and a population count.
//
// Bound: device-memory bytes: each row's bytes read once (a negative
// pos's second walk hits the L1 cache), its offsets, 8 B of pos and of
// length where they are columns, and 4 B of count or 8 B of cut written.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShort = 128;  // bytes a thread walks alone
constexpr unsigned kFull = 0xffffffffu;
enum { kLength = 0, kSubstring = 1, kTrim = 2, kTrimLeft = 3, kTrimRight = 4 };

__device__ __forceinline__ bool is_lead(unsigned char b) {
  return (b & 0xC0) != 0x80;
}

// A substring's pos and length: a column (int64[cap]) or a literal.
struct Cut {
  const long long* pos;
  long long pos_lit;
  const long long* len;
  long long len_lit;
  int has_len;  // 0: to the row's end
  __device__ __forceinline__ long long pos_at(long long i) const {
    return pos != nullptr ? pos[i] : pos_lit;
  }
};

// The character cut [sc, ec) of Spark's substring(pos, len) over a row of
// n characters (n is read only where pos < 0); ec = -1 runs to the row's
// end.  A cut past the row's characters meets no lead byte, so its byte
// stays the row's end: the reference's clamps into [0, n].
__device__ __forceinline__ void char_cut(const Cut& c, long long i,
                                         long long n, long long p,
                                         long long& sc, long long& ec) {
  const long long start = p > 0 ? p - 1 : (p < 0 ? n + p : 0);
  sc = start < 0 ? 0 : start;
  ec = -1;
  if (c.has_len) {
    const long long l = c.len != nullptr ? c.len[i] : c.len_lit;
    const long long end = start + (l > 0 ? l : 0);
    ec = end < sc ? sc : end;
  }
}

__device__ void cut_thread(const unsigned char* __restrict__ chars, int mode,
                           long long o0, long long o1, const Cut& c,
                           long long i, int& count, long long& b0,
                           long long& b1) {
  if (mode == kLength) {
    long long n = 0;
    for (long long q = o0; q < o1; ++q) n += is_lead(__ldg(chars + q));
    count = static_cast<int>(n);
    return;
  }
  if (mode == kSubstring) {
    const long long p = c.pos_at(i);
    long long n = 0;
    if (p < 0)
      for (long long q = o0; q < o1; ++q) n += is_lead(__ldg(chars + q));
    long long sc, ec;
    char_cut(c, i, n, p, sc, ec);
    const long long stop = ec < 0 ? sc : ec;
    b0 = o1;
    b1 = o1;
    long long k = 0;
    for (long long q = o0; q < o1 && k <= stop; ++q) {
      if (!is_lead(__ldg(chars + q))) continue;
      if (k == sc) b0 = q;
      if (k == ec) b1 = q;
      ++k;
    }
    return;
  }
  long long first = o1, last = o0 - 1;
  for (long long q = o0; q < o1; ++q) {
    if (__ldg(chars + q) != 32) {
      if (first == o1) first = q;
      last = q;
    }
  }
  if (first == o1) {  // all spaces
    b0 = b1 = o0;
    return;
  }
  b0 = mode == kTrimRight ? o0 : first;
  b1 = mode == kTrimLeft ? o1 : last + 1;
}

__device__ __forceinline__ long long count_warp(
    const unsigned char* __restrict__ chars, long long o0, long long o1,
    int lane) {
  long long n = 0;
  for (long long base = o0; base < o1; base += 32) {
    const long long q = base + lane;
    n += __popc(__ballot_sync(kFull, q < o1 && is_lead(__ldg(chars + q))));
  }
  return n;
}

__device__ void cut_warp(const unsigned char* __restrict__ chars, int mode,
                         long long o0, long long o1, const Cut& c,
                         long long i, int lane, int& count, long long& b0,
                         long long& b1) {
  if (mode == kLength) {
    count = static_cast<int>(count_warp(chars, o0, o1, lane));
    return;
  }
  if (mode == kSubstring) {
    const long long p = c.pos_at(i);
    const long long n = p < 0 ? count_warp(chars, o0, o1, lane) : 0;
    long long sc, ec;
    char_cut(c, i, n, p, sc, ec);
    const long long stop = ec < 0 ? sc : ec;
    b0 = o1;
    b1 = o1;
    long long k = 0;  // lead bytes before this step
    for (long long base = o0; base < o1 && k <= stop; base += 32) {
      const long long q = base + lane;
      const bool lead = q < o1 && is_lead(__ldg(chars + q));
      const unsigned m = __ballot_sync(kFull, lead);
      const long long rank = k + __popc(m & ((1u << lane) - 1u));
      const unsigned h0 = __ballot_sync(kFull, lead && rank == sc);
      const unsigned h1 = __ballot_sync(kFull, lead && rank == ec);
      if (h0) b0 = base + __ffs(h0) - 1;
      if (h1) b1 = base + __ffs(h1) - 1;
      k += __popc(m);
    }
    return;
  }
  long long first = o1, last = o0 - 1;
  for (long long base = o0; base < o1; base += 32) {
    const long long q = base + lane;
    const unsigned m =
        __ballot_sync(kFull, q < o1 && __ldg(chars + q) != 32);
    if (m) {
      if (first == o1) first = base + __ffs(m) - 1;
      last = base + 31 - __clz(m);
    }
  }
  if (first == o1) {
    b0 = b1 = o0;
    return;
  }
  b0 = mode == kTrimRight ? o0 : first;
  b1 = mode == kTrimLeft ? o1 : last + 1;
}

__global__ void __launch_bounds__(kThreads)
cut_kernel(const int* __restrict__ offsets,
           const unsigned char* __restrict__ chars, int cap, int mode,
           Cut c, int* __restrict__ count_out, int* __restrict__ b0_out,
           int* __restrict__ b1_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long o0 = 0, o1 = 0;
  if (i < cap) {
    o0 = offsets[i];
    o1 = offsets[i + 1];
  }
  const bool long_row = o1 - o0 > kShort;
  int count = 0;
  long long b0 = o0, b1 = o1;
  if (i < cap && !long_row)
    cut_thread(chars, mode, o0, o1, c, i, count, b0, b1);
  unsigned todo = __ballot_sync(kFull, i < cap && long_row);
  while (todo) {
    const int owner = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long r0 = __shfl_sync(kFull, o0, owner);
    const long long r1 = __shfl_sync(kFull, o1, owner);
    const long long row = __shfl_sync(kFull, i, owner);
    long long c0 = r0, c1 = r1;
    int n = 0;
    cut_warp(chars, mode, r0, r1, c, row, lane, n, c0, c1);
    if (lane == owner) {
      count = n;
      b0 = c0;
      b1 = c1;
    }
  }
  if (i < cap) {
    if (count_out != nullptr) count_out[i] = count;
    if (b0_out != nullptr) b0_out[i] = static_cast<int>(b0);
    if (b1_out != nullptr) b1_out[i] = static_cast<int>(b1);
  }
}

}  // namespace

// offsets: int32[cap + 1]; chars: the bytes; mode: 0 length, 1 substring,
// 2 trim, 3 trim left, 4 trim right; a substring's pos is int64[cap], or
// null for pos_lit in every row, its length likewise (has_len 0: to the
// row's end); count (a length) and b0, b1 (the other modes): int32[cap]
// out.
extern "C" int srt_utf8_cut(const int* offsets, const unsigned char* chars,
                            int cap, int mode, const long long* pos,
                            long long pos_lit, const long long* len,
                            long long len_lit, int has_len, int* count,
                            int* b0, int* b1, cudaStream_t stream) {
  if (cap < 0 || mode < kLength || mode > kTrimRight ||
      (mode == kLength && count == nullptr) ||
      (mode != kLength && (b0 == nullptr || b1 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (cap == 0) return static_cast<int>(cudaSuccess);
  const Cut c{pos, pos_lit, len, len_lit, has_len};
  const int blocks = (cap + kThreads - 1) / kThreads;
  cut_kernel<<<blocks, kThreads, 0, stream>>>(offsets, chars, cap, mode, c,
                                              count, b0, b1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

// K21: a byte map of every string row into a new chars buffer under the
// same offsets: ASCII upper and lower case, initcap, and a reverse by
// UTF-8 character.
//
// Replaces the reference's expr/strings.py _case_map (a where over the
// whole buffer), _eval_initcap (the byte before each byte, and a scatter
// of the row starts) and _eval_reverse (a searchsorted of every byte's
// row, then a gather that reverses bytes; here the characters are
// reversed and the bytes inside a character keep their order, Spark's
// answer).  Upper and lower map every byte below the total, one byte a
// thread over a grid-stride loop; initcap and reverse walk each row: a
// letter is upper-cased at its row's start or after a space and
// lower-cased elsewhere; a reverse writes each character's bytes to
// o0 + (o1 - end) + (byte - start).  Bytes past the total are zero.
//
// Skew: a thread walks a row of at most kShort bytes alone; a warp's
// longer rows are walked by all 32 lanes, 32 bytes a step; in a reverse
// each lead byte's lane writes its character where the next lead byte is
// in the same step, and the warp writes the character still open at a
// step's end once its end is found.
//
// Bound: device-memory bytes: each byte read once and written once, and
// the offsets.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShort = 128;  // bytes a thread walks alone
constexpr unsigned kFull = 0xffffffffu;
enum { kUpper = 0, kLower = 1, kInitCap = 2, kReverse = 3 };

__device__ __forceinline__ unsigned char to_upper(unsigned char c) {
  return (c >= 'a' && c <= 'z') ? c - 32 : c;
}

__device__ __forceinline__ unsigned char to_lower(unsigned char c) {
  return (c >= 'A' && c <= 'Z') ? c + 32 : c;
}

__device__ __forceinline__ bool is_lead(unsigned char b) {
  return (b & 0xC0) != 0x80;
}

__global__ void __launch_bounds__(kThreads)
case_kernel(const int* __restrict__ offsets, int cap,
            const unsigned char* __restrict__ chars, long long n, int upper,
            unsigned char* __restrict__ out) {
  const long long total = offsets[cap];
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x; q < n;
       q += stride) {
    const unsigned char c = q < total ? chars[q] : 0;
    out[q] = q < total ? (upper ? to_upper(c) : to_lower(c)) : 0;
  }
}

// Writes bytes [s, e) of a character of the row [o0, o1) to its reversed
// place, lane-strided over the warp's lanes (step 32) or by one thread
// (step 1).
__device__ __forceinline__ void put_char(const unsigned char* __restrict__ chars,
                                         long long o0, long long o1,
                                         long long s, long long e, int first,
                                         int step,
                                         unsigned char* __restrict__ out) {
  for (long long q = s + first; q < e; q += step)
    out[o0 + (o1 - e) + (q - s)] = chars[q];
}

__device__ void row_thread(const unsigned char* __restrict__ chars, int mode,
                           long long o0, long long o1,
                           unsigned char* __restrict__ out) {
  if (mode == kInitCap) {
    unsigned char prev = 32;
    for (long long q = o0; q < o1; ++q) {
      const unsigned char c = chars[q];
      out[q] = (q == o0 || prev == 32) ? to_upper(c) : to_lower(c);
      prev = c;
    }
    return;
  }
  long long s = o0;  // the open character's first byte
  for (long long q = o0 + 1; q <= o1; ++q) {
    if (q == o1 || is_lead(chars[q])) {
      put_char(chars, o0, o1, s, q, 0, 1, out);
      s = q;
    }
  }
}

__device__ void row_warp(const unsigned char* __restrict__ chars, int mode,
                         long long o0, long long o1, int lane,
                         unsigned char* __restrict__ out) {
  if (mode == kInitCap) {
    for (long long q = o0 + lane; q < o1; q += 32) {
      const unsigned char c = chars[q];
      const bool word = q == o0 || chars[q - 1] == 32;
      out[q] = word ? to_upper(c) : to_lower(c);
    }
    return;
  }
  long long open = o0;  // the first byte of the character not yet written
  for (long long base = o0; base < o1; base += 32) {
    const long long q = base + lane;
    const bool lead = q < o1 && q > o0 && is_lead(chars[q]);
    const unsigned m = __ballot_sync(kFull, lead);
    if (!m) continue;
    // the open character ends at this step's first lead byte
    const long long first = base + __ffs(m) - 1;
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

__global__ void __launch_bounds__(kThreads)
row_kernel(const int* __restrict__ offsets,
           const unsigned char* __restrict__ chars, int cap, long long n,
           int mode, unsigned char* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long o0 = 0, o1 = 0;
  if (i < cap) {
    o0 = offsets[i];
    o1 = offsets[i + 1];
  }
  const bool long_row = o1 - o0 > kShort;
  if (i < cap && !long_row && o1 > o0) row_thread(chars, mode, o0, o1, out);
  unsigned todo = __ballot_sync(kFull, i < cap && long_row);
  while (todo) {
    const int owner = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long r0 = __shfl_sync(kFull, o0, owner);
    const long long r1 = __shfl_sync(kFull, o1, owner);
    row_warp(chars, mode, r0, r1, lane, out);
  }
  // the zero tail past the total
  const long long total = offsets[cap];
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long q = total + i; q < n; q += stride) out[q] = 0;
}

}  // namespace

// offsets: int32[cap + 1]; chars: uint8[n]; mode: 0 upper, 1 lower,
// 2 initcap, 3 reverse; out: uint8[n].
extern "C" int srt_string_map(const int* offsets, const unsigned char* chars,
                              int cap, long long n, int mode,
                              unsigned char* out, cudaStream_t stream) {
  if (cap < 0 || n < 0 || mode < kUpper || mode > kReverse)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (mode == kUpper || mode == kLower) {
    long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    case_kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(
        offsets, cap, chars, n, mode == kUpper, out);
  } else {
    const int blocks = cap > 0 ? (cap + kThreads - 1) / kThreads : 1;
    row_kernel<<<blocks, kThreads, 0, stream>>>(offsets, chars, cap, n, mode,
                                                out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

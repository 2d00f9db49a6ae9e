// K14: the two 64-bit rolling hashes of every string, and the join's key
// word.
//
// Replaces the reference's ops/strings.py _rolling_hash / string_hashes,
// which compute hash_i = sum_{j in span i} (c_j + 1) * base^(j - start_i)
// mod 2^64 for two bases through a global prefix sum of
// (c_j + 1) * base^j, a cumulative product of base^-1 and two gathers
// (O(char_cap) work in 64-bit lanes, the TPU's way round a per-row
// loop).  Here each row is a Horner loop from its last byte to its
// first, h = h * base + (c + 1), which gives the same bits (sums and
// products wrap mod 2^64 in both).  With a join word pointer it also
// writes h1 ^ (h2 * MIX), the reference's ops/join_kernels.py string key
// word, which K6 and K4 mix and fold (csrc/join_hash.cuh kKeyString).
//
// One thread a row.  Skew: a row longer than kShort bytes is not hashed
// by its own thread; the warp's long rows are hashed one after another
// by all 32 lanes, each Horner-folding one contiguous 1/32 of the span,
// scaling its partial hash by base^(chunk start) (square-and-multiply)
// and adding the 32 partials with shuffles.  So a 1 MB string costs its
// warp about 32 KB of bytes a lane, and no other warp waits on it.
//
// Bound: device-memory bytes.  Per row the offsets (4 B), its chars, and
// 16 B of hashes (24 B with the join word) written, over 3.35 TB/s.  The
// two 64-bit multiply-adds a byte are a dependent chain per thread; the
// warps in flight hide its latency.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShort = 64;  // bytes a thread hashes alone
constexpr unsigned long long kBase1 = 0x100000001B3ull;
constexpr unsigned long long kBase2 = 0x9E3779B97F4A7C15ull;
constexpr unsigned long long kMix = 0xBF58476D1CE4E5B9ull;

__device__ __forceinline__ unsigned long long pow64(unsigned long long b,
                                                    unsigned long long e) {
  unsigned long long r = 1;
  while (e) {
    if (e & 1) r *= b;
    b *= b;
    e >>= 1;
  }
  return r;
}

// Horner over bytes [s, e), last byte first: sum (c_j + 1) * base^(j - s).
__device__ __forceinline__ void horner(const unsigned char* __restrict__ chars,
                                       long long s, long long e,
                                       unsigned long long& h1,
                                       unsigned long long& h2) {
  for (long long j = e - 1; j >= s; --j) {
    const unsigned long long c = static_cast<unsigned long long>(
                                     __ldg(chars + j)) + 1ull;
    h1 = h1 * kBase1 + c;
    h2 = h2 * kBase2 + c;
  }
}

__global__ void __launch_bounds__(kThreads)
hash_kernel(const int* __restrict__ offsets,
            const unsigned char* __restrict__ chars, int cap,
            unsigned long long* __restrict__ h1_out,
            unsigned long long* __restrict__ h2_out,
            unsigned long long* __restrict__ word_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long s = 0, e = 0;
  if (i < cap) {
    s = offsets[i];
    e = offsets[i + 1];
  }
  unsigned long long h1 = 0, h2 = 0;
  const bool long_row = e - s > kShort;
  if (!long_row) horner(chars, s, e, h1, h2);
  unsigned todo = __ballot_sync(0xffffffffu, long_row);
  while (todo) {
    const int owner = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long rs = __shfl_sync(0xffffffffu, s, owner);
    const long long re = __shfl_sync(0xffffffffu, e, owner);
    const long long chunk = (re - rs + 31) / 32;
    const long long cs = rs + lane * chunk;
    const long long ce = cs + chunk < re ? cs + chunk : re;
    unsigned long long p1 = 0, p2 = 0;
    if (cs < re) {
      horner(chars, cs, ce, p1, p2);
      const unsigned long long shift =
          static_cast<unsigned long long>(cs - rs);
      p1 *= pow64(kBase1, shift);
      p2 *= pow64(kBase2, shift);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p1 += __shfl_xor_sync(0xffffffffu, p1, off);
      p2 += __shfl_xor_sync(0xffffffffu, p2, off);
    }
    if (lane == owner) {
      h1 = p1;
      h2 = p2;
    }
  }
  if (i < cap) {
    h1_out[i] = h1;
    h2_out[i] = h2;
    if (word_out != nullptr) word_out[i] = h1 ^ (h2 * kMix);
  }
}

}  // namespace

// offsets: int32[cap + 1]; chars: the bytes they index; h1, h2:
// uint64[cap] out; word: uint64[cap] out, or null for no join word.
extern "C" int srt_string_hashes(const int* offsets,
                                 const unsigned char* chars, int cap,
                                 unsigned long long* h1,
                                 unsigned long long* h2,
                                 unsigned long long* word,
                                 cudaStream_t stream) {
  if (cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cap == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (cap + kThreads - 1) / kThreads;
  hash_kernel<<<blocks, kThreads, 0, stream>>>(offsets, chars, cap, h1, h2,
                                               word);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

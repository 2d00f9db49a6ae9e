// K15: Spark's Murmur3 hash of every string (hashUnsafeBytes), folded into
// a running per-row seed.
//
// Replaces the reference's expr/hashfns.py hash_bytes, where all rows
// step together through a loop over the longest row's 4-byte blocks
// (a traced while_loop, so every row pays for the longest).  Here a
// thread hashes its own row: the 4-byte little-endian blocks through
// mix_k1 / mix_h1, then each tail byte as a signed int, then fmix with
// the byte length, from the row's seed; a null row (validity 0) keeps
// its seed, Spark's rule.
//
// Skew: Murmur3 is one dependent chain a row (each block's state feeds
// the next), so a long span cannot be split across a warp as K14 splits
// its polynomial hash.  A 1 MB string costs its thread 2^18 block steps
// while the other 31 lanes of its warp sit done; other warps and blocks
// do not wait on it (no block-wide barrier), so the cost of skew is
// one warp's slot, not the launch.
//
// Bound: device-memory bytes.  Per row the offsets (4 B), its chars, the
// seed (4 B) and validity (1 B) read, and the hash (4 B) written, over
// 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned rotl(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ unsigned mix_k1(unsigned k) {
  k *= 0xCC9E2D51u;
  k = rotl(k, 15);
  return k * 0x1B873593u;
}

__device__ __forceinline__ unsigned mix_h1(unsigned h, unsigned k) {
  h ^= k;
  h = rotl(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ unsigned fmix(unsigned h, unsigned len) {
  h ^= len;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

__global__ void __launch_bounds__(kThreads)
murmur_kernel(const int* __restrict__ offsets,
              const unsigned char* __restrict__ chars,
              const unsigned char* __restrict__ valid,
              const int* __restrict__ seed, int cap, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= cap) return;
  unsigned h = static_cast<unsigned>(seed[i]);
  if (valid == nullptr || valid[i]) {
    const long long s = offsets[i];
    const long long len = offsets[i + 1] - s;
    const unsigned char* p = chars + s;
    const long long blocks = len >> 2;
    for (long long b = 0; b < blocks; ++b) {
      const unsigned char* q = p + 4 * b;
      const unsigned k = static_cast<unsigned>(__ldg(q)) |
                         (static_cast<unsigned>(__ldg(q + 1)) << 8) |
                         (static_cast<unsigned>(__ldg(q + 2)) << 16) |
                         (static_cast<unsigned>(__ldg(q + 3)) << 24);
      h = mix_h1(h, mix_k1(k));
    }
    for (long long j = blocks * 4; j < len; ++j) {
      const int c = static_cast<signed char>(__ldg(p + j));
      h = mix_h1(h, mix_k1(static_cast<unsigned>(c)));
    }
    h = fmix(h, static_cast<unsigned>(len));
  }
  out[i] = static_cast<int>(h);
}

}  // namespace

// offsets: int32[cap + 1]; chars: the bytes they index; valid: bool[cap]
// or null (all valid); seed, out: int32[cap] (uint32 bits).
extern "C" int srt_hash_bytes(const int* offsets, const unsigned char* chars,
                              const unsigned char* valid, const int* seed,
                              int cap, int* out, cudaStream_t stream) {
  if (cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cap == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (cap + kThreads - 1) / kThreads;
  murmur_kernel<<<blocks, kThreads, 0, stream>>>(offsets, chars, valid, seed,
                                                 cap, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

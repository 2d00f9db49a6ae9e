// K17: the ordering words of every string.
//
// Replaces the reference's ops/strings.py prefix_words / order_keys: the
// first 32 bytes of each string as 4 big-endian uint64 words (zero past
// the string's end), then its length, most significant first, so that
// the unsigned lexicographic order of the 5 words is the byte order of
// the strings (strings sharing more than 32 bytes of prefix tie-break
// by length only, as in the reference).  The reference gathers a
// [rows, 32] byte matrix through an int32 index matrix; here a thread
// reads its row's bytes and packs them in registers.  Each word is
// written XOR 2^63, the port's carrier for a uint64 key word in an
// int64 lane (K2 sorts signed words).
//
// One thread a row; a row reads at most 32 bytes, so no row is longer
// than any other here and skew cannot hold a warp.  Output is word-major
// (out[w * cap + i]), so each word's stores are coalesced.
//
// Bound: device-memory bytes.  Per row the offsets (4 B), up to 32 B of
// chars, and 40 B written, over 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;
constexpr unsigned long long kSign = 0x8000000000000000ull;

__global__ void __launch_bounds__(kThreads)
prefix_kernel(const int* __restrict__ offsets,
              const unsigned char* __restrict__ chars, int cap,
              unsigned long long* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= cap) return;
  const long long s = offsets[i];
  const int len = offsets[i + 1] - static_cast<int>(s);
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    unsigned long long word = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int k = w * 8 + b;
      const unsigned long long c =
          k < len ? static_cast<unsigned long long>(__ldg(chars + s + k)) : 0;
      word = (word << 8) | c;
    }
    out[(long long)w * cap + i] = word ^ kSign;
  }
  out[(long long)kWords * cap + i] =
      static_cast<unsigned long long>(static_cast<long long>(len)) ^ kSign;
}

}  // namespace

// offsets: int32[cap + 1]; chars: the bytes they index; out:
// uint64[5 * cap], word w of row i at w * cap + i.
extern "C" int srt_prefix_words(const int* offsets, const unsigned char* chars,
                                int cap, unsigned long long* out,
                                cudaStream_t stream) {
  if (cap < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (cap == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (cap + kThreads - 1) / kThreads;
  prefix_kernel<<<blocks, kThreads, 0, stream>>>(offsets, chars, cap, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

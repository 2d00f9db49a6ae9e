// K2: stable lexicographic sort of rows by int64 key words, carrying
// the int32 row order.
//
// Replaces the reference's ops/carry.py sort_rows / sort_lanes and
// ops/segmented.py lexsort (lax.sort with num_keys and is_stable on the
// TPU).  An LSD radix sort: the least significant word first, as the
// reference's _sort_rows_lean orders its passes, and within a word one
// stable 16-bucket partition per 4-bit digit, reusing K1's count / scan
// / scatter.  A digit whose bits are equal in every row is skipped:
// srt_diff_bits reports which bits vary, so a key of 100,000 values
// takes five passes, not sixteen.  Words hold int64 values in signed
// order; each digit is taken from the word with its sign bit flipped.
//
// Bound: device-memory bytes.  Least traffic is each key word read once
// and the order written once, over 3.35 TB/s; each pass here reads the
// current word twice and moves (word, order) once.

#include "partition.cuh"

namespace {

struct RadixDigit {
  const long long* key;
  int shift;
  __device__ int operator()(long long i) const {
    const unsigned long long u =
        static_cast<unsigned long long>(key[i]) ^ 0x8000000000000000ull;
    return static_cast<int>((u >> shift) & 15ull);
  }
};

__global__ void diff_bits_kernel(const long long* w, int n,
                                 unsigned long long* out) {
  const unsigned long long first = static_cast<unsigned long long>(w[0]);
  unsigned long long acc = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    acc |= static_cast<unsigned long long>(w[i]) ^ first;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc |= __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if ((threadIdx.x & 31) == 0 && acc) atomicOr(out, acc);
}

}  // namespace

// *out |= OR over rows of (w[i] ^ w[0]); *out must start at zero.
extern "C" int srt_diff_bits(const long long* w, int n,
                             unsigned long long* out, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  int blocks = (n + 255) / 256;
  if (blocks > 1056) blocks = 1056;  // 8 blocks per SM on 132 SMs
  diff_bits_kernel<<<blocks, 256, 0, stream>>>(w, n, out);
  return static_cast<int>(cudaGetLastError());
}

// One stable pass on the 4-bit digit at `shift`: (key_in, ord_in) ->
// (key_out, ord_out).  key_out may be null when the keys are not needed
// after this pass.  scratch: 32 * num_tiles(n) ints.
extern "C" int srt_radix_pass(const long long* key_in, const int* ord_in,
                              long long* key_out, int* ord_out, int n,
                              int shift, int* scratch, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (shift < 0 || shift > 60 || shift % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  srt::LaneWriter writer;
  writer.lanes.count = 0;
  const int k = key_out != nullptr ? 1 : 0;
  if (k) {
    writer.lanes.in[0] = key_in;
    writer.lanes.out[0] = key_out;
    writer.lanes.bytes[0] = 8;
    writer.lanes.clear_back[0] = 0;
  }
  writer.lanes.in[k] = ord_in;
  writer.lanes.out[k] = ord_out;
  writer.lanes.bytes[k] = 4;
  writer.lanes.clear_back[k] = 0;
  writer.lanes.count = k + 1;
  const int tiles = srt::num_tiles(n);
  int* counts = scratch;
  int* offsets = scratch + 16 * tiles;
  return static_cast<int>(srt::partition<16>(
      RadixDigit{key_in, shift}, writer, n, counts, offsets, stream));
}

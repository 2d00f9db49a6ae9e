// K6: the equi-join's combined key hash, written out for every row.
//
// Replaces the reference's ops/join_kernels.py combined_key_hash (with
// _mix64 and ops/segmented.py encode_int_ordered / encode_float_ordered):
// there a chain of elementwise passes over whole lanes, in the port's
// plain version about 40 torch passes.  The join hashes the build side
// with it; the probe side's hash is computed inside K4 instead
// (join_probe.cu), from the same device function (join_hash.cuh).
//
// One thread per row: each key column's value and validity are read
// once, the hash is folded in registers and written once.
//
// Bound: device-memory bytes.  Least traffic per row is each key's value
// (1, 4 or 8 B) and validity (1 B) read and the 8 B hash written, over
// 3.35 TB/s.

#include <cuda_runtime.h>

#include "join_hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
key_hash_kernel(srt::KeyCols keys, int n, int null_matches,
                unsigned long long sentinel,
                unsigned long long* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = srt::row_hash(keys, i, null_matches != 0, sentinel);
}

}  // namespace

// desc: device array of 3 * nkeys int64s (srt::KeyCols); n rows; side 0
// for the build side's null sentinel, 1 for the probe side's; out:
// int64[n], the hashes' bits.
extern "C" int srt_key_hash(const long long* desc, int nkeys, int n,
                            int null_matches, int side,
                            unsigned long long* out, cudaStream_t stream) {
  if (nkeys < 1 || n < 0 || side < 0 || side > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const srt::KeyCols keys{desc, nkeys};
  const int blocks = (n + kThreads - 1) / kThreads;
  key_hash_kernel<<<blocks, kThreads, 0, stream>>>(
      keys, n, null_matches, side ? srt::kNullProbe : srt::kNullBuild, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

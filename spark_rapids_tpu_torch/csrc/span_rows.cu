// K18: the child rows of gathered spans.
//
// Replaces the child branch of the reference's ops/gather.py gather_spans:
// once K16's first launch has written the new offsets of a row selection
// over an ARRAY or MAP column (and each selected row's source start), every
// output child slot p < total finds the row r whose new span holds it
// (new_offsets[r] <= p < new_offsets[r + 1]) and reads its child row
// starts[r] + p - new_offsets[r].  The reference finds r by a searchsorted
// over the new offsets (numpy) or a scatter-and-cummax fill
// (ops/scan.py fill_rows_from_starts, on the TPU).  Slots from total on
// read child row 0 and are out of range.
//
// Bound: device-memory bytes.  4 B written per child slot, and the new
// offsets and starts read once per row that holds a slot (8 B a row), over
// 3.35 TB/s.
//
// Design (K16's copy is the model, csrc/gather_strings.cu): the output is
// cut into stretches of kStretch = 1,024 slots, one block a stretch, 4
// consecutive slots a thread.  Thread 0 of a block finds, by two binary
// searches over the new offsets, the rows r0 and r1 that hold the
// stretch's first and last slot below total.  When they are at most kStage
// rows apart (the usual case: rows of one element or more), the block
// stages those rows' (new offset, start) pairs in shared memory and each
// thread finds the row of each of its slots by a binary search over the
// staged offsets.  When empty or null rows lie between them, so that more
// than kStage rows lie in the stretch, nothing is staged: each thread finds
// its slots' rows by binary searches over the new offsets in [r0, r1],
// reusing a row while its span still holds the next slot.  A thread keeps
// its 4 results in registers and writes them with one 16-byte store.  The
// work of a thread never depends on a span's length nor on how many empty
// rows lie between two spans (at most 4 searches of log2(r1 - r0) steps):
// a row of 2^24 elements spreads over 16,384 blocks, one-element rows come
// 4 to a thread, and 10^6 empty rows cost each thread of their stretch 20
// steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 4;                       // output slots a thread
constexpr int kStretch = kThreads * kSlots;     // output slots a block
constexpr int kStage = 2048;                    // rows staged a round

// The first i in [0, n] with offs[i] > x (offs nondecreasing, n + 1 long).
__device__ __forceinline__ int upper_bound(const int* __restrict__ offs,
                                           int n, long long x) {
  int lo = 0, hi = n + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
span_rows_kernel(const int* __restrict__ starts,
                 const int* __restrict__ new_offsets, int n, int total,
                 int* __restrict__ out, long long out_cap) {
  __shared__ int s_off[kStage + 1];
  __shared__ int s_src[kStage];
  __shared__ int s_rows[2];
  const long long p0 = (long long)blockIdx.x * kStretch;
  const long long c0 = p0 + (long long)threadIdx.x * kSlots;
  int v[kSlots] = {0, 0, 0, 0};
  if (p0 < total) {
    if (threadIdx.x == 0) {
      const long long last = p0 + kStretch < total ? p0 + kStretch - 1
                                                   : total - 1;
      s_rows[0] = upper_bound(new_offsets, n, p0) - 1;
      s_rows[1] = upper_bound(new_offsets, n, last);
    }
    __syncthreads();
    const int r0 = s_rows[0], r1 = s_rows[1];
    if (r1 - r0 <= kStage) {
      const int cnt = r1 - r0;
      for (int j = threadIdx.x; j < cnt; j += kThreads) {
        s_off[j] = new_offsets[r0 + j];
        s_src[j] = starts[r0 + j];
      }
      if (threadIdx.x == 0) s_off[cnt] = new_offsets[r1];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const long long p = c0 + k;
        if (p < total) {
          // the last staged row whose offset is <= p holds p
          int a = 0, z = cnt;
          while (a < z) {
            const int mid = (a + z) >> 1;
            if (s_off[mid] <= p) a = mid + 1; else z = mid;
          }
          const int j = a - 1;
          v[k] = s_src[j] + static_cast<int>(p - s_off[j]);
        }
      }
    } else {
      int j = r0, end = -1;                     // row of the last slot, its end
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const long long p = c0 + k;
        if (p < total) {
          if (p >= end) {
            // the last row in [j, r1] whose offset is <= p holds p
            int a = j, z = r1;
            while (a < z) {
              const int mid = (a + z + 1) >> 1;
              if (new_offsets[mid] <= p) a = mid; else z = mid - 1;
            }
            j = a;
            end = new_offsets[j + 1];
          }
          v[k] = starts[j] + static_cast<int>(p - new_offsets[j]);
        }
      }
    }
  }
  if (c0 + kSlots <= out_cap) {
    *reinterpret_cast<int4*>(out + c0) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    for (int k = 0; k < kSlots && c0 + k < out_cap; ++k) out[c0 + k] = v[k];
  }
}

}  // namespace

// starts: int32[n] each selected row's source start; new_offsets:
// int32[n + 1], new_offsets[n] = total, n >= 1; out: int32[out_cap],
// 16-byte aligned, total <= out_cap; every slot written (0 from total on).
extern "C" int srt_span_rows(const int* starts, const int* new_offsets,
                             int n, int total, int* out, long long out_cap,
                             cudaStream_t stream) {
  if (n < 1 || total < 0 || total > out_cap || out_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long blocks = (out_cap + kStretch - 1) / kStretch;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  span_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      starts, new_offsets, n, total, out, out_cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kStretch; }

// K9 and K10: the packed device-to-host fetch of a batch.
//
// Replaces the reference's columnar/fetch.py _lane_stats (with
// _narrow_min) and _make_shrink_pack_fn, which XLA compiles into one
// program per schema and plan.
//
// K9 lane_stats: one launch over every lane of a batch reduces its live
// rows [0, n): a bool lane gives (all true, 0), an int32 or int64 lane
// (min, max), any other lane (0, 0).  The host seeds the result with the
// empty-batch values (dtype max, dtype min for integers; 1, 0 for
// bools), so a block's result folds in with 64-bit integer atomics, which
// are exact.  Grid: x cuts the rows, y is the lane.  Bound: device-memory
// bytes, each reduced lane read once.  Bool lanes are read 16 bytes a
// thread where the lane is 16-byte aligned.
//
// K10 pack_lanes: one launch writes every lane that the host's transfer
// plan keeps into its slice of one byte buffer, each slice 8-byte
// aligned: a narrowed integer lane as (value - min) in 1, 2 or 4 bytes, a
// bool lane bit-packed 8 rows a byte, least significant bit first (the
// order of Arrow's validity bitmaps; one warp ballot makes one 32-bit
// word), any other lane as it is.  A lane that moves as it is (the same
// width, nothing subtracted) is copied 16 or 8 bytes a thread, as its
// two ends' alignment allows, whatever its element width.  Each slice's
// tail up to the next 8-byte boundary is written with zeros, so the
// buffer's every byte is defined.  Bound: device-memory bytes, each kept lane's live rows read
// once and its slice written once.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksX = 512;

enum Kind { kBool = 0, kInt32 = 1, kInt64 = 2, kOther = 3 };

__device__ __forceinline__ int bytes_all_true(unsigned int w) {
  // bool bytes are 0 or 1
  return (w & 0x01010101u) == 0x01010101u;
}

// desc: nlanes pointers, then nlanes kinds; stats: 2 * nlanes, seeded.
__global__ void __launch_bounds__(kThreads)
lane_stats_kernel(const long long* __restrict__ desc, int nlanes, int n,
                  long long* __restrict__ stats) {
  const int l = blockIdx.y;
  const int kind = static_cast<int>(desc[nlanes + l]);
  if (kind == kOther) return;
  const void* p = reinterpret_cast<const void*>(desc[l]);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (kind == kBool) {
    const unsigned char* b = static_cast<const unsigned char*>(p);
    int all = 1;
    long long done = 0;
    if ((reinterpret_cast<unsigned long long>(b) & 15) == 0) {
      const uint4* v = reinterpret_cast<const uint4*>(b);
      const long long nv = n / 16;
      for (long long j = first; j < nv; j += stride) {
        const uint4 x = __ldg(v + j);
        all &= bytes_all_true(x.x & x.y & x.z & x.w);
      }
      done = nv * 16;
    }
    for (long long i = done + first; i < n; i += stride) all &= b[i] != 0;
    all = __syncthreads_and(all);
    if (threadIdx.x == 0 && !all) atomicMin(&stats[2 * l], 0ll);
    return;
  }
  long long mn = LLONG_MAX, mx = LLONG_MIN;
  if (kind == kInt32) {
    const int* x = static_cast<const int*>(p);
    for (long long i = first; i < n; i += stride) {
      const long long v = __ldg(x + i);
      mn = min(mn, v);
      mx = max(mx, v);
    }
  } else {
    const long long* x = static_cast<const long long*>(p);
    for (long long i = first; i < n; i += stride) {
      const long long v = __ldg(x + i);
      mn = min(mn, v);
      mx = max(mx, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = min(mn, __shfl_down_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
  __shared__ long long s_mn[kWarps], s_mx[kWarps];
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      mn = min(mn, s_mn[w]);
      mx = max(mx, s_mx[w]);
    }
    if (mn <= mx) {               // the block saw at least one row
      atomicMin(&stats[2 * l], mn);
      atomicMax(&stats[2 * l + 1], mx);
    }
  }
}

// desc: 6 int64s a kept lane: source pointer, source bytes (1, 2, 4, 8),
// wire bytes (1, 2, 4, 8; 0 = bit-packed), slice offset, slice end
// (8-byte aligned), min subtracted (0 for a copy).
__global__ void __launch_bounds__(kThreads)
pack_kernel(const long long* __restrict__ desc, int n,
            unsigned char* __restrict__ out) {
  const long long* d = desc + 6 * blockIdx.y;
  const void* src = reinterpret_cast<const void*>(d[0]);
  const int sb = static_cast<int>(d[1]);
  const int wb = static_cast<int>(d[2]);
  const long long off = d[3];
  const long long end = d[4];
  const unsigned long long minv = static_cast<unsigned long long>(d[5]);
  unsigned char* dst = out + off;
  const long long stride = (long long)gridDim.x * kThreads;
  long long data_end;
  if (wb == 0) {
    // every thread of a block runs the same iterations: the ballot is
    // collective
    const unsigned char* b = static_cast<const unsigned char*>(src);
    unsigned int* words = reinterpret_cast<unsigned int*>(dst);
    for (long long base = (long long)blockIdx.x * kThreads; base < n;
         base += stride) {
      const long long i = base + threadIdx.x;
      const bool v = i < n && b[i] != 0;
      const unsigned int bits = __ballot_sync(0xffffffffu, v);
      if ((threadIdx.x & 31) == 0 && i < n) words[i / 32] = bits;
    }
    data_end = 4 * (((long long)n + 31) / 32);
  } else if (wb == sb && minv == 0) {
    // a copy: vectors where both ends allow, then the last bytes
    data_end = (long long)n * wb;
    const unsigned char* b = static_cast<const unsigned char*>(src);
    const unsigned long long ends = reinterpret_cast<unsigned long long>(b) |
                                    reinterpret_cast<unsigned long long>(dst);
    const int vb = (ends & 15) == 0 ? 16 : (ends & 7) == 0 ? 8 : 1;
    const long long words = data_end / vb;
    const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (vb == 16) {
      for (long long i = first; i < words; i += stride)
        reinterpret_cast<uint4*>(dst)[i] =
            __ldg(reinterpret_cast<const uint4*>(b) + i);
    } else if (vb == 8) {
      for (long long i = first; i < words; i += stride)
        reinterpret_cast<unsigned long long*>(dst)[i] =
            __ldg(reinterpret_cast<const unsigned long long*>(b) + i);
    } else {
      for (long long i = first; i < words; i += stride) dst[i] = __ldg(b + i);
    }
    const long long rest = data_end - words * vb;
    if (blockIdx.x == 0 && threadIdx.x < rest)
      dst[words * vb + threadIdx.x] = __ldg(b + words * vb + threadIdx.x);
  } else {
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += stride) {
      unsigned long long v;
      if (sb == 8) {
        v = __ldg(static_cast<const unsigned long long*>(src) + i);
      } else if (sb == 4) {
        // sign-extended, so (value - min) is exact modulo 2^64
        v = static_cast<unsigned long long>(static_cast<long long>(
            __ldg(static_cast<const int*>(src) + i)));
      } else if (sb == 2) {
        v = static_cast<unsigned long long>(static_cast<long long>(
            __ldg(static_cast<const short*>(src) + i)));
      } else {
        v = __ldg(static_cast<const unsigned char*>(src) + i);
      }
      v -= minv;
      switch (wb) {
        case 8:
          reinterpret_cast<unsigned long long*>(dst)[i] = v;
          break;
        case 4:
          reinterpret_cast<unsigned int*>(dst)[i] =
              static_cast<unsigned int>(v);
          break;
        case 2:
          reinterpret_cast<unsigned short*>(dst)[i] =
              static_cast<unsigned short>(v);
          break;
        default:
          dst[i] = static_cast<unsigned char>(v);
          break;
      }
    }
    data_end = (long long)n * wb;
  }
  const long long pad = end - off - data_end;
  if (blockIdx.x == 0 && threadIdx.x < pad) dst[data_end + threadIdx.x] = 0;
}

int blocks_for(int n, int rows_per_thread) {
  const long long per_block = (long long)kThreads * rows_per_thread;
  long long b = (n + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > kMaxBlocksX) b = kMaxBlocksX;
  return static_cast<int>(b);
}

}  // namespace

// desc: device int64[2 * nlanes] (pointers, kinds); stats: device
// int64[2 * nlanes], seeded with the empty-batch values; n live rows.
extern "C" int srt_lane_stats(const long long* desc, int nlanes, int n,
                              long long* stats, cudaStream_t stream) {
  if (nlanes < 1 || nlanes > 65535 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(blocks_for(n, 16), nlanes);
  lane_stats_kernel<<<grid, kThreads, 0, stream>>>(desc, nlanes, n, stats);
  return static_cast<int>(cudaGetLastError());
}

// desc: device int64[6 * nlanes] (see pack_kernel); out: the byte
// buffer, at least the last slice's end long.
extern "C" int srt_pack_lanes(const long long* desc, int nlanes, int n,
                              unsigned char* out, cudaStream_t stream) {
  if (nlanes < 1 || nlanes > 65535 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for(n, 4), nlanes);
  pack_kernel<<<grid, kThreads, 0, stream>>>(desc, n, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

// K8: gather of a batch's row lanes through a row order.
//
// Replaces the payload half of the reference's ops/carry.py sort_rows /
// sort_lanes, where lax.sort carries every payload lane through the
// sort's comparator network (chosen there because the TPU's gathers
// were slow).  On the card the sort (K2) returns the row order and this
// kernel moves the lanes: out[l][i] = in[l][order[i]] for lanes of 1, 4
// or 8 bytes.  `order` may repeat rows and index lanes longer than n.
//
// Bound: device-memory bytes.  Least traffic is the order (4 B a row)
// read once, and every lane read once and written once, over 3.35 TB/s.
// What holds a gather far from it is the random read: on K2's order
// order[i] is random, and every read in[l][order[i]] pulls a whole
// 32-byte sector from device memory, for a 1-byte validity lane as for
// an 8-byte value lane.
//
// single_kernel reads each lane on its own: one thread a row and a lane,
// blockIdx.y the lane, so the blocks in flight read one lane's rows at a
// time.  At q3 (six lanes, 27 B a row) that costs 4 x 6 + 32 x 6 + 27 =
// 243 B a row, and no single pass over the lanes goes below about 2.4 ms
// there.
//
// The record path makes the one random access a row a whole sector:
//   1. pack_kernel writes the m source rows as records of R = 16, 32 or
//      64 bytes, the lanes side by side (the host's layout: ops/gather.py
//      record_layout), 256 rows a block: each lane read coalesced into
//      shared memory, the records written with 16-byte stores;
//   2. unpack_kernel reads records[order[i]] for 256 rows a block, the
//      R / 16 pieces of one record loaded by neighbouring threads of one
//      instruction (one sector request a record), and writes each lane
//      coalesced.
// At q3 that is 27 + 32 (pack) + 4 + 32 + 27 (unpack) = 122 B a row with
// one random sector, against the single pass's 243 with six.  Binning
// the rows by source window, so that the random reads hit L2, does not
// pay once a row's lanes are one sector: each sector is then read by one
// row only.  The host chooses the path by this traffic (ops/gather.py
// gather_plan): one lane stays on the single pass.  Scratch, allocated by
// the caller: the m records.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 16;

struct Lanes {
  const void* in[kMaxLanes];
  void* out[kMaxLanes];
  int bytes[kMaxLanes];
  int offset[kMaxLanes];  // byte offset in a record (record path)
};

__device__ __forceinline__ unsigned long long load_lane(const void* p, int b,
                                                        long long i) {
  switch (b) {
    case 8: return __ldg(static_cast<const unsigned long long*>(p) + i);
    case 4: return __ldg(static_cast<const unsigned int*>(p) + i);
    case 2: return __ldg(static_cast<const unsigned short*>(p) + i);
    default: return __ldg(static_cast<const unsigned char*>(p) + i);
  }
}

__device__ __forceinline__ void store_lane(void* p, int b, long long i,
                                           unsigned long long v) {
  switch (b) {
    case 8: static_cast<unsigned long long*>(p)[i] = v; break;
    case 4: static_cast<unsigned int*>(p)[i] = static_cast<unsigned>(v);
      break;
    case 2: static_cast<unsigned short*>(p)[i] =
        static_cast<unsigned short>(v);
      break;
    default: static_cast<unsigned char*>(p)[i] =
        static_cast<unsigned char>(v);
  }
}

__global__ void __launch_bounds__(kThreads)
single_kernel(const int* __restrict__ order, int n, Lanes lanes) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int k = blockIdx.y;
  store_lane(lanes.out[k], lanes.bytes[k], i,
             load_lane(lanes.in[k], lanes.bytes[k], __ldg(order + i)));
}

// The rows' lanes packed into records of R bytes, 256 rows a block: each
// lane read coalesced into the staged records, the records written out
// with 16-byte stores.
template <int R>
__global__ void __launch_bounds__(kThreads)
pack_kernel(int m, Lanes lanes, int nlanes, uint4* __restrict__ records) {
  constexpr int kChunks = R / 16;
  __shared__ uint4 s_rec[kThreads * kChunks];
  unsigned char* s_bytes = reinterpret_cast<unsigned char*>(s_rec);
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * kThreads;
  const int rows = static_cast<int>(
      m - first < kThreads ? m - first : (long long)kThreads);
  if (tid < rows) {
    unsigned char* rec = s_bytes + tid * R;
    for (int l = 0; l < nlanes; ++l)
      store_lane(rec + lanes.offset[l], lanes.bytes[l], 0,
                 load_lane(lanes.in[l], lanes.bytes[l], first + tid));
  }
  __syncthreads();
  for (int q = tid; q < rows * kChunks; q += kThreads)
    records[first * kChunks + q] = s_rec[q];
}

// out[l][i] = lane l of records[order[i]], 256 rows a block: the records
// come in with 16-byte loads, the R / 16 loads of one record from
// neighbouring threads of one instruction (one random request a sector),
// and each lane goes out coalesced.
template <int R>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const int* __restrict__ order, int n,
              const uint4* __restrict__ records, Lanes lanes, int nlanes) {
  constexpr int kChunks = R / 16;
  __shared__ uint4 s_rec[kThreads * kChunks];
  const int tid = threadIdx.x;
  const long long first = (long long)blockIdx.x * kThreads;
  const int rows = static_cast<int>(
      n - first < kThreads ? n - first : (long long)kThreads);
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int q = k * kThreads + tid;
    if (q < rows * kChunks) {
      const long long src = __ldg(order + first + q / kChunks);
      s_rec[q] = __ldg(records + src * kChunks + q % kChunks);
    }
  }
  __syncthreads();
  if (tid >= rows) return;
  const unsigned char* rec =
      reinterpret_cast<const unsigned char*>(s_rec) + tid * R;
  for (int l = 0; l < nlanes; ++l) {
    const unsigned char* at = rec + lanes.offset[l];
    unsigned long long v;
    switch (lanes.bytes[l]) {
      case 8: v = *reinterpret_cast<const unsigned long long*>(at); break;
      case 4: v = *reinterpret_cast<const unsigned*>(at); break;
      case 2: v = *reinterpret_cast<const unsigned short*>(at); break;
      default: v = *at;
    }
    store_lane(lanes.out[l], lanes.bytes[l], first + tid, v);
  }
}

template <int R>
int launch_packed(const int* order, int n, int m, const Lanes& lanes,
                  int nlanes, uint4* records, cudaStream_t stream) {
  pack_kernel<R><<<(m + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      m, lanes, nlanes, records);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unpack_kernel<R><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      order, n, records, lanes, nlanes);
  return static_cast<int>(cudaGetLastError());
}

int copy_lanes(Lanes* lanes, int nlanes, const void* const* in,
               void* const* out, const int* bytes) {
  if (nlanes < 1 || nlanes > kMaxLanes) return 1;
  for (int k = 0; k < nlanes; ++k) {
    if (bytes[k] != 1 && bytes[k] != 2 && bytes[k] != 4 && bytes[k] != 8)
      return 1;
    lanes->in[k] = in[k];
    lanes->out[k] = out[k];
    lanes->bytes[k] = bytes[k];
    lanes->offset[k] = 0;
  }
  return 0;
}

}  // namespace

// The single pass.  order: int32[n], each entry a row of every input
// lane; in / out / bytes: host arrays of nlanes (<= 16) lanes, out lanes
// hold n elements.
extern "C" int srt_gather_rows(const int* order, int n, int nlanes,
                               const void* const* in, void* const* out,
                               const int* bytes, cudaStream_t stream) {
  Lanes lanes;
  if (n < 0 || copy_lanes(&lanes, nlanes, in, out, bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kThreads - 1) / kThreads, nlanes);
  single_kernel<<<grid, kThreads, 0, stream>>>(order, n, lanes);
  return static_cast<int>(cudaGetLastError());
}

// The record path for one chunk of lanes: pack the m source rows into
// records, then read one record a row through the order and unpack it.
// offsets: each lane's byte offset in a record of record_bytes (16, 32
// or 64), aligned to its width, lanes apart; records: m * record_bytes
// of scratch, 16-byte aligned.
extern "C" int srt_gather_packed(const int* order, int n, int m, int nlanes,
                                 const void* const* in, void* const* out,
                                 const int* bytes, const int* offsets,
                                 int record_bytes, void* records,
                                 cudaStream_t stream) {
  Lanes lanes;
  if (n < 0 || m < 0 || copy_lanes(&lanes, nlanes, in, out, bytes) ||
      (record_bytes != 16 && record_bytes != 32 && record_bytes != 64) ||
      reinterpret_cast<size_t>(records) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned long long used = 0;
  for (int k = 0; k < nlanes; ++k) {
    const int off = offsets[k], b = bytes[k];
    if (off < 0 || off % b != 0 || off + b > record_bytes)
      return static_cast<int>(cudaErrorInvalidValue);
    const unsigned long long mine =
        (b == 8 ? ~0ull >> 56 : b == 4 ? 0xfull : b == 2 ? 3ull : 1ull) << off;
    if (used & mine) return static_cast<int>(cudaErrorInvalidValue);
    used |= mine;
    lanes.offset[k] = off;
  }
  if (n == 0 || m == 0) return static_cast<int>(cudaSuccess);
  uint4* r = static_cast<uint4*>(records);
  switch (record_bytes) {
    case 16: return launch_packed<16>(order, n, m, lanes, nlanes, r, stream);
    case 32: return launch_packed<32>(order, n, m, lanes, nlanes, r, stream);
    default: return launch_packed<64>(order, n, m, lanes, nlanes, r, stream);
  }
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

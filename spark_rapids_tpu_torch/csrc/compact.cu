// K1: stable compaction of a batch's row lanes by a keep flag.
//
// Replaces the reference's ops/carry.py compact_rows (one uint8-key
// carry-sort on the TPU, chosen there because its gathers were slow)
// together with mask_validity, as called from exec/filter_common.py
// compact.  Kept rows move to the front in their input order, dropped
// rows follow in theirs, and validity lanes are cleared for every row at
// or past the kept count -- the same permutation the reference's stable
// sort produces, from one count / scan / scatter partition instead.
//
// Bound: device-memory bytes.  Least traffic is the keep flags once
// plus every lane read once and written once, over 3.35 TB/s; this
// design reads the keep flags twice.

#include "partition.cuh"

namespace {

struct KeepDigit {
  const unsigned char* keep;
  __device__ int operator()(long long i) const { return keep[i] ? 0 : 1; }
};

}  // namespace

// keep: bool[n]; lanes described by host arrays in/out/bytes/clear_back;
// scratch: 4 * num_tiles(n) ints; num_kept: one device int.
extern "C" int srt_compact(const unsigned char* keep, int n, int nlanes,
                           const void* const* in, void* const* out,
                           const int* bytes, const int* clear_back,
                           int* scratch, int* num_kept, cudaStream_t stream) {
  srt::LaneWriter writer;
  if (!srt::make_lanes(nlanes, in, out, bytes, clear_back, &writer.lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0)
    return static_cast<int>(
        cudaMemsetAsync(num_kept, 0, sizeof(int), stream));
  const int tiles = srt::num_tiles(n);
  int* counts = scratch;
  int* offsets = scratch + 2 * tiles;
  cudaError_t err = srt::partition<2>(KeepDigit{keep}, writer, n, counts,
                                      offsets, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the first bucket-1 offset is the number of kept rows
  err = cudaMemcpyAsync(num_kept, offsets + tiles, sizeof(int),
                        cudaMemcpyDeviceToDevice, stream);
  return static_cast<int>(err);
}

// K4: the probe of the equi-join, with the probe side's key hash fused in.
// For every probe row, the range of equal hashes in the build side's
// combined key hashes, sorted in ascending unsigned order by K2.
//
// Replaces the reference's ops/join_kernels.py count_matches after its
// sort (the numpy branch's two searchsorted calls; the jnp branch's one
// combined sort over build and probe rows stands in for them on the TPU,
// whose gathers were slow), together with the probe side's
// combined_key_hash, whose only reader this is.
//
// Two launches:
//   1. build_kernel, once per build side: one thread per sorted build
//      row; the first row of each run of equal hashes inserts (hash, run
//      start, run length) into an open-addressing table of 16-byte slots
//      (a power of two, at least twice the build rows, so at most half
//      full), claimed by atomicCAS on the slot's run start with linear
//      probing.  The run length comes from a galloping search, so a hot
//      key with c copies costs one thread 2 log2(c) reads.  The dead rows
//      parked at 0xFFFF...FFFF are a run like any other, so a probe hash
//      equal to that word finds them, as the searchsorted version does.
//      Which slot a run lands in may change from run to run; what a
//      lookup finds does not, since every hash has one entry.
//   2. probe_kernel, per probe batch: one thread per probe row computes
//      the row's hash in registers (join_hash.cuh; it is never written to
//      memory) and looks it up: a hit gives the run start and length; a
//      miss has count 0 and its lower bound in the sorted hashes (the
//      searchsorted "left" position) from a binary search.  A dead row
//      (row >= num_rows) writes its lower bound and count 0.
//
// Bound: device-memory bytes.  Least traffic per probe row is each key's
// value and validity read and lo (4 B) and count (8 B) written; per build
// row its sorted hash (8 B) read; per table slot 16 B written; over 3.35
// TB/s.  The table of a 262,144-row build side (8 MB) stays in the 50 MB
// L2, so a hit costs one L2 read where the binary searches of the
// previous design cost about 18 dependent ones.

#include <cuda_runtime.h>

#include "join_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kFibonacci = 0x9E3779B97F4A7C15ull;

// One table entry; lo == -1 marks an empty slot.
struct __align__(16) Slot {
  unsigned long long hash;
  int lo;
  int count;
};

// The home slot of a hash: its top log2(slots) bits after a
// multiplicative hash (shift = 64 - log2(slots)).
__device__ __forceinline__ unsigned home(unsigned long long h, int shift) {
  return static_cast<unsigned>((h * kFibonacci) >> shift);
}

// First index in [lo, hi) whose hash is not below h, else hi.
__device__ __forceinline__ int lower_bound(const unsigned long long* s,
                                           int lo, int hi,
                                           unsigned long long h) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(s + mid) < h) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// First index in [lo, hi) whose hash is above h, else hi.
__device__ __forceinline__ int upper_bound(const unsigned long long* s,
                                           int lo, int hi,
                                           unsigned long long h) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(s + mid) <= h) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
build_kernel(const unsigned long long* __restrict__ sorted, int nb,
             Slot* __restrict__ table, unsigned mask, int shift) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= nb) return;
  const int lo = static_cast<int>(i);
  const unsigned long long h = sorted[lo];
  if (lo > 0 && sorted[lo - 1] == h) return;   // not the run's first row
  // gallop: double the step while sorted[lo + step] still holds h; the
  // run's end then lies in [below, top]
  int step = 1;
  int below = lo + 1;
  while (lo + step < nb && __ldg(sorted + lo + step) <= h) {
    below = lo + step + 1;
    step <<= 1;
  }
  const int top = lo + step < nb ? lo + step : nb;
  const int count = upper_bound(sorted, below, top, h) - lo;
  for (unsigned s = home(h, shift);; s = (s + 1) & mask) {
    if (atomicCAS(&table[s].lo, -1, lo) == -1) {
      table[s].hash = h;
      table[s].count = count;
      return;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const unsigned long long* __restrict__ sorted, int nb,
             const Slot* __restrict__ table, unsigned mask, int shift,
             srt::KeyCols keys, int n, int num_rows, int null_matches,
             int* __restrict__ lo_out, long long* __restrict__ counts) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned long long h =
      srt::row_hash(keys, i, null_matches != 0, srt::kNullProbe);
  int lo = -1;
  int count = 0;
  const ulonglong2* slots = reinterpret_cast<const ulonglong2*>(table);
  for (unsigned s = home(h, shift);; s = (s + 1) & mask) {
    const ulonglong2 slot = __ldg(slots + s);    // (hash, lo | count << 32)
    const int slot_lo = static_cast<int>(slot.y & 0xFFFFFFFFull);
    if (slot_lo == -1) break;                    // empty: no run of h
    if (slot.x == h) {
      lo = slot_lo;
      count = static_cast<int>(slot.y >> 32);
      break;
    }
  }
  if (lo < 0) lo = lower_bound(sorted, 0, nb, h);
  lo_out[i] = lo;
  counts[i] = i < num_rows ? count : 0;
}

int log2_of(int slots) {
  int b = 0;
  while ((1 << b) < slots) ++b;
  return b;
}

constexpr int kMaxBuildRows = 1 << 29;   // 2 nb slots stay below 2^31

bool valid_table(int nb, int slots) {
  return nb >= 0 && nb < kMaxBuildRows && slots >= 2 && slots >= 2 * nb &&
         (slots & (slots - 1)) == 0;
}

}  // namespace

// Slots of the table for nb sorted build rows: the least power of two
// that is at least 2 nb, and at least 2; -1 for more than 2^29 - 1 rows.
extern "C" int srt_join_table_slots(int nb) {
  if (nb < 0 || nb >= kMaxBuildRows) return -1;
  int slots = 2;
  while (slots < 2 * nb) slots <<= 1;
  return slots;
}

// sorted: nb hashes in ascending unsigned order; table: slots * 16 bytes
// (slots from srt_join_table_slots), filled here.
extern "C" int srt_join_build_table(const unsigned long long* sorted, int nb,
                                    void* table, int slots,
                                    cudaStream_t stream) {
  if (!valid_table(nb, slots)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaMemsetAsync(table, 0xFF, (size_t)slots * sizeof(Slot), stream);
  if (err != cudaSuccess || nb == 0) return static_cast<int>(err);
  const int blocks = (nb + kThreads - 1) / kThreads;
  build_kernel<<<blocks, kThreads, 0, stream>>>(
      sorted, nb, static_cast<Slot*>(table), slots - 1, 64 - log2_of(slots));
  return static_cast<int>(cudaGetLastError());
}

// sorted and table: as built above; desc: device array of 3 * nkeys
// int64s (srt::KeyCols), the probe side's key columns of n rows, the
// first num_rows live; lo: int[n] and counts: long long[n] out.
extern "C" int srt_join_probe(const unsigned long long* sorted, int nb,
                              const void* table, int slots,
                              const long long* desc, int nkeys, int n,
                              int num_rows, int null_matches, int* lo,
                              long long* counts, cudaStream_t stream) {
  if (!valid_table(nb, slots) || nkeys < 1 || n < 0 || num_rows < 0 ||
      num_rows > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const srt::KeyCols keys{desc, nkeys};
  const int blocks = (n + kThreads - 1) / kThreads;
  probe_kernel<<<blocks, kThreads, 0, stream>>>(
      sorted, nb, static_cast<const Slot*>(table), slots - 1,
      64 - log2_of(slots), keys, n, num_rows, null_matches, lo, counts);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kThreads; }

// K2: stable lexicographic sort of rows by int64 key words, returning the
// int32 row order.  An LSD one-sweep radix sort with 8-bit digits, after
// Adinets & Merrill, "Onesweep: A Faster Least Significant Digit Radix
// Sort for GPUs" (arXiv 2206.01784).
//
// Replaces the reference's ops/carry.py sort_rows / _sort_rows_lean and
// ops/segmented.py lexsort (lax.sort with num_keys and is_stable on the
// TPU).  Words hold int64 values in signed order; each digit is taken from
// the word with its sign bit flipped, so the order is the reference's
// unsigned order of its uint64 words.  The least significant word goes
// first, as _sort_rows_lean orders its passes.
//
// Two kernels:
//   1. histogram_kernel, one launch for all words (up to 16): each block
//      counts the 8 digits of its rows of every word in shared memory
//      (the digits that are the same in all 32 rows of a warp step are
//      counted by one lane, which holds their count back while they
//      repeat) and adds each non-zero count to the global histogram with
//      one atomic; the last block turns each digit's 256 counts into
//      bucket starts (exclusive scan) and flags the digit as varying
//      unless one bucket holds all n rows.  The host reads the flags (the
//      sort's one host sync) and runs one pass per varying digit: a key
//      of 100,000 values takes three.
//   2. onesweep_kernel, one launch per pass.  Each block takes the next
//      tile number from an atomic counter (so tiles start in order and the
//      look-back below always makes progress), loads its tile of keys and
//      order, ranks each row inside the tile by its digit, and publishes
//      its 256 bucket counts.  It finds where its rows of each bucket start
//      by decoupled look-back over the earlier tiles' published counts and
//      the bucket starts of step 1, then writes the tile back through
//      shared memory in digit order, so consecutive threads store
//      consecutive addresses of one bucket's run.
//
// Rows inside a warp are ranked by ballots, in row order (item by item,
// lane by lane), into a warp-private histogram; warps add up in warp
// order and tiles in tile order, so every pass is stable.
//
// The first pass takes each row's order from its row index; the first
// pass of every later word reads that word through the current order
// (a gather inside the load); the last pass of a word writes no key.
//
// Tile: 256 threads x 24 rows = 6,144 rows.  24 rows a thread keep 24
// 8-byte loads in flight per thread and their ranks in registers (ptxas:
// 127 registers, no spills, under 2 blocks of 256 threads an SM); the
// tile's keys and order staged in shared memory take 72 KB, plus 10 KB
// of counters, so two tiles fit on an SM's 227 KB, and q1's 25M rows
// make 4,096 tiles, 31 per SM on 132 SMs.  Each bucket's run in the
// write-back is then 24 rows long for 256 buckets of uniform digits.
// Tiles of 2,048 to 6,144 rows were tried on the card; the larger ones
// were the faster, and more rows a thread would spill.
//
// Bound: device-memory bytes.  Least traffic for the function is each key
// word read once and the order written once, over 3.35 TB/s.  This design
// moves per row: 8 B per word in the histogram, and per pass the key and
// order in (the first pass reads no order) and the order and key out (the
// last pass of a word writes no key), plus 2 KB of look-back state per
// tile and pass.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 24;
constexpr int kTile = kThreads * kItems;  // rows per tile
constexpr int kWarpRows = 32 * kItems;    // rows per warp, consecutive
constexpr int kBuckets = 256;
constexpr int kDigits = 8;                // 8-bit digits of a 64-bit word
constexpr int kMaxWords = 16;             // words per histogram launch
constexpr int kHistItems = 4;             // rows per thread per round
constexpr int kHistBlocks = 1056;         // 8 blocks an SM on 132 SMs
static_assert(kThreads == kBuckets, "a pass gives each thread one bucket");
constexpr size_t kPassSmem =
    sizeof(long long) * kTile + sizeof(int) * kTile +
    sizeof(unsigned) * (kWarps * kBuckets + 2 * kBuckets);

__device__ __forceinline__ unsigned long long flipped(long long key) {
  return static_cast<unsigned long long>(key) ^ 0x8000000000000000ull;
}

__device__ __forceinline__ unsigned digit_of(long long key, int shift) {
  return static_cast<unsigned>(flipped(key) >> shift) & 255u;
}

// The lanes of `active` whose digit equals this lane's, by eight ballots.
__device__ __forceinline__ unsigned peers_of(unsigned d, unsigned active) {
  unsigned peers = active;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned bit = (d >> b) & 1u;
    const unsigned vote = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? vote : ~vote;
  }
  return peers;
}

__device__ __forceinline__ unsigned warp_inclusive_scan(unsigned v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// Adds `count` rows to the bucket of every digit in `mask` (0xff bytes)
// whose value is that byte of `value`.
__device__ __forceinline__ void add_held(unsigned (*s_hist)[kBuckets],
                                         unsigned long long mask,
                                         unsigned long long value,
                                         unsigned count) {
  if (count == 0) return;
#pragma unroll
  for (int dg = 0; dg < kDigits; ++dg) {
    if ((mask >> (8 * dg)) & 1u)
      atomicAdd(&s_hist[dg][static_cast<unsigned>(value >> (8 * dg)) & 255u],
                count);
  }
}

struct WordList {
  const long long* w[kMaxWords];
};

// Every block counts its rows of every word, one word after the other,
// so the blocks share the work evenly whatever each word costs.  hist:
// per word 8 x 256 counts, zero on entry, bucket starts on exit; done: a
// zeroed counter; varying: per word 8 flags.
__global__ void __launch_bounds__(kThreads)
histogram_kernel(WordList words, int count, int n, unsigned* hist,
                 unsigned* done, int* varying) {
  __shared__ unsigned s_hist[kDigits][kBuckets];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long stride = (long long)gridDim.x * kThreads * kHistItems;
  for (int j = 0; j < count; ++j) {
    const long long* w = words.w[j];
    for (int i = tid; i < kDigits * kBuckets; i += kThreads)
      (&s_hist[0][0])[i] = 0;
    __syncthreads();
    // lane 0 of each warp holds back the count of rows whose uniform
    // digits (those equal in all rows of a warp step: the constant
    // digits) repeat from step to step, and adds it when they change
    unsigned long long held_mask = 0, held_value = 0;
    unsigned held_count = 0;
    for (long long base = (long long)blockIdx.x * kThreads * kHistItems;
         base < n; base += stride) {
      long long key[kHistItems];
#pragma unroll
      for (int k = 0; k < kHistItems; ++k) {
        const long long i = base + (long long)k * kThreads + tid;
        key[k] = i < n ? w[i] : 0;
      }
#pragma unroll
      for (int k = 0; k < kHistItems; ++k) {
        const bool ok = base + (long long)k * kThreads + tid < n;
        const unsigned active = __ballot_sync(0xffffffffu, ok);
        if (active == 0) continue;  // the same for the whole warp
        // active lanes are a prefix of the warp, so lane 0 is one
        const unsigned long long u0 =
            __shfl_sync(0xffffffffu, flipped(key[k]), 0);
        const unsigned long long u = ok ? flipped(key[k]) : u0;
        const unsigned long long diff = u ^ u0;
        const unsigned long long differ =
            (static_cast<unsigned long long>(__reduce_or_sync(
                 0xffffffffu, static_cast<unsigned>(diff >> 32))) << 32) |
            __reduce_or_sync(0xffffffffu, static_cast<unsigned>(diff));
        // 0xff in each byte (digit) where no row differs from lane 0's
        unsigned long long t = differ | (differ >> 4);
        t |= t >> 2;
        t |= t >> 1;
        const unsigned long long same =
            ~((t & 0x0101010101010101ull) * 0xffull);
        if (lane == 0) {
          if (same != held_mask || (u0 & same) != held_value) {
            add_held(s_hist, held_mask, held_value, held_count);
            held_mask = same;
            held_value = u0 & same;
            held_count = 0;
          }
          held_count += __popc(active);
        }
#pragma unroll
        for (int dg = 0; dg < kDigits; ++dg) {
          if (!((same >> (8 * dg)) & 1u) && ok)
            atomicAdd(
                &s_hist[dg][static_cast<unsigned>(u >> (8 * dg)) & 255u], 1u);
        }
      }
    }
    if (lane == 0) add_held(s_hist, held_mask, held_value, held_count);
    __syncthreads();
    unsigned* word_hist = hist + (size_t)j * kDigits * kBuckets;
    for (int i = tid; i < kDigits * kBuckets; i += kThreads) {
      const unsigned c = (&s_hist[0][0])[i];
      if (c) atomicAdd(&word_hist[i], c);
    }
    __syncthreads();
  }
  __threadfence();
  if (tid == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the last block: a warp scans one digit's 256 counts, 8 per lane
  for (int p = tid >> 5; p < count * kDigits; p += kWarps) {
    unsigned* counts = hist + (size_t)p * kBuckets + lane * 8;
    unsigned c[8];
    unsigned sum = 0;
    bool full = false;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      c[k] = __ldcg(counts + k);
      sum += c[k];
      full |= c[k] == static_cast<unsigned>(n);
    }
    unsigned run = warp_inclusive_scan(sum) - sum;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      counts[k] = run;
      run += c[k];
    }
    const bool constant = __any_sync(0xffffffffu, full);
    if (lane == 0) varying[p] = constant ? 0 : 1;
  }
}

// Look-back state of one (tile, bucket): the high word is 2 * tag for a
// tile's own count, 2 * tag + 1 for its inclusive prefix; lower tags are
// earlier passes (or zero) and mean "not ready".
__device__ __forceinline__ unsigned long long status_word(unsigned hi,
                                                          unsigned value) {
  return (static_cast<unsigned long long>(hi) << 32) | value;
}

// One stable pass on the 8-bit digit at `shift`.  Row i's key is
// key_in[ord_in[i]] when `through` is set, else key_in[i]; its order is
// ord_in[i], or i when ord_in is null.  Writes (key, order) in digit
// order; key_out may be null.  starts: this digit's 256 bucket starts;
// status: 256 words per tile, not written by this pass before;
// tile_counter: zero on entry.
__global__ void __launch_bounds__(kThreads, 2)
onesweep_kernel(const long long* key_in, const int* ord_in, int through,
                long long* key_out, int* ord_out, int n, int shift,
                const unsigned* starts, unsigned long long* status,
                int* tile_counter, unsigned tag) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_key = reinterpret_cast<long long*>(smem);
  int* s_ord = reinterpret_cast<int*>(s_key + kTile);
  unsigned* s_warp = reinterpret_cast<unsigned*>(s_ord + kTile);
  unsigned* s_start = s_warp + kWarps * kBuckets;  // bucket start in tile
  int* s_dst = reinterpret_cast<int*>(s_start + kBuckets);
  __shared__ int s_tile;
  __shared__ unsigned s_warp_sum[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(tile_counter, 1);
  for (int i = tid; i < kWarps * kBuckets; i += kThreads) s_warp[i] = 0;
  __syncthreads();
  const int tile = s_tile;
  const long long first = (long long)tile * kTile;
  const int rows = static_cast<int>(
      n - first < kTile ? n - first : (long long)kTile);

  // load: warp w holds rows [w * 512, (w + 1) * 512) of the tile, item k
  // of lane l being row w * 512 + k * 32 + l, so each item is one
  // coalesced read per warp and (warp, item, lane) is the row order
  const int row0 = warp * kWarpRows + lane;
  long long key[kItems];
  int ord[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = row0 + k * 32;
    if (r < rows) {
      const int g = static_cast<int>(first + r);
      ord[k] = ord_in != nullptr ? ord_in[g] : g;
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = row0 + k * 32;
    if (r < rows) key[k] = key_in[through ? ord[k] : (int)(first + r)];
  }

  // rank inside the warp, in row order
  unsigned* my_warp = s_warp + warp * kBuckets;
  const unsigned lower = (1u << lane) - 1u;
  int rank[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const bool ok = row0 + k * 32 < rows;
    const unsigned active = __ballot_sync(0xffffffffu, ok);
    rank[k] = 0;
    if (active == 0) continue;  // the same for the whole warp
    const unsigned d = ok ? digit_of(key[k], shift) : 0u;
    const unsigned peers = peers_of(d, active);
    const unsigned before = ok ? my_warp[d] : 0u;
    __syncwarp();
    if (ok && lane == 31 - __clz(peers)) my_warp[d] = before + __popc(peers);
    __syncwarp();
    rank[k] = static_cast<int>(before + __popc(peers & lower));
  }
  __syncthreads();

  // thread b owns bucket b: warp offsets, the tile's count, publication
  const int b = tid;
  unsigned total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = s_warp[w * kBuckets + b];
    s_warp[w * kBuckets + b] = total;
    total += c;
  }
  volatile unsigned long long* st =
      status + (size_t)tile * kBuckets + b;
  *st = status_word(2 * tag + (tile == 0 ? 1 : 0), total);

  // the tile's bucket starts: exclusive scan of the counts over buckets
  const unsigned incl = warp_inclusive_scan(total);
  if (lane == 31) s_warp_sum[warp] = incl;
  __syncthreads();
  unsigned warp_base = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) warp_base += w < warp ? s_warp_sum[w] : 0u;
  const unsigned tile_start = warp_base + incl - total;
  s_start[b] = tile_start;

  // decoupled look-back: add earlier tiles' counts until one that
  // published its inclusive prefix
  unsigned before = 0;
  if (tile > 0) {
    for (int t = tile - 1; t >= 0; --t) {
      volatile const unsigned long long* p =
          status + (size_t)t * kBuckets + b;
      unsigned long long s;
      do {
        s = *p;
      } while (static_cast<unsigned>(s >> 32) < 2 * tag);
      before += static_cast<unsigned>(s);
      if (static_cast<unsigned>(s >> 32) == 2 * tag + 1) break;
    }
    *st = status_word(2 * tag + 1, before + total);
  }
  s_dst[b] = static_cast<int>(starts[b] + before) -
             static_cast<int>(tile_start);
  __syncthreads();

  // stage the tile in digit order
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (row0 + k * 32 < rows) {
      const unsigned d = digit_of(key[k], shift);
      const int pos = static_cast<int>(s_start[d] + my_warp[d]) + rank[k];
      s_key[pos] = key[k];
      s_ord[pos] = ord[k];
    }
  }
  __syncthreads();

  // write back: sorted position i of the tile goes to s_dst[digit] + i
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = tid + k * kThreads;
    if (i < rows) {
      const long long v = s_key[i];
      const int dst = s_dst[digit_of(v, shift)] + i;
      ord_out[dst] = s_ord[i];
      if (key_out != nullptr) key_out[dst] = v;
    }
  }
}

}  // namespace

// Histogram of every 8-bit digit of `count` (<= 16) words of n rows.
// hist: count x 8 x 256 zeroed ints, returned as bucket starts; done: one
// zeroed int; varying: count x 8 ints, 1 where a digit varies.
extern "C" int srt_sort_histogram(const void* const* words, int count,
                                  int n, unsigned* hist, unsigned* done,
                                  int* varying, cudaStream_t stream) {
  if (count < 1 || count > kMaxWords || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  WordList list;
  for (int j = 0; j < count; ++j)
    list.w[j] = static_cast<const long long*>(words[j]);
  const int rounds = (n + kThreads * kHistItems - 1) / (kThreads * kHistItems);
  const int blocks = rounds < kHistBlocks ? rounds : kHistBlocks;
  histogram_kernel<<<blocks, kThreads, 0, stream>>>(list, count, n, hist,
                                                    done, varying);
  return static_cast<int>(cudaGetLastError());
}

// One pass (see onesweep_kernel); `tag` numbers the passes of one sort
// from 1, and status (256 words per tile) and tile_counter are zeroed
// once before the first.
extern "C" int srt_sort_pass(const long long* key_in, const int* ord_in,
                             int through, long long* key_out, int* ord_out,
                             int n, int shift, const unsigned* starts,
                             unsigned long long* status, int* tile_counter,
                             int tag, cudaStream_t stream) {
  if (n < 1 || shift < 0 || shift > 56 || shift % 8 != 0 || tag < 1 ||
      (through && ord_in == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        onesweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kPassSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int tiles = (n + kTile - 1) / kTile;
  onesweep_kernel<<<tiles, kThreads, kPassSmem, stream>>>(
      key_in, ord_in, through, key_out, ord_out, n, shift, starts, status,
      tile_counter, static_cast<unsigned>(tag));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int srt_tile_rows() { return kTile; }

// Row tiles of a span column, shared by K19 (csrc/string_find.cu) and K21
// (csrc/string_map.cu).
//
// The rows' starts and the buffer's bytes form one merged sequence of
// cap + n items, a row's start before byte p when offsets[row] <= p
// (csrc/merge_path.cuh); tile t is its items [t * kTile, (t + 1) * kTile):
// the rows [r0, r1) that start there and the bytes [B0, B1), B0 =
// t * kTile - r0 (tile_bytes).  So no tile holds more than kTile rows or
// kTile bytes whatever the rows hold: a run of a million empty rows (the
// padding past a filter's live rows) spreads over many tiles.  A row
// starts at or after B0 and at or before B1; a row of at most kTile
// bytes ends by B1 + kTile, so a tile's short rows fit a stage of
// 2 * kTile bytes (+ 16 for alignment).  A longer row is always its
// tile's last row (its bytes alone pass the tile's end) and is left out
// of the tile's bytes: its kernel searches or maps it from device memory,
// a warp over the row.  Every row lies in exactly one tile.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_path.cuh"

namespace srt {

// One tile: its rows [r0, r1) and their bytes [b0, bend), bend the start
// of the last row where that row is longer than kTile (and so left out).
struct __align__(16) RowTile {
  int r0, r1, b0, bend;
};

// A thread a tile: two merge-path searches of dependent reads, every
// tile's at once, so no block waits on one in its prologue.
template <int kTile>
__global__ void row_tiles_kernel(const int* __restrict__ offsets, int cap,
                                 long long n, long long ntiles,
                                 RowTile* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntiles) return;
  const auto start = [offsets](long long i) {
    return static_cast<long long>(__ldg(offsets + i));
  };
  const long long total = cap + n;
  const long long d1 = (t + 1) * kTile < total ? (t + 1) * kTile : total;
  const int r0 = static_cast<int>(merge_path_rows(start, cap, n, t * kTile));
  const int r1 = static_cast<int>(merge_path_rows(start, cap, n, d1));
  RowTile rt;
  rt.r0 = r0;
  rt.r1 = r1;
  rt.b0 = __ldg(offsets + r0);
  rt.bend = __ldg(offsets + r1);
  if (r1 > r0 && rt.bend - __ldg(offsets + r1 - 1) > kTile)
    rt.bend = __ldg(offsets + r1 - 1);
  out[t] = rt;
}

// Tile t's bytes [B0, B1) of a buffer of n bytes.
template <int kTile>
__device__ __forceinline__ void tile_bytes(long long t, const RowTile& rt,
                                           long long n, long long* b0,
                                           long long* b1) {
  *b0 = t * kTile - rt.r0;
  const long long e = (t + 1) * kTile - rt.r1;
  *b1 = e < n ? e : n;
}

template <int kTile>
__host__ inline long long row_tile_count(int cap, long long n) {
  const long long items = static_cast<long long>(cap) + n;
  return items > 0 ? (items + kTile - 1) / kTile : 1;
}

template <int kTile>
__host__ inline cudaError_t launch_row_tiles(const int* offsets, int cap,
                                             long long n, RowTile* out,
                                             cudaStream_t stream) {
  const long long ntiles = row_tile_count<kTile>(cap, n);
  const int threads = 256;
  const long long blocks = (ntiles + threads - 1) / threads;
  row_tiles_kernel<kTile><<<static_cast<unsigned>(blocks), threads, 0,
                            stream>>>(offsets, cap, n, ntiles, out);
  return cudaGetLastError();
}

// The 16 bytes of the aligned block at chars + i0 (chars + i0 16-byte
// aligned), only those in [0, total) read and the rest zero: a vector
// load where the whole block lies inside, byte loads at either end of
// the buffer, nothing outside it.
__device__ __forceinline__ uint4 load_block(const unsigned char* chars,
                                            long long i0, long long total) {
  if (i0 >= 0 && i0 + 16 <= total)
    return __ldg(reinterpret_cast<const uint4*>(chars + i0));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const long long q = i0 + j;
    if (q >= 0 && q < total)
      w[j >> 2] |= static_cast<unsigned>(__ldg(chars + q)) << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The position i0 <= pos with chars + i0 16-byte aligned.
__host__ __device__ __forceinline__ long long align_down(
    const unsigned char* chars, long long pos) {
  return pos - static_cast<long long>(
                   (reinterpret_cast<uintptr_t>(chars) + pos) & 15);
}

// ---- a tile staged by the bulk asynchronous copy, on an mbarrier (PTX) ----

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread starts the copy of tile rt's bytes [b0, bend) into stage st
// (byte q at st[q - align_down(chars, b0)]): the 16-byte aligned window
// around them, clipped to the buffer's aligned inside, in one bulk copy;
// the few bytes no aligned window reaches (at the buffer's two ends only)
// by plain loads, visible after the block's next barrier.  Nothing past
// offsets[cap] (total) is read.  Every stage arrives on its barrier once,
// with the window's bytes as the transaction count.
__device__ __forceinline__ void stage_tile(
    const RowTile& rt, const unsigned char* __restrict__ chars,
    long long total, unsigned char* st, uint64_t* bar) {
  unsigned bytes = 0;
  long long abase = 0, wlo = 0;
  if (rt.bend > rt.b0) {
    abase = align_down(chars, rt.b0);
    const long long first = align_down(chars, 15);  // first aligned >= 0
    const long long up = align_down(chars, rt.bend + 15ll);
    const long long last = align_down(chars, total);
    wlo = abase > first ? abase : first;
    const long long whi = up < last ? up : last;
    if (whi > wlo) {
      bytes = static_cast<unsigned>(whi - wlo);
      for (long long q = rt.b0; q < wlo && q < rt.bend; ++q)
        st[q - abase] = chars[q];
      for (long long q = whi > rt.b0 ? whi : rt.b0; q < rt.bend; ++q)
        st[q - abase] = chars[q];
    } else {
      for (long long q = rt.b0; q < rt.bend; ++q) st[q - abase] = chars[q];
    }
  }
  fence_async_shared();
  mbar_expect(bar, bytes);
  if (bytes) bulk_load(st + (wlo - abase), chars + wlo, bytes, bar);
}

}  // namespace srt

// The merge-path search (the load-balanced search of Baxter's moderngpu)
// shared by K5 (csrc/join_expand.cu) and K18 (csrc/span_rows.cu).
//
// n rows, row i ending at end(i) (nondecreasing, each row's positions
// before its end), and the positions 0, 1, ..., cap - 1 form one merged
// sequence of n + cap items, a row's end before position p when
// end(i) <= p.  Cut into tiles of equal items, every tile has the same
// work whatever the rows hold: a row of many positions spreads over many
// tiles, and a run of rows with no position costs one item a row.

#pragma once

namespace srt {

// The rows before diagonal d (0 <= d <= n + cap) of that merge: the first
// i in [max(0, d - cap), min(d, n)) with end(i) > d - 1 - i, else the
// upper end; d - i positions lie before the diagonal.  One binary search
// of dependent reads of end: run it for many diagonals at once (one
// thread each), never as a block's serial prologue.
template <class End>
__device__ __forceinline__ long long merge_path_rows(End end, long long n,
                                                     long long cap,
                                                     long long d) {
  long long lo = d - cap > 0 ? d - cap : 0;
  long long hi = d < n ? d : n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (end(mid) > d - 1 - mid) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

}  // namespace srt

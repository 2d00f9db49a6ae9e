"""Row permutations: stable compaction (kernel K1) and the stable
multi-word sort (kernel K2).

Counterpart of spark_rapids_tpu/ops/carry.py.  The reference moves rows
by carrying every lane through ``lax.sort``, because the TPU's gathers
were slow; on the card a compaction is a count / scan / scatter, a sort
is an LSD radix sort that returns the row order, and payload lanes are
gathered by that order.

Each kernel's wrapper takes its plain PyTorch version for CPU tensors
only; for CUDA tensors it launches the kernel (``csrc/``) or raises, and
counts the call in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .. import kernels
from ..columnar.device import DeviceColumn
from .gather import gather_column


# ---------------------------------------------------------------------------
# K1: stable compaction
# ---------------------------------------------------------------------------

def compact_lanes_plain(keep: torch.Tensor, lanes: Sequence[torch.Tensor],
                        clear_back: Sequence[bool]
                        ) -> Tuple[List[torch.Tensor], int]:
    """Plain version of K1: kept rows first, then dropped rows, each in
    input order; lanes flagged in ``clear_back`` are zero from the kept
    count on.  Returns (lanes, kept count)."""
    kept = torch.nonzero(keep).flatten()
    order = torch.cat([kept, torch.nonzero(~keep).flatten()])
    n_kept = int(kept.shape[0])
    outs = []
    for lane, clear in zip(lanes, clear_back):
        out = lane[order]
        if clear:
            out[n_kept:] = 0
        outs.append(out)
    return outs, n_kept


def compact_lanes(keep: torch.Tensor, lanes: Sequence[torch.Tensor],
                  clear_back: Sequence[bool]
                  ) -> Tuple[List[torch.Tensor], int]:
    """Stable partition of row lanes by ``keep`` (K1); see
    ``compact_lanes_plain`` for the result."""
    if keep.device.type == "cpu":
        return compact_lanes_plain(keep, lanes, clear_back)
    kernels.require_cuda("compact_rows", keep, *lanes)
    n = int(keep.shape[0])
    if keep.dtype != torch.bool:
        raise TypeError("compact_rows: keep must be bool")
    for lane in lanes:
        if lane.shape != (n,) or lane.element_size() not in (1, 4, 8):
            raise TypeError(f"compact_rows: lane {lane.dtype}{tuple(lane.shape)}"
                            f" does not match keep[{n}]")
    lib = kernels.library("compact")
    scratch = torch.empty(max(4 * kernels.num_tiles(lib, n), 1),
                          dtype=torch.int32, device=keep.device)
    num_kept = torch.empty(1, dtype=torch.int32, device=keep.device)
    outs = [torch.empty_like(lane) for lane in lanes]
    step = 16                                   # kMaxLanes in csrc
    for s in range(0, max(len(lanes), 1), step):
        chunk, out_chunk = lanes[s:s + step], outs[s:s + step]
        kernels.check(lib, lib.srt_compact(
            keep.data_ptr(), n, len(chunk), kernels.pointers(chunk),
            kernels.pointers(out_chunk),
            kernels.ints(x.element_size() for x in chunk),
            kernels.ints(int(c) for c in clear_back[s:s + step]),
            scratch.data_ptr(), num_kept.data_ptr(), kernels.stream(keep)),
            "compact_rows")
        compact_lanes.launches += 1
    return outs, int(num_kept.item())


compact_lanes.launches = 0


def compact_rows(keep: torch.Tensor, cols: Sequence[DeviceColumn]
                 ) -> Tuple[List[DeviceColumn], int]:
    """Kept rows move to the front in their input order and the rest
    become padding: validity is cleared from the kept count on (the
    reference's compact_rows followed by mask_validity).  Returns
    (columns, kept count)."""
    lanes, clear = [], []
    for c in cols:
        lanes += [c.data, c.validity]
        clear += [False, True]
    outs, n_kept = compact_lanes(keep, lanes, clear)
    out_cols = [DeviceColumn(c.dtype, outs[2 * i], outs[2 * i + 1])
                for i, c in enumerate(cols)]
    return out_cols, n_kept


# ---------------------------------------------------------------------------
# K2: stable lexicographic sort
# ---------------------------------------------------------------------------

def sort_order_plain(key_words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of K2: one stable sort per word, least significant
    first (the reference's _sort_rows_lean)."""
    n = int(key_words[0].shape[0])
    order = torch.arange(n, dtype=torch.int64, device=key_words[0].device)
    for w in reversed(list(key_words)):
        _, idx = torch.sort(w[order], stable=True)
        order = order[idx]
    return order.to(torch.int32)


def _radix_passes(varying: Sequence[int]) -> List[Tuple[int, int]]:
    """(word, shift) of every 4-bit digit that varies, least significant
    word and digit first."""
    return [(j, shift) for j in reversed(range(len(varying)))
            for shift in range(0, 64, 4) if (varying[j] >> shift) & 15]


def sort_order(key_words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable ascending lexicographic order of rows by int64 key words,
    most significant first (K2).  Returns int32[n]."""
    if not key_words:
        raise ValueError("sort_order needs at least one key word")
    words = list(key_words)
    n = int(words[0].shape[0])
    for w in words:
        if w.dtype != torch.int64 or w.shape != (n,):
            raise TypeError(f"sort_order: key words must be int64[{n}], got "
                            f"{w.dtype}{tuple(w.shape)}")
    if words[0].device.type == "cpu":
        return sort_order_plain(words)
    kernels.require_cuda("sort_order", *words)
    dev = words[0].device
    lib = kernels.library("radix_sort")
    st = kernels.stream(words[0])
    varying_dev = torch.zeros(len(words), dtype=torch.int64, device=dev)
    for j, w in enumerate(words):
        kernels.check(lib, lib.srt_diff_bits(
            w.data_ptr(), n, varying_dev.data_ptr() + 8 * j, st), "sort_order")
    passes = _radix_passes(varying_dev.cpu().tolist())
    sort_order.launches += 1
    order = torch.arange(n, dtype=torch.int32, device=dev)
    if not passes:
        return order
    spare = torch.empty_like(order)
    keys = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(2)]
    scratch = torch.empty(32 * kernels.num_tiles(lib, n), dtype=torch.int32,
                          device=dev)
    key_in = None
    for p, (j, shift) in enumerate(passes):
        if p == 0 or passes[p - 1][0] != j:
            # first digit of a word: the word in the current row order
            key_in = words[j] if p == 0 else words[j].index_select(0, order)
        last_of_word = p + 1 == len(passes) or passes[p + 1][0] != j
        key_out = None if last_of_word else keys[p % 2]
        kernels.check(lib, lib.srt_radix_pass(
            key_in.data_ptr(), order.data_ptr(),
            None if key_out is None else key_out.data_ptr(),
            spare.data_ptr(), n, shift, scratch.data_ptr(), st), "sort_order")
        order, spare = spare, order
        key_in = key_out
    return order


sort_order.launches = 0


def sort_rows(key_words: Sequence[torch.Tensor],
              cols: Sequence[DeviceColumn],
              extras: Sequence[torch.Tensor] = ()):
    """Stable sort of rows by ``key_words``; the rows of ``cols`` and the
    lanes in ``extras`` follow the order.  Returns (order, cols, extras)."""
    order = sort_order(key_words)
    out_cols = [gather_column(c, order) for c in cols]
    out_extras = [e.index_select(0, order) for e in extras]
    return order, out_cols, out_extras

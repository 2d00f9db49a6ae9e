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
from .. import types as t
from ..columnar.device import DeviceColumn, columns_from_lanes, flat_lanes
from .gather import gather_columns, gather_rows


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
    kernels.require_row_lanes("compact_rows", lanes)
    if keep.device.type == "cpu":
        return compact_lanes_plain(keep, lanes, clear_back)
    kernels.require_cuda("compact_rows", keep, *lanes)
    n = int(keep.shape[0])
    if keep.dtype != torch.bool:
        raise TypeError("compact_rows: keep must be bool")
    for lane in lanes:
        if lane.shape != (n,) or lane.element_size() not in (1, 2, 4, 8):
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
    (columns, kept count).  The flat lanes move through K1; a string,
    binary or nested column follows the kept rows' input positions,
    which K1 carries as one more lane, through ``gather_columns`` (K16,
    K18 and K8; the reference's carry falls back to gather_column for
    columns it cannot carry)."""
    flat = [c for c in cols if c.is_flat]
    lanes = flat_lanes(flat)
    clear = [x is c.validity for c in flat for x in
             [c.data, c.validity] + ([] if c.data_hi is None
                                     else [c.data_hi])]
    spans = [c for c in cols if not c.is_flat]
    if spans:
        lanes.append(torch.arange(keep.shape[0], dtype=torch.int32,
                                  device=keep.device))
        clear.append(False)
    outs, n_kept = compact_lanes(keep, lanes, clear)
    moved = iter(columns_from_lanes(flat, outs))
    if spans:
        live = torch.arange(keep.shape[0], device=keep.device) < n_kept
        gathered = iter(gather_columns(spans, outs[-1], live))
    return [next(moved) if c.is_flat else next(gathered)
            for c in cols], n_kept


def mask_validity(col: DeviceColumn, mask: torch.Tensor) -> DeviceColumn:
    """AND ``mask`` into a column's validity; the data under the new
    nulls becomes zero, as everywhere in the port (a new null string,
    binary, array or map becomes empty, through K16 and K18).  A
    STRUCT takes the mask into its own validity and, as the reference's
    ``mask_validity`` does, into every row-aligned child."""
    if isinstance(col.dtype, t.StructType):
        return DeviceColumn(col.dtype, None, col.validity & mask, None, None,
                            [mask_validity(k, mask) for k in col.children])
    if not col.is_flat:
        return gather_columns([col], torch.arange(
            col.capacity, dtype=torch.int32, device=mask.device), mask)[0]
    validity = col.validity & mask
    return DeviceColumn(col.dtype, torch.where(
        validity, col.data, torch.zeros_like(col.data)), validity, None,
        None if col.data_hi is None else torch.where(
            validity, col.data_hi, torch.zeros_like(col.data_hi)))


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


_SIGN = -2**63           # int64 with only the sign bit set
_DIGITS = 8              # 8-bit digits of a 64-bit word
_MAX_WORDS = 16          # words per histogram launch (kMaxWords in csrc)


def digit_histogram_plain(key_words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version of K2's histogram step: ``counts[j, d, b]`` is the
    number of rows of word j whose digit d (bits 8d to 8d+7 of the word
    with its sign bit flipped) is b.  int64[words, 8, 256]."""
    rows = []
    for w in key_words:
        u = w ^ _SIGN
        rows.append(torch.stack([
            torch.bincount((u >> (8 * d)) & 255, minlength=256)
            for d in range(_DIGITS)]))
    return torch.stack(rows)


def varying_digits(counts: torch.Tensor, n: int) -> List[List[bool]]:
    """Per word and digit, whether the digit varies: no bucket of its
    histogram holds all n rows."""
    return (counts.amax(-1) < n).tolist()


def plan_passes(varying: Sequence[Sequence[bool]]) -> List[Tuple[int, int]]:
    """(word, shift) of every 8-bit digit that varies, least significant
    word and digit first."""
    return [(j, 8 * d) for j in reversed(range(len(varying)))
            for d in range(_DIGITS) if varying[j][d]]


def sort_order(key_words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable ascending lexicographic order of rows by int64 key words,
    most significant first (K2).  Returns int32[n]."""
    return sort_order_and_varying(key_words)[0]


def sort_order_and_varying(key_words: Sequence[torch.Tensor]):
    """``sort_order``'s order and which words vary: K2's histogram already
    says which words hold more than one value (None where it did not
    run: on the CPU or over no rows), so K3 can skip its own pass over
    the words."""
    if not key_words:
        raise ValueError("sort_order needs at least one key word")
    words = list(key_words)
    n = int(words[0].shape[0])
    for w in words:
        if w.dtype != torch.int64 or w.shape != (n,):
            raise TypeError(f"sort_order: key words must be int64[{n}], got "
                            f"{w.dtype}{tuple(w.shape)}")
    if words[0].device.type == "cpu":
        return sort_order_plain(words), None
    kernels.require_cuda("sort_order", *words)
    dev = words[0].device
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=dev), None
    lib = kernels.library("onesweep")
    st = kernels.stream(words[0])
    nw = len(words)
    # per word: 8 x 256 counts (bucket starts after the launch) and 8
    # varying flags; a done counter per launch of up to 16 words
    table = torch.zeros(nw * (_DIGITS * 256 + _DIGITS + 1),
                        dtype=torch.int32, device=dev)
    hist = table[:nw * _DIGITS * 256]
    flags = table[hist.numel():hist.numel() + nw * _DIGITS]
    done = table[hist.numel() + flags.numel():]
    for c in range(0, nw, _MAX_WORDS):
        chunk = words[c:c + _MAX_WORDS]
        kernels.check(lib, lib.srt_sort_histogram(
            kernels.pointers(chunk), len(chunk), n,
            hist.data_ptr() + 4 * _DIGITS * 256 * c, done.data_ptr() + 4 * c,
            flags.data_ptr() + 4 * _DIGITS * c, st), "sort_order")
    sort_order.launches += 1
    digits = flags.view(nw, _DIGITS).cpu().tolist()
    varies = [any(d) for d in digits]
    passes = plan_passes(digits)
    sort_order.passes += len(passes)
    if not passes:
        return torch.arange(n, dtype=torch.int32, device=dev), varies
    # look-back state: 256 words per tile, one tile counter per pass
    tiles = kernels.num_tiles(lib, n)
    status = torch.zeros(tiles * 256 + len(passes), dtype=torch.int64,
                         device=dev)
    counters = status.data_ptr() + 8 * tiles * 256
    ords = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)]
    carried = len(passes) > len({j for j, _ in passes})
    keys = [torch.empty(n, dtype=torch.int64, device=dev)
            for _ in range(2 if carried else 0)]
    order = key = None
    for p, (j, shift) in enumerate(passes):
        first_of_word = p == 0 or passes[p - 1][0] != j
        last_of_word = p + 1 == len(passes) or passes[p + 1][0] != j
        key_out = None if last_of_word else keys[p % 2]
        # a word's first pass reads the word itself, through the order
        # after the first word; later passes read the carried keys
        key_in = words[j] if first_of_word else key
        through = int(first_of_word and order is not None)
        kernels.check(lib, lib.srt_sort_pass(
            key_in.data_ptr(), None if order is None else order.data_ptr(),
            through, None if key_out is None else key_out.data_ptr(),
            ords[p % 2].data_ptr(), n, shift,
            hist.data_ptr() + 4 * (j * _DIGITS * 256 + (shift // 8) * 256),
            status.data_ptr(), counters + 8 * p, p + 1, st), "sort_order")
        order, key = ords[p % 2], key_out
    return order, varies


sort_order.launches = 0
sort_order.passes = 0      # radix passes run, over all calls


def sort_rows(key_words: Sequence[torch.Tensor],
              cols: Sequence[DeviceColumn],
              extras: Sequence[torch.Tensor] = ()):
    """Stable sort of rows by ``key_words`` (K2); the flat rows of
    ``cols`` and the lanes in ``extras`` follow the order through one
    gather (K8), string columns through K16.  Returns (order, cols,
    extras)."""
    order = sort_order(key_words)
    flat = [c for c in cols if c.is_flat]
    lanes = flat_lanes(flat)
    nflat = len(lanes)
    outs = gather_rows(order, lanes + list(extras))
    moved = iter(columns_from_lanes(flat, outs[:nflat]))
    gathered = iter(gather_columns([c for c in cols if not c.is_flat],
                                   order))
    out_cols = [next(moved) if c.is_flat else next(gathered)
                for c in cols]
    return order, out_cols, outs[nflat:]

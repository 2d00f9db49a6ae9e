"""Order-preserving key words and segment boundaries.

Counterpart of spark_rapids_tpu/ops/segmented.py.  The reference builds
uint64 key words; torch has no uint64 arithmetic (``+``, ``~``, ``>>``
and ``searchsorted`` raise for it), and a plain cast to int64 would
misorder words at or above 2^63 without an error.  So every word is
carried as int64 holding (reference word XOR 2^63): signed int64 order
then equals the reference's unsigned order.  Narrow words (the uint8
null word, the uint32 word of an INT, the uint8 word of a BOOLEAN) are
carried as the int64 value they encode (the null word as 1 for a valid
row under nulls first), which keeps their order too.  A descending
value word is the bitwise NOT of the ascending one, in the port's
convention as in the reference's: ~(w XOR 2^63) == (~w) XOR 2^63 for
a 64-bit word, and NOT reverses the order of any narrow word carried as
its sign-extended value.

Each flat type's value word is an int64 whose signed order is the
value order: BYTE, SHORT, INT and DATE their value (the reference's
uint32 ``encode_int_ordered32`` word is that value XOR 2^31 read
unsigned), FLOAT its 32-bit total-order word (``encode_float_ordered32``
carried the same way), LONG, TIMESTAMP and a DECIMAL of at most 18
digits their value, DOUBLE ``encode_float_ordered``'s word, and a wider
DECIMAL two words, the signed high word then the low word XOR 2^63 (the
reference's (hi signed, lo unsigned) pair).

A STRING column's words follow the reference: for grouping (equality)
the null word and the two rolling hashes (K14), each XOR 2^63; for
ordering the null word, the 4 prefix words and the length (K17).
Prefix words alone would merge two strings that share 32 bytes and a
length, so grouping never uses them.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import types as t
from ..columnar.device import DeviceColumn
from . import strings as sops
from .scan import cumsum

_LOW63 = 0x7FFFFFFFFFFFFFFF
_SIGN = -2**63


def encode_int_ordered(data: torch.Tensor) -> torch.Tensor:
    """Integer key word.  The reference flips the sign bit into a uint64;
    flipped back, that word is the int64 value itself."""
    return data.to(torch.int64)


def encode_float_ordered(data: torch.Tensor) -> torch.Tensor:
    """float64 key word in Spark's total order: -0.0 equals 0.0, NaN is
    canonical and sorts after +inf."""
    d = data.to(torch.float64)
    d = torch.where(d == 0.0, torch.zeros_like(d), d)
    d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
    bits = d.view(torch.int64)
    return torch.where(bits < 0, bits ^ _LOW63, bits)


def encode_int_ordered32(data: torch.Tensor) -> torch.Tensor:
    """A narrow integer's key word: the reference's uint32 word (the value
    XOR 2^31) minus 2^31, which is the value itself, as int64."""
    return data.to(torch.int64)


def encode_float_ordered32(data: torch.Tensor) -> torch.Tensor:
    """float32 key word in Spark's total order (-0.0 equals 0.0, NaN
    canonical and last): the reference's uint32 word minus 2^31, as
    int64."""
    d = data.to(torch.float32)
    d = torch.where(d == 0.0, torch.zeros_like(d), d)
    d = torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)
    bits = d.view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)


def decimal128_words(col: DeviceColumn) -> List[torch.Tensor]:
    """A DECIMAL128 column's two value words: the signed high word, then
    the unsigned low word carried XOR 2^63."""
    return [col.data_hi.to(torch.int64), col.data ^ _SIGN]


def ordered_word(values: torch.Tensor) -> torch.Tensor:
    """The int64 word of a min/max value lane, whose signed order is the
    value order: an int64 lane (LONG, and the narrow integers widened) is
    its own word; a float64 lane (DOUBLE, and FLOAT widened) takes Spark's total order of
    ``encode_float_ordered`` (-0.0 equals 0.0, NaN is canonical and
    greatest), carried as the reference's uint64 word XOR 2^63.  The
    flat-type counterpart of the reference's ``_ordered_words32``, which
    splits the same order into int32 words for the TPU's scatters."""
    if values.dtype == torch.float64:
        return encode_float_ordered(values)
    return values.to(torch.int64)


def segment_reduce(op: str, values: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, valid: torch.Tensor):
    """Plain per-segment min or max: (out[num_segments],
    count_valid[num_segments]).  Rows with ``valid`` false or a negative
    segment id do not contribute.  A segment's result is the value, bit
    for bit, of its first row (lowest index) whose ordered word is the
    least (min) or greatest (max): the reference's ``segment_reduce``
    on its jax branch (``_argext_rows``).  A segment no row reached is
    0."""
    if op not in ("min", "max"):
        raise ValueError(f"segment_reduce: op {op!r} (min or max)")
    n, dev = int(values.shape[0]), values.device
    take = valid & (seg_ids >= 0)
    ids = seg_ids[take].to(torch.int64)
    cnt = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    cnt.index_add_(0, ids, torch.ones_like(ids))
    out = torch.zeros(num_segments, dtype=values.dtype, device=dev)
    if ids.numel() == 0:
        return out, cnt
    w = ordered_word(values)[take]
    if op == "max":
        w = ~w                      # NOT reverses the signed order
    best = torch.full((num_segments,), _LOW63, dtype=torch.int64,
                      device=dev).scatter_reduce_(0, ids, w, "amin")
    hit = w == best[ids]
    pos = torch.arange(n, device=dev)[take]
    row = torch.full((num_segments,), n, dtype=torch.int64,
                     device=dev).scatter_reduce_(0, ids[hit], pos[hit],
                                                 "amin")
    got = cnt > 0
    out[got] = values[row[got]]
    return out, cnt


def segment_pick(op: str, seg_ids: torch.Tensor, num_segments: int,
                 valid: torch.Tensor):
    """Plain per-segment first or last: (position int64[num_segments],
    count_valid[num_segments]), the least (``first``) or greatest
    (``last``) row position whose ``valid`` is set, 0 where no row
    contributed; rows with a negative segment id do not contribute.  The
    reference's ``segment_reduce(np, "first"|"last", ...)`` (its numpy
    branch: ``minimum.at`` / ``maximum.at`` of the positions) before its
    gather, by ``scatter_reduce_``."""
    if op not in ("first", "last"):
        raise ValueError(f"segment_pick: op {op!r} (first or last)")
    dev = seg_ids.device
    take = valid & (seg_ids >= 0)
    ids = seg_ids[take].to(torch.int64)
    cnt = torch.zeros(num_segments, dtype=torch.int64,
                      device=dev).index_add_(0, ids, torch.ones_like(ids))
    pos = torch.nonzero(take).flatten()
    init = int(seg_ids.shape[0]) if op == "first" else -1
    out = torch.full((num_segments,), init, dtype=torch.int64,
                     device=dev).scatter_reduce_(
        0, ids, pos, "amin" if op == "first" else "amax")
    return torch.where(cnt > 0, out, torch.zeros_like(out)), cnt


def segment_sum128(lo: torch.Tensor, hi: torch.Tensor,
                   seg_ids: torch.Tensor, num_segments: int,
                   valid: torch.Tensor):
    """Plain 128-bit per-segment sum of (lo, hi) words: (lo_out, hi_out,
    count_valid), exact modulo 2^128 (the reference's
    ``segment_sum128`` on its numpy branch: the low word's two 32-bit
    halves and the high word summed apart, then the carries joined;
    exact for up to 2^31 rows a segment).  Rows with ``valid`` false or
    a negative segment id do not contribute."""
    take = valid & (seg_ids >= 0)
    ids = seg_ids[take].to(torch.int64)
    dev = lo.device

    def per_seg(x):
        return torch.zeros(num_segments, dtype=torch.int64,
                           device=dev).index_add_(0, ids, x[take])
    s0 = per_seg(lo & 0xFFFFFFFF)
    s1 = per_seg((lo >> 32) & 0xFFFFFFFF)
    sh = per_seg(hi)
    cnt = per_seg(torch.ones_like(lo))
    tmid = s1 + (s0 >> 32)
    lo_out = (s0 & 0xFFFFFFFF) | ((tmid & 0xFFFFFFFF) << 32)
    return lo_out, sh + (tmid >> 32), cnt


def segment_extreme128(op: str, lo: torch.Tensor, hi: torch.Tensor,
                       seg_ids: torch.Tensor, num_segments: int,
                       valid: torch.Tensor):
    """Plain per-segment min or max of DECIMAL128 (lo, hi) words:
    (lo_out, hi_out, count_valid), ordered by (hi signed, lo unsigned);
    0 where no row contributed."""
    if op not in ("min", "max"):
        raise ValueError(f"segment_extreme128: op {op!r} (min or max)")
    take = valid & (seg_ids >= 0)
    ids = seg_ids[take].to(torch.int64)
    dev = lo.device
    cnt = torch.zeros(num_segments, dtype=torch.int64,
                      device=dev).index_add_(0, ids, torch.ones_like(ids))
    out_lo = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    out_hi = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    if ids.numel() == 0:
        return out_lo, out_hi, cnt
    w_hi, w_lo = hi[take], lo[take] ^ _SIGN
    if op == "max":
        w_hi, w_lo = ~w_hi, ~w_lo           # NOT reverses the signed order
    best_hi = torch.full((num_segments,), _LOW63, dtype=torch.int64,
                         device=dev).scatter_reduce_(0, ids, w_hi, "amin")
    on_hi = w_hi == best_hi[ids]
    best_lo = torch.full((num_segments,), _LOW63, dtype=torch.int64,
                         device=dev).scatter_reduce_(0, ids[on_hi],
                                                     w_lo[on_hi], "amin")
    hit = on_hi & (w_lo == best_lo[ids])
    row = torch.full((num_segments,), lo.shape[0], dtype=torch.int64,
                     device=dev).scatter_reduce_(
        0, ids[hit], torch.nonzero(take).flatten()[hit], "amin")
    got = cnt > 0
    out_lo[got] = lo[row[got]]
    out_hi[got] = hi[row[got]]
    return out_lo, out_hi, cnt


def sort_key_words(col: DeviceColumn, ascending: bool = True,
                   nulls_first: bool = True) -> List[torch.Tensor]:
    """Sort key words for one column, most significant first: the null
    word, which places nulls first or last whatever the direction, then
    the value word, inverted for a descending order (the reference's
    ``key_words_for_column`` with ``for_grouping=False``)."""
    valid = col.validity if nulls_first else ~col.validity
    words = [valid.to(torch.int64)]
    dtype = col.dtype
    if dtype == t.STRING:
        words += sops.order_keys(col.offsets, col.data)
    elif dtype == t.DOUBLE:
        words.append(encode_float_ordered(col.data))
    elif dtype == t.FLOAT:
        words.append(encode_float_ordered32(col.data))
    elif t.is_dec128(dtype):
        words += decimal128_words(col)
    elif dtype in (t.BYTE, t.SHORT, t.INT, t.DATE):
        words.append(encode_int_ordered32(col.data))
    elif dtype in (t.LONG, t.TIMESTAMP, t.BOOLEAN) or \
            isinstance(dtype, t.DecimalType):
        words.append(encode_int_ordered(col.data))
    elif isinstance(dtype, t.StructType):
        # each child's words in turn (the reference's recursion), zero
        # under a null struct row so the null rows tie
        for k in col.children:
            words += [torch.where(col.validity, w, torch.zeros_like(w))
                      for w in sort_key_words(k, True, nulls_first)]
    else:
        raise NotImplementedError(f"key words for {dtype} are not ported")
    if not ascending:
        words[1:] = [~w for w in words[1:]]
    return words


def key_words_for_column(col: DeviceColumn) -> List[torch.Tensor]:
    """Grouping key words for one column, most significant first: the
    null word (nulls first), then the value word; for a string or a
    binary the two rolling hashes (K14), so equal values and only they
    group together (up to a ~2^-120 collision, the reference's
    tradeoff); for a STRUCT the null word, then each child's words in
    turn (the reference's recursion).  A child's words are zero under a
    null struct row, so every null struct groups as one whatever its
    children hold."""
    if t.is_span(col.dtype):
        h1, h2 = sops.string_hashes(col.offsets, col.data)
        return [col.validity.to(torch.int64), h1 ^ _SIGN, h2 ^ _SIGN]
    if isinstance(col.dtype, t.StructType):
        words = [col.validity.to(torch.int64)]
        for k in col.children:
            words += [torch.where(col.validity, w, torch.zeros_like(w))
                      for w in key_words_for_column(k)]
        return words
    return sort_key_words(col)


def lexsort(key_words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable ascending lexicographic argsort (most significant word
    first); int32 order.  Runs kernel K2 on CUDA tensors."""
    from .carry import sort_order
    return sort_order(key_words)


def segment_boundaries(sorted_words: Sequence[torch.Tensor],
                       live_sorted: torch.Tensor) -> torch.Tensor:
    """New-group flags over sorted rows: a live row that is the first row
    or differs from the previous row in any key word."""
    n = live_sorted.shape[0]
    new_group = torch.zeros(n, dtype=torch.bool, device=live_sorted.device)
    if n == 0:
        return new_group
    new_group[0] = True
    for w in sorted_words:
        new_group[1:] |= w[1:] != w[:-1]
    return new_group & live_sorted


def segment_ids(new_group: torch.Tensor) -> torch.Tensor:
    return (cumsum(new_group.to(torch.int32), dtype=torch.int32) - 1
            ).to(torch.int32)

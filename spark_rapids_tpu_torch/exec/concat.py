"""Batch concatenation.

Counterpart of spark_rapids_tpu/exec/concat.py: the live rows of each
batch, in order, padded to the capacity bucket of the total.  A string
or binary column's offsets are rebased by the bytes before each piece
and its bytes padded to the bucket of their total (the reference's span
concat, ``concat_char_buffers``); an ARRAY's or MAP's offsets are
rebased by the child rows before each piece and its children
concatenated by recursion, and a STRUCT concatenates each child.  The
live counts of every span column that is row-aligned with the batch are
read to the host in one read (``_span_counts``), a level of children
one read a column.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import types as t
from ..columnar.device import (DEFAULT_CHAR_BUCKETS, DeviceBatch,
                               DeviceColumn, bucket_for)
from ..ops.strings import concat_char_buffers

_INT32_MAX = 2**31 - 1


def _concat_lane(parts: Sequence[torch.Tensor], cap: int) -> torch.Tensor:
    total = sum(int(p.shape[0]) for p in parts)
    out = torch.zeros(cap, dtype=parts[0].dtype, device=parts[0].device)
    torch.cat(list(parts), out=out[:total])
    return out


def _span_nodes(dt: t.DataType, path=()):
    """The paths (child index sequences) of a column's span columns that
    are row-aligned with it: itself, or a STRUCT's descendants'."""
    if isinstance(dt, t.StructType):
        return [p for i, f in enumerate(dt.fields)
                for p in _span_nodes(f.data_type, path + (i,))]
    if t.is_varlen(dt):
        return [path]
    return []


def _at(col: DeviceColumn, path) -> DeviceColumn:
    for i in path:
        col = col.children[i]
    return col


def _span_counts(cols: List[List[DeviceColumn]], counts: List[int],
                 dtypes) -> List[dict]:
    """Per column, the live byte or child-row count of each of its span
    columns (by path) in every piece, all in one host read."""
    reqs = [(i, p) for i, dt in enumerate(dtypes) for p in _span_nodes(dt)]
    out = [dict() for _ in dtypes]
    if not reqs:
        return out
    ends = torch.stack([_at(c, p).offsets[n] for i, p in reqs
                        for c, n in zip(cols[i], counts)]).tolist()
    k = len(counts)
    for j, (i, p) in enumerate(reqs):
        out[i][p] = ends[j * k:(j + 1) * k]
    return out


def _concat_offsets(offs_list: Sequence[torch.Tensor], counts: Sequence[int],
                    inner: Sequence[int], cap: int) -> torch.Tensor:
    """The offsets of the pieces' live rows, each piece's rebased by the
    child rows before it, padded to ``cap + 1`` with the total."""
    total = sum(inner)
    if total > _INT32_MAX:
        raise ValueError(f"concatenating {total} child rows exceeds the "
                         f"2^31-1 rows of int32 offsets")
    offs = torch.full((cap + 1,), total, dtype=torch.int32,
                      device=offs_list[0].device)
    row = base = 0
    for o, n, b in zip(offs_list, counts, inner):
        offs[row:row + n] = o[:n] + base
        row += n
        base += b
    return offs


def concat_columns(src: Sequence[DeviceColumn], counts: Sequence[int],
                   cap: int, dt: t.DataType, ends: dict,
                   path=()) -> DeviceColumn:
    """One column of the first ``counts[i]`` rows of each ``src[i]``,
    padded to ``cap`` rows (the reference's ``concat_columns``); ``ends``
    holds each row-aligned span column's live counts by path.  An
    ARRAY's or MAP's children are concatenated by recursion over the
    child counts, read one column at a time."""
    validity = _concat_lane([c.validity[:n] for c, n in zip(src, counts)],
                            cap)
    if isinstance(dt, t.StructType):
        return DeviceColumn(dt, None, validity, None, None, [
            concat_columns([c.children[i] for c in src], counts, cap,
                           f.data_type, ends, path + (i,))
            for i, f in enumerate(dt.fields)])
    if t.is_varlen(dt):
        inner = ends[path]
        if t.is_span(dt):
            offs, chars = concat_char_buffers(
                [c.offsets for c in src], [c.data for c in src], counts,
                inner, cap, bucket_for(max(sum(inner), 1),
                                       DEFAULT_CHAR_BUCKETS))
            return DeviceColumn(dt, chars, validity, offs)
        offs = _concat_offsets([c.offsets for c in src], counts, inner, cap)
        base = sum(inner)
        child_cap = bucket_for(max(base, 1))
        kids = []
        for i, kt in enumerate(t.child_types(dt)):
            pieces = [c.children[i] for c in src]
            kid_ends = _span_counts([pieces], inner, [kt])[0]
            kids.append(concat_columns(pieces, inner, child_cap, kt,
                                       kid_ends))
        return DeviceColumn(dt, None, validity, offs, None, kids)
    hi = None if src[0].data_hi is None else _concat_lane(
        [c.data_hi[:n] for c, n in zip(src, counts)], cap)
    return DeviceColumn(
        dt, _concat_lane([c.data[:n] for c, n in zip(src, counts)], cap),
        validity, None, hi)


def concat_batches(batches: List[DeviceBatch], names: Sequence[str],
                   dtypes: Sequence[t.DataType]) -> DeviceBatch:
    counts = [b.num_rows for b in batches]
    total = sum(counts)
    cap = bucket_for(max(total, 1))
    cols = [[b.columns[i] for b in batches] for i in range(len(dtypes))]
    ends = _span_counts(cols, counts, dtypes)
    return DeviceBatch([concat_columns(src, counts, cap, dt, e)
                        for src, dt, e in zip(cols, dtypes, ends)],
                       total, names)

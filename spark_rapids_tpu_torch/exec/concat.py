"""Batch concatenation.

Counterpart of spark_rapids_tpu/exec/concat.py: the live rows of each
batch, in order, padded to the capacity bucket of the total.  A string
column's offsets are rebased by the bytes before each piece and its
chars padded to the bucket of their total (the reference's span concat,
``concat_char_buffers``); the byte counts of every string column of
every batch are read to the host in one read (``_span_counts``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import types as t
from ..columnar.device import (DEFAULT_CHAR_BUCKETS, DeviceBatch,
                               DeviceColumn, bucket_for)
from ..ops.strings import concat_char_buffers


def _concat_lane(parts: Sequence[torch.Tensor], cap: int) -> torch.Tensor:
    total = sum(int(p.shape[0]) for p in parts)
    out = torch.zeros(cap, dtype=parts[0].dtype, device=parts[0].device)
    torch.cat(list(parts), out=out[:total])
    return out


def _span_counts(batches: List[DeviceBatch], dtypes) -> List[List[int]]:
    """Per string column, every batch's live byte count, in one host
    read."""
    spans = [i for i, dt in enumerate(dtypes) if dt == t.STRING]
    if not spans:
        return []
    ends = torch.stack([b.columns[i].offsets[b.num_rows]
                        for i in spans for b in batches]).tolist()
    k = len(batches)
    return [ends[j * k:(j + 1) * k] for j in range(len(spans))]


def concat_batches(batches: List[DeviceBatch], names: Sequence[str],
                   dtypes: Sequence[t.DataType]) -> DeviceBatch:
    counts = [b.num_rows for b in batches]
    total = sum(counts)
    cap = bucket_for(max(total, 1))
    nbytes = iter(_span_counts(batches, dtypes))
    cols = []
    for i, dt in enumerate(dtypes):
        src = [b.columns[i] for b in batches]
        validity = _concat_lane([c.validity[:n] for c, n in
                                 zip(src, counts)], cap)
        if dt == t.STRING:
            b = next(nbytes)
            offs, chars = concat_char_buffers(
                [c.offsets for c in src], [c.data for c in src], counts, b,
                cap, bucket_for(max(sum(b), 1), DEFAULT_CHAR_BUCKETS))
            cols.append(DeviceColumn(dt, chars, validity, offs))
            continue
        hi = None if src[0].data_hi is None else _concat_lane(
            [c.data_hi[:n] for c, n in zip(src, counts)], cap)
        cols.append(DeviceColumn(
            dt, _concat_lane([c.data[:n] for c, n in zip(src, counts)], cap),
            validity, None, hi))
    return DeviceBatch(cols, total, names)

"""Batch concatenation for flat columns.

Counterpart of spark_rapids_tpu/exec/concat.py: the live rows of each
batch, in order, padded to the capacity bucket of the total.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from .. import types as t
from ..columnar.device import DeviceBatch, DeviceColumn, bucket_for


def _concat_lane(parts: Sequence[torch.Tensor], cap: int) -> torch.Tensor:
    total = sum(int(p.shape[0]) for p in parts)
    out = torch.zeros(cap, dtype=parts[0].dtype, device=parts[0].device)
    torch.cat(list(parts), out=out[:total])
    return out


def concat_batches(batches: List[DeviceBatch], names: Sequence[str],
                   dtypes: Sequence[t.DataType]) -> DeviceBatch:
    counts = [b.num_rows for b in batches]
    total = sum(counts)
    cap = bucket_for(max(total, 1))
    cols = []
    for i, dt in enumerate(dtypes):
        src = [b.columns[i] for b in batches]
        cols.append(DeviceColumn(
            dt,
            _concat_lane([c.data[:n] for c, n in zip(src, counts)], cap),
            _concat_lane([c.validity[:n] for c, n in zip(src, counts)], cap)))
    return DeviceBatch(cols, total, names)

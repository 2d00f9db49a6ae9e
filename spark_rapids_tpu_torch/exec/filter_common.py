"""Filter compaction.

Counterpart of spark_rapids_tpu/exec/filter_common.py: a predicate
becomes keep flags (a null or a padding row drops the row), and kernel
K1 moves the kept rows to the front.
"""

from __future__ import annotations

import torch

from ..columnar.device import DeviceBatch
from ..expr.core import ScalarValue
from ..ops.carry import compact_rows


def keep_flags(batch: DeviceBatch, pred_value) -> torch.Tensor:
    """bool[cap]: rows the predicate keeps (null -> drop, as Spark)."""
    live = torch.arange(batch.capacity, device=batch.device) < batch.num_rows
    if isinstance(pred_value, ScalarValue):
        if pred_value.value is None or not bool(pred_value.value):
            return torch.zeros_like(live)
        return live
    col = pred_value.col
    return col.data.to(torch.bool) & col.validity & live


def compact(batch: DeviceBatch, keep: torch.Tensor, names) -> DeviceBatch:
    cols, n = compact_rows(keep, batch.columns)
    return DeviceBatch(cols, n, names)


def apply_filter(batch: DeviceBatch, pred_value, names) -> DeviceBatch:
    return compact(batch, keep_flags(batch, pred_value), names)

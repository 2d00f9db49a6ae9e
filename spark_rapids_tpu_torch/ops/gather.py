"""Row gather over flat device columns.

Counterpart of spark_rapids_tpu/ops/gather.py for flat columns: row i
of the output is row ``indices[i]`` of the input, and null where
``valid[i]`` is False.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..columnar.device import DeviceBatch, DeviceColumn


def gather_column(col: DeviceColumn, indices: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> DeviceColumn:
    idx = indices.to(torch.int64)
    data = col.data[idx]
    validity = col.validity[idx]
    if valid is not None:
        validity = validity & valid
        data = torch.where(validity, data, torch.zeros_like(data))
    return DeviceColumn(col.dtype, data, validity)


def gather_batch(batch: DeviceBatch, indices: torch.Tensor,
                 valid: Optional[torch.Tensor], num_rows: int) -> DeviceBatch:
    return DeviceBatch([gather_column(c, indices, valid)
                        for c in batch.columns], num_rows, batch.names)

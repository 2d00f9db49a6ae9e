"""Prefix sums.

Counterpart of spark_rapids_tpu/ops/scan.py.  The reference builds its
scans from pad-shift doubling steps, a workaround for the TPU's slow
scan lowering; here a scan is ``torch.cumsum``.  The reference's
segmented float scan has no counterpart: the grouped float sums it
served are folded per group by kernel K3 (exec/aggregate.py).
"""

from __future__ import annotations

from typing import Optional

import torch


def cumsum(v: torch.Tensor, dtype: Optional[torch.dtype] = None
           ) -> torch.Tensor:
    """Inclusive prefix sum (integer sums wrap mod 2^64)."""
    return torch.cumsum(v, dim=0, dtype=dtype)


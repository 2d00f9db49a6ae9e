"""Hash partitioning: Spark's pmod(murmur3(keys), n).

Counterpart of spark_rapids_tpu/shuffle/partitioning.py
(Partitioning, HashPartitioning and slice_batch_by_partition), so the
port routes every row to the partition the reference and Spark route it
to.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.device import DeviceBatch
from ..expr.core import EvalContext, Expression, bind_expression
from ..expr.hashfns import Murmur3Hash
from ..ops.gather import gather_column


class Partitioning:
    num_partitions: int = 1

    def bind(self, names, dtypes) -> "Partitioning":
        return self

    def partition_ids(self, ctx: EvalContext, batch: DeviceBatch
                      ) -> torch.Tensor:
        """int32[cap]: the partition of every row."""
        raise NotImplementedError

    def describe(self) -> str:
        return f"{type(self).__name__}({self.num_partitions})"


class HashPartitioning(Partitioning):
    def __init__(self, keys: Sequence[Expression], num_partitions: int):
        self.keys = list(keys)
        self.num_partitions = num_partitions
        self._bound: Optional[Murmur3Hash] = None

    def bind(self, names, dtypes):
        out = HashPartitioning(self.keys, self.num_partitions)
        out._bound = Murmur3Hash(
            [bind_expression(k, names, dtypes) for k in self.keys])
        return out

    def partition_ids(self, ctx, batch):
        h = self._bound.eval(ctx).col.data.to(torch.int64)
        # Spark's pmod: torch's remainder takes the divisor's sign
        return torch.remainder(h, self.num_partitions).to(torch.int32)


def slice_batch_by_partition(batch: DeviceBatch, pids: torch.Tensor,
                             num_partitions: int
                             ) -> Tuple[DeviceBatch, List[int]]:
    """The live rows sorted stably by partition id, and the row count of
    every partition (read to the host once)."""
    live = torch.arange(batch.capacity, device=batch.device) < batch.num_rows
    key = torch.where(live, pids.to(torch.int64),
                      torch.full_like(pids, num_partitions,
                                      dtype=torch.int64))
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=num_partitions + 1)
    cols = [gather_column(c, order) for c in batch.columns]
    return (DeviceBatch(cols, batch.num_rows, batch.names),
            counts[:num_partitions].tolist())

"""Hash, round-robin and range partitioning.

Counterpart of spark_rapids_tpu/shuffle/partitioning.py (Partitioning,
HashPartitioning, RoundRobinPartitioning, RangePartitioning and
slice_batch_by_partition), so the port routes every row to the
partition the reference routes it to: Spark's pmod(murmur3(keys), n)
for hash partitioning; for round robin the row's index in its map
partition mod n; for range partitioning the number of sampled bounds at
or below the row's sort key words.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar.device import DeviceBatch
from ..exec.sort import order_key_words
from ..expr.core import EvalContext, Expression, bind_expression
from ..expr.hashfns import Murmur3Hash
from ..ops.carry import sort_order
from ..ops.gather import gather_column


class Partitioning:
    num_partitions: int = 1

    def bind(self, names, dtypes) -> "Partitioning":
        return self

    def partition_ids(self, ctx: EvalContext, batch: DeviceBatch,
                      row_offset: int = 0) -> torch.Tensor:
        """int32[cap]: the partition of every row; ``row_offset`` is the
        number of rows of the map partition before this batch."""
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

    def partition_ids(self, ctx, batch, row_offset=0):
        h = self._bound.eval(ctx).col.data.to(torch.int64)
        # Spark's pmod: torch's remainder takes the divisor's sign
        return torch.remainder(h, self.num_partitions).to(torch.int32)


class RoundRobinPartitioning(Partitioning):
    """Row i of a map partition goes to partition i mod n, i counted in
    int32 as the reference counts it (past 2^31 it wraps, and the mod
    takes the divisor's sign)."""

    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions

    def partition_ids(self, ctx, batch, row_offset=0):
        idx = torch.arange(batch.capacity, dtype=torch.int64,
                           device=batch.device) + row_offset
        idx = ((idx + 2**31) & 0xFFFFFFFF) - 2**31     # int32 wrap
        return torch.remainder(idx, self.num_partitions).to(torch.int32)


class RangePartitioning(Partitioning):
    """Range partitioning by bounds sampled from the first batch it sees
    (the reference's GpuRangePartitioner form): the batch's rows sorted
    by the sort key words, n - 1 equally spaced rows picked as bounds,
    and each row routed to the number of bounds its words are at or
    above, so equal keys share a partition."""

    def __init__(self, orders, num_partitions: int):
        # orders: [(expr, ascending, nulls_first)]
        self.orders = list(orders)
        self.num_partitions = num_partitions
        self._bound_orders = None
        self.bounds_words: Optional[List[torch.Tensor]] = None

    def bind(self, names, dtypes):
        out = RangePartitioning(self.orders, self.num_partitions)
        out._bound_orders = [(bind_expression(e, names, dtypes), asc, nf)
                             for e, asc, nf in self.orders]
        out.bounds_words = self.bounds_words
        return out

    def _row_words(self, ctx: EvalContext) -> List[torch.Tensor]:
        # no padding word: padding rows are null in every column, so they
        # take the null word's place, as in the reference
        return order_key_words(ctx, self._bound_orders)

    def compute_bounds(self, ctx: EvalContext, batch: DeviceBatch):
        """n - 1 equally spaced bound rows of the sorted batch."""
        words = self._row_words(ctx)
        order = sort_order(words).to(torch.int64)
        n = self.num_partitions
        live_n = max(batch.num_rows, 1)
        picks = (torch.arange(n - 1, dtype=torch.int64, device=batch.device)
                 + 1) * live_n // n
        picks = picks.clamp(0, batch.capacity - 1)
        self.bounds_words = [w[order][picks] for w in words]

    def partition_ids(self, ctx, batch, row_offset=0):
        if self.bounds_words is None:
            self.compute_bounds(ctx, batch)
        words = self._row_words(ctx)
        cap = batch.capacity
        pid = torch.zeros(cap, dtype=torch.int32, device=batch.device)
        for b in range(self.num_partitions - 1):
            gt = torch.zeros(cap, dtype=torch.bool, device=batch.device)
            eq = torch.ones(cap, dtype=torch.bool, device=batch.device)
            for w, bw in zip(words, self.bounds_words):
                bv = bw[b]
                gt = gt | (eq & (w > bv))
                eq = eq & (w == bv)
            pid += (gt | eq).to(torch.int32)
        return pid


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

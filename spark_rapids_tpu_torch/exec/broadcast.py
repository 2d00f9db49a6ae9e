"""Broadcast exchange and the broadcast joins.

Counterpart of spark_rapids_tpu/exec/broadcast.py
(BroadcastExchangeExec, BroadcastHashJoinExec,
BroadcastNestedLoopJoinExec).  The build side is collected and
concatenated once per plan, cached on the exchange, and every probe
partition and every probe batch joins against the same batch.
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

import pyarrow as pa

from ..analysis.determinism import ORDER_STABLE, Determinism
from ..columnar.device import DeviceBatch, batch_to_device
from ..columnar.interop import to_arrow_schema
from .base import Exec, ExecContext
from .concat import concat_batches
from .join import HashJoinExec, NestedLoopJoinExec


class BroadcastExchangeExec(Exec):
    """Collects every child partition into one concatenated batch,
    computed once and served to all consumers (one partition)."""

    def __init__(self, child: Exec):
        super().__init__([child])
        self._lock = threading.Lock()
        self._cached: Optional[DeviceBatch] = None

    @property
    def output_names(self):
        return self.children[0].output_names

    @property
    def output_types(self):
        return self.children[0].output_types

    @property
    def num_partitions(self):
        return 1

    def describe(self):
        return "BroadcastExchange"

    def determinism(self):
        return Determinism(
            ORDER_STABLE, "whole-side collect concatenates child "
            "partitions in emission order; content multiset is "
            "invariant")

    def _materialize(self, ctx: ExecContext) -> DeviceBatch:
        with self._lock:
            if self._cached is not None:
                return self._cached
            child = self.children[0]
            batches = [b for pid in range(child.num_partitions)
                       for b in self.child_batches(0, pid, ctx)]
            if not batches:
                schema = to_arrow_schema(child.output_names,
                                         child.output_types)
                batches = [batch_to_device(pa.RecordBatch.from_arrays(
                    [pa.array([], type=f.type) for f in schema],
                    schema=schema), self.device(ctx))]
            self._cached = concat_batches(
                batches, child.output_names, child.output_types) \
                if len(batches) > 1 else batches[0]
            return self._cached

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        yield self._materialize(ctx)


class BroadcastHashJoinExec(HashJoinExec):
    """Equi-join whose build (right) child is a BroadcastExchangeExec: the
    cached broadcast batch is the build input of every partition."""

    def describe(self):
        ks = ", ".join(f"{a.sql()}={b.sql()}"
                       for a, b in zip(self.left_keys, self.right_keys))
        return f"BroadcastHashJoin {self.how} on [{ks}]"


class BroadcastNestedLoopJoinExec(NestedLoopJoinExec):
    """Cross or conditional join whose build side is broadcast."""

    def describe(self):
        c = f" on {self.condition.sql()}" if self.condition is not None \
            else ""
        return f"BroadcastNestedLoopJoin {self.how}{c}"

"""Shuffle exchange, in memory.

Counterpart of the map and reduce sides of
spark_rapids_tpu/shuffle/exchange.py (ShuffleExchangeExec) without its
shuffle manager, wire or spill: the first partition read runs every map
partition, sorts each batch's rows stably by target partition, and
keeps the slices; reduce partition p then yields, per map partition in
order, one batch of the rows routed to p.  It runs on the host only: on
a single device the plan rewrite strips an exchange whose consumer runs
on the device, and keeps the others on the CPU (plan/overrides.py).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional

import torch

from ..analysis.determinism import ORDER_STABLE, Determinism
from ..columnar.device import DeviceBatch, bucket_for
from ..exec.base import CPU, Exec, ExecContext
from ..exec.concat import concat_batches
from ..expr.core import EvalContext
from ..io.scan import set_current_input_file
from ..ops.gather import gather_batch
from .partitioning import Partitioning, slice_batch_by_partition


def _rows(batch: DeviceBatch, start: int, n: int) -> DeviceBatch:
    """Rows [start, start + n) of a batch, padded to a capacity bucket."""
    cap = bucket_for(n)
    p = torch.arange(cap, device=batch.device)
    valid = p < n
    idx = torch.where(valid, p + start, torch.zeros_like(p))
    return gather_batch(batch, idx, valid, n)


class ShuffleExchangeExec(Exec):
    placement = CPU

    def __init__(self, partitioning: Partitioning, child: Exec):
        super().__init__([child])
        self.partitioning = partitioning.bind(child.output_names,
                                              child.output_types)
        self._lock = threading.Lock()
        self._blocks: Optional[Dict[int, List[DeviceBatch]]] = None

    @property
    def output_names(self):
        return self.children[0].output_names

    @property
    def output_types(self):
        return self.children[0].output_types

    @property
    def num_partitions(self):
        return self.partitioning.num_partitions

    def describe(self):
        return f"ShuffleExchange {self.partitioning.describe()}"

    def determinism(self):
        return Determinism(
            ORDER_STABLE, "hash routing is content-determined; block "
            "arrival order on the reduce side follows scheduling, the "
            "per-partition row multiset is invariant")

    def _write_all(self, ctx: ExecContext) -> Dict[int, List[DeviceBatch]]:
        """Reduce partition -> its blocks, one per map partition that
        routed rows to it, in map order."""
        child = self.children[0]
        n = self.num_partitions
        blocks: Dict[int, List[DeviceBatch]] = {p: [] for p in range(n)}
        for map_id in range(child.num_partitions):
            pieces: Dict[int, List[DeviceBatch]] = {}
            row_offset = 0
            for b in self.child_batches(0, map_id, ctx):
                pids = self.partitioning.partition_ids(EvalContext(b), b,
                                                       row_offset)
                row_offset += b.num_rows
                sorted_b, counts = slice_batch_by_partition(b, pids, n)
                start = 0
                for p, cnt in enumerate(counts):
                    if cnt:
                        pieces.setdefault(p, []).append(
                            _rows(sorted_b, start, cnt))
                    start += cnt
            for p, parts in pieces.items():
                blocks[p].append(parts[0] if len(parts) == 1 else
                                 concat_batches(parts, self.output_names,
                                                self.output_types))
        return blocks

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        with self._lock:
            if self._blocks is None:
                self._blocks = self._write_all(ctx)
        # past an exchange there is no current input file (Spark's
        # input_file_name() is "" there)
        set_current_input_file("")
        yield from self._blocks[pid]

"""Scan, range, project, filter, union, limit, sample and batch-coalesce
operators.

Counterpart of spark_rapids_tpu/exec/basic.py (LocalScanExec,
RangeExec, ProjectExec, FilterExec, UnionExec, LocalLimitExec,
GlobalLimitExec, SampleExec, CoalesceBatchesExec).  Operators evaluate
their expressions eagerly on the batch's device; the compaction of the
filter and of the sample is kernel K1.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import pyarrow as pa
import torch

from .. import types as t
from ..analysis.determinism import BIT_EXACT, ORDER_STABLE, Determinism
from ..columnar.device import (DeviceBatch, DeviceColumn, batch_to_device,
                               bucket_for)
from ..columnar.interop import from_arrow_type
from ..expr.core import (EvalContext, Expression, ScalarValue,
                         bind_expression, make_column, output_name)
from ..expr.hashfns import POSITIONAL
from ..ops.carry import mask_validity
from .base import PASSES, READS, Exec, ExecContext
from .concat import concat_batches
from .filter_common import apply_filter, compact


class LocalScanExec(Exec):
    """Scan over an in-memory Arrow table, split into partitions and,
    with ``batch_rows``, into batches of at most that many rows."""

    def __init__(self, table: pa.Table, num_partitions: int = 1,
                 batch_rows: Optional[int] = None,
                 pin_cache: Optional[dict] = None):
        super().__init__([])
        self.table = table
        self._names = list(table.schema.names)
        self._types = [from_arrow_type(f.type) for f in table.schema]
        self._num_partitions = max(1, num_partitions)
        self.batch_rows = batch_rows
        # uploaded batches kept on the device across collects, owned by
        # the logical LocalRelation: a DataFrame queried again is not
        # uploaded again (the reference's pinned scan cache; its eviction
        # under memory pressure is not ported)
        self.pin_cache = pin_cache

    @property
    def output_names(self):
        return self._names

    @property
    def output_types(self):
        return self._types

    @property
    def num_partitions(self):
        return self._num_partitions

    def estimated_size_bytes(self):
        return self.table.nbytes

    def execute_partition(self, pid, ctx: ExecContext
                          ) -> Iterator[DeviceBatch]:
        if self.pin_cache is None:
            yield from self._produce_partition(pid, ctx)
            return
        key = (pid, self._num_partitions, self.batch_rows, self.device(ctx))
        if key not in self.pin_cache:
            self.pin_cache[key] = list(self._produce_partition(pid, ctx))
        yield from self.pin_cache[key]

    def _produce_partition(self, pid, ctx: ExecContext
                           ) -> Iterator[DeviceBatch]:
        n = self.table.num_rows
        per = -(-n // self._num_partitions)
        start = min(pid * per, n)
        length = min(per, n - start)
        chunk = self.table.slice(start, length)
        rows = self.batch_rows or max(length, 1)
        offset = 0
        while True:
            piece = chunk.slice(offset, min(rows, length - offset))
            rb = pa.RecordBatch.from_arrays(
                [c.combine_chunks() for c in piece.columns],
                names=self._names)
            yield batch_to_device(rb, self.device(ctx))
            offset += rows
            if offset >= length:
                break


class RangeExec(Exec):
    """``range(start, end, step)`` as one LONG column.  Partition ``pid``
    holds rows [pid * per, min(pid * per + per, total)) of the total
    ceil((end - start) / step) rows, per = ceil(total / partitions), in
    batches of at most ``max_batch_rows``; row i is i * step + start,
    in int64 that wraps.  Built on the operator's device."""

    def __init__(self, start: int, end: int, step: int = 1,
                 num_partitions: int = 1, name: str = "id",
                 max_batch_rows: int = 1 << 20):
        super().__init__([])
        if step == 0:
            raise ValueError("range step must not be 0")
        self.start, self.end, self.step = start, end, step
        self._name = name
        self._num_partitions = max(1, num_partitions)
        self.max_batch_rows = max_batch_rows

    @property
    def output_names(self):
        return [self._name]

    @property
    def output_types(self):
        return [t.LONG]

    @property
    def num_partitions(self):
        return self._num_partitions

    def describe(self):
        return (f"Range ({self.start}, {self.end}, step={self.step}, "
                f"splits={self._num_partitions})")

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        total = max(0, -(-(self.end - self.start) // self.step))
        per = -(-total // self._num_partitions)
        lo = min(pid * per, total)
        hi = min(lo + per, total)
        dev = self.device(ctx)
        i = lo
        while i < hi:
            n = min(self.max_batch_rows, hi - i)
            pos = torch.arange(bucket_for(n), dtype=torch.int64, device=dev)
            live = pos < n
            vals = (pos + i) * self.step + self.start
            yield DeviceBatch([DeviceColumn(
                t.LONG, torch.where(live, vals, torch.zeros_like(vals)),
                live)], n, [self._name])
            i += n


class ProjectExec(Exec):
    """Evaluate the expressions over each batch.  When one reads the row
    position (``hashfns.POSITIONAL``), each batch gets the base
    (partition id << 33) + the partition's running row offset, counted
    from the batches' host row counts."""

    def __init__(self, exprs: Sequence[Expression], child: Exec):
        super().__init__([child])
        self.exprs = list(exprs)
        self._bound = [bind_expression(e, child.output_names,
                                       child.output_types)
                       for e in self.exprs]
        self._needs_rowpos = _exprs_need_rowpos(self._bound)

    @property
    def output_names(self):
        return [output_name(e) for e in self.exprs]

    @property
    def output_types(self):
        return [b.data_type() for b in self._bound]

    def describe(self):
        return f"Project [{', '.join(e.sql() for e in self.exprs)}]"

    def partition_use(self):
        # the row position counts rows within the partition
        return READS if self._needs_rowpos else PASSES

    def _compute(self, batch: DeviceBatch, row_base: int = 0) -> DeviceBatch:
        ctx = EvalContext(batch, row_base)
        cols = []
        for b in self._bound:
            v = b.eval(ctx)
            if isinstance(v, ScalarValue):
                v = make_column(ctx, b.data_type(), v.value,
                                None if v.value is not None else False)
            cols.append(v.col)
        return DeviceBatch(cols, batch.num_rows, self.output_names)

    def execute_partition(self, pid, ctx):
        offset = 0
        for b in self.child_batches(0, pid, ctx):
            yield self._compute(b, (pid << 33) + offset)
            if self._needs_rowpos:
                offset += b.num_rows


def _exprs_need_rowpos(bound_exprs) -> bool:
    """True when an expression reads the (partition, row position)
    context: monotonically_increasing_id, spark_partition_id, rand."""
    return any(b.collect(lambda e: isinstance(e, POSITIONAL))
               for b in bound_exprs)


class FilterExec(Exec):
    """Filter with device-side stable compaction (kernel K1).  A
    condition that reads the row position gets the projection's base:
    (partition id << 33) + the partition's running offset over the
    input rows."""

    def __init__(self, condition: Expression, child: Exec):
        super().__init__([child])
        self.condition = condition
        self._bound = bind_expression(condition, child.output_names,
                                      child.output_types)
        self._needs_rowpos = _exprs_need_rowpos([self._bound])

    @property
    def output_names(self):
        return self.children[0].output_names

    @property
    def output_types(self):
        return self.children[0].output_types

    def describe(self):
        return f"Filter [{self.condition.sql()}]"

    def partition_use(self):
        # the row position counts rows within the partition
        return READS if self._needs_rowpos else PASSES

    def _compute(self, batch: DeviceBatch, row_base: int = 0) -> DeviceBatch:
        pred = self._bound.eval(EvalContext(batch, row_base))
        return apply_filter(batch, pred, self.output_names)

    def execute_partition(self, pid, ctx):
        offset = 0
        for b in self.child_batches(0, pid, ctx):
            yield self._compute(b, (pid << 33) + offset)
            if self._needs_rowpos:
                offset += b.num_rows


class UnionExec(Exec):
    """The children's partitions, end to end: partition ``pid`` is the
    partition of the child whose range holds it."""

    def __init__(self, children: Sequence[Exec]):
        super().__init__(children)

    @property
    def output_names(self):
        return self.children[0].output_names

    @property
    def output_types(self):
        return self.children[0].output_types

    @property
    def num_partitions(self):
        return sum(c.num_partitions for c in self.children)

    def determinism(self):
        return Determinism(
            ORDER_STABLE, "union interleaves child partitions: output "
            "row order follows child emission, content multiset is "
            "invariant")

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        for i, c in enumerate(self.children):
            if pid < c.num_partitions:
                yield from self.child_batches(i, pid, ctx)
                return
            pid -= c.num_partitions


class LocalLimitExec(Exec):
    """The first ``limit`` live rows of each partition, in arrival order:
    a batch past the limit keeps its first rows, the rest become padding
    (invalid, data zero)."""

    def __init__(self, limit: int, child: Exec):
        super().__init__([child])
        self.limit = limit

    @property
    def output_names(self):
        return self.children[0].output_names

    @property
    def output_types(self):
        return self.children[0].output_types

    def partition_use(self):
        return READS        # the first rows of each partition

    def determinism(self):
        return Determinism(
            BIT_EXACT, "limit selects the first rows by input "
            "position", order_sensitive_selection=True)

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        remaining = self.limit
        for b in self.child_batches(0, pid, ctx):
            n = b.num_rows
            take = min(n, remaining)
            if take < n:
                keep = torch.arange(b.capacity, device=b.device) < take
                cols = [mask_validity(c, keep) for c in b.columns]
                b = DeviceBatch(cols, take, b.names)
            remaining -= take
            yield b
            if remaining <= 0:
                return


class GlobalLimitExec(LocalLimitExec):
    """The whole result's limit; the planner puts one partition below."""


def sample_keep_mask(cap: int, row_offset: int, pid: int, seed: int,
                     fraction: float, device) -> torch.Tensor:
    """bool[cap]: the rows a Bernoulli sample keeps, the reference's
    ``SampleExec._keep_mask`` bit for bit.  Its uint32 mixer over
    (seed, partition, row index mod 2^32) is carried in int64: each
    product wraps, its low 32 bits are kept, and every value is masked to
    32 bits before a shift, so the shift is logical."""
    m32 = 0xFFFFFFFF
    idx = (torch.arange(cap, dtype=torch.int64, device=device)
           + (row_offset & m32)) & m32
    h = idx ^ ((seed * 0x9E3779B9 + pid * 0x85EBCA6B) & m32)
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & m32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & m32
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).to(torch.float64) / float(1 << 24) < fraction


class SampleExec(Exec):
    """Bernoulli sampling: the keep decision hashes (seed, partition,
    the row's index in its partition), so every engine keeps the same
    rows; the kept rows are compacted by K1."""

    def __init__(self, fraction: float, seed: int, child: Exec):
        super().__init__([child])
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"sample fraction {fraction} is not in [0, 1]")
        self.fraction = float(fraction)
        self.seed = int(seed) & 0xFFFFFFFF

    @property
    def output_names(self):
        return self.children[0].output_names

    @property
    def output_types(self):
        return self.children[0].output_types

    def describe(self):
        return f"Sample fraction={self.fraction} seed={self.seed}"

    def partition_use(self):
        return READS        # the keep decision hashes the partition id

    def determinism(self):
        return Determinism(
            BIT_EXACT, "seeded hash of (seed, partition, global row "
            "index): the keep decision follows the running row offset, "
            "i.e. input arrival order", order_sensitive_selection=True)

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        dev = self.device(ctx)
        row_offset = 0
        for b in self.child_batches(0, pid, ctx):
            keep = sample_keep_mask(b.capacity, row_offset, pid, self.seed,
                                    self.fraction, dev)
            live = torch.arange(b.capacity, device=dev) < b.num_rows
            yield compact(b, keep & live, self.output_names)
            row_offset += b.num_rows


# the reference's coalesce target, in live rows
TARGET_ROWS = 1 << 22


class CoalesceBatchesExec(Exec):
    """Concatenate a partition's batches, in arrival order, until they
    reach TARGET_ROWS live rows; empty batches are dropped.  A batch that
    reaches the target alone passes through uncopied."""

    def __init__(self, child: Exec):
        super().__init__([child])

    def determinism(self):
        return Determinism(
            ORDER_STABLE, "re-batches in arrival order: batch "
            "boundaries follow arrival, row multiset is invariant")

    @property
    def output_names(self):
        return self.children[0].output_names

    @property
    def output_types(self):
        return self.children[0].output_types

    def _concat(self, pending: List[DeviceBatch]) -> DeviceBatch:
        if len(pending) == 1:
            return pending[0]
        return concat_batches(pending, self.output_names, self.output_types)

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        target = TARGET_ROWS
        pending: List[DeviceBatch] = []
        pending_rows = 0
        for b in self.child_batches(0, pid, ctx):
            if b.num_rows == 0:
                continue
            pending.append(b)
            pending_rows += b.num_rows
            if pending_rows >= target:
                yield self._concat(pending)
                pending, pending_rows = [], 0
        if pending:
            yield self._concat(pending)

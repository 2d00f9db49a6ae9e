"""Grouped aggregate: sort by key words, then one fold per group.

Counterpart of spark_rapids_tpu/exec/aggregate.py (TpuHashAggregateExec
and its _group_reduce).  Per batch: evaluate the grouping keys and the
update inputs, build order-preserving int64 key words, sort the live
rows stably by them (kernel K2), and reduce each group (kernel K3).
Across batches: concatenate the partial buffers, order them by key and
buffer words (the canonical keyed merge), and reduce again with the
merge ops.  COMPLETE and FINAL modes then evaluate the result
expressions over the buffers.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence, Tuple

import pyarrow as pa
import torch

from .. import kernels
from .. import types as t
from ..columnar.device import (DeviceBatch, DeviceColumn, batch_to_device,
                               bucket_for)
from ..columnar.interop import to_arrow_schema
from ..expr.aggregates import (COMPLETE, PARTIAL, AggregateExpression,
                               bind_aggregate)
from ..expr.core import (ColumnValue, EvalContext, Expression,
                         bind_expression, make_column, output_name)
from ..ops import segmented as seg
from ..ops.carry import sort_order
from ..ops.gather import gather_batch, gather_column
from .base import Exec, ExecContext
from .concat import concat_batches

_KIND_COUNT, _KIND_SUM_INT, _KIND_SUM_FLOAT = 0, 1, 2
_MAX_WORDS = _MAX_OPS = 16                     # kMaxWords / kMaxOps in csrc


# ---------------------------------------------------------------------------
# K3: grouped reduce over key-sorted rows
# ---------------------------------------------------------------------------

def segment_reduce_sorted_plain(sorted_words: Sequence[torch.Tensor],
                                live_sorted: torch.Tensor,
                                values: Sequence[Optional[torch.Tensor]],
                                contribs: Sequence[torch.Tensor],
                                global_agg: bool):
    """Plain version of K3, from boundaries, segment ids and index_add_.
    See ``segment_reduce_sorted`` for the result."""
    n = int(live_sorted.shape[0])
    dev = live_sorted.device
    if global_agg:
        groups = 1
        ids = torch.zeros(n, dtype=torch.int64, device=dev)
        first_row = torch.zeros(1, dtype=torch.int32, device=dev)
    else:
        new_group = seg.segment_boundaries(sorted_words, live_sorted)
        first_row = torch.nonzero(new_group).flatten().to(torch.int32)
        groups = int(first_row.shape[0])
        ids = seg.segment_ids(new_group).clamp(min=0).to(torch.int64)
    sums, counts = [], []
    for v, c in zip(values, contribs):
        idx = ids[c]

        def per_group(x, dtype):
            return torch.zeros(groups, dtype=dtype, device=dev).index_add_(
                0, idx, x.to(dtype))

        cnt = per_group(torch.ones_like(idx), torch.int64)
        counts.append(cnt)
        if v is None:
            sums.append(None)
            continue
        x = v[c]
        if v.dtype != torch.float64:
            sums.append(per_group(x, torch.int64))
            continue
        finite = torch.isfinite(x)
        s = per_group(torch.where(finite, x, torch.zeros_like(x)),
                      torch.float64)
        n_nan = per_group(torch.isnan(x), torch.int64)
        n_pi = per_group(x == float("inf"), torch.int64)
        n_ni = per_group(x == float("-inf"), torch.int64)
        s = torch.where((n_nan > 0) | ((n_pi > 0) & (n_ni > 0)),
                        torch.full_like(s, float("nan")), s)
        s = torch.where((n_pi > 0) & (n_ni == 0) & (n_nan == 0),
                        torch.full_like(s, float("inf")), s)
        s = torch.where((n_ni > 0) & (n_pi == 0) & (n_nan == 0),
                        torch.full_like(s, float("-inf")), s)
        sums.append(torch.where(cnt > 0, s, torch.zeros_like(s)))
    return first_row, sums, counts, groups


def segment_reduce_sorted(sorted_words: Sequence[torch.Tensor],
                          live_sorted: torch.Tensor,
                          values: Sequence[Optional[torch.Tensor]],
                          contribs: Sequence[torch.Tensor],
                          global_agg: bool):
    """Reduce key-sorted rows per group (K3).

    A group starts at a live row that is the first row or differs from
    the previous row in a key word; with ``global_agg`` all rows form one
    group.  Per op k, ``contribs[k]`` marks the rows that contribute and
    ``values[k]`` is the int64 or float64 lane to sum (None for a count).
    Returns (first_row int32[G], sums, counts int64[G], G): int64 sums
    wrap mod 2^64; float64 sums add the finite values and are NaN if any
    NaN or both infinities contribute, else +-inf if one does; a sum with
    no contributor is 0."""
    if live_sorted.device.type == "cpu":
        return segment_reduce_sorted_plain(sorted_words, live_sorted, values,
                                           contribs, global_agg)
    present = [v for v in values if v is not None]
    kernels.require_cuda("segment_reduce_sorted", live_sorted,
                         *sorted_words, *contribs, *present)
    n = int(live_sorted.shape[0])
    if len(sorted_words) > _MAX_WORDS or len(values) > _MAX_OPS:
        raise ValueError(f"segment_reduce_sorted: at most {_MAX_WORDS} key "
                         f"words and {_MAX_OPS} ops")
    if live_sorted.dtype != torch.bool or any(
            c.dtype != torch.bool or c.shape != (n,) for c in contribs):
        raise TypeError("segment_reduce_sorted: live and contributor masks "
                        f"must be bool[{n}]")
    if any(w.dtype != torch.int64 or w.shape != (n,) for w in sorted_words):
        raise TypeError(f"segment_reduce_sorted: key words must be int64[{n}]")
    if any(v.dtype not in (torch.int64, torch.float64) or v.shape != (n,)
           for v in present):
        raise TypeError("segment_reduce_sorted: values must be int64 or "
                        f"float64[{n}]")
    dev = live_sorted.device
    m = max(n, 1)
    lib = kernels.library("segment_reduce")
    kinds = [_KIND_COUNT if v is None else
             _KIND_SUM_FLOAT if v.dtype == torch.float64 else _KIND_SUM_INT
             for v in values]
    sums = [None if v is None else torch.empty(m, dtype=v.dtype, device=dev)
            for v in values]
    counts = [torch.empty(m, dtype=torch.int64, device=dev) for _ in values]
    first_row = torch.empty(m, dtype=torch.int32, device=dev)
    groups = torch.empty(1, dtype=torch.int32, device=dev)
    scratch = torch.empty(4 * kernels.num_tiles(lib, n) + m,
                          dtype=torch.int32, device=dev)
    kernels.check(lib, lib.srt_segment_reduce(
        kernels.pointers(sorted_words), len(sorted_words),
        live_sorted.data_ptr(), n, int(global_agg), len(values),
        kernels.pointers(values), kernels.pointers(contribs),
        kernels.ints(kinds), kernels.pointers(sums),
        kernels.pointers(counts), first_row.data_ptr(), groups.data_ptr(),
        scratch.data_ptr(), kernels.stream(live_sorted)),
        "segment_reduce_sorted")
    segment_reduce_sorted.launches += 1
    g = int(groups.item())
    return (first_row[:g], [None if s is None else s[:g] for s in sums],
            [c[:g] for c in counts], g)


segment_reduce_sorted.launches = 0


# ---------------------------------------------------------------------------
# the grouped reduce around K2 and K3
# ---------------------------------------------------------------------------

def _prefix(col: DeviceColumn, n: int) -> DeviceColumn:
    return DeviceColumn(col.dtype, col.data[:n], col.validity[:n])


def _padded(x: torch.Tensor, cap: int) -> torch.Tensor:
    out = torch.zeros(cap, dtype=x.dtype, device=x.device)
    out[:x.shape[0]] = x
    return out


def _group_reduce(key_cols: List[DeviceColumn],
                  value_cols: List[DeviceColumn], ops: List[str],
                  num_rows: int, global_agg: bool
                  ) -> Tuple[List[DeviceColumn], List[DeviceColumn], int]:
    """Group the first ``num_rows`` rows by ``key_cols`` and reduce each
    value column with its op (``sum`` or ``countvalid``).  Returns
    (key columns, value columns, group count); the outputs hold one row
    per group, padded to a capacity bucket.

    The reference sorts every row with a leading live word so padding
    sorts last; live rows are always a prefix here, so only the prefix
    is sorted, which gives the same order."""
    for op in ops:
        if op not in ("sum", "countvalid"):
            raise NotImplementedError(f"aggregate op {op!r} is not ported")
    n = num_rows
    keys = [_prefix(c, n) for c in key_cols]
    vals = [_prefix(c, n) for c in value_cols]
    words = [w for kc in keys for w in seg.key_words_for_column(kc)]
    order = sort_order(words) if words else None
    moved = {}

    def in_order(lane: torch.Tensor) -> torch.Tensor:
        # a lane in key order: only the lanes K3 reads are gathered, and
        # a lane several ops share (avg's sum and count) only once
        if order is None:
            return lane
        key = (lane.data_ptr(), lane.dtype)
        if key not in moved:
            moved[key] = lane.index_select(0, order)
        return moved[key]

    dev = vals[0].data.device if vals else keys[0].data.device
    live = torch.ones(n, dtype=torch.bool, device=dev)
    first_row, sums, counts, groups = segment_reduce_sorted(
        [in_order(w) for w in words], live,
        [in_order(v.data) if op == "sum" else None
         for v, op in zip(vals, ops)],
        [in_order(v.validity) for v in vals], global_agg)
    # each group's key is read at its first row, in input order
    first_in = first_row if order is None else order.index_select(
        0, first_row)
    cap = bucket_for(groups)
    out_keys = []
    for kc in keys:
        g = gather_column(kc, first_in)
        out_keys.append(DeviceColumn(kc.dtype, _padded(g.data, cap),
                                     _padded(g.validity, cap)))
    out_vals = []
    for vc, op, s, cnt in zip(vals, ops, sums, counts):
        if op == "countvalid":
            out_vals.append(DeviceColumn(
                t.LONG, _padded(cnt, cap),
                _padded(torch.ones_like(cnt, dtype=torch.bool), cap)))
        else:
            out_vals.append(DeviceColumn(vc.dtype, _padded(s, cap),
                                         _padded(cnt > 0, cap)))
    return out_keys, out_vals, groups


class GpuHashAggregateExec(Exec):
    """Grouped aggregate in PARTIAL, FINAL or COMPLETE mode."""

    # Canonical keyed merge: partial buffers are ordered by key and buffer
    # value words before the merge folds them, so float sums do not depend
    # on batch arrival order (the reference's tpudsan determinism class).
    stable_merge: bool = True

    def __init__(self, grouping: Sequence[Expression],
                 aggregates: Sequence[AggregateExpression], mode: str,
                 child: Exec):
        super().__init__([child])
        self.grouping = list(grouping)
        cn, ct = child.output_names, child.output_types
        if mode in (PARTIAL, COMPLETE):
            self.aggregates = [bind_aggregate(a, cn, ct) for a in aggregates]
        else:
            self.aggregates = list(aggregates)   # FINAL: pre-bound
        self.mode = mode
        self._group_names = [output_name(g) for g in self.grouping]
        if mode in (PARTIAL, COMPLETE):
            self._bound_grouping = [bind_expression(g, cn, ct)
                                    for g in self.grouping]
            self._update_inputs, self._update_ops = [], []
            for ae in self.aggregates:
                for expr, op in ae.func.update():
                    self._update_inputs.append(bind_expression(expr, cn, ct))
                    self._update_ops.append(op)
        self._buffer_names, self._buffer_types, self._merge_ops = [], [], []
        for i, ae in enumerate(self.aggregates):
            for j, bt in enumerate(ae.func.buffer_types()):
                self._buffer_names.append(f"buf{i}_{j}")
                self._buffer_types.append(bt)
            self._merge_ops += ae.func.merge_ops()

    def _key_types(self) -> List[t.DataType]:
        if self.mode in (PARTIAL, COMPLETE):
            return [g.data_type() for g in self._bound_grouping]
        return self.children[0].output_types[:len(self.grouping)]

    @property
    def output_names(self):
        if self.mode == PARTIAL:
            return self._group_names + self._buffer_names
        return self._group_names + [ae.name for ae in self.aggregates]

    @property
    def output_types(self):
        if self.mode == PARTIAL:
            return self._key_types() + self._buffer_types
        return self._key_types() + [ae.data_type() for ae in self.aggregates]

    def describe(self):
        return (f"GpuHashAggregate(mode={self.mode}, keys="
                f"[{', '.join(self._group_names)}], fns="
                f"[{', '.join(a.name for a in self.aggregates)}])")

    # --- per-batch programs -------------------------------------------------
    def _update_columns(self, batch: DeviceBatch):
        """(grouping key columns, update input columns) of a batch."""
        ctx = EvalContext(batch)
        key_cols = [g.eval(ctx).col for g in self._bound_grouping]
        val_cols = []
        for b in self._update_inputs:
            v = b.eval(ctx)
            if not isinstance(v, ColumnValue):
                v = make_column(ctx, b.data_type(), v.value,
                                None if v.value is not None else False)
            val_cols.append(v.col)
        return key_cols, val_cols

    def _update_batch(self, batch: DeviceBatch) -> DeviceBatch:
        key_cols, val_cols = self._update_columns(batch)
        ok, ov, n = _group_reduce(key_cols, val_cols, self._update_ops,
                                  batch.num_rows, not self.grouping)
        return DeviceBatch(ok + ov, n, self._group_names + self._buffer_names)

    def _merge_batch(self, batch: DeviceBatch) -> DeviceBatch:
        if self.stable_merge:
            batch = self._canonicalize_merge_input(batch)
        k = len(self.grouping)
        ok, ov, n = _group_reduce(list(batch.columns[:k]),
                                  list(batch.columns[k:]), self._merge_ops,
                                  batch.num_rows, not self.grouping)
        return DeviceBatch(ok + ov, n, self._group_names + self._buffer_names)

    def _canonicalize_merge_input(self, batch: DeviceBatch) -> DeviceBatch:
        """The live rows ordered by key and buffer value words, so the fold
        order within a group is a function of content (stable_merge)."""
        n = batch.num_rows
        live = DeviceBatch([_prefix(c, n) for c in batch.columns], n,
                           batch.names)
        words = [w for c in live.columns
                 for w in seg.key_words_for_column(c)]
        return gather_batch(live, seg.lexsort(words), None, n)

    def _evaluate_batch(self, batch: DeviceBatch) -> DeviceBatch:
        k = len(self.grouping)
        ctx = EvalContext(batch)
        out_cols = list(batch.columns[:k])
        pos = k
        for ae in self.aggregates:
            nb = len(ae.func.buffer_types())
            bufs = [ColumnValue(batch.columns[pos + j]) for j in range(nb)]
            out_cols.append(ae.func.evaluate(ctx, bufs).col)
            pos += nb
        return DeviceBatch(out_cols, batch.num_rows, self.output_names)

    # --- execution ----------------------------------------------------------
    def execute_partition(self, pid, ctx: ExecContext
                          ) -> Iterator[DeviceBatch]:
        it = iter(self.children[0].execute_partition(pid, ctx))
        first = next(it, None)
        second = next(it, None) if first is not None else None
        if first is not None and second is None and \
                self.mode in (PARTIAL, COMPLETE):
            # one input batch leaves unique keys: the merge would be a no-op
            out = self._update_batch(first)
            yield self._evaluate_batch(out) if self.mode == COMPLETE else out
            return
        partials = []
        for b in itertools.chain([x for x in (first, second)
                                  if x is not None], it):
            partials.append(self._update_batch(b)
                            if self.mode in (PARTIAL, COMPLETE) else b)
        if not partials:
            if self.grouping:
                return
            # a global aggregate over no input still yields one row
            child = self.children[0]
            empty = to_arrow_schema(child.output_names, child.output_types)
            rb = pa.RecordBatch.from_arrays(
                [pa.array([], type=f.type) for f in empty], schema=empty)
            partials = [self._update_batch(batch_to_device(rb, ctx.device))]
        names = self._group_names + self._buffer_names
        types = self._key_types() + self._buffer_types
        merged_in = partials[0] if len(partials) == 1 else \
            concat_batches(partials, names, types)
        out = self._merge_batch(merged_in)
        yield out if self.mode == PARTIAL else self._evaluate_batch(out)


"""Grouped aggregate: sort by key words, then one fold per group.

Counterpart of spark_rapids_tpu/exec/aggregate.py (TpuHashAggregateExec
and its _group_reduce).  Per batch: evaluate the grouping keys and the
update inputs, build order-preserving int64 key words, sort the live
rows stably by them (kernel K2), and reduce each group (kernel K3),
which reads the lanes through K2's order: no lane is gathered into key
order first.  Across batches: concatenate the partial buffers, order
them by key and buffer words (the canonical keyed merge), and reduce
again through that order with the merge ops.  COMPLETE and FINAL modes
then evaluate the result expressions over the buffers.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence, Tuple

import pyarrow as pa
import torch

from .. import kernels
from .. import types as t
from ..analysis.determinism import ORDER_DEPENDENT, ORDER_STABLE, Determinism
from ..columnar.device import (DeviceBatch, DeviceColumn, batch_to_device,
                               bucket_for)
from ..columnar.interop import to_arrow_schema
from ..expr.aggregates import (COMPLETE, PARTIAL, AggregateExpression,
                               bind_aggregate)
from ..expr.core import (ColumnValue, EvalContext, Expression,
                         bind_expression, make_column, output_name)
from ..ops import segmented as seg
from ..ops.carry import sort_order
from ..ops.gather import gather_column
from .base import Exec, ExecContext
from .concat import concat_batches

_KIND_COUNT, _KIND_SUM_INT, _KIND_SUM_FLOAT = 0, 1, 2


# ---------------------------------------------------------------------------
# K3: grouped reduce over rows read in key order
# ---------------------------------------------------------------------------

def segment_reduce_sorted_plain(words: Sequence[torch.Tensor],
                                live: Optional[torch.Tensor],
                                values: Sequence[Optional[torch.Tensor]],
                                contribs: Sequence[torch.Tensor],
                                global_agg: bool,
                                order: Optional[torch.Tensor] = None):
    """Plain version of K3: the lanes put in key order by index_select,
    then boundaries, segment ids and index_add_.  See
    ``segment_reduce_sorted`` for the arguments and the result."""
    if order is not None:
        idx = order.to(torch.int64)
        words = [w.index_select(0, idx) for w in words]
        live = None if live is None else live.index_select(0, idx)
        values = [None if v is None else v.index_select(0, idx)
                  for v in values]
        contribs = [c.index_select(0, idx) for c in contribs]
    lanes = _lanes(words, live, values, contribs)
    n, dev = int(lanes[0].shape[0]), lanes[0].device
    if live is None:
        live = torch.ones(n, dtype=torch.bool, device=dev)
    if global_agg:
        groups = 1
        ids = torch.zeros(n, dtype=torch.int64, device=dev)
        first_row = torch.zeros(1, dtype=torch.int32, device=dev)
    else:
        new_group = seg.segment_boundaries(words, live)
        first_row = torch.nonzero(new_group).flatten().to(torch.int32)
        groups = int(first_row.shape[0])
        ids = seg.segment_ids(new_group).to(torch.int64)
    grouped = ids >= 0            # rows before the first start: no group
    sums, counts = [], []
    for v, c in zip(values, contribs):
        c = c & grouped
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
    if order is not None and n > 0:
        first_row = order.index_select(0, first_row.to(torch.int64))
    return first_row, sums, counts, groups


def _lanes(words, live, values, contribs) -> List[torch.Tensor]:
    lanes = [x for x in (*words, live, *values, *contribs) if x is not None]
    if not lanes:
        raise ValueError("segment_reduce_sorted needs a key word, the live "
                         "flags or an op")
    return lanes


def segment_reduce_sorted(words: Sequence[torch.Tensor],
                          live: Optional[torch.Tensor],
                          values: Sequence[Optional[torch.Tensor]],
                          contribs: Sequence[torch.Tensor],
                          global_agg: bool,
                          order: Optional[torch.Tensor] = None):
    """Reduce rows per group, reading them in key order (K3).

    Every lane is in input order; ``order`` (int32, K2's permutation)
    puts them in key order -- sorted row i is input row ``order[i]`` --
    or is None when they already are.  A group starts at a live row
    (``live`` None: every row) that is the first sorted row or differs
    from the previous one in a key word; rows before the first start
    belong to no group; with ``global_agg`` all rows form one group.  Per
    op k, ``contribs[k]`` marks the rows that contribute and
    ``values[k]`` is the int64 or float64 lane to sum (None for a count).
    Returns (first_row int32[G], sums, counts int64[G], G), groups in key
    order, ``first_row[g]`` the input row of group g's first sorted row:
    int64 sums wrap mod 2^64; float64 sums add the finite values and are
    NaN if any NaN or both infinities contribute, else +-inf if one
    does; a sum with no contributor is 0."""
    lanes = _lanes(words, live, values, contribs)
    if order is not None:
        lanes.append(order)
    if lanes[0].device.type == "cpu":
        return segment_reduce_sorted_plain(words, live, values, contribs,
                                           global_agg, order)
    kernels.require_cuda("segment_reduce_sorted", *lanes)
    n = int(lanes[0].shape[0])
    if any(c.dtype != torch.bool or c.shape != (n,)
           for c in [*contribs, *([] if live is None else [live])]):
        raise TypeError("segment_reduce_sorted: live and contributor masks "
                        f"must be bool[{n}]")
    if any(w.dtype != torch.int64 or w.shape != (n,) for w in words):
        raise TypeError(f"segment_reduce_sorted: key words must be int64[{n}]")
    present = [v for v in values if v is not None]
    if any(v.dtype not in (torch.int64, torch.float64) or v.shape != (n,)
           for v in present):
        raise TypeError("segment_reduce_sorted: values must be int64 or "
                        f"float64[{n}]")
    if order is not None and (order.dtype != torch.int32
                              or order.shape != (n,)):
        raise TypeError(f"segment_reduce_sorted: order must be int32[{n}]")
    dev = lanes[0].device
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
    scratch = torch.empty(
        max(lib.srt_segment_reduce_scratch_bytes(n, len(words),
                                                 len(values)) // 8, 1),
        dtype=torch.int64, device=dev)
    word_ptrs = kernels.device_int64s([w.data_ptr() for w in words], dev)
    kernels.check(lib, lib.srt_segment_reduce(
        word_ptrs.data_ptr(), len(words),
        None if live is None else live.data_ptr(),
        None if order is None else order.data_ptr(), n, int(global_agg),
        len(values), kernels.pointers(values), kernels.pointers(contribs),
        kernels.ints(kinds), kernels.pointers(sums),
        kernels.pointers(counts), first_row.data_ptr(), groups.data_ptr(),
        scratch.data_ptr(), kernels.stream(lanes[0])),
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


def k3_ops(vals: List[DeviceColumn], ops: List[str]):
    """K3's value lanes and contributor masks for ``vals`` reduced by
    ``ops``, and for each op the index of the K3 op whose result it
    takes.  A count of a lane's valid rows is also the contributor count
    of an earlier op over the same validity lane (avg's sum and count),
    so K3 folds that lane once."""
    k3_vals, k3_contribs, take, by_lane = [], [], [], {}
    for v, op in zip(vals, ops):
        lane = v.validity.data_ptr()
        if op == "countvalid" and lane in by_lane:
            take.append(by_lane[lane])
            continue
        by_lane.setdefault(lane, len(k3_vals))
        take.append(len(k3_vals))
        k3_vals.append(v.data if op == "sum" else None)
        k3_contribs.append(v.validity)
    return k3_vals, k3_contribs, take


def _group_reduce(key_cols: List[DeviceColumn],
                  value_cols: List[DeviceColumn], ops: List[str],
                  num_rows: int, global_agg: bool,
                  order: Optional[torch.Tensor] = None
                  ) -> Tuple[List[DeviceColumn], List[DeviceColumn], int]:
    """Group the first ``num_rows`` rows by ``key_cols`` and reduce each
    value column with its op (``sum`` or ``countvalid``).  ``order``, when
    given, is a permutation that already sorts the rows by key; else the
    rows are sorted here (K2).  Returns (key columns, value columns, group
    count); the outputs hold one row per group, padded to a capacity
    bucket.

    The reference sorts every row with a leading live word so padding
    sorts last, and carries every lane through the sort; live rows are
    always a prefix here, so only the prefix is sorted, which gives the
    same order, and K3 reads the lanes through the order."""
    for op in ops:
        if op not in ("sum", "countvalid"):
            raise NotImplementedError(f"aggregate op {op!r} is not ported")
    n = num_rows
    keys = [_prefix(c, n) for c in key_cols]
    vals = [_prefix(c, n) for c in value_cols]
    words = [w for kc in keys for w in seg.key_words_for_column(kc)]
    if order is None and words:
        order = sort_order(words)
    k3_vals, k3_contribs, take = k3_ops(vals, ops)
    first_row, sums, counts, groups = segment_reduce_sorted(
        words, None, k3_vals, k3_contribs, global_agg, order)
    cap = bucket_for(groups)
    out_keys = []
    for kc in keys:
        # each group's key is read at its first row, in input order
        g = gather_column(kc, first_row)
        out_keys.append(DeviceColumn(kc.dtype, _padded(g.data, cap),
                                     _padded(g.validity, cap)))
    out_vals = []
    for vc, op, i in zip(vals, ops, take):
        s, cnt = sums[i], counts[i]
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
    # on batch arrival order (``determinism()``).
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

    def determinism(self):
        scoped = self.mode == PARTIAL   # partial buffers regroup with the
        #                                 input split
        if any(bt == t.DOUBLE for bt in self._buffer_types) and \
                not self.stable_merge:
            return Determinism(
                ORDER_DEPENDENT, "float partial buffers fold in batch "
                "arrival order (stable_merge off): a different arrival "
                "order changes the sums", partition_scoped=scoped,
                canonicalizable=True)
        return Determinism(
            ORDER_STABLE, "group emission order follows arrival; the "
            "canonical keyed merge makes buffer folds "
            "content-determined", partition_scoped=scoped)

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
        k = len(self.grouping)
        order = self._canonical_order(batch) if self.stable_merge else None
        ok, ov, n = _group_reduce(list(batch.columns[:k]),
                                  list(batch.columns[k:]), self._merge_ops,
                                  batch.num_rows, not self.grouping, order)
        return DeviceBatch(ok + ov, n, self._group_names + self._buffer_names)

    def _canonical_order(self, batch: DeviceBatch) -> torch.Tensor:
        """The live rows' order by key and buffer value words, so the fold
        order within a group is a function of content (stable_merge).  The
        key words lead, so the order also sorts the rows by key, as the
        stable key sort of rows put in this order would."""
        n = batch.num_rows
        words = [w for c in batch.columns
                 for w in seg.key_words_for_column(_prefix(c, n))]
        return seg.lexsort(words)

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


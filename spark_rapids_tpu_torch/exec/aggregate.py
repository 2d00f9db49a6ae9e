"""Grouped aggregate: sort by key words, then one fold per group; and the
host engine's aggregate.

Counterpart of spark_rapids_tpu/exec/aggregate.py (TpuHashAggregateExec
and its _group_reduce, CpuHashAggregateExec).  Per batch: evaluate the grouping keys and the
update inputs, build order-preserving int64 key words, sort the live
rows stably by them (kernel K2), and reduce each group (kernel K3: sums,
counts, min and max),
which reads the lanes through K2's order: no lane is gathered into key
order first.  Across batches: concatenate the partial buffers, order
them by key and buffer words (the canonical keyed merge), and reduce
again through that order with the merge ops.  COMPLETE and FINAL modes
then evaluate the result expressions over the buffers.
CpuHashAggregateExec is the complete-mode aggregate the plan rewrite
starts from and keeps on the CPU where tagging says so: pyarrow's
group_by over the host-evaluated keys and inputs.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence, Tuple

import pyarrow as pa
import pyarrow.compute as pc
import torch

from .. import kernels
from .. import types as t
from ..analysis.determinism import ORDER_DEPENDENT, ORDER_STABLE, Determinism
from ..columnar.device import (DeviceBatch, DeviceColumn, batch_to_device,
                               bucket_for, column_to_arrow)
from ..columnar.interop import to_arrow_schema, to_arrow_type
from ..expr.aggregates import (COMPLETE, PARTIAL, AggregateExpression,
                               Average, Count, Max, Min, Sum, bind_aggregate)
from ..expr.core import (ColumnValue, EvalContext, Expression, ScalarValue,
                         bind_expression, make_column, output_name)
from ..ops import segmented as seg
from ..ops.carry import sort_order
from ..ops.gather import gather_columns
from .base import CPU, Exec, ExecContext
from .concat import concat_batches

_KIND_COUNT, _KIND_SUM_INT, _KIND_SUM_FLOAT = 0, 1, 2
# min / max of an int64 lane, then of a float64 lane
_KIND_EXTREME = {("min", False): 3, ("max", False): 4, ("min", True): 5,
                 ("max", True): 6}


# ---------------------------------------------------------------------------
# K3: grouped reduce over rows read in key order
# ---------------------------------------------------------------------------

def _op_names(values, ops) -> List[str]:
    """Each op's name: ``count`` for a None value, else ``ops[k]`` (sum,
    min or max; every value sums when ``ops`` is None)."""
    if ops is None:
        ops = ["sum"] * len(values)
    if len(ops) != len(values):
        raise ValueError("segment_reduce_sorted: one op per value lane")
    names = []
    for v, op in zip(values, ops):
        if v is None:
            names.append("count")
        elif op in ("sum", "min", "max"):
            names.append(op)
        else:
            raise ValueError(f"segment_reduce_sorted: op {op!r}")
    return names


def segment_reduce_sorted_plain(words: Sequence[torch.Tensor],
                                live: Optional[torch.Tensor],
                                values: Sequence[Optional[torch.Tensor]],
                                contribs: Sequence[torch.Tensor],
                                global_agg: bool,
                                order: Optional[torch.Tensor] = None,
                                ops: Optional[Sequence[str]] = None):
    """Plain version of K3: the lanes put in key order by index_select,
    then boundaries, segment ids, index_add_ and, for min and max,
    ``ops/segmented.py:segment_reduce``.  See ``segment_reduce_sorted``
    for the arguments and the result."""
    names = _op_names(values, ops)
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
    for v, c, op in zip(values, contribs, names):
        if op in ("min", "max"):
            out, cnt = seg.segment_reduce(op, v, ids, groups, c & grouped)
            sums.append(out)
            counts.append(cnt)
            continue
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
                          order: Optional[torch.Tensor] = None,
                          ops: Optional[Sequence[str]] = None):
    """Reduce rows per group, reading them in key order (K3).

    Every lane is in input order; ``order`` (int32, K2's permutation)
    puts them in key order -- sorted row i is input row ``order[i]`` --
    or is None when they already are.  A group starts at a live row
    (``live`` None: every row) that is the first sorted row or differs
    from the previous one in a key word; rows before the first start
    belong to no group; with ``global_agg`` all rows form one group.  Per
    op k, ``contribs[k]`` marks the rows that contribute and
    ``values[k]`` is the int64 or float64 lane to reduce (None for a
    count) by ``ops[k]``: ``sum`` (every op when ``ops`` is None),
    ``min`` or ``max``.  Returns (first_row int32[G], sums, counts
    int64[G], G), groups in key order, ``first_row[g]`` the input row of
    group g's first sorted row: int64 sums wrap mod 2^64; float64 sums
    add the finite values and are NaN if any NaN or both infinities
    contribute, else +-inf if one does; a min or max is the value, bit
    for bit, of the group's earliest sorted row whose ordered word
    (``ops/segmented.py:ordered_word``) is the extreme; a result with no
    contributor is 0."""
    names = _op_names(values, ops)
    lanes = _lanes(words, live, values, contribs)
    if order is not None:
        lanes.append(order)
    if lanes[0].device.type == "cpu":
        return segment_reduce_sorted_plain(words, live, values, contribs,
                                           global_agg, order, ops)
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
    kinds = [_KIND_COUNT if op == "count" else
             _KIND_EXTREME[op, v.dtype == torch.float64]
             if op in ("min", "max") else
             _KIND_SUM_FLOAT if v.dtype == torch.float64 else _KIND_SUM_INT
             for v, op in zip(values, names)]
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
    if col.offsets is not None:
        return DeviceColumn(col.dtype, col.data, col.validity[:n],
                            col.offsets[:n + 1])
    return DeviceColumn(col.dtype, col.data[:n], col.validity[:n])


def _padded(x: torch.Tensor, cap: int) -> torch.Tensor:
    out = torch.zeros(cap, dtype=x.dtype, device=x.device)
    out[:x.shape[0]] = x
    return out


def _padded_column(col: DeviceColumn, cap: int) -> DeviceColumn:
    """A column of G rows padded to ``cap`` rows; a string's offsets
    repeat its last offset."""
    if col.offsets is None:
        return DeviceColumn(col.dtype, _padded(col.data, cap),
                            _padded(col.validity, cap))
    g = col.offsets.shape[0] - 1
    offs = torch.empty(cap + 1, dtype=col.offsets.dtype,
                       device=col.offsets.device)
    offs[:g + 1] = col.offsets
    offs[g + 1:] = col.offsets[g]
    return DeviceColumn(col.dtype, col.data, _padded(col.validity, cap),
                        offs)


def _ordered_pick(words: List[torch.Tensor], col: DeviceColumn, op: str,
                  global_agg: bool, order: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """The reference's ordered reduce for a string min or max
    (``exec/aggregate.py`` _group_reduce): the rows sorted by (key words,
    not contributing, value words, descending for max) through K2, and
    each group's first row in that order is its extreme; K3 reads the
    first rows.  With ``order`` (the canonical merge order) the second
    sort breaks its ties in that order.  Returns int32[G], the input row
    of each group's pick."""
    vwords = seg.sort_key_words(col, ascending=op == "min")[1:]
    words2 = list(words) + [(~col.validity).to(torch.int64)] + vwords
    if order is None:
        order2 = sort_order(words2)
    else:
        idx = order.to(torch.int64)
        order2 = order.index_select(0, sort_order(
            [w.index_select(0, idx) for w in words2]).to(torch.int64))
    first_row, _, _, _ = segment_reduce_sorted(
        words, None, [None], [col.validity], global_agg, order2)
    return first_row


def _extreme_lane(col: DeviceColumn) -> torch.Tensor:
    """A min/max input as K3 reads it: float64 as it is, any other flat
    type widened to int64."""
    if col.data.dtype == torch.float64:
        return col.data
    return col.data.to(torch.int64)


def k3_ops(vals: List[DeviceColumn], ops: List[str]):
    """K3's value lanes, contributor masks and op names for ``vals``
    reduced by ``ops`` (sum, countvalid, min, max), and for each op the
    index of the K3 op whose result it takes.  A count of a lane's valid
    rows is also the contributor count of an earlier op over the same
    validity lane (avg's sum and count), so K3 folds that lane once."""
    k3_vals, k3_contribs, k3_names, take, by_lane = [], [], [], [], {}
    for v, op in zip(vals, ops):
        lane = v.validity.data_ptr()
        if op == "countvalid" and lane in by_lane:
            take.append(by_lane[lane])
            continue
        by_lane.setdefault(lane, len(k3_vals))
        take.append(len(k3_vals))
        if op == "countvalid" or v.offsets is not None:
            # a string min or max: K3 counts its contributors, and the
            # value comes from the ordered pick (_ordered_pick)
            k3_vals.append(None)
            k3_names.append("sum")
            k3_contribs.append(v.validity)
            continue
        elif op == "sum":
            k3_vals.append(v.data)
        else:
            k3_vals.append(_extreme_lane(v))
        k3_names.append("sum" if op == "countvalid" else op)
        k3_contribs.append(v.validity)
    return k3_vals, k3_contribs, k3_names, take


def _group_reduce(key_cols: List[DeviceColumn],
                  value_cols: List[DeviceColumn], ops: List[str],
                  num_rows: int, global_agg: bool,
                  order: Optional[torch.Tensor] = None
                  ) -> Tuple[List[DeviceColumn], List[DeviceColumn], int]:
    """Group the first ``num_rows`` rows by ``key_cols`` and reduce each
    value column with its op (``sum``, ``countvalid``, ``min`` or
    ``max``; a min or max keeps the column's type).  ``order``, when
    given, is a permutation that already sorts the rows by key; else the
    rows are sorted here (K2).  Returns (key columns, value columns, group
    count); the outputs hold one row per group, padded to a capacity
    bucket.

    The reference sorts every row with a leading live word so padding
    sorts last, and carries every lane through the sort; live rows are
    always a prefix here, so only the prefix is sorted, which gives the
    same order, and K3 reads the lanes through the order."""
    for op in ops:
        if op not in ("sum", "countvalid", "min", "max"):
            raise NotImplementedError(
                f"aggregate op {op!r} is not ported (the grouped first and "
                f"last wait for P8)")
    n = num_rows
    keys = [_prefix(c, n) for c in key_cols]
    vals = [_prefix(c, n) for c in value_cols]
    words = [w for kc in keys for w in seg.key_words_for_column(kc)]
    if order is None and words:
        order = sort_order(words)
    k3_vals, k3_contribs, k3_names, take = k3_ops(vals, ops)
    first_row, sums, counts, groups = segment_reduce_sorted(
        words, None, k3_vals, k3_contribs, global_agg, order, k3_names)
    cap = bucket_for(groups)
    # each group's key is read at its first row, in input order
    out_keys = [_padded_column(g, cap)
                for g in gather_columns(keys, first_row)]
    out_vals = []
    for vc, op, i in zip(vals, ops, take):
        s, cnt = sums[i], counts[i]
        if vc.offsets is not None and op in ("min", "max"):
            pick = _ordered_pick(words, vc, op, global_agg, order)
            out_vals.append(_padded_column(
                gather_columns([vc], pick, cnt > 0)[0], cap))
        elif op == "countvalid":
            out_vals.append(DeviceColumn(
                t.LONG, _padded(cnt, cap),
                _padded(torch.ones_like(cnt, dtype=torch.bool), cap)))
        elif op in ("min", "max"):
            out_vals.append(DeviceColumn(
                vc.dtype, _padded(s.to(vc.dtype.torch_dtype), cap),
                _padded(cnt > 0, cap)))
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
        it = iter(self.child_batches(0, pid, ctx))
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
            partials = [self._update_batch(
                batch_to_device(rb, self.device(ctx)))]
        names = self._group_names + self._buffer_names
        types = self._key_types() + self._buffer_types
        merged_in = partials[0] if len(partials) == 1 else \
            concat_batches(partials, names, types)
        out = self._merge_batch(merged_in)
        yield out if self.mode == PARTIAL else self._evaluate_batch(out)



# ---------------------------------------------------------------------------
# the host engine's aggregate: pyarrow group_by
# ---------------------------------------------------------------------------

_PA_AGG = {Sum: "sum", Count: "count", Average: "mean", Min: "min",
           Max: "max"}
_PA_SCALAR = {"sum": pc.sum, "count": pc.count, "mean": pc.mean,
              "min": pc.min, "max": pc.max}


class CpuHashAggregateExec(Exec):
    """Complete-mode aggregate on pyarrow (the 'Spark CPU' role): the
    grouping keys and aggregate inputs are evaluated on CPU tensors, then
    pyarrow groups them.  Groups come out in arrival order."""

    placement = CPU

    def __init__(self, grouping: Sequence[Expression],
                 aggregates: Sequence[AggregateExpression], child: Exec):
        super().__init__([child])
        self.grouping = list(grouping)
        cn, ct = child.output_names, child.output_types
        self.aggregates = [bind_aggregate(a, cn, ct) for a in aggregates]
        self._bound_grouping = [bind_expression(g, cn, ct) for g in grouping]
        self._group_names = [output_name(g) for g in grouping]

    @property
    def output_names(self):
        return self._group_names + [a.name for a in self.aggregates]

    @property
    def output_types(self):
        return [g.data_type() for g in self._bound_grouping] + \
            [a.data_type() for a in self.aggregates]

    def describe(self):
        return (f"CpuHashAggregate(keys=[{', '.join(self._group_names)}], "
                f"fns=[{', '.join(a.name for a in self.aggregates)}])")

    def determinism(self):
        floaty = any(bt == t.DOUBLE for ae in self.aggregates
                     for bt in ae.func.buffer_types())
        if floaty:
            return Determinism(
                ORDER_DEPENDENT, "pyarrow group_by folds the table in "
                "batch-arrival row order (no canonical merge on the "
                "host fallback)")
        return Determinism(
            ORDER_STABLE, "integer/decimal folds are exact; group "
            "emission order follows arrival")

    def _input_table(self, b: DeviceBatch) -> pa.Table:
        """The batch's grouping keys and aggregate inputs as Arrow
        columns ``<key name>`` and ``__in<i>``."""
        ec = EvalContext(b)
        n = b.num_rows
        cols = {}
        for g, nm in zip(self._bound_grouping, self._group_names):
            cols[nm] = column_to_arrow(g.eval(ec).col, n)
        for i, ae in enumerate(self.aggregates):
            fn = ae.func
            if fn.children:
                v = fn.child.eval(ec)
                if isinstance(v, ScalarValue):
                    v = make_column(ec, fn.child.data_type(),
                                    v.value if v.value is not None else 0,
                                    None if v.value is not None else False)
                cols[f"__in{i}"] = column_to_arrow(v.col, n)
            else:
                cols[f"__in{i}"] = pa.array([1] * n, type=pa.int64())
        return pa.table(cols)

    def _empty_input(self) -> pa.Table:
        names = self._group_names + [f"__in{i}" for i in
                                     range(len(self.aggregates))]
        dtypes = [g.data_type() for g in self._bound_grouping] + \
            [a.func.child.data_type() if a.func.children else t.INT
             for a in self.aggregates]
        return pa.table({nm: pa.array([], to_arrow_type(dt))
                         for nm, dt in zip(names, dtypes)})

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        tables = [self._input_table(b)
                  for b in self.child_batches(0, pid, ctx)]
        if not tables:
            if self.grouping:
                return
            tables = [self._empty_input()]
        table = pa.concat_tables(tables)
        for ae in self.aggregates:
            if type(ae.func) not in _PA_AGG:
                raise NotImplementedError(
                    f"aggregate {type(ae.func).__name__} is not ported (the "
                    f"grouped first and last wait for P8)")
        aggs = [(f"__in{i}", _PA_AGG[type(ae.func)], None)
                for i, ae in enumerate(self.aggregates)]
        if self.grouping:
            res = pa.TableGroupBy(table, self._group_names,
                                  use_threads=False).aggregate(aggs)
        elif table.num_rows == 0:
            # Spark: a global aggregate over empty input yields one row
            cols = {}
            for cname, kind, _ in aggs:
                scalar = _PA_SCALAR[kind](table.column(cname))
                cols[f"{cname}_{kind}"] = pa.array([scalar.as_py()],
                                                   type=scalar.type)
            res = pa.table(cols)
        else:
            res = pa.TableGroupBy(
                table.append_column("__g", pa.array([1] * table.num_rows)),
                ["__g"], use_threads=False).aggregate(aggs)
            res = res.drop_columns(["__g"])
        out_cols = [res.column(nm) for nm in self._group_names]
        for (cname, kind, _), ae in zip(aggs, self.aggregates):
            out_cols.append(res.column(f"{cname}_{kind}").cast(
                to_arrow_type(ae.data_type())))
        out = pa.table(dict(zip(self.output_names, out_cols)))
        for rb in out.combine_chunks().to_batches():
            yield batch_to_device(rb, self.device(ctx))

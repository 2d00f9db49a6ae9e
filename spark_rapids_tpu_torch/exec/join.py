"""Join operators and their planning.

Counterpart of spark_rapids_tpu/exec/join.py (HashJoinExec,
NestedLoopJoinExec, CpuJoinExec, split_equi_condition, plan_join).  An
equi-join hashes the build side's keys into one 64-bit word per row
(kernel K6), sorts the hashes (K2) and builds K4's hash table over
them, once per build side; then, per probe batch: hashes each probe row's keys and finds its match range in
one kernel (K4), sums the output rows per probe row (K7), reads their
total on the host once, and expands the pairs at a capacity bucket of
that total, gathering both sides' columns in the same kernel (K5).  The
build side is always the right child; a right join is planned flipped.
Output row order follows the probe side, and a probe row's build rows
come in sorted-hash order, as in the reference, so the two agree row for
row.

``plan_join`` plans a CpuJoinExec, the host engine's join (pyarrow),
with a broadcast or shuffle exchange under it where a side has more
than one partition; the plan rewrite (plan/overrides.py) turns it into
a device join where tagging allows.

A string key hashes to one word (K14's ``h1 ^ (h2 * MIX)``), which K6
and K4 mix and fold like any key.  String payloads do not go through
K5: they follow its pair indices through K16, their byte totals sized
as the reference's count phase sizes them and read in the same host
read as the pair total (``_expand``).  Not ported yet: the speculative
sizing that fuses count and expand on the TPU (the same output, one
host sync fewer).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from ..analysis.determinism import ORDER_STABLE, Determinism
from ..columnar.device import (DeviceBatch, batch_to_arrow, batch_to_device,
                               bucket_for, column_to_arrow)
from ..columnar.interop import to_arrow_schema
from ..expr.conditional import Coalesce
from ..expr.core import (Alias, AttributeReference, BoundReference,
                         ColumnValue, EvalContext, Expression, ScalarValue,
                         all_null_column, bind_expression, make_column)
from ..expr.predicates import And, EqualTo
from ..ops import join_kernels as jk
from ..ops.carry import mask_validity
from ..ops.gather import gather_columns
from ..ops.strings import lengths
from .base import CPU, MERGES, Exec, ExecContext
from .basic import ProjectExec
from .concat import concat_batches
from .filter_common import apply_filter, compact

JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
              "cross")


def _attribute_names(e: Expression) -> set:
    if isinstance(e, AttributeReference):
        return {e.name}
    return set().union(*(_attribute_names(c) for c in e.children))


def split_equi_condition(cond: Optional[Expression], left_names, right_names
                         ) -> Tuple[List[Expression], List[Expression],
                                    Optional[Expression]]:
    """Split a join condition into equi key pairs and a residual (Spark's
    ExtractEquiJoinKeys): a top-level conjunct ``a = b`` with one side
    over left columns only and the other over right columns only is a
    key pair."""
    lset, rset = set(left_names), set(right_names)
    conjuncts: List[Expression] = []

    def flatten(e):
        if isinstance(e, And):
            flatten(e.children[0])
            flatten(e.children[1])
        else:
            conjuncts.append(e)
    if cond is not None:
        flatten(cond)
    lkeys, rkeys, residual = [], [], []
    for c in conjuncts:
        if isinstance(c, EqualTo):
            a, b = c.children
            ra, rb = _attribute_names(a), _attribute_names(b)
            if ra <= lset and rb <= rset and ra and rb:
                lkeys.append(a)
                rkeys.append(b)
                continue
            if ra <= rset and rb <= lset and ra and rb:
                lkeys.append(b)
                rkeys.append(a)
                continue
        residual.append(c)
    res = None
    for c in residual:
        res = c if res is None else And(res, c)
    return lkeys, rkeys, res


def _live(batch: DeviceBatch) -> torch.Tensor:
    return torch.arange(batch.capacity, device=batch.device) < batch.num_rows


def _column(ctx: EvalContext, e: Expression, v):
    """A column from an expression's value (a literal is broadcast)."""
    if isinstance(v, ScalarValue):
        v = make_column(ctx, e.data_type(), v.value,
                        None if v.value is not None else False)
    return v.col


def _collect_side(node: Exec, i: int, ctx: ExecContext
                  ) -> Optional[DeviceBatch]:
    """Every partition of ``node``'s child ``i`` as one batch; None if it
    yields no batch."""
    child = node.children[i]
    batches = [b for p in range(child.num_partitions)
               for b in node.child_batches(i, p, ctx)]
    if not batches:
        return None
    if len(batches) == 1:
        return batches[0]
    return concat_batches(batches, child.output_names, child.output_types)


class HashJoinExec(Exec):
    """Equi-join; the build side is always the right child, all of it."""

    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], how: str,
                 condition: Optional[Expression], left: Exec, right: Exec):
        super().__init__([left, right])
        assert how in JOIN_TYPES
        self.how = how
        self.left_keys = [bind_expression(k, left.output_names,
                                          left.output_types)
                          for k in left_keys]
        self.right_keys = [bind_expression(k, right.output_names,
                                           right.output_types)
                           for k in right_keys]
        self.condition = condition
        self._bound_condition = (
            bind_expression(condition, self.output_names, self.output_types)
            if condition is not None else None)

    @property
    def output_names(self):
        l, r = self.children
        if self.how in ("left_semi", "left_anti"):
            return l.output_names
        return l.output_names + r.output_names

    @property
    def output_types(self):
        l, r = self.children
        if self.how in ("left_semi", "left_anti"):
            return list(l.output_types)
        return list(l.output_types) + list(r.output_types)

    def determinism(self):
        return Determinism(
            ORDER_STABLE, "probe-order emission: output row order "
            "follows probe-side arrival, matched multiset is invariant")

    def describe(self):
        ks = ", ".join(f"{a.sql()}={b.sql()}"
                       for a, b in zip(self.left_keys, self.right_keys))
        return f"HashJoin {self.how} on [{ks}]"

    # --- phase 1: build and probe ---------------------------------------------
    def _hash_keys(self, build: DeviceBatch):
        """(build hashes, build live flags): K6 over the build side's
        keys.  The probe side's hashes are computed inside K4."""
        ctx = EvalContext(build)
        keys = [_column(ctx, k, k.eval(ctx)) for k in self.right_keys]
        return (jk.combined_key_hash(keys, build.capacity, side="build"),
                _live(build))

    def _count(self, side: jk.BuildSide, probe: DeviceBatch):
        """(order, lo, counts, probe live flags): build rows
        ``order[lo[i]:lo[i] + counts[i]]`` match probe row i (K4)."""
        ctx = EvalContext(probe)
        keys = [_column(ctx, k, k.eval(ctx)) for k in self.left_keys]
        lo, counts = jk.join_probe(side, keys, probe.num_rows)
        return side.order, lo, counts, _live(probe)

    # --- phase 2: expansion ---------------------------------------------------
    @staticmethod
    def _span_bytes(build: DeviceBatch, probe: DeviceBatch, order, lo,
                    counts, plive, how: str) -> List[torch.Tensor]:
        """Device totals of the output bytes (or child rows) of every span
        column, probe side first (the reference's count-phase span
        sizing): a probe column's bytes once per output row of its row, a
        build column's bytes of every matched build row.  A STRUCT has no
        total of its own (the join rule keeps varlen types nested in
        varlen ones on the CPU)."""
        pspans = [c for c in probe.columns if c.offsets is not None]
        bspans = [c for c in build.columns if c.offsets is not None]
        out = []
        if pspans:
            eff = jk.effective_counts(counts, plive, how)
            out = [(eff * lengths(c.offsets)).sum().reshape(1)
                   for c in pspans]
        if bspans:
            live = plive & (counts > 0)
        for c in bspans:
            sl = lengths(c.offsets).to(torch.int64)[order.long()]
            pre = torch.zeros(sl.shape[0] + 1, dtype=torch.int64,
                              device=sl.device)
            torch.cumsum(sl, 0, out=pre[1:])
            lo64 = lo.to(torch.int64).clamp(0, sl.shape[0])
            hi64 = (lo64 + counts).clamp(0, sl.shape[0])
            out.append(torch.where(live, pre[hi64] - pre[lo64],
                                   torch.zeros_like(lo64)).sum().reshape(1))
        return out

    def _expand(self, build: DeviceBatch, probe: DeviceBatch, order, lo,
                counts, plive, how: str):
        """All pairs of ``how`` with both sides' columns gathered (K7,
        K5, and K16 for string columns).
        Returns (batch, probe index per output row)."""
        ends, total = jk.expand_ends(counts, plive, how)   # K7
        # the one host read: the pair total and every string column's bytes
        span_bytes = self._span_bytes(build, probe, order, lo, counts, plive,
                                      how)
        sizes = (torch.cat([total] + span_bytes) if span_bytes
                 else total).tolist()
        total = sizes[0]
        if total >= 1 << 31:
            # the output's row indices are int32
            raise RuntimeError(
                f"join expansion of {total} rows exceeds the 2^31-1 "
                f"per-batch capacity; split the inputs")
        if any(x > (1 << 31) - 1 for x in sizes[1:]):
            raise RuntimeError(
                f"join expansion of {max(sizes[1:])} string bytes exceeds "
                f"the 2^31-1 bytes of int32 offsets; split the inputs")
        out_cap = bucket_for(max(total, 1))
        pflat = [c for c in probe.columns if c.is_flat]
        bflat = [c for c in build.columns if c.is_flat]
        pidx, bidx, lflat, rflat = jk.expand_pairs(
            ends, lo, counts, order, total, out_cap, pflat, bflat)
        nbytes = iter(sizes[1:])
        cols = []
        for side, idx, flat in ((probe, pidx, iter(lflat)),
                                (build, bidx, iter(rflat))):
            spans = [c for c in side.columns if not c.is_flat]
            if spans:
                pair = torch.arange(out_cap, device=idx.device) < total
                if side is build:
                    pair &= counts[pidx.long()] > 0
                moved = iter(gather_columns(
                    spans, idx, pair, [None if c.offsets is None
                                       else next(nbytes) for c in spans]))
            cols += [next(flat) if c.is_flat else next(moved)
                     for c in side.columns]
        return DeviceBatch(cols, total, self.output_names), pidx

    def _expand_left_cond(self, build: DeviceBatch, probe: DeviceBatch,
                          order, lo, counts, plive) -> DeviceBatch:
        """LEFT join with a residual condition: expand every candidate
        pair, evaluate the condition, keep the passing pairs, and repair
        probe rows whose candidates all failed: their first pair stays,
        with the build side null (Spark's outer conditional join)."""
        out, pidx = self._expand(build, probe, order, lo, counts, plive,
                                 "left")
        ctx = EvalContext(out)
        v = _column(ctx, self._bound_condition,
                    self._bound_condition.eval(ctx))
        passes = v.data.to(torch.bool) & v.validity
        pair_valid = _live(out)
        rows = pidx.long()
        real = counts[rows] > 0                   # vs the null-extended row
        pred_true = passes & real & pair_valid
        pass_cnt = torch.zeros(probe.capacity, dtype=torch.int32,
                               device=out.device).index_add_(
            0, rows, pred_true.to(torch.int32))
        # pairs come grouped by probe row: a change of row marks a first
        first = torch.ones_like(pair_valid)
        first[1:] = pidx[1:] != pidx[:-1]
        first &= pair_valid
        convert = first & real & (pass_cnt[rows] == 0)
        keep = pair_valid & (~real | pred_true | convert)
        null_build = ~real | convert
        nl = len(probe.columns)
        fixed = list(out.columns[:nl]) + [
            mask_validity(c, ~null_build) for c in out.columns[nl:]]
        return compact(DeviceBatch(fixed, out.num_rows, self.output_names),
                       keep, self.output_names)

    def _unmatched_build(self, build: DeviceBatch,
                         matched_any: torch.Tensor) -> DeviceBatch:
        """Right and full joins: build rows no probe row matched, with a
        null left side."""
        compacted = compact(build, _live(build) & ~matched_any,
                            self.children[1].output_names)
        ctx = EvalContext(compacted)
        lcols = [all_null_column(ctx, dt).col
                 for dt in self.children[0].output_types]
        return DeviceBatch(lcols + list(compacted.columns),
                           compacted.num_rows, self.output_names)

    def _collect_build(self, ctx: ExecContext) -> DeviceBatch:
        """The whole build side as one batch."""
        right = self.children[1]
        build = _collect_side(self, 1, ctx)
        if build is None:
            schema = to_arrow_schema(right.output_names, right.output_types)
            build = batch_to_device(pa.RecordBatch.from_arrays(
                [pa.array([], type=f.type) for f in schema], schema=schema),
                self.device(ctx))
        return build

    def execute_partition(self, pid, ctx: ExecContext
                          ) -> Iterator[DeviceBatch]:
        build = self._collect_build(ctx)
        # hashed, sorted and tabled once for every probe batch
        side = jk.sort_build(*self._hash_keys(build))
        names = self.output_names
        # right and full joins emit the build rows no probe row matched,
        # every build row when no probe batch arrives
        matched_acc = torch.zeros(build.capacity, dtype=torch.bool,
                                  device=build.device) \
            if self.how in ("right", "full") else None
        for probe in self.child_batches(0, pid, ctx):
            order, lo, counts, plive = self._count(side, probe)
            if matched_acc is not None:
                matched_acc |= jk.build_matched_flags(
                    order, lo, counts, plive, build.capacity)
            if self.how == "left_semi":
                yield compact(probe, (counts > 0) & plive, names)
                continue
            if self.how == "left_anti":
                yield compact(probe, (counts == 0) & plive, names)
                continue
            if self._bound_condition is not None and self.how == "left":
                out = self._expand_left_cond(build, probe, order, lo, counts,
                                             plive)
            else:
                out, _ = self._expand(build, probe, order, lo, counts,
                                      plive, self.how)
                if self._bound_condition is not None and \
                        self.how == "inner":
                    out = apply_filter(
                        out, self._bound_condition.eval(EvalContext(out)),
                        names)
            yield out
        if matched_acc is not None:
            out = self._unmatched_build(build, matched_acc)
            if out.num_rows:
                yield out


class NestedLoopJoinExec(Exec):
    """Cross product with an optional condition (one partition)."""

    def __init__(self, how: str, condition: Optional[Expression],
                 left: Exec, right: Exec):
        super().__init__([left, right])
        self.how = how
        self.condition = condition
        self._bound_condition = (
            bind_expression(condition, self.output_names, self.output_types)
            if condition is not None else None)

    @property
    def output_names(self):
        return self.children[0].output_names + self.children[1].output_names

    @property
    def output_types(self):
        return (list(self.children[0].output_types)
                + list(self.children[1].output_types))

    def determinism(self):
        return Determinism(
            ORDER_STABLE, "cross-product emission order follows both "
            "sides' arrival; matched multiset is invariant")

    def describe(self):
        return f"NestedLoopJoin {self.how}"

    def execute_partition(self, pid, ctx: ExecContext
                          ) -> Iterator[DeviceBatch]:
        build = _collect_side(self, 1, ctx)
        if build is None:
            return
        nb = build.num_rows
        for probe in self.child_batches(0, pid, ctx):
            total = probe.num_rows * nb
            p = torch.arange(bucket_for(max(total, 1)), device=probe.device)
            valid = p < total
            pidx = (p // max(nb, 1)).clamp(max=probe.capacity - 1)
            bidx = (p % max(nb, 1)).clamp(max=build.capacity - 1)
            out = DeviceBatch(
                gather_columns(probe.columns, pidx, valid)
                + gather_columns(build.columns, bidx, valid),
                total, self.output_names)
            if self._bound_condition is not None:
                out = apply_filter(
                    out, self._bound_condition.eval(EvalContext(out)),
                    self.output_names)
            yield out


# ---------------------------------------------------------------------------
# the host engine's join: pyarrow Table.join
# ---------------------------------------------------------------------------

_PA_JOIN = {"inner": "inner", "left": "left outer", "right": "right outer",
            "full": "full outer", "left_semi": "left semi",
            "left_anti": "left anti"}


def _pa_join(lt: pa.Table, rt: pa.Table, lkn, rkn, join_type: str
             ) -> pa.Table:
    """pyarrow's join of two tables.  pyarrow carries no nested column
    that is not a key, so each side's nested columns stay behind and a
    row id goes through in their place; the joined rows then take them
    by that id (a null id, an unmatched side, gives a null), which gives
    Spark's answer where the reference's CPU join raises."""
    rid = "__rid"
    sides, nested = [], []
    for tbl in (lt, rt):
        names = [f.name for f in tbl.schema if pa.types.is_nested(f.type)]
        nested.append(names)
        if names:
            tbl = tbl.drop_columns(names).append_column(
                rid + str(len(sides)), pa.array(
                    np.arange(tbl.num_rows, dtype=np.int64)))
        sides.append(tbl)
    joined = sides[0].join(sides[1], keys=lkn, right_keys=rkn,
                           join_type=join_type, coalesce_keys=False,
                           use_threads=False)
    if not any(nested):
        return joined
    for i, (tbl, names) in enumerate(zip((lt, rt), nested)):
        if names and rid + str(i) in joined.column_names:
            ids = joined.column(rid + str(i))
            for nm in names:
                joined = joined.append_column(nm, tbl.column(nm).take(ids))
            joined = joined.drop_columns([rid + str(i)])
    return joined


class CpuJoinExec(Exec):
    """Equi-join on pyarrow: the join the planner emits, kept on the CPU
    where tagging says so.  Null keys never match (Spark), so they are
    split off before pyarrow joins and put back as the join type needs.
    With ``colocated`` (both sides hash-exchanged on the keys) partition
    i joins the right side's partition i, else the whole right side."""

    placement = CPU

    def __init__(self, left_keys, right_keys, how, condition,
                 left: Exec, right: Exec, colocated: bool = False):
        super().__init__([left, right])
        self.how = how
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.condition = condition
        self.colocated = colocated

    @property
    def output_names(self):
        l, r = self.children
        if self.how in ("left_semi", "left_anti"):
            return l.output_names
        return l.output_names + r.output_names

    @property
    def output_types(self):
        l, r = self.children
        if self.how in ("left_semi", "left_anti"):
            return list(l.output_types)
        return list(l.output_types) + list(r.output_types)

    def describe(self):
        return f"CpuJoin {self.how}"

    def partition_use(self):
        return MERGES       # on one device it joins the gathered sides

    def _collect_side(self, side: int, ctx, pid=None) -> pa.Table:
        child = self.children[side]
        rbs = []
        pids = range(child.num_partitions) if pid is None else [pid]
        for p in pids:
            for b in self.child_batches(side, p, ctx):
                rb = batch_to_arrow(DeviceBatch(b.columns, b.num_rows,
                                                child.output_names))
                if rb.num_rows:
                    rbs.append(rb)
        schema = to_arrow_schema(child.output_names, child.output_types)
        if not rbs:
            return schema.empty_table()
        return pa.Table.from_batches([r.cast(schema) for r in rbs])

    def execute_partition(self, pid, ctx) -> Iterator[DeviceBatch]:
        left = self._collect_side(0, ctx, pid)
        right = self._collect_side(1, ctx, pid if self.colocated else None)
        # materialize key columns (they may be expressions)
        lkn, rkn = [], []
        lt, rt = left, right
        for i, (lk, rk) in enumerate(zip(self.left_keys, self.right_keys)):
            ln_, rn_ = f"__lk{i}", f"__rk{i}"
            lt = lt.append_column(ln_, _eval_arrow(lk, left,
                                                   self.children[0]))
            rt = rt.append_column(rn_, _eval_arrow(rk, right,
                                                   self.children[1]))
            lkn.append(ln_)
            rkn.append(rn_)
        # avoid output name collisions: temporarily rename
        lnames = [f"l_{i}" for i in range(len(left.schema.names))]
        rnames = [f"r_{i}" for i in range(len(right.schema.names))]
        lt = lt.rename_columns(lnames + lkn)
        rt = rt.rename_columns(rnames + rkn)

        def null_key_mask(tbl, keys):
            m = None
            for k in keys:
                kn = pc.is_null(tbl.column(k))
                m = kn if m is None else pc.or_(m, kn)
            return m
        l_null = null_key_mask(lt, lkn)
        r_null = null_key_mask(rt, rkn)
        lt_nn = lt.filter(pc.invert(l_null)) if l_null is not None else lt
        rt_nn = rt.filter(pc.invert(r_null)) if r_null is not None else rt
        for k in lkn + rkn:
            tbl = lt if k in lkn else rt
            if pa.types.is_nested(tbl.schema.field(k).type):
                raise NotImplementedError(
                    f"a join on a {tbl.schema.field(k).type} key is not "
                    f"ported to the CPU engine (pyarrow cannot match on it; "
                    f"ROADMAP Queue 1 item 4)")
        joined = _pa_join(lt_nn, rt_nn, lkn, rkn, _PA_JOIN[self.how])
        lout = self.children[0].output_names
        rout = self.children[1].output_names
        if self.how in ("left_semi", "left_anti"):
            out = joined.select(lnames).rename_columns(lout)
            if self.how == "left_anti" and l_null is not None:
                extra = lt.filter(l_null).select(lnames).rename_columns(lout)
                out = pa.concat_tables([out, extra]) if extra.num_rows \
                    else out
        else:
            out = joined.select(lnames + rnames).rename_columns(
                self.output_names)
            if self.how in ("left", "full") and l_null is not None:
                nulls_l = lt.filter(l_null).select(lnames)
                if nulls_l.num_rows:
                    extra = nulls_l.rename_columns(lout)
                    for rn_, on in zip(rnames, rout):
                        extra = extra.append_column(on, pa.nulls(
                            nulls_l.num_rows, rt.schema.field(rn_).type))
                    out = pa.concat_tables(
                        [out, extra.rename_columns(self.output_names)])
            if self.how in ("right", "full") and r_null is not None:
                nulls_r = rt.filter(r_null).select(rnames)
                if nulls_r.num_rows:
                    extra = pa.table(
                        {n: pa.nulls(nulls_r.num_rows,
                                     lt.schema.field(ln).type)
                         for n, ln in zip(lout, lnames)})
                    for arr, on in zip(nulls_r.columns, rout):
                        extra = extra.append_column(on, arr)
                    out = pa.concat_tables(
                        [out, extra.rename_columns(self.output_names)])
        if self.condition is not None:
            if self.how == "inner":
                out = out.filter(_eval_arrow(self.condition, out, self))
            elif self.how == "left":
                out = _left_conditional_impl(self, lt, rt, lkn, rkn, lnames,
                                             rnames, l_null, r_null)
            else:
                raise NotImplementedError(
                    f"conditional {self.how} join on CPU engine")
        schema = to_arrow_schema(self.output_names, self.output_types)
        out = out.cast(schema)
        for rb in out.combine_chunks().to_batches():
            yield batch_to_device(rb, self.device(ctx))


def _left_conditional_impl(join_exec: CpuJoinExec, lt, rt, lkn, rkn,
                           lnames, rnames, l_null, r_null) -> pa.Table:
    """Conditional LEFT join on the CPU engine: re-join with a probe row
    id and a build marker, filter pairs by the condition, and
    null-extend every probe row without a passing pair."""
    lt2 = lt.append_column(
        "__pid__", pa.array(np.arange(lt.num_rows, dtype=np.int64)))
    rt2 = rt.append_column(
        "__bmark__", pa.array(np.ones(rt.num_rows, dtype=np.int8)))
    l_nn = lt2.filter(pc.invert(l_null)) if l_null is not None else lt2
    r_nn = rt2.filter(pc.invert(r_null)) if r_null is not None else rt2
    joined = _pa_join(l_nn, r_nn, lkn, rkn, "left outer")
    mask = _eval_arrow(
        join_exec.condition,
        joined.select(lnames + rnames).rename_columns(
            join_exec.output_names),
        join_exec)
    if isinstance(mask, pa.ChunkedArray):
        mask = mask.combine_chunks()
    mask = pc.fill_null(mask, False)
    real = pc.is_valid(joined.column("__bmark__"))
    pass_rows = joined.filter(pc.and_(mask, real))
    passed = np.unique(pass_rows.column("__pid__").combine_chunks()
                       .to_numpy(zero_copy_only=False))
    all_pids = lt2.column("__pid__").combine_chunks() \
        .to_numpy(zero_copy_only=False)
    missing = lt2.take(np.flatnonzero(~np.isin(all_pids, passed)))
    out = pass_rows.select(lnames + rnames)
    if missing.num_rows:
        pad = missing.select(lnames)
        for rn_ in rnames:
            pad = pad.append_column(
                rn_, pa.nulls(missing.num_rows, rt.schema.field(rn_).type))
        out = pa.concat_tables([out, pad])
    return out.rename_columns(join_exec.output_names)


def _eval_arrow(expr: Expression, table: pa.Table, child_like) -> pa.Array:
    """Evaluate an expression over an Arrow table on CPU tensors."""
    names = child_like.output_names
    dtypes = child_like.output_types
    tbl = table.rename_columns(names) \
        if list(table.schema.names) != names else table
    tbl = tbl.combine_chunks()
    rbs = tbl.to_batches() or [pa.RecordBatch.from_pydict(
        {n: pa.array([], type=f.type)
         for n, f in zip(tbl.schema.names, tbl.schema)})]
    outs = []
    bound = bind_expression(expr, names, dtypes)
    for rb in rbs:
        ec = EvalContext(batch_to_device(rb, "cpu"))
        v = bound.eval(ec)
        if not isinstance(v, ColumnValue):
            v = make_column(ec, bound.data_type(),
                            v.value if v.value is not None else 0,
                            None if v.value is not None else False)
        outs.append(column_to_arrow(v.col, rb.num_rows))
    return pa.chunked_array(outs) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def plan_join(lp, left: Exec, right: Exec, conf) -> Exec:
    """Logical Join -> CPU-placed physical join (Spark's
    ExtractEquiJoinKeys and join selection): a CpuJoinExec for an
    equi-join, with the right side broadcast when it is small enough and
    a side has more than one partition, else both sides hash-exchanged on
    the keys; a nested-loop join when there is no equi key."""
    from ..config import AUTO_BROADCAST_JOIN_THRESHOLD
    how = lp.how
    cond = lp.condition
    using = lp.using
    if using:
        lkeys = [AttributeReference(k) for k in using]
        rkeys = [AttributeReference(k) for k in using]
        residual = None
    else:
        lkeys, rkeys, residual = split_equi_condition(
            cond, left.output_names, right.output_names)
    threshold = conf.get(AUTO_BROADCAST_JOIN_THRESHOLD)
    lsz = left.estimated_size_bytes()
    rsz = right.estimated_size_bytes()

    # the build side is always the right child: flip when the join type
    # forces it (right outer) or an inner join's smaller side is on the left
    flipped = False
    if (how == "right" and lkeys) or (
            how == "inner" and lkeys and lsz is not None
            and rsz is not None and lsz < rsz):
        left, right = right, left
        lkeys, rkeys = rkeys, lkeys
        lsz, rsz = rsz, lsz
        flipped = True
        if how == "right":
            how = "left"

    multi = left.num_partitions > 1 or right.num_partitions > 1

    # non-equi: a nested-loop join; broadcast the build side so it is
    # collected once, not once per probe partition
    if not lkeys:
        from .broadcast import (BroadcastExchangeExec,
                                BroadcastNestedLoopJoinExec)
        r = BroadcastExchangeExec(right) if multi else right
        cls = BroadcastNestedLoopJoinExec if multi else NestedLoopJoinExec
        if how == "cross" or (how == "inner" and cond is not None):
            return cls("cross" if how == "cross" else how, cond, left, r)
        if how == "inner":
            return cls("cross", None, left, r)
        raise NotImplementedError(
            f"non-equi {how} join is not supported yet")

    colocated = False
    if multi and threshold >= 0 and rsz is not None and rsz <= threshold \
            and how in ("inner", "left", "left_semi", "left_anti", "cross"):
        from .broadcast import BroadcastExchangeExec
        right = BroadcastExchangeExec(right)
    elif multi:
        # shuffled hash join: co-partition both sides on the join keys
        from ..shuffle.exchange import ShuffleExchangeExec
        from ..shuffle.partitioning import HashPartitioning
        n = max(left.num_partitions, right.num_partitions)
        left = ShuffleExchangeExec(HashPartitioning(lkeys, n), left)
        right = ShuffleExchangeExec(HashPartitioning(rkeys, n), right)
        colocated = True

    join: Exec = CpuJoinExec(lkeys, rkeys, how, residual, left, right,
                             colocated=colocated)
    out_exec = join
    if flipped or using:
        names = join.output_names
        types = join.output_types
        nl = len(left.output_names)
        if flipped:
            # output order: the original left (now the right child) first
            exprs = [BoundReference(nl + i, types[nl + i], names[nl + i])
                     for i in range(len(right.output_names))] + \
                    [BoundReference(i, types[i], names[i])
                     for i in range(nl)]
            out_exec = ProjectExec([Alias(e, e.name) for e in exprs], join)
            names = out_exec.output_names
            types = out_exec.output_types
        if using and how not in ("left_semi", "left_anti"):
            lnames = lp.children[0].schema()[0]
            rnames = lp.children[1].schema()[0]
            n_l = len(lnames)
            exprs = []
            for k in using:
                li = lnames.index(k)
                ri = n_l + rnames.index(k)
                lref = BoundReference(li, types[li], k)
                rref = BoundReference(ri, types[ri], k)
                if lp.how == "full":
                    exprs.append(Alias(Coalesce(lref, rref), k))
                else:
                    exprs.append(Alias(rref if lp.how == "right" else lref,
                                       k))
            for i, n in enumerate(lnames):
                if n not in using:
                    exprs.append(Alias(BoundReference(i, types[i], n), n))
            for j, n in enumerate(rnames):
                if n not in using:
                    exprs.append(Alias(
                        BoundReference(n_l + j, types[n_l + j], n), n))
            out_exec = ProjectExec(exprs, out_exec)
    return out_exec

"""Join operators and their planning, for one partition.

Counterpart of spark_rapids_tpu/exec/join.py (HashJoinExec,
NestedLoopJoinExec, split_equi_condition, plan_join).  An equi-join
hashes the build side's keys into one 64-bit word per row (kernel K6),
sorts the hashes (K2) and builds K4's hash table over them, once per
build side; then, per probe batch: hashes each probe row's keys and
finds its match range in one kernel (K4), sums the output rows per
probe row (K7), reads their total on the host once, and expands the
pairs at a capacity bucket of that total, gathering both sides' columns
in the same kernel (K5).  The build side is always the right child; a
right join is planned flipped.  Output row order follows the probe side,
and a probe row's build rows come in sorted-hash order, as in the
reference, so the two agree row for row.

Not ported yet: string keys and payloads (the span sizing of the
reference's count phase), the broadcast and shuffled joins (more than
one partition), the CPU join that the reference falls back to, and the
speculative sizing that fuses count and expand on the TPU (the same
output, one host sync fewer).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import pyarrow as pa
import torch

from ..analysis.determinism import ORDER_STABLE, Determinism
from ..columnar.device import DeviceBatch, batch_to_device, bucket_for
from ..columnar.interop import to_arrow_schema
from ..expr.conditional import Coalesce
from ..expr.core import (Alias, AttributeReference, BoundReference,
                         EvalContext, Expression, ScalarValue,
                         all_null_column, bind_expression, make_column)
from ..expr.predicates import And, EqualTo
from ..ops import join_kernels as jk
from ..ops.carry import mask_validity
from ..ops.gather import gather_column
from .base import Exec, ExecContext
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


def _collect_side(child: Exec, ctx: ExecContext) -> Optional[DeviceBatch]:
    """Every partition of ``child`` as one batch; None if it yields no
    batch."""
    batches = [b for p in range(child.num_partitions)
               for b in child.execute_partition(p, ctx)]
    if not batches:
        return None
    if len(batches) == 1:
        return batches[0]
    return concat_batches(batches, child.output_names, child.output_types)


class HashJoinExec(Exec):
    """Equi-join; the build side is always the right child."""

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
    def _expand(self, build: DeviceBatch, probe: DeviceBatch, order, lo,
                counts, plive, how: str):
        """All pairs of ``how`` with both sides' columns gathered (K7,
        K5).
        Returns (batch, probe index per output row)."""
        ends, total = jk.expand_ends(counts, plive, how)   # K7
        total = int(total)                                  # the one host read
        if total >= 1 << 31:
            # the output's row indices are int32
            raise RuntimeError(
                f"join expansion of {total} rows exceeds the 2^31-1 "
                f"per-batch capacity; split the inputs")
        out_cap = bucket_for(max(total, 1))
        pidx, _, lcols, rcols = jk.expand_pairs(
            ends, lo, counts, order, total, out_cap, probe.columns,
            build.columns)
        return DeviceBatch(lcols + rcols, total, self.output_names), pidx

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
        right = self.children[1]
        build = _collect_side(right, ctx)
        if build is None:
            schema = to_arrow_schema(right.output_names, right.output_types)
            build = batch_to_device(pa.RecordBatch.from_arrays(
                [pa.array([], type=f.type) for f in schema], schema=schema),
                ctx.device)
        return build

    def execute_partition(self, pid, ctx: ExecContext
                          ) -> Iterator[DeviceBatch]:
        build = self._collect_build(ctx)
        # hashed, sorted and tabled once for every probe batch
        side = jk.sort_build(*self._hash_keys(build))
        names = self.output_names
        matched_acc = None
        for probe in self.children[0].execute_partition(pid, ctx):
            order, lo, counts, plive = self._count(side, probe)
            if self.how in ("right", "full"):
                matched = jk.build_matched_flags(order, lo, counts, plive,
                                                 build.capacity)
                matched_acc = matched if matched_acc is None else \
                    matched_acc | matched
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
        build = _collect_side(self.children[1], ctx)
        if build is None:
            return
        nb = build.num_rows
        for probe in self.children[0].execute_partition(pid, ctx):
            total = probe.num_rows * nb
            p = torch.arange(bucket_for(max(total, 1)), device=probe.device)
            valid = p < total
            pidx = (p // max(nb, 1)).clamp(max=probe.capacity - 1)
            bidx = (p % max(nb, 1)).clamp(max=build.capacity - 1)
            out = DeviceBatch(
                [gather_column(c, pidx, valid) for c in probe.columns]
                + [gather_column(c, bidx, valid) for c in build.columns],
                total, self.output_names)
            if self._bound_condition is not None:
                out = apply_filter(
                    out, self._bound_condition.eval(EvalContext(out)),
                    self.output_names)
            yield out


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def plan_join(lp, left: Exec, right: Exec) -> Exec:
    """Logical Join -> physical, one partition a side.  The reference
    plans a CpuJoinExec that its tagging turns into a HashJoinExec; the
    port has no tagging or CPU engine yet, so it plans HashJoinExec
    directly and raises NotImplementedError where the tagging would keep
    the join on the CPU."""
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
        flipped = True
        if how == "right":
            how = "left"

    if left.num_partitions > 1 or right.num_partitions > 1:
        raise NotImplementedError(
            "a join over more than one partition needs the broadcast or "
            "shuffle exchange (BroadcastExchangeExec, ShuffleExchangeExec), "
            "which are not ported yet")

    if not lkeys:
        if how == "cross" or (how == "inner" and cond is not None):
            return NestedLoopJoinExec("cross" if how == "cross" else how,
                                      cond, left, right)
        if how == "inner":
            return NestedLoopJoinExec("cross", None, left, right)
        raise NotImplementedError(
            f"non-equi {how} join is not supported yet")
    if residual is not None and how not in ("inner", "left"):
        # the reference's tagging: inner post-filters, left repairs
        # unmatched probe rows; anything else stays on its CPU engine
        raise NotImplementedError(
            f"conditional {how} join is not supported on the device (the "
            "reference runs it on its CPU engine, which is not ported yet)")

    join = HashJoinExec(lkeys, rkeys, how, residual, left, right)
    out_exec: Exec = join
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

"""Plan rewrite: tag -> cost -> convert -> transitions.

Counterpart of spark_rapids_tpu/plan/overrides.py (TpuOverrides.apply,
the Meta hierarchy, the expression and exec rules, the join, aggregate
and sort conversions, the single-device exchange fusion and the
transition insertion).  Flow:

  1. wrap the CPU-placed physical plan in a Meta tree;
  2. tag every node: the per-op enable keys, TypeSig checks of its output
     columns, every expression's rule, and the exec's own tag rule; a
     node that cannot run on the GPU keeps its reasons;
  3. with spark.rapids.sql.optimizer.enabled, let the cost model move
     more subtrees to the CPU;
  4. record (and, per spark.rapids.sql.explain, print) the explain lines;
  5. convert every node that can run on the GPU: a CpuJoinExec becomes a
     hash join, a CpuHashAggregateExec a GpuHashAggregateExec,
     anything else is the same operator placed on the GPU, and an
     exchange left GPU-placed becomes a partition gather;
  6. insert HostToDevice / DeviceToHost transitions at placement
     boundaries, and gather and coalesce at the collect boundary.

A CPU placement comes from tagging and nowhere else: nothing catches a
GPU operator's error and re-plans on the CPU.  The port's session drives
one device, so a shuffle exchange is stripped into a gather of its
input's partitions (spark.rapids.tpu.singleChipFuse ``auto`` = ``on``;
the aggregate and join conversions also coalesce the gathered batches)
unless an operator above it reads its partitions (a sample, a limit, a
row position, a sort within partitions, a cache write) before a GPU
aggregate, join, window or global sort merges them
(``Exec.partition_use``).  The exchange itself runs on the host only,
so one that is kept, or whose consumer stays on the CPU, is tagged off
the GPU.  A cache write is placed where its child is.  With the key
``off`` the consumers of exchanges stay on the CPU: the reference's
device exchange between a PARTIAL and a FINAL aggregate, and its
co-partitioned shuffled hash join, are not ported.  Not ported
either: the reference's ICI stages, plan lint, AQE readers and extension
rules.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

from .. import config as cfg
from .. import types as t
from ..exec import base as eb
from ..exec.aggregate import CpuHashAggregateExec, GpuHashAggregateExec
from ..exec.basic import (CoalesceBatchesExec, FilterExec, GlobalLimitExec,
                          LocalLimitExec, LocalScanExec, ProjectExec,
                          RangeExec, SampleExec, UnionExec)
from ..exec.broadcast import (BroadcastExchangeExec, BroadcastHashJoinExec,
                              BroadcastNestedLoopJoinExec)
from ..exec.gatherpart import GatherPartitionsExec
from ..exec.join import CpuJoinExec, HashJoinExec, NestedLoopJoinExec
from ..exec.sort import SortExec
from ..exec.window import WindowExec
from ..expr import aggregates as agg
from ..expr import arithmetic as ar
from ..expr import complextype as cx
from ..expr import conditional as cond
from ..expr import mathexpr as mx
from ..expr import predicates as pred
from ..expr import window as win
from ..expr.cast import Cast, cast_supported_on_gpu
from ..expr.core import (Alias, AttributeReference, BoundReference,
                         Expression, Literal, bind_expression)
from ..expr import bitwise as bw
from ..expr import datetime_expr as dte
from ..expr import hashfns as hf
from ..expr import misc_tail as mt
from ..expr import strings as se
from ..expr.params import ParamLiteral
from ..expr.subquery import ScalarSubquery
from ..io.cached_batch import CachedScanExec, CacheWriteExec
from ..io.scan import FileScanExec
from ..shuffle.exchange import ShuffleExchangeExec
from ..types import T, TypeSig


# ---------------------------------------------------------------------------
# Expression rules
# ---------------------------------------------------------------------------

class ExprRule:
    def __init__(self, sig: TypeSig, tag_fn=None):
        self.sig = sig
        self.tag_fn = tag_fn


EXPR_RULES: Dict[Type[Expression], ExprRule] = {}


def expr_rule(cls, sig: TypeSig, tag_fn=None):
    EXPR_RULES[cls] = ExprRule(sig, tag_fn)


_num = T.numeric64
_common = T.common_scalar
_cmp = T.numeric64 + T.BOOLEAN + T.DATE + T.TIMESTAMP + T.STRING + T.NULL


def _tag_literal(meta: "ExprMeta"):
    e = meta.expr
    if isinstance(e.data_type(), t.DecimalType) and e.value is not None \
            and not (-(2**63) <= int(e.value) < 2**63):
        meta.will_not_work(
            "decimal literal beyond 64-bit unscaled range stays on CPU")


expr_rule(Literal, T.all_types, _tag_literal)
expr_rule(Alias, T.all_types.nested())
expr_rule(AttributeReference,
          (_common + T.ARRAY + T.STRUCT + T.MAP + T.BINARY).nested())
expr_rule(BoundReference,
          (_common + T.ARRAY + T.STRUCT + T.MAP + T.BINARY).nested())
for c in (ar.Add, ar.Subtract, ar.Multiply, ar.Divide, ar.IntegralDivide,
          ar.Remainder, ar.Pmod, ar.UnaryMinus, ar.UnaryPositive, ar.Abs,
          ar.Greatest, ar.Least):
    expr_rule(c, _num)
for c in (pred.EqualTo, pred.EqualNullSafe, pred.LessThan,
          pred.LessThanOrEqual, pred.GreaterThan, pred.GreaterThanOrEqual,
          pred.In):
    expr_rule(c, _cmp)
for c in (pred.And, pred.Or, pred.Not):
    expr_rule(c, T.BOOLEAN)
for c in (pred.IsNull, pred.IsNotNull, pred.IsNaN):
    expr_rule(c, _common)
for c in (cond.If, cond.CaseWhen, cond.Coalesce, cond.NullIf, cond.Nvl):
    expr_rule(c, _cmp)
for c in (mx.Sqrt, mx.Exp, mx.Expm1, mx.Sin, mx.Cos, mx.Tan, mx.Asin,
          mx.Acos, mx.Atan, mx.Sinh, mx.Cosh, mx.Tanh, mx.Cbrt, mx.Rint,
          mx.ToDegrees, mx.ToRadians, mx.Log, mx.Log2, mx.Log10, mx.Log1p,
          mx.Pow, mx.Atan2, mx.Signum, mx.Round, mx.BRound, mx.Floor,
          mx.Ceil, mx.Asinh, mx.Acosh, mx.Atanh, mx.Cot, mx.Logarithm):
    expr_rule(c, _num)


def _tag_cast(meta: "ExprMeta"):
    e = meta.expr
    src = e.child.data_type()
    if not cast_supported_on_gpu(src, e.to):
        meta.will_not_work(
            f"cast from {src.name} to {e.to.name} is not supported on GPU")


expr_rule(Cast, T.all_types, _tag_cast)

# the string functions (the reference's rules, plan/overrides.py:119-125)
for c in (se.Upper, se.Lower, se.Substring, se.Concat, se.Trim, se.TrimLeft,
          se.TrimRight, se.StringReplace, se.StringRepeat, se.Reverse,
          se.StringLPad, se.StringRPad, se.InitCap):
    expr_rule(c, T.STRING)
for c in (se.Length, se.BitLength, se.StringLocate):
    expr_rule(c, T.INT)
for c in (se.Contains, se.StartsWith, se.EndsWith, se.Like):
    expr_rule(c, T.BOOLEAN)
expr_rule(se.Ascii, T.INT)


def _tag_host_only(reason: str):
    def tag(meta: "ExprMeta"):
        meta.will_not_work(reason)
    return tag


# host-evaluated string rules, with the reference's reasons
expr_rule(se.ConcatWs, T.STRING, _tag_host_only(
    "concat_ws's variadic null/separator semantics evaluate on the host "
    "engine"))
expr_rule(hf.Md5, T.STRING, _tag_host_only(
    "md5 digests run on the host engine (byte-serial digest)"))
expr_rule(se.SubstringIndex, T.STRING, lambda m: m.will_not_work(
    "substring_index with a multi-byte or empty delimiter needs "
    "sequential non-overlapping search; host engine")
    if len(m.expr.delim_bytes()) != 1 else None)


def _tag_string_literal_needle(meta: "ExprMeta"):
    e = meta.expr
    needle = e.children[1] if len(e.children) > 1 else None
    if needle is not None and se._literal_bytes(needle) is None and \
            not isinstance(needle, Literal):
        meta.will_not_work(f"{type(e).__name__} requires a literal search "
                           f"argument on GPU")


for c in (se.Contains, se.StartsWith, se.EndsWith, se.Like,
          se.StringReplace):
    EXPR_RULES[c].tag_fn = _tag_string_literal_needle
# the decimal markers of Spark's analyzer (ref plan/overrides.py:195-203)
expr_rule(ar.PromotePrecision, T.DECIMAL_64 + T.DECIMAL_128)
expr_rule(ar.MakeDecimal, T.DECIMAL_64 + T.DECIMAL_128)
expr_rule(ar.CheckOverflow, T.DECIMAL_64 + T.DECIMAL_128)
expr_rule(hf.Murmur3Hash, T.INT)
# (partition << 33) + row position, ref GpuMonotonicallyIncreasingID
expr_rule(hf.MonotonicallyIncreasingID, T.LONG)
expr_rule(hf.SparkPartitionID, T.INT)
# engine-deterministic, not Spark's XORShift sequence (as the reference)
expr_rule(hf.Rand, T.DOUBLE)
expr_rule(hf.InputFileName, T.STRING, _tag_host_only(
    "file-path strings materialize on the host engine (task-context "
    "metadata, not device data)"))

# dates and times (the reference's rules, plan/overrides.py:158-166,
# :275-280, :418-421)
for c in (dte.Year, dte.Month, dte.DayOfMonth, dte.Quarter, dte.DayOfWeek,
          dte.WeekDay, dte.DayOfYear, dte.Hour, dte.Minute, dte.Second,
          dte.DateDiff):
    expr_rule(c, T.INT)
for c in (dte.LastDay, dte.DateAdd, dte.DateSub, dte.AddMonths,
          dte.TruncDate):
    expr_rule(c, T.DATE)
for c in (dte.ToUnixTimestamp, dte.UnixTimestamp):
    expr_rule(c, T.LONG)
for c in (dte.FromUnixTime, dte.TimeAdd):
    expr_rule(c, T.TIMESTAMP)
expr_rule(dte.DateFormatClass, T.STRING, _tag_host_only(
    "strftime-style formatting runs on the host engine (byte-serial "
    "pattern rendering)"))
expr_rule(dte.DateAddInterval, T.DATE, _tag_host_only(
    "the calendar-interval type is not modeled on device; interval "
    "arithmetic runs on the host engine"))
expr_rule(dte.TimeWindow, T.STRUCT.nested(T.TIMESTAMP), lambda m:
          m.will_not_work("sliding time windows lower through ExpandExec, "
                          "which is not ported yet (ROADMAP Queue 1 item "
                          "4d)") if not m.expr.is_tumbling else None)
# bitwise (ref plan/overrides.py:110-111)
for c in (bw.BitwiseAnd, bw.BitwiseOr, bw.BitwiseXor, bw.BitwiseNot,
          bw.ShiftLeft, bw.ShiftRight, bw.ShiftRightUnsigned):
    expr_rule(c, T.integral)
# the registry's small leaves (ref plan/overrides.py:77, :191-213, :227)
expr_rule(mt.NaNvl, T.DOUBLE + T.FLOAT)
expr_rule(mt.InSet, T.BOOLEAN)
expr_rule(mt.AtLeastNNonNulls, T.BOOLEAN)
for c in (mt.KnownNotNull, mt.KnownFloatingPointNormalized):
    expr_rule(c, T.all_types.nested())          # optimizer markers
expr_rule(mt.UnscaledValue, T.LONG, lambda m: m.will_not_work(
    "unscaledvalue of decimal128 needs both lanes")
    if t.is_dec128(m.expr.children[0].data_type()) else None)
expr_rule(mt.PreciseTimestampConversion, T.TIMESTAMP + T.LONG)
# 0 and the file's size for the port's whole-file reads
for c in (mt.InputFileBlockStart, mt.InputFileBlockLength):
    expr_rule(c, T.LONG)
expr_rule(mx.NormalizeNaNAndZero, T.FLOAT + T.DOUBLE)
expr_rule(ParamLiteral, _num + T.DATE + T.TIMESTAMP + T.STRING)
# resolved to a literal before planning (api/session.py)
expr_rule(ScalarSubquery, T.common_scalar)
_nested_common = (T.common_scalar + T.ARRAY + T.STRUCT + T.MAP +
                  T.BINARY).nested()
expr_rule(cx.GetStructField, _nested_common)
expr_rule(cx.GetArrayItem, _nested_common)
expr_rule(cx.ElementAt, _nested_common)
expr_rule(cx.CreateNamedStruct, T.STRUCT.nested(T.common_scalar))


def _tag_create_array(meta: "ExprMeta"):
    et = meta.expr.children[0].data_type() if meta.expr.children else None
    if isinstance(et, (t.StringType, t.BinaryType, t.ArrayType,
                       t.StructType, t.MapType)):
        meta.will_not_work(
            "array() over string/nested elements is not supported on GPU")


expr_rule(cx.CreateArray, T.ARRAY.nested(T.common_scalar), _tag_create_array)
# Sum takes decimal64 inputs into exact 128-bit buffers (K3's 128-bit
# sum); Average's final divide is 64-bit in the reference, so decimal
# averages stay on the CPU; Min and Max carry both decimal words
expr_rule(agg.Sum, T.numeric)
expr_rule(agg.Average, T.integral + T.FLOAT + T.DOUBLE)
expr_rule(agg.Count, T.all_types)
expr_rule(agg.Min, T.numeric + T.DATE + T.TIMESTAMP + T.BOOLEAN + T.STRING)
expr_rule(agg.Max, T.numeric + T.DATE + T.TIMESTAMP + T.BOOLEAN + T.STRING)
expr_rule(agg.First, _common)
expr_rule(agg.Last, _common)
# collect over flat types: a list keeps the sorted rows' order, a set the
# order of its value words
_collect_elem = T.numeric + T.BOOLEAN + T.DATE + T.TIMESTAMP + T.STRING
expr_rule(agg.CollectList, (_collect_elem + T.ARRAY).nested(_collect_elem))
expr_rule(agg.CollectSet, (_collect_elem + T.ARRAY).nested(_collect_elem))
for c in (agg.StddevPop, agg.StddevSamp, agg.VariancePop, agg.VarianceSamp):
    expr_rule(c, _num)
# first over IF(p <=> v, x, NULL): the unit a pivot lowers to, one
# instance per pivot value
expr_rule(agg.PivotFirst, _common)
# the exact inverted-CDF percentile over collected groups (a DECIMAL128
# would drop its high word in the rank gather)
expr_rule(agg.ApproximatePercentile, T.numeric64)
expr_rule(agg.AggregateExpression, T.all_types.nested())
# window machinery registered as expressions, as in the reference;
# evaluation lives in WindowExec
for c in (win.WindowExpression, win.RowNumber, win.Rank, win.DenseRank,
          win.PercentRank, win.CumeDist, win.NTile, win.Lead, win.Lag,
          win.WindowSpec):
    expr_rule(c, T.common_scalar.nested())


# ---------------------------------------------------------------------------
# Meta hierarchy
# ---------------------------------------------------------------------------

class BaseMeta:
    def __init__(self, conf: cfg.RapidsConf):
        self.conf = conf
        self.reasons: List[str] = []

    def will_not_work(self, reason: str):
        if reason not in self.reasons:
            self.reasons.append(reason)

    @property
    def can_replace(self) -> bool:
        return not self.reasons


class ExprMeta(BaseMeta):
    """Wraps one expression node."""

    def __init__(self, expr: Expression, conf, input_names, input_types):
        super().__init__(conf)
        self.expr = expr
        self.input_names = input_names
        self.input_types = input_types
        self.children = [ExprMeta(c, conf, input_names, input_types)
                         for c in expr.children]

    def tag(self):
        name = type(self.expr).__name__
        rule = EXPR_RULES.get(type(self.expr))
        if rule is None:
            self.will_not_work(f"expression {name} is not supported on GPU")
        else:
            if not self.conf.is_op_enabled("expression", name):
                self.will_not_work(f"expression {name} has been disabled")
            try:
                dt = bind_expression(self.expr, self.input_names,
                                     self.input_types).data_type()
                if dt != t.NULL and not rule.sig.is_supported(dt):
                    for r in rule.sig.reasons_not_supported(dt):
                        self.will_not_work(
                            f"{name} produces unsupported type: {r}")
            except Exception as ex:     # unresolvable -> cannot place
                self.will_not_work(f"{name}: {ex}")
            if rule.tag_fn is not None and not self.reasons:
                bound = ExprMeta.__new__(ExprMeta)
                bound.__dict__.update(self.__dict__)
                bound.expr = bind_expression(self.expr, self.input_names,
                                             self.input_types)
                rule.tag_fn(bound)
        for c in self.children:
            c.tag()

    @property
    def can_replace_tree(self) -> bool:
        return self.can_replace and all(c.can_replace_tree
                                        for c in self.children)

    def all_reasons(self) -> List[str]:
        out = list(self.reasons)
        for c in self.children:
            out += c.all_reasons()
        return out


class ExecMeta(BaseMeta):
    """Wraps one physical operator."""

    def __init__(self, exec_node: eb.Exec, conf):
        super().__init__(conf)
        self.exec = exec_node
        self.children = [ExecMeta(c, conf) for c in exec_node.children]

    def _input_schema(self):
        if self.exec.children:
            c = self.exec.children[0]
            return c.output_names, c.output_types
        return [], []

    def expressions(self) -> List[Expression]:
        e = self.exec
        if isinstance(e, ProjectExec):
            return list(e.exprs)
        if isinstance(e, FilterExec):
            return [e.condition]
        if isinstance(e, CpuHashAggregateExec):
            return list(e.grouping) + list(e.aggregates)
        if isinstance(e, SortExec):
            return [o[0] for o in e.orders]
        return []

    def tag(self):
        e = self.exec
        name = type(e).__name__
        if not self.conf.is_op_enabled("exec", name):
            self.will_not_work(f"{name} has been disabled by config")
        rule_sig = EXEC_SIGS.get(type(e))
        if rule_sig is None:
            self.will_not_work(f"{name} has no GPU implementation")
        else:
            for n, dt in zip(e.output_names, e.output_types):
                if dt == t.NULL:
                    continue
                if not rule_sig.is_supported(dt):
                    for r in rule_sig.reasons_not_supported(dt):
                        self.will_not_work(f"output column {n}: {r}")
        names, dtypes = self._input_schema()
        self.expr_metas = [ExprMeta(x, self.conf, names, dtypes)
                           for x in self.expressions()]
        for em in self.expr_metas:
            em.tag()
            if not em.can_replace_tree:
                for r in em.all_reasons():
                    self.will_not_work(r)
        if any(isinstance(c, ShuffleExchangeExec) for c in e.children) \
                and not _fuse_single_chip(self.conf):
            self.will_not_work(_NO_FUSE)
        custom = EXEC_TAGS.get(type(e))
        if custom:
            custom(self)
        for c in self.children:
            c.tag()

    def convert(self) -> eb.Exec:
        new_children = [c.convert() for c in self.children]
        e = self.exec.with_new_children(new_children)
        if not self.can_replace:
            return e
        conv = EXEC_CONVERTS.get(type(e))
        if conv is not None:
            return conv(e, self.conf)
        e.placement = eb.GPU
        return e

    def explain_lines(self, level=0) -> List[str]:
        pad = "  " * level
        name = type(self.exec).__name__
        if self.can_replace:
            lines = [f"{pad}*Exec <{name}> will run on GPU"]
        else:
            lines = [f"{pad}!Exec <{name}> cannot run on GPU because "
                     + "; ".join(self.reasons[:4])]
        for c in self.children:
            lines += c.explain_lines(level + 1)
        return lines


# exec output-type signatures (the reference's)
_exec_common = (T.common_scalar + T.ARRAY + T.STRUCT + T.MAP +
                T.BINARY).nested()
EXEC_SIGS: Dict[Type[eb.Exec], TypeSig] = {
    cls: _exec_common for cls in (
        LocalScanExec, ProjectExec, FilterExec, CoalesceBatchesExec,
        GatherPartitionsExec, CpuJoinExec,
        NestedLoopJoinExec, HashJoinExec, BroadcastExchangeExec,
        BroadcastHashJoinExec, BroadcastNestedLoopJoinExec,
        ShuffleExchangeExec, LocalLimitExec, GlobalLimitExec,
        FileScanExec, UnionExec, SampleExec, CachedScanExec,
        CacheWriteExec)}
# struct keys group: their words are the children's, in turn
EXEC_SIGS[CpuHashAggregateExec] = (T.common_scalar + T.ARRAY +
                                   T.STRUCT).nested(T.common_scalar)
EXEC_SIGS[RangeExec] = T.LONG
EXEC_SIGS[SortExec] = T.common_scalar.nested()
EXEC_SIGS[WindowExec] = T.common_scalar.nested()

EXEC_TAGS: Dict[Type[eb.Exec], Callable] = {}
EXEC_CONVERTS: Dict[Type[eb.Exec], Callable] = {}


def _fuse_single_chip(conf: cfg.RapidsConf) -> bool:
    """Collapse exchanges when the session drives one device: an
    N-partition exchange there runs N per-partition stages one after
    another, parallelism that does not exist.  The port's session always
    drives one device, so ``auto`` is on."""
    return conf.get(cfg.SINGLE_CHIP_FUSE) != "off"


_NO_FUSE = ("spark.rapids.tpu.singleChipFuse=off keeps the shuffle "
            "exchange below, which runs on the host only")


def _strip_exchange(exchange: eb.Exec, coalesce: bool = False) -> eb.Exec:
    """Replace an exchange with a partition gather (and, with
    ``coalesce``, a device-side batch coalesce, so a streaming consumer
    sees one batch where it would see one per source partition)."""
    src = exchange.children[0]
    node = src
    if src.num_partitions > 1:
        node = GatherPartitionsExec(src)
        node.placement = src.placement
    if coalesce:
        node = CoalesceBatchesExec(node)
        node.placement = src.placement
    return node


def _convert_join(e: CpuJoinExec, conf) -> eb.Exec:
    left, right = e.children
    if e.colocated:
        # the exchanges only co-locate keys, which one device already
        # does: drop both, and run one count / read / expand round
        left = _strip_exchange(left, coalesce=True)   # probe streams
        right = _strip_exchange(right)                # build concats
    elif left.num_partitions > 1 and _fuse_single_chip(conf):
        # each probe batch pays its own count -> read -> expand round:
        # funnel the probe side into as few device batches as the
        # coalesce target allows
        g = GatherPartitionsExec(left)
        g.placement = left.placement
        left = CoalesceBatchesExec(g)
        left.placement = g.placement
    cls = BroadcastHashJoinExec if isinstance(right, BroadcastExchangeExec) \
        else HashJoinExec
    return cls(e.left_keys, e.right_keys, e.how, e.condition, left, right)


def _tag_join(meta: ExecMeta):
    e: CpuJoinExec = meta.exec
    if e.condition is not None and e.how not in ("inner", "left"):
        # inner post-filters; left repairs unmatched probe rows (right
        # arrives flipped to left)
        meta.will_not_work(
            f"conditional {e.how} join is not supported on GPU")
    l, r = e.children
    for k in e.left_keys + e.right_keys:
        try:
            b = bind_expression(k, l.output_names, l.output_types)
        except Exception:
            try:
                b = bind_expression(k, r.output_names, r.output_types)
            except Exception as ex:
                meta.will_not_work(str(ex))
                continue
        dt = b.data_type()
        if not (T.comparable + T.STRUCT).is_supported(dt):
            meta.will_not_work(f"join key type {dt.name} not supported")
    # the count phase sizes the top-level spans only: a varlen type
    # nested inside another type (array<string>, map<_, string>,
    # struct<string>) stays on the CPU, as in the reference
    for side in e.children:
        for dt in side.output_types:
            if _nested_varlen(dt):
                meta.will_not_work(
                    f"join payload type {dt.name} (varlen nested in "
                    f"varlen) not sized for duplicating gathers")


def _has_varlen(dt: t.DataType) -> bool:
    return t.is_varlen(dt) or isinstance(dt, t.StructType) and any(
        _has_varlen(k) for k in t.child_types(dt))


def _nested_varlen(dt: t.DataType) -> bool:
    return any(_has_varlen(k) for k in t.child_types(dt))


def _convert_aggregate(e: CpuHashAggregateExec, conf) -> eb.Exec:
    """The complete-mode CPU aggregate becomes one COMPLETE GPU
    aggregate: over an exchange, over the gathered, coalesced input
    (one device)."""
    child = e.children[0]
    if isinstance(child, ShuffleExchangeExec):
        child = _strip_exchange(child, coalesce=True)
    return GpuHashAggregateExec(e.grouping, e.aggregates, agg.COMPLETE,
                                child)


def _tag_aggregate(meta: ExecMeta):
    e: CpuHashAggregateExec = meta.exec
    cn, ct = e.children[0].output_names, e.children[0].output_types
    for ae in e.aggregates:
        fn = ae.func
        rule = EXPR_RULES.get(type(fn))
        if rule is None:
            meta.will_not_work(
                f"aggregate {type(fn).__name__} is not supported on GPU")
            continue
        if fn.children:
            try:
                dt = bind_expression(fn.child, cn, ct).data_type()
                for r in rule.sig.reasons_not_supported(dt):
                    meta.will_not_work(
                        f"{type(fn).__name__} over unsupported input: {r}")
                if isinstance(fn, agg.Sum) and t.is_dec128(dt):
                    # as the reference: its update cast reads the low word
                    meta.will_not_work(
                        "sum over decimal(>18) inputs runs on CPU")
            except Exception as ex:
                meta.will_not_work(str(ex))


def _tag_window(meta: ExecMeta):
    e: WindowExec = meta.exec
    cn, ct = e.children[0].output_names, e.children[0].output_types
    for w in e.window_exprs:
        f = w.func
        if isinstance(f, agg.AggregateFunction):
            if not isinstance(f, (agg.Sum, agg.Count, agg.Average, agg.Min,
                                  agg.Max, agg.First, agg.Last)):
                meta.will_not_work(
                    f"window aggregate {type(f).__name__} not supported")
            kind, lo, hi = w.spec.effective_frame(False)
            bounded = not (lo == win.UNBOUNDED_PRECEDING and
                           hi in (win.CURRENT_ROW, win.UNBOUNDED_FOLLOWING))
            if kind == "range" and bounded:
                # bounded range frames search one ascending numeric order
                # key per row
                orders = w.spec.order_by
                ok = len(orders) == 1 and orders[0][1]
                if ok:
                    try:
                        dt = bind_expression(orders[0][0], cn,
                                             ct).data_type()
                        ok = (T.numeric.is_supported(dt) and not
                              isinstance(dt, t.DecimalType)) or \
                            dt in (t.DATE, t.TIMESTAMP)
                    except Exception:
                        ok = False
                if not ok:
                    meta.will_not_work(
                        "bounded range frames need a single ascending "
                        "numeric/date/timestamp order key")
        elif not isinstance(f, (win.RowNumber, win.Rank, win.DenseRank,
                                win.Lead, win.Lag, win.NTile)):
            meta.will_not_work(
                f"window function {type(f).__name__} not supported")


def _tag_file_scan(meta: ExecMeta):
    """A format switched off leaves its scan on the CPU; the transition
    above carries its batches up."""
    e: FileScanExec = meta.exec
    key = {"parquet": cfg.PARQUET_ENABLED, "orc": cfg.ORC_ENABLED,
           "csv": cfg.CSV_ENABLED}.get(e.fmt)
    if key is not None and not meta.conf.get(key):
        meta.will_not_work(f"{e.fmt} scan disabled by config")


EXEC_CONVERTS[CpuHashAggregateExec] = _convert_aggregate
EXEC_CONVERTS[CpuJoinExec] = _convert_join
EXEC_TAGS[CpuJoinExec] = _tag_join
EXEC_TAGS[CpuHashAggregateExec] = _tag_aggregate
EXEC_TAGS[WindowExec] = _tag_window
EXEC_TAGS[FileScanExec] = _tag_file_scan


def _tag_cache_writes(meta: ExecMeta):
    """A cache write runs where its child does."""
    for c in meta.children:
        _tag_cache_writes(c)
    if isinstance(meta.exec, CacheWriteExec) and \
            not meta.children[0].can_replace:
        meta.will_not_work("the cache write runs where its child does, and "
                           "its child stays on the CPU")


def _tag_partition_readers(meta: ExecMeta, reader: Optional[str] = None):
    """Keep on the host every exchange whose partitions an operator above
    reads before a GPU-placed operator merges them: stripping it would
    hand that reader other partitions than the reference's.  ``reader``
    is the nearest such operator above ``meta``.  A merger kept on the
    CPU runs partition by partition, so the layout passes through it."""
    e = meta.exec
    use = e.partition_use()
    if use == eb.MERGES and meta.can_replace:
        reader = None
    elif use == eb.READS:
        reader = type(e).__name__
    if isinstance(e, ShuffleExchangeExec) and reader is not None:
        meta.will_not_work(
            f"{reader} above reads its partitions, which stripping it on "
            f"one device would merge; it runs on the host")
    for c in meta.children:
        _tag_partition_readers(c, reader)


def _strip_device_exchanges(root: eb.Exec) -> eb.Exec:
    """An exchange still GPU-placed after the conversions (one that
    ``_tag_partition_readers`` let through, under a consumer that does
    not strip it itself, or at the root) becomes a gather of its input's
    partitions: one device already co-locates every key."""
    return root.transform_up(
        lambda n: _strip_exchange(n) if isinstance(n, ShuffleExchangeExec)
        and n.placement == eb.GPU else n)


def _tag_host_exchanges(meta: ExecMeta):
    """An exchange under a consumer that stays on the CPU is not
    stripped, and runs on the host."""
    for c in meta.children:
        if isinstance(c.exec, ShuffleExchangeExec) and not meta.can_replace:
            c.will_not_work(
                f"the shuffle exchange runs on the host only (its consumer "
                f"{type(meta.exec).__name__} stays on the CPU)")
        _tag_host_exchanges(c)


# ---------------------------------------------------------------------------
# Transitions
# ---------------------------------------------------------------------------

def insert_transitions(root: eb.Exec) -> eb.Exec:
    def fix(node: eb.Exec) -> eb.Exec:
        new_children = []
        for c in node.children:
            c = fix(c)
            if c.placement != node.input_placement():
                c = eb.HostToDeviceExec(c) if c.placement == eb.CPU \
                    else eb.DeviceToHostExec(c)
            new_children.append(c)
        if node.children:
            node = node.with_new_children(new_children)
        return node

    root = fix(root)
    if root.placement == eb.GPU:
        # collect boundary: every partition's device batches funnel into
        # as few device batches as the coalesce target allows before
        # crossing to the host
        if root.num_partitions > 1:
            root = GatherPartitionsExec(root)
        root = eb.DeviceToHostExec(CoalesceBatchesExec(root))

    def fuse(node: eb.Exec) -> eb.Exec:
        # DeviceToHost(HostToDevice(x)) -> x, and the other way round
        if isinstance(node, eb.HostToDeviceExec) and \
                isinstance(node.children[0], eb.DeviceToHostExec):
            return node.children[0].children[0]
        if isinstance(node, eb.DeviceToHostExec) and \
                isinstance(node.children[0], eb.HostToDeviceExec):
            return node.children[0].children[0]
        return node
    return root.transform_up(fuse)


class GpuOverrides:
    """The plan rewrite's entry point."""

    def __init__(self, conf: cfg.RapidsConf):
        self.conf = conf
        self.last_explain = ""

    def apply(self, plan: eb.Exec) -> eb.Exec:
        if not self.conf.sql_enabled:
            self.last_explain = "(GPU acceleration disabled)"
            return plan
        meta = ExecMeta(plan, self.conf)
        meta.tag()
        if self.conf.get(cfg.OPTIMIZER_ENABLED):
            from .cost import CostBasedOptimizer
            CostBasedOptimizer(self.conf).optimize(meta)
        _tag_partition_readers(meta)
        _tag_cache_writes(meta)
        _tag_host_exchanges(meta)
        lines = meta.explain_lines()
        self.last_explain = "\n".join(lines)
        mode = self.conf.explain
        if mode == "ALL":
            print(self.last_explain)
        elif mode == "NOT_ON_GPU":
            bad = [ln for ln in lines if ln.lstrip().startswith("!")]
            if bad:
                print("\n".join(bad))
        return insert_transitions(_strip_device_exchanges(meta.convert()))

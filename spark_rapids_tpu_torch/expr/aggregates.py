"""Declarative aggregate functions: Sum, Count, Average, Min, Max, First,
Last, CollectList, CollectSet, the moments (variance and standard
deviation), PivotFirst and ApproximatePercentile.

Counterpart of spark_rapids_tpu/expr/aggregates.py.  Each function
declares its update stage (input expression and segmented op per
buffer), its buffer types, its merge ops over partial buffers, and the
expression that evaluates the final value from merged buffers.  Ops are
``sum``, ``countvalid`` (the count of non-null rows), ``min``, ``max``,
``first`` and ``last`` (the first or last non-null row of the group in
fold order), ``first_any`` and ``last_any`` (the first or last row,
null or not), ``collect_list`` and ``collect_set`` (the non-null values
as an array, a set without repeats) and their merges ``collect_concat``
and ``collect_concat_set``; a buffer's group is null when no row
contributed to it.  Min, Max, First and Last run grouped and global
(exec/aggregate.py, K3's folds and positional kinds) and over windows
(exec/window.py, K23 for First and Last).  Result and buffer types
follow the reference: Sum of a DECIMAL(p, s) is DECIMAL(min(p + 10, 38),
s), on a 128-bit buffer past 18 digits (K3's 128-bit sum); Average of
one is DECIMAL(p + 4, s + 4) over a DECIMAL(p + 10, s) sum, rounded
HALF_UP; Sum and Average of FLOAT add as DOUBLE; Min and Max keep their
type.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import torch

from .. import types as t
from .cast import Cast
from .core import (ColumnValue, EvalContext, Expression, Literal,
                   bind_expression, make_column)

PARTIAL = "Partial"
FINAL = "Final"
COMPLETE = "Complete"


class AggregateFunction(Expression):
    def __init__(self, child: Optional[Expression] = None):
        self.children = (child,) if child is not None else ()

    @property
    def child(self):
        return self.children[0]

    def update(self) -> List[Tuple[Expression, str]]:
        raise NotImplementedError

    def buffer_types(self) -> List[t.DataType]:
        raise NotImplementedError

    def merge_ops(self) -> List[str]:
        raise NotImplementedError

    def evaluate(self, ctx: EvalContext, buffers: List[ColumnValue]
                 ) -> ColumnValue:
        raise NotImplementedError


def _sum_decimal(ct: t.DecimalType) -> t.DecimalType:
    return t.DecimalType(min(ct.precision + 10, t.MAX_DECIMAL128_PRECISION),
                         ct.scale)


class Sum(AggregateFunction):
    def data_type(self):
        ct = self.child.data_type()
        if isinstance(ct, t.DecimalType):
            return _sum_decimal(ct)
        return t.LONG if t.is_integral(ct) else t.DOUBLE

    def update(self):
        return [(Cast(self.child, self.data_type()), "sum")]

    def buffer_types(self):
        return [self.data_type()]

    def merge_ops(self):
        return ["sum"]

    def evaluate(self, ctx, buffers):
        return buffers[0]


class Count(AggregateFunction):
    """count(expr), or count(*) when there is no child."""

    def data_type(self):
        return t.LONG

    def update(self):
        target = self.children[0] if self.children else Literal(1, t.INT)
        return [(target, "countvalid")]

    def buffer_types(self):
        return [t.LONG]

    def merge_ops(self):
        return ["sum"]

    def evaluate(self, ctx, buffers):
        # never null: a slot no row reached counts 0
        return make_column(ctx, t.LONG, buffers[0].col.data, None)


class Average(AggregateFunction):
    def data_type(self):
        ct = self.child.data_type()
        if isinstance(ct, t.DecimalType):
            return t.DecimalType(min(ct.precision + 4, 38),
                                 min(ct.scale + 4, 38))
        return t.DOUBLE

    def _sum_type(self):
        ct = self.child.data_type()
        return _sum_decimal(ct) if isinstance(ct, t.DecimalType) \
            else t.DOUBLE

    def update(self):
        return [(Cast(self.child, self._sum_type()), "sum"),
                (self.child, "countvalid")]

    def buffer_types(self):
        return [self._sum_type(), t.LONG]

    def merge_ops(self):
        return ["sum", "sum"]

    def evaluate(self, ctx, buffers):
        s, c = buffers
        cnt = c.col.data
        nonzero = cnt > 0
        safe = torch.where(nonzero, cnt, torch.ones_like(cnt))
        out = self.data_type()
        if isinstance(out, t.DecimalType):
            # sum * 10^(out scale - sum scale) / count, HALF_UP, exactly
            from ..ops import int128 as i128
            from .core import decimal_pair, make_decimal_column
            # (a sum past 38 digits wraps, so the bound is the word's)
            q = i128.div_half_up(decimal_pair(s.col),
                                 10 ** (out.scale - self._sum_type().scale),
                                 i128.from_int64(safe), 2 ** 127, 2 ** 63)
            return make_decimal_column(ctx, out, q, nonzero & s.col.validity)
        return make_column(ctx, t.DOUBLE, s.col.data / safe, nonzero)


class Min(AggregateFunction):
    op = "min"

    def data_type(self):
        return self.child.data_type()

    def update(self):
        return [(self.child, self.op)]

    def buffer_types(self):
        return [self.data_type()]

    def merge_ops(self):
        return [self.op]

    def evaluate(self, ctx, buffers):
        return buffers[0]


class Max(Min):
    op = "max"


class First(AggregateFunction):
    """first(x[, ignorenulls]): the group's first row in fold order, or
    its first non-null row with ``ignore_nulls``."""

    op = "first"

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        super().__init__(child)
        self.ignore_nulls = ignore_nulls

    def data_type(self):
        return self.child.data_type()

    def _op(self):
        return self.op if self.ignore_nulls else self.op + "_any"

    def update(self):
        return [(self.child, self._op())]

    def buffer_types(self):
        return [self.data_type()]

    def merge_ops(self):
        return [self._op()]

    def evaluate(self, ctx, buffers):
        return buffers[0]


class Last(First):
    op = "last"


class CollectList(AggregateFunction):
    """collect_list(x): the group's non-null values as an array, in fold
    order; an empty group gives [], never null."""

    update_op = "collect_list"
    merge_op = "collect_concat"

    def data_type(self):
        return t.ArrayType(self.child.data_type())

    def update(self):
        return [(self.child, self.update_op)]

    def buffer_types(self):
        return [self.data_type()]

    def merge_ops(self):
        return [self.merge_op]

    def evaluate(self, ctx, buffers):
        return buffers[0]


class CollectSet(CollectList):
    """collect_set(x): collect_list without repeats, each value once in
    the order of its value words."""

    update_op = "collect_set"
    merge_op = "collect_concat_set"


class _MomentAgg(AggregateFunction):
    """Variance and standard deviation over the buffers (count, sum, sum
    of squares) of the input as DOUBLE, as the reference keeps them: M2
    = sumsq - sum^2 / n, clamped at 0 (not Welford's update)."""

    ddof = 1

    def data_type(self):
        return t.DOUBLE

    def update(self):
        from .arithmetic import Multiply
        x = Cast(self.child, t.DOUBLE)
        return [(self.child, "countvalid"), (x, "sum"),
                (Multiply(x, x), "sum")]

    def buffer_types(self):
        return [t.LONG, t.DOUBLE, t.DOUBLE]

    def merge_ops(self):
        return ["sum", "sum", "sum"]

    def _var(self, buffers):
        n = buffers[0].col.data.to(torch.float64)
        s, ss = buffers[1].col.data, buffers[2].col.data
        m2 = ss - torch.where(n > 0, s * s / torch.clamp(n, min=1.0),
                              torch.zeros_like(s))
        m2 = torch.clamp(m2, min=0.0)
        denom = n - self.ddof
        ok = denom > 0
        return torch.where(ok, m2 / torch.clamp(denom, min=1.0),
                           torch.zeros_like(m2)), ok

    def evaluate(self, ctx, buffers):
        var, ok = self._var(buffers)
        return make_column(ctx, t.DOUBLE, var, ok)


class VarianceSamp(_MomentAgg):
    pass


class VariancePop(_MomentAgg):
    ddof = 0


class StddevSamp(_MomentAgg):
    def evaluate(self, ctx, buffers):
        var, ok = self._var(buffers)
        return make_column(ctx, t.DOUBLE, torch.sqrt(var), ok)


class StddevPop(StddevSamp):
    ddof = 0


class PivotFirst(AggregateFunction):
    """pivot_first(p, x, v): the first non-null x of the rows whose p is
    v (null-safe), as ``first`` over IF(p <=> v, x, NULL); a pivot
    lowers to one per pivot value."""

    def __init__(self, pivot: Expression, value: Expression, pivot_value):
        self.children = (pivot, value)
        self.pivot_value = pivot_value

    def data_type(self):
        return self.children[1].data_type()

    def sql(self):
        return (f"pivot_first({self.children[0].sql()}, "
                f"{self.children[1].sql()}, {self.pivot_value!r})")

    def _masked(self):
        from .conditional import If
        from .predicates import EqualNullSafe
        return If(EqualNullSafe(self.children[0], Literal(self.pivot_value)),
                  self.children[1], Literal(None, t.NULL))

    def update(self):
        return [(self._masked(), "first")]

    def buffer_types(self):
        return [self.data_type()]

    def merge_ops(self):
        return ["first"]

    def evaluate(self, ctx, buffers):
        return buffers[0]


class ApproximatePercentile(AggregateFunction):
    """approx_percentile(x, p[, accuracy]): exact, the inverted-CDF
    element of rank ceil(p n) - 1 of the group's n non-null values
    (collected, then sorted within each group by value); null for an
    empty group.  ``accuracy`` is kept for the API and not used."""

    def __init__(self, child: Expression, percentage: float,
                 accuracy: int = 10000):
        super().__init__(child)
        self.percentage = float(percentage)
        self.accuracy = int(accuracy)

    def data_type(self):
        ct = self.child.data_type()
        return ct if t.is_numeric(ct) else t.DOUBLE

    def sql(self):
        return f"approx_percentile({self.child.sql()}, {self.percentage})"

    def update(self):
        return [(self.child, "collect_list")]

    def buffer_types(self):
        return [t.ArrayType(self.child.data_type())]

    def merge_ops(self):
        return ["collect_concat"]

    def evaluate(self, ctx, buffers):
        from ..columnar.device import DeviceColumn
        from ..ops import segmented as seg
        arr = buffers[0].col
        offs = arr.offsets.to(torch.int64)      # [cap + 1], padding empty
        child = arr.children[0]
        total = int(offs[-1])
        n = offs[1:] - offs[:-1]
        valid = n > 0
        if total == 0:
            return make_column(ctx, self.data_type(), torch.zeros(
                n.shape[0], dtype=child.data.dtype, device=n.device), valid)
        # each value's group, then the values sorted by (group, value)
        pos = torch.arange(total, dtype=torch.int64, device=n.device)
        grp = torch.searchsorted(offs[1:], pos, right=True)
        vals = DeviceColumn(child.dtype, child.data[:total],
                            child.validity[:total])
        order = seg.lexsort([grp] + seg.sort_key_words(vals)[1:])
        k = torch.ceil(self.percentage * n.to(torch.float64)).to(
            torch.int64) - 1
        k = torch.minimum(torch.clamp(k, min=0), torch.clamp(n - 1, min=0))
        at = torch.clamp(offs[:-1] + k, 0, total - 1)
        data = vals.data[order.to(torch.int64)[at]]
        return make_column(ctx, self.data_type(), data, valid)


class AggregateExpression(Expression):
    """An aggregate function bound to its output name."""

    def __init__(self, func: AggregateFunction, name: Optional[str] = None):
        self.children = (func,)
        self.func = func
        self.name = name or func.sql()

    def with_children(self, children):
        c = super().with_children(children)
        c.func = c.children[0]
        return c

    def data_type(self):
        return self.func.data_type()

    def sql(self):
        return self.name


def bind_aggregate(ae: AggregateExpression, names, dtypes
                   ) -> AggregateExpression:
    """Bind the function's child expressions against an input schema."""
    fn = ae.func
    if fn.children:
        fn = copy.copy(fn)
        fn.children = tuple(bind_expression(c, names, dtypes)
                            for c in ae.func.children)
    return AggregateExpression(fn, ae.name)

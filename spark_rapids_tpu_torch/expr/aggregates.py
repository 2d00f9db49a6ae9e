"""Declarative aggregate functions: Sum, Count, Average, Min, Max.

Counterpart of spark_rapids_tpu/expr/aggregates.py.  Each function
declares its update stage (input expression and segmented op per
buffer), its buffer types, its merge ops over partial buffers, and the
expression that evaluates the final value from merged buffers.  Ops are
``sum``, ``countvalid`` (the count of non-null rows), ``min`` and
``max``; a buffer's group is null when no row contributed to it.  Min
and Max run grouped and global (exec/aggregate.py, K3's min and max
folds) and over windows (exec/window.py).  Result and buffer types
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

"""Comparisons and three-valued boolean logic.

Counterpart of spark_rapids_tpu/expr/predicates.py for numeric and
boolean operands: FALSE AND NULL is FALSE, TRUE OR NULL is TRUE, and
doubles follow Spark's total order (NaN equals NaN and is greater than
every other value).
"""

from __future__ import annotations

import torch

from .. import types as t
from .arithmetic import cast_data, promote
from .core import (EvalContext, Expression, and_validity, data_of, evaluator,
                   make_column, validity_of)


class BinaryComparison(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        self.children = (left, right)

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def data_type(self):
        return t.BOOLEAN

    def sql(self):
        return f"({self.left.sql()} {self.symbol} {self.right.sql()})"


class EqualTo(BinaryComparison):
    symbol = "="


class LessThan(BinaryComparison):
    symbol = "<"


class LessThanOrEqual(BinaryComparison):
    symbol = "<="


class GreaterThan(BinaryComparison):
    symbol = ">"


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="


def _cmp_inputs(e: BinaryComparison, ctx: EvalContext):
    lv, rv = e.left.eval(ctx), e.right.eval(ctx)
    lt, rt = e.left.data_type(), e.right.data_type()
    common = promote(lt, rt)
    sides = []
    for d, dt in ((data_of(lv), lt), (data_of(rv), rt)):
        d = cast_data(d, dt, common)
        if not isinstance(d, torch.Tensor):      # a literal: 0-d tensor
            d = torch.tensor(d, dtype=common.torch_dtype, device=ctx.device)
        sides.append(d)
    ld, rd = sides
    if ld.dim() == 0 and rd.dim() == 0:
        ld = ld.expand(ctx.capacity)
    return ld, rd, common, and_validity(ctx, validity_of(lv),
                                        validity_of(rv))


@evaluator(EqualTo)
def _eval_eq(e: EqualTo, ctx: EvalContext):
    ld, rd, common, v = _cmp_inputs(e, ctx)
    data = ld == rd
    if common == t.DOUBLE:
        data = data | (torch.isnan(ld) & torch.isnan(rd))
    return make_column(ctx, t.BOOLEAN, data, v)


def _eval_ordering(e: BinaryComparison, ctx: EvalContext, flip: bool,
                   or_equal: bool):
    ld, rd, common, v = _cmp_inputs(e, ctx)
    if flip:
        ld, rd = rd, ld
    if common == t.DOUBLE:
        a_nan, b_nan = torch.isnan(ld), torch.isnan(rd)
        lt = ~a_nan & (b_nan | (ld < rd))
        data = (lt | (ld == rd) | (a_nan & b_nan)) if or_equal else lt
    else:
        data = (ld <= rd) if or_equal else (ld < rd)
    return make_column(ctx, t.BOOLEAN, data, v)


@evaluator(LessThan)
def _eval_lt(e, ctx):
    return _eval_ordering(e, ctx, flip=False, or_equal=False)


@evaluator(LessThanOrEqual)
def _eval_le(e, ctx):
    return _eval_ordering(e, ctx, flip=False, or_equal=True)


@evaluator(GreaterThan)
def _eval_gt(e, ctx):
    return _eval_ordering(e, ctx, flip=True, or_equal=False)


@evaluator(GreaterThanOrEqual)
def _eval_ge(e, ctx):
    return _eval_ordering(e, ctx, flip=True, or_equal=True)


class And(Expression):
    def __init__(self, left, right):
        self.children = (left, right)

    def data_type(self):
        return t.BOOLEAN

    def sql(self):
        return f"({self.children[0].sql()} AND {self.children[1].sql()})"


class Or(Expression):
    def __init__(self, left, right):
        self.children = (left, right)

    def data_type(self):
        return t.BOOLEAN

    def sql(self):
        return f"({self.children[0].sql()} OR {self.children[1].sql()})"


class Not(Expression):
    def __init__(self, child):
        self.children = (child,)

    def data_type(self):
        return t.BOOLEAN

    def sql(self):
        return f"(NOT {self.children[0].sql()})"


def _bool_parts(ctx: EvalContext, v):
    d = data_of(v)
    if not isinstance(d, torch.Tensor):
        d = torch.full((ctx.capacity,), bool(d), device=ctx.device)
    val = validity_of(v)
    if val is None:
        val = torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device)
    elif val is False:
        val = torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
    return d.to(torch.bool), val


@evaluator(And)
def _eval_and(e: And, ctx: EvalContext):
    da, va = _bool_parts(ctx, e.children[0].eval(ctx))
    db, vb = _bool_parts(ctx, e.children[1].eval(ctx))
    data = da & db & va & vb
    validity = (va & vb) | (va & ~da) | (vb & ~db)
    return make_column(ctx, t.BOOLEAN, data, validity)


@evaluator(Or)
def _eval_or(e: Or, ctx: EvalContext):
    da, va = _bool_parts(ctx, e.children[0].eval(ctx))
    db, vb = _bool_parts(ctx, e.children[1].eval(ctx))
    data = (da & va) | (db & vb)
    validity = (va & vb) | (va & da) | (vb & db)
    return make_column(ctx, t.BOOLEAN, data, validity)


@evaluator(Not)
def _eval_not(e: Not, ctx: EvalContext):
    d, v = _bool_parts(ctx, e.children[0].eval(ctx))
    return make_column(ctx, t.BOOLEAN, ~d & v, v)


"""Comparisons, three-valued boolean logic, null tests and IN.

Counterpart of spark_rapids_tpu/expr/predicates.py for numeric, date,
timestamp and boolean operands: FALSE AND NULL is FALSE, TRUE OR NULL is
TRUE, and doubles and floats follow Spark's total order (NaN equals NaN
and is greater than every other value).  Decimals compare at their
common type's scale, over int128 pairs, so mixed scales and precisions
compare exactly.  ``<=>`` is true for two nulls; IS NULL, IS NOT
NULL and isnan are never null; IN is null when the value is null, or
when nothing matches and the list holds a null.  IN compares doubles as
``=`` does (NaN IN (NaN) is true, Spark's answer); the reference's IN
compares them by IEEE ``==`` (ROADMAP.md Queue 3).

String operands (a column or a literal on either side) compare as the
reference compares them (ops/strings.py): ``=``, ``<=>`` and IN by the
length and the two rolling hashes (K14), ``<``, ``<=``, ``>`` and
``>=`` by the 4 prefix words and the length (K17), so strings sharing
more than 32 bytes of prefix order by length only.  A literal is hashed
once on the host (``scalar_string_keys``).
"""

from __future__ import annotations

import torch

from .. import types as t
from ..ops import int128 as i128
from ..ops import strings as sops
from .arithmetic import cast_data, decimal_operand, promote
from .core import (ColumnValue, EvalContext, Expression, and_validity,
                   data_of, evaluator, make_column, validity_of)


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


class EqualNullSafe(BinaryComparison):
    symbol = "<=>"


class LessThan(BinaryComparison):
    symbol = "<"


class LessThanOrEqual(BinaryComparison):
    symbol = "<="


class GreaterThan(BinaryComparison):
    symbol = ">"


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="


def _is_string(e: Expression) -> bool:
    return e.data_type() == t.STRING


def _literal_bytes(v) -> bytes:
    return v.value if isinstance(v.value, bytes) else b""


def _string_eq_data(ctx: EvalContext, lv, rv, col_hashes=None):
    """bool[cap]: the two string values are equal (their lengths and both
    hashes); ``col_hashes`` are a column side's hashes when known."""
    if isinstance(lv, ColumnValue) and isinstance(rv, ColumnValue):
        a, b = lv.col, rv.col
        return sops.string_eq(a.offsets, a.data, b.offsets, b.data)
    if not isinstance(lv, ColumnValue) and not isinstance(rv, ColumnValue):
        return torch.full((ctx.capacity,),
                          _literal_bytes(lv) == _literal_bytes(rv),
                          device=ctx.device)
    c, lit = (lv, rv) if isinstance(lv, ColumnValue) else (rv, lv)
    c1, c2 = col_hashes or sops.string_hashes(c.col.offsets, c.col.data)
    _, h1, h2, ln = sops.scalar_string_keys(_literal_bytes(lit))
    return (sops.lengths(c.col.offsets) == ln) & (c1 == h1) & (c2 == h2)


def _string_order_lt(ctx: EvalContext, lv, rv, or_equal: bool):
    """bool[cap]: a < b (or <=) by the lexicographic order of the prefix
    words and the length."""
    def keys(v):
        if isinstance(v, ColumnValue):
            return sops.order_keys(v.col.offsets, v.col.data)
        words, _, _, ln = sops.scalar_string_keys(_literal_bytes(v))
        return [torch.full((ctx.capacity,), w, dtype=torch.int64,
                           device=ctx.device)
                for w in words + [ln ^ -2**63]]
    lt = torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
    eq = torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device)
    for a, b in zip(keys(lv), keys(rv)):
        lt = lt | (eq & (a < b))
        eq = eq & (a == b)
    return (lt | eq) if or_equal else lt


def _cmp_values(e: BinaryComparison, ctx: EvalContext, lv, rv):
    """Both sides at their common type: tensors, or int128 pairs for a
    decimal common type."""
    lt, rt = e.left.data_type(), e.right.data_type()
    common = promote(lt, rt)
    if isinstance(common, t.DecimalType):
        return (decimal_operand(ctx, lv, lt, common.scale),
                decimal_operand(ctx, rv, rt, common.scale), common)
    sides = []
    for d, dt in ((data_of(lv), lt), (data_of(rv), rt)):
        d = cast_data(d, dt, common)
        if not isinstance(d, torch.Tensor):      # a literal: 0-d tensor
            d = torch.tensor(d, dtype=common.torch_dtype, device=ctx.device)
        sides.append(d)
    ld, rd = sides
    if ld.dim() == 0 and rd.dim() == 0:
        ld = ld.expand(ctx.capacity)
    return ld, rd, common


def _cmp_inputs(e: BinaryComparison, ctx: EvalContext):
    lv, rv = e.left.eval(ctx), e.right.eval(ctx)
    ld, rd, common = _cmp_values(e, ctx, lv, rv)
    return ld, rd, common, and_validity(ctx, validity_of(lv),
                                        validity_of(rv))


def _equal(ld, rd, common: t.DataType):
    if isinstance(ld, tuple):
        return i128.eq(ld, rd)
    data = ld == rd
    if common in (t.DOUBLE, t.FLOAT):
        data = data | (torch.isnan(ld) & torch.isnan(rd))
    return data


@evaluator(EqualTo)
def _eval_eq(e: EqualTo, ctx: EvalContext):
    if _is_string(e.left) or _is_string(e.right):
        lv, rv = e.left.eval(ctx), e.right.eval(ctx)
        return make_column(ctx, t.BOOLEAN, _string_eq_data(ctx, lv, rv),
                           and_validity(ctx, validity_of(lv),
                                        validity_of(rv)))
    ld, rd, common, v = _cmp_inputs(e, ctx)
    return make_column(ctx, t.BOOLEAN, _equal(ld, rd, common), v)


def _full_validity(ctx: EvalContext, v):
    val = validity_of(v)
    if val is None:
        return torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device)
    if val is False:
        return torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
    return val


@evaluator(EqualNullSafe)
def _eval_eq_ns(e: EqualNullSafe, ctx: EvalContext):
    lv, rv = e.left.eval(ctx), e.right.eval(ctx)
    if _is_string(e.left) or _is_string(e.right):
        eq = _string_eq_data(ctx, lv, rv)
    else:
        ld, rd, common = _cmp_values(e, ctx, lv, rv)
        eq = _equal(ld, rd, common)
    va, vb = _full_validity(ctx, lv), _full_validity(ctx, rv)
    data = (va & vb & eq) | (~va & ~vb)
    return make_column(ctx, t.BOOLEAN, data, None)


def _eval_ordering(e: BinaryComparison, ctx: EvalContext, flip: bool,
                   or_equal: bool):
    if _is_string(e.left) or _is_string(e.right):
        lv, rv = e.left.eval(ctx), e.right.eval(ctx)
        a, b = (rv, lv) if flip else (lv, rv)
        return make_column(ctx, t.BOOLEAN,
                           _string_order_lt(ctx, a, b, or_equal),
                           and_validity(ctx, validity_of(lv),
                                        validity_of(rv)))
    ld, rd, common, v = _cmp_inputs(e, ctx)
    if flip:
        ld, rd = rd, ld
    if isinstance(ld, tuple):
        lt = i128.lt(ld, rd)
        data = (lt | i128.eq(ld, rd)) if or_equal else lt
    elif common in (t.DOUBLE, t.FLOAT):
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



# ---------------------------------------------------------------------------
# null tests
# ---------------------------------------------------------------------------

class IsNull(Expression):
    def __init__(self, child):
        self.children = (child,)

    def data_type(self):
        return t.BOOLEAN

    def sql(self):
        return f"({self.children[0].sql()} IS NULL)"


class IsNotNull(IsNull):
    def sql(self):
        return f"({self.children[0].sql()} IS NOT NULL)"


class IsNaN(Expression):
    def __init__(self, child):
        self.children = (child,)

    def data_type(self):
        return t.BOOLEAN


def _eval_isnull(e: IsNull, ctx: EvalContext):
    val = _full_validity(ctx, e.children[0].eval(ctx))
    return make_column(ctx, t.BOOLEAN,
                       val if type(e) is IsNotNull else ~val, None)


evaluator(IsNull)(_eval_isnull)
evaluator(IsNotNull)(_eval_isnull)


@evaluator(IsNaN)
def _eval_isnan(e: IsNaN, ctx: EvalContext):
    """isnan(null) is false."""
    v = e.children[0].eval(ctx)
    val = _full_validity(ctx, v)
    d = data_of(v)
    if e.children[0].data_type() not in (t.DOUBLE, t.FLOAT):
        return make_column(ctx, t.BOOLEAN, torch.zeros_like(val), None)
    nan = torch.isnan(d) if isinstance(d, torch.Tensor) else \
        torch.full_like(val, d != d)
    return make_column(ctx, t.BOOLEAN, nan & val, None)


# ---------------------------------------------------------------------------
# IN
# ---------------------------------------------------------------------------

class In(Expression):
    """value IN (literals...)."""

    def __init__(self, value: Expression, items):
        self.children = (value,)
        self.items = tuple(items)            # Literal expressions

    def data_type(self):
        return t.BOOLEAN

    def sql(self):
        return (f"({self.children[0].sql()} IN "
                f"({', '.join(i.sql() for i in self.items)}))")


@evaluator(In)
def _eval_in(e: In, ctx: EvalContext):
    v = e.children[0].eval(ctx)
    val = _full_validity(ctx, v)
    dt = e.children[0].data_type()
    d = data_of(v)
    matched = torch.zeros(ctx.capacity, dtype=torch.bool, device=ctx.device)
    has_null = False
    hashes = None
    if dt == t.STRING and isinstance(v, ColumnValue):
        hashes = sops.string_hashes(v.col.offsets, v.col.data)   # once
    for item in e.items:
        if item.value is None:
            has_null = True
            continue
        if dt == t.STRING:
            matched = matched | _string_eq_data(ctx, v, item.eval(ctx),
                                                hashes)
            continue
        common = promote(dt, item.dtype)
        if isinstance(common, t.DecimalType):
            matched = matched | i128.eq(
                decimal_operand(ctx, v, dt, common.scale),
                decimal_operand(ctx, item.eval(ctx), item.dtype,
                                common.scale))
            continue
        ld = cast_data(d, dt, common)
        if not isinstance(ld, torch.Tensor):
            ld = torch.full((ctx.capacity,), ld, dtype=common.torch_dtype,
                            device=ctx.device)
        rd = cast_data(item.value, item.dtype, common)
        matched = matched | (torch.isnan(ld) if rd != rd else ld == rd)
    validity = val & matched if has_null else val
    return make_column(ctx, t.BOOLEAN, matched & val, validity)

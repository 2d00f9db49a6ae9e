"""Arithmetic expressions with Spark SQL semantics, over the port's flat
types.

Counterpart of spark_rapids_tpu/expr/arithmetic.py: ``promote``,
``cast_data``, Add, Subtract, Multiply, Divide, IntegralDivide,
Remainder, Pmod, UnaryMinus, UnaryPositive, Abs, Greatest and Least.
The port carries no decimal type, so the reference's decimal branches
wait for Queue 1 item 3 with the type itself.  Semantics (Spark's
non-ANSI mode):
  * integral overflow wraps (``Abs`` and ``-`` of INT64_MIN give
    INT64_MIN);
  * ``/`` always gives DOUBLE; a zero divisor gives null for ``/``,
    ``div``, ``%`` and ``pmod``;
  * ``div`` and ``%`` truncate toward zero, so ``%`` takes the
    dividend's sign (``torch.fmod``, never ``torch.remainder``); a
    divisor of -1 is a wrapping negation and a remainder of 0, taken
    before the divide (integer INT64_MIN / -1 traps on the CPU);
  * ``pmod`` is Spark's ``r = a % n; r < 0 ? (r + n) % n : r``;
  * ``greatest`` and ``least`` skip nulls and order doubles by Spark's
    total order (NaN is the greatest value).
Where the reference's numpy/jnp arithmetic departs from Spark (INT64_MIN
over a divisor other than +-1, pmod with a negative divisor, NaN in
greatest/least), the port follows Spark (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import torch

from .. import types as t
from .core import (EvalContext, Expression, and_validity, data_of, evaluator,
                   make_column, validity_of)

_INT_ORDER = (t.IntegerType, t.LongType)


def promote(a: t.DataType, b: t.DataType) -> t.DataType:
    if a == b or b == t.NULL:
        return a
    if a == t.NULL:
        return b
    if a == t.DOUBLE or b == t.DOUBLE:
        if a == t.BOOLEAN or b == t.BOOLEAN:
            raise TypeError(f"cannot promote {a} and {b}")
        return t.DOUBLE
    if t.is_integral(a) and t.is_integral(b):
        ia = _INT_ORDER.index(type(a))
        ib = _INT_ORDER.index(type(b))
        return a if ia >= ib else b
    raise TypeError(f"cannot promote {a} and {b}")


def cast_data(data, src: t.DataType, dst: t.DataType):
    """Plain numeric representation change of a tensor or a Python
    scalar (no bounds checks)."""
    if src == dst:
        return data
    if isinstance(data, torch.Tensor):
        return data.to(dst.torch_dtype)
    if dst == t.DOUBLE:
        return float(data)
    if dst == t.BOOLEAN:
        return bool(data)
    return int(data)


def wrap_int(x: int, dtype: t.DataType) -> int:
    """A Python int wrapped into ``dtype``'s two's-complement range."""
    bits = 32 if dtype == t.INT else 64
    half = 1 << (bits - 1)
    return ((x + half) % (1 << bits)) - half


def operands(ctx: EvalContext, left: Expression, right: Expression,
             out: t.DataType):
    """Both children's data as ``out`` and their joint validity.  A
    literal side stays a Python scalar; when both are, the left becomes a
    column."""
    lv, rv = left.eval(ctx), right.eval(ctx)
    ld = cast_data(data_of(lv), left.data_type(), out)
    rd = cast_data(data_of(rv), right.data_type(), out)
    if not isinstance(ld, torch.Tensor) and not isinstance(rd, torch.Tensor):
        ld = torch.full((ctx.capacity,), ld, dtype=out.torch_dtype,
                        device=ctx.device)
    return ld, rd, and_validity(ctx, validity_of(lv), validity_of(rv))


def _nonzero_divisor(ctx: EvalContext, rd, validity):
    """(a divisor that is never 0, the validity with zero divisors
    null)."""
    if isinstance(rd, torch.Tensor):
        zero = rd == 0
        return (torch.where(zero, torch.ones_like(rd), rd),
                and_validity(ctx, validity, ~zero))
    if rd == 0:
        return 1, False
    return rd, validity


class BinaryArithmetic(Expression):
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
        return promote(self.left.data_type(), self.right.data_type())

    def sql(self):
        return f"({self.left.sql()} {self.symbol} {self.right.sql()})"


class Add(BinaryArithmetic):
    symbol = "+"


class Subtract(BinaryArithmetic):
    symbol = "-"


class Multiply(BinaryArithmetic):
    symbol = "*"


class Divide(BinaryArithmetic):
    symbol = "/"

    def data_type(self):
        return t.DOUBLE


class IntegralDivide(BinaryArithmetic):
    symbol = "div"

    def data_type(self):
        return t.LONG


class Remainder(BinaryArithmetic):
    symbol = "%"


class Pmod(BinaryArithmetic):
    symbol = "pmod"


@evaluator(Add)
def _eval_add(e: Add, ctx: EvalContext):
    out = e.data_type()
    ld, rd, v = operands(ctx, e.left, e.right, out)
    return make_column(ctx, out, ld + rd, v)


@evaluator(Subtract)
def _eval_sub(e: Subtract, ctx: EvalContext):
    out = e.data_type()
    ld, rd, v = operands(ctx, e.left, e.right, out)
    return make_column(ctx, out, ld - rd, v)


@evaluator(Multiply)
def _eval_mul(e: Multiply, ctx: EvalContext):
    out = e.data_type()
    ld, rd, v = operands(ctx, e.left, e.right, out)
    return make_column(ctx, out, ld * rd, v)


@evaluator(Divide)
def _eval_div(e: Divide, ctx: EvalContext):
    ld, rd, v = operands(ctx, e.left, e.right, t.DOUBLE)
    rd, v = _nonzero_divisor(ctx, rd, v)
    return make_column(ctx, t.DOUBLE, ld / rd, v)


def _truncated(ld, rd):
    """(quotient truncated toward zero, remainder with the dividend's
    sign) of integer ``ld`` by a nonzero ``rd``.  A divisor of -1 never
    reaches the divide: its quotient is the wrapping negation and its
    remainder 0."""
    if not isinstance(rd, torch.Tensor):
        if rd == -1:
            return -ld, torch.zeros_like(ld)
        return (torch.div(ld, rd, rounding_mode="trunc"),
                torch.fmod(ld, rd))
    minus_one = rd == -1
    safe = torch.where(minus_one, torch.ones_like(rd), rd)
    if not isinstance(ld, torch.Tensor):
        ld = torch.full_like(rd, ld)
    q = torch.where(minus_one, -ld,
                    torch.div(ld, safe, rounding_mode="trunc"))
    r = torch.where(minus_one, torch.zeros_like(ld), torch.fmod(ld, safe))
    return q, r


def _remainder(ld, rd, out: t.DataType):
    if out == t.DOUBLE:
        return torch.fmod(ld, rd) if isinstance(ld, torch.Tensor) else \
            torch.fmod(torch.full_like(rd, ld), rd)
    return _truncated(ld, rd)[1]


@evaluator(IntegralDivide)
def _eval_idiv(e: IntegralDivide, ctx: EvalContext):
    ld, rd, v = operands(ctx, e.left, e.right, t.LONG)
    rd, v = _nonzero_divisor(ctx, rd, v)
    return make_column(ctx, t.LONG, _truncated(ld, rd)[0], v)


@evaluator(Remainder)
def _eval_rem(e: Remainder, ctx: EvalContext):
    out = e.data_type()
    ld, rd, v = operands(ctx, e.left, e.right, out)
    rd, v = _nonzero_divisor(ctx, rd, v)
    return make_column(ctx, out, _remainder(ld, rd, out), v)


@evaluator(Pmod)
def _eval_pmod(e: Pmod, ctx: EvalContext):
    out = e.data_type()
    ld, rd, v = operands(ctx, e.left, e.right, out)
    rd, v = _nonzero_divisor(ctx, rd, v)
    r = _remainder(ld, rd, out)
    fixed = _remainder(r + rd, rd, out)
    return make_column(ctx, out, torch.where(r < 0, fixed, r), v)


class UnaryMinus(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self):
        return self.children[0].data_type()

    def sql(self):
        return f"(- {self.children[0].sql()})"


class UnaryPositive(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self):
        return self.children[0].data_type()


class Abs(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self):
        return self.children[0].data_type()


def _negate(d, dtype: t.DataType):
    if isinstance(d, torch.Tensor):
        return -d
    return -d if dtype == t.DOUBLE else wrap_int(-d, dtype)


@evaluator(UnaryMinus)
def _eval_neg(e: UnaryMinus, ctx: EvalContext):
    v = e.children[0].eval(ctx)
    return make_column(ctx, e.data_type(), _negate(data_of(v), e.data_type()),
                       validity_of(v))


@evaluator(UnaryPositive)
def _eval_pos(e: UnaryPositive, ctx: EvalContext):
    return e.children[0].eval(ctx)


@evaluator(Abs)
def _eval_abs(e: Abs, ctx: EvalContext):
    v = e.children[0].eval(ctx)
    d, dt = data_of(v), e.data_type()
    if dt == t.DOUBLE:
        d = torch.abs(d) if isinstance(d, torch.Tensor) else abs(d)
    elif isinstance(d, torch.Tensor):
        d = torch.where(d < 0, -d, d)          # -INT64_MIN wraps
    else:
        d = wrap_int(abs(d), dt)
    return make_column(ctx, dt, d, validity_of(v))


class Greatest(Expression):
    def __init__(self, *children: Expression):
        self.children = tuple(children)

    def data_type(self):
        out = self.children[0].data_type()
        for c in self.children[1:]:
            out = promote(out, c.data_type())
        return out


class Least(Greatest):
    pass


def _eval_extreme(e, ctx: EvalContext, is_max: bool):
    """Per row, the greatest (least) non-null child; null if all are."""
    from ..ops.segmented import ordered_word
    out = e.data_type()
    best = best_word = best_valid = None
    for c in e.children:
        v = c.eval(ctx)
        d = cast_data(data_of(v), c.data_type(), out)
        if not isinstance(d, torch.Tensor):
            d = torch.full((ctx.capacity,), d, dtype=out.torch_dtype,
                           device=ctx.device)
        val = and_validity(ctx, validity_of(v))
        if val is None:
            val = torch.ones(ctx.capacity, dtype=torch.bool,
                             device=ctx.device)
        word = ordered_word(d)
        if best is None:
            best, best_word, best_valid = d, word, val
            continue
        better = (word > best_word) if is_max else (word < best_word)
        take = val & (~best_valid | better)
        best = torch.where(take, d, best)
        best_word = torch.where(take, word, best_word)
        best_valid = best_valid | val
    return make_column(ctx, out, best, best_valid)


@evaluator(Greatest)
def _eval_greatest(e, ctx):
    return _eval_extreme(e, ctx, True)


@evaluator(Least)
def _eval_least(e, ctx):
    return _eval_extreme(e, ctx, False)

"""Arithmetic expressions with Spark SQL semantics, over the port's flat
types.

Counterpart of spark_rapids_tpu/expr/arithmetic.py: ``promote``,
``cast_data``, Add, Subtract, Multiply, Divide, IntegralDivide,
Remainder, Pmod, UnaryMinus, UnaryPositive, Abs, Greatest and Least.
Decimals follow the reference's ``DecimalPrecision`` result types
(``_decimal_binary_type``): ``+``/``-`` rescale both sides to the larger
scale, ``*`` adds the scales, ``/`` rounds HALF_UP to its scale, ``div``,
``%`` and ``pmod`` divide both sides' words at the common scale with
truncation (``div`` a LONG, the others the common decimal type), and a
zero divisor gives null.  Every decimal result is computed exactly over
int128 (lo, hi) pairs (``ops/int128.py``; the reference's CPU engine uses
Python-int object arrays for the same integers), so a DECIMAL(26..38)
product is exact on either engine; the plan rewrite keeps expressions
over more than 18 digits on the CPU engine, as the reference's does.
BYTE and SHORT arithmetic wraps in its own width.  Semantics (Spark's
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
greatest/least, a decimal ``div`` through doubles), the port follows
Spark (ROADMAP.md Queue 3).
"""

from __future__ import annotations

import torch

from .. import types as t
from ..ops import int128 as i128
from .core import (ColumnValue, EvalContext, Expression, and_validity,
                   data_of, decimal_pair, evaluator, make_column,
                   make_decimal_column, validity_of)

_INT_ORDER = (t.ByteType, t.ShortType, t.IntegerType, t.LongType)
_INT_BITS = {t.BYTE: 8, t.SHORT: 16, t.INT: 32, t.LONG: 64}


def promote(a: t.DataType, b: t.DataType) -> t.DataType:
    """Spark's tightest common type of two operands (the reference's
    subset)."""
    if a == b or b == t.NULL:
        return a
    if a == t.NULL:
        return b
    if t.BOOLEAN in (a, b) and (t.is_numeric(a) or t.is_numeric(b)):
        raise TypeError(f"cannot promote {a} and {b}")
    if a == t.DOUBLE or b == t.DOUBLE:
        return t.DOUBLE
    if a == t.FLOAT or b == t.FLOAT:
        return t.FLOAT
    if isinstance(a, t.DecimalType) and isinstance(b, t.DecimalType):
        scale = max(a.scale, b.scale)
        intd = max(a.precision - a.scale, b.precision - b.scale)
        return t.DecimalType(min(intd + scale, t.MAX_DECIMAL128_PRECISION),
                             scale)
    if isinstance(a, t.DecimalType) and t.is_integral(b):
        return promote(a, _decimal_of_integral(b))
    if isinstance(b, t.DecimalType) and t.is_integral(a):
        return promote(_decimal_of_integral(a), b)
    if t.is_integral(a) and t.is_integral(b):
        ia = _INT_ORDER.index(type(a))
        ib = _INT_ORDER.index(type(b))
        return a if ia >= ib else b
    raise TypeError(f"cannot promote {a} and {b}")


def _decimal_of_integral(dt: t.DataType) -> t.DecimalType:
    return t.DecimalType({t.BYTE: 3, t.SHORT: 5, t.INT: 10,
                          t.LONG: 20}[dt], 0)


def _as_decimal(dt: t.DataType) -> t.DecimalType:
    return dt if isinstance(dt, t.DecimalType) else _decimal_of_integral(dt)


def _decimal_binary_type(op: str, lt: t.DecimalType,
                         rt: t.DecimalType) -> t.DecimalType:
    """Spark's DecimalPrecision result types, capped at 38 digits as the
    reference caps them."""
    p1, s1, p2, s2 = lt.precision, lt.scale, rt.precision, rt.scale
    if op in ("add", "sub"):
        scale = max(s1, s2)
        prec = max(p1 - s1, p2 - s2) + scale + 1
    elif op == "mul":
        scale = s1 + s2
        prec = p1 + p2 + 1
    elif op == "div":
        scale = max(6, s1 + p2 + 1)
        prec = p1 - s1 + s2 + scale
    else:
        raise ValueError(op)
    return t.DecimalType(min(prec, t.MAX_DECIMAL128_PRECISION),
                         min(scale, 38))


def div_round_half_up(num: torch.Tensor, den) -> torch.Tensor:
    """Integer num / den rounded half away from zero (Spark's decimal
    rounding) for int64 tensors and a nonzero divisor (the reference's
    ``_div_round_half_up``)."""
    trunc = torch.div(num, den, rounding_mode="trunc")
    r = (num - trunc * den).abs()
    den_abs = den.abs() if isinstance(den, torch.Tensor) else abs(den)
    step = torch.where((num < 0) != (torch.as_tensor(den) < 0), -1, 1)
    return trunc + torch.where(2 * r >= den_abs, step, 0)


def cast_data(data, src: t.DataType, dst: t.DataType):
    """Plain numeric representation change of a tensor or a Python
    scalar (no bounds checks); a decimal in one int64 lane is rescaled
    (up by a multiply, down HALF_UP)."""
    if src == dst:
        return data
    if isinstance(dst, t.DecimalType) and (
            isinstance(src, t.DecimalType) or t.is_integral(src)):
        scale = src.scale if isinstance(src, t.DecimalType) else 0
        k = dst.scale - scale
        if not isinstance(data, torch.Tensor):
            return _rescale_int(int(data), k)
        data = data.to(torch.int64)
        return data * 10 ** k if k >= 0 else \
            div_round_half_up(data, 10 ** -k)
    if isinstance(src, t.DecimalType):
        if not isinstance(data, torch.Tensor):
            data = int(data) / 10.0 ** src.scale
            return data if dst in (t.DOUBLE, t.FLOAT) else int(data)
        return (data.to(torch.float64) / 10.0 ** src.scale).to(
            dst.torch_dtype)
    if isinstance(data, torch.Tensor):
        return data.to(dst.torch_dtype)
    if dst in (t.DOUBLE, t.FLOAT):
        return float(data)
    if dst == t.BOOLEAN:
        return bool(data)
    return int(data)


def _rescale_int(x: int, k: int) -> int:
    """A Python int times 10^k, or divided by 10^-k HALF_UP."""
    if k >= 0:
        return x * 10 ** k
    q, r = divmod(abs(x), 10 ** -k)
    q += 2 * r >= 10 ** -k
    return q if x >= 0 else -q


def decimal_operand(ctx: EvalContext, v, dtype: t.DataType, scale: int):
    """A decimal or integral operand as an int128 pair at ``scale``
    (its own scale or more): a column's lanes, or a literal broadcast."""
    own = dtype.scale if isinstance(dtype, t.DecimalType) else 0
    if isinstance(v, ColumnValue):
        pair = decimal_pair(v.col) if isinstance(dtype, t.DecimalType) \
            else i128.from_int64(v.col.data)
        return i128.mul(pair, 10 ** (scale - own)) if scale > own else pair
    value = 0 if v.value is None else int(v.value)
    return i128.full(value * 10 ** (scale - own),
                     torch.empty(ctx.capacity, dtype=torch.int64,
                                 device=ctx.device))


def wrap_int(x: int, dtype: t.DataType) -> int:
    """A Python int wrapped into ``dtype``'s two's-complement range."""
    bits = _INT_BITS[dtype]
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


class _DecimalArithmetic(BinaryArithmetic):
    """An operator whose decimal result type is Spark's
    DecimalPrecision rule for ``op``."""
    op = "?"

    def data_type(self):
        lt, rt = self.left.data_type(), self.right.data_type()
        if isinstance(lt, t.DecimalType) or isinstance(rt, t.DecimalType):
            return _decimal_binary_type(self.op, _as_decimal(lt),
                                        _as_decimal(rt))
        return self._plain_type(lt, rt)

    def _plain_type(self, lt, rt):
        return promote(lt, rt)


class Add(_DecimalArithmetic):
    symbol = "+"
    op = "add"


class Subtract(_DecimalArithmetic):
    symbol = "-"
    op = "sub"


class Multiply(_DecimalArithmetic):
    symbol = "*"
    op = "mul"


class Divide(_DecimalArithmetic):
    symbol = "/"
    op = "div"

    def _plain_type(self, lt, rt):
        return t.DOUBLE


class IntegralDivide(BinaryArithmetic):
    symbol = "div"

    def data_type(self):
        return t.LONG


class Remainder(BinaryArithmetic):
    symbol = "%"


class Pmod(BinaryArithmetic):
    symbol = "pmod"


def _decimal_sides(e: BinaryArithmetic, ctx: EvalContext, scale: int):
    """Both operands as int128 pairs at ``scale`` (each at its own scale
    where ``scale`` is None), and their joint validity."""
    out = []
    vals = []
    for c in (e.left, e.right):
        v = c.eval(ctx)
        dt = c.data_type()
        own = dt.scale if isinstance(dt, t.DecimalType) else 0
        out.append(decimal_operand(ctx, v, dt, own if scale is None
                                   else scale))
        vals.append(validity_of(v))
    return out[0], out[1], and_validity(ctx, *vals)


def _eval_decimal(e: BinaryArithmetic, ctx: EvalContext):
    """A decimal +, -, * or /, exact over int128 pairs."""
    out = e.data_type()
    if isinstance(e, (Add, Subtract)):
        a, b, v = _decimal_sides(e, ctx, out.scale)
        r = i128.add(a, b) if isinstance(e, Add) else i128.sub(a, b)
        return make_decimal_column(ctx, out, r, v)
    if isinstance(e, Multiply):
        a, b, v = _decimal_sides(e, ctx, None)
        return make_decimal_column(ctx, out, i128.mul(a, b), v)
    # l / r at out's scale: l * 10^(out.scale - s1 + s2) / r, HALF_UP;
    # out.scale >= s1 (_decimal_binary_type), so the shift is never
    # negative, and within 18 digits of out every word fits int64
    lt, rt = _as_decimal(e.left.data_type()), _as_decimal(e.right.data_type())
    a, b, v = _decimal_sides(e, ctx, None)
    zero = i128.eq(b, 0)
    v = and_validity(ctx, v, ~zero)
    den = i128.where(zero, i128.full(1, b[0]), b)
    q = i128.div_half_up(a, 10 ** (out.scale - lt.scale + rt.scale), den,
                         10 ** lt.precision, 10 ** rt.precision)
    return make_decimal_column(ctx, out, q, v)


def _is_decimal(e: BinaryArithmetic) -> bool:
    return isinstance(e.data_type(), t.DecimalType)


@evaluator(Add)
def _eval_add(e: Add, ctx: EvalContext):
    out = e.data_type()
    if _is_decimal(e):
        return _eval_decimal(e, ctx)
    ld, rd, v = operands(ctx, e.left, e.right, out)
    return make_column(ctx, out, ld + rd, v)


@evaluator(Subtract)
def _eval_sub(e: Subtract, ctx: EvalContext):
    out = e.data_type()
    if _is_decimal(e):
        return _eval_decimal(e, ctx)
    ld, rd, v = operands(ctx, e.left, e.right, out)
    return make_column(ctx, out, ld - rd, v)


@evaluator(Multiply)
def _eval_mul(e: Multiply, ctx: EvalContext):
    out = e.data_type()
    if _is_decimal(e):
        return _eval_decimal(e, ctx)
    ld, rd, v = operands(ctx, e.left, e.right, out)
    return make_column(ctx, out, ld * rd, v)


@evaluator(Divide)
def _eval_div(e: Divide, ctx: EvalContext):
    if _is_decimal(e):
        return _eval_decimal(e, ctx)
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
    if out in (t.DOUBLE, t.FLOAT):
        return torch.fmod(ld, rd) if isinstance(ld, torch.Tensor) else \
            torch.fmod(torch.full_like(rd, ld), rd)
    return _truncated(ld, rd)[1]


def _decimal_division(e: BinaryArithmetic, ctx: EvalContext):
    """A decimal div, % or pmod: both operands' unscaled words at their
    common scale, divided with truncation (one int64 divide where both
    fit 18 digits, else int128, ``i128.divmod_trunc``); a zero divisor
    gives null.  div keeps the quotient's low 64 bits (Spark's toLong);
    % and pmod are decimals at the common type."""
    lt, rt = _as_decimal(e.left.data_type()), _as_decimal(e.right.data_type())
    scale = max(lt.scale, rt.scale)
    a, b, v = _decimal_sides(e, ctx, scale)
    zero = i128.eq(b, 0)
    v = and_validity(ctx, v, ~zero)
    b = i128.where(zero, i128.full(1, b[0]), b)
    q, r = i128.divmod_trunc(a, b, 10 ** (lt.precision - lt.scale + scale),
                             10 ** (rt.precision - rt.scale + scale))
    if isinstance(e, IntegralDivide):
        return make_column(ctx, t.LONG, q[0], v)
    if isinstance(e, Pmod):
        # Spark's (r + n) % n for r < 0: r + n where n > 0, r where n < 0
        r = i128.where(i128.is_neg(r) & ~i128.is_neg(b), i128.add(r, b), r)
    return make_decimal_column(ctx, e.data_type(), r, v)


def _decimal_operands(e: BinaryArithmetic) -> bool:
    return isinstance(promote(e.left.data_type(), e.right.data_type()),
                      t.DecimalType)


@evaluator(IntegralDivide)
def _eval_idiv(e: IntegralDivide, ctx: EvalContext):
    if _decimal_operands(e):
        return _decimal_division(e, ctx)
    ld, rd, v = operands(ctx, e.left, e.right, t.LONG)
    rd, v = _nonzero_divisor(ctx, rd, v)
    return make_column(ctx, t.LONG, _truncated(ld, rd)[0], v)


@evaluator(Remainder)
def _eval_rem(e: Remainder, ctx: EvalContext):
    if _decimal_operands(e):
        return _decimal_division(e, ctx)
    out = e.data_type()
    ld, rd, v = operands(ctx, e.left, e.right, out)
    rd, v = _nonzero_divisor(ctx, rd, v)
    return make_column(ctx, out, _remainder(ld, rd, out), v)


@evaluator(Pmod)
def _eval_pmod(e: Pmod, ctx: EvalContext):
    if _decimal_operands(e):
        return _decimal_division(e, ctx)
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
    if dtype in (t.DOUBLE, t.FLOAT) or isinstance(dtype, t.DecimalType):
        return -d
    return wrap_int(-d, dtype)


@evaluator(UnaryMinus)
def _eval_neg(e: UnaryMinus, ctx: EvalContext):
    v = e.children[0].eval(ctx)
    dt = e.data_type()
    if isinstance(dt, t.DecimalType):
        pair = decimal_operand(ctx, v, dt, dt.scale)
        return make_decimal_column(ctx, dt, i128.neg(pair), validity_of(v))
    return make_column(ctx, dt, _negate(data_of(v), dt), validity_of(v))


@evaluator(UnaryPositive)
def _eval_pos(e: UnaryPositive, ctx: EvalContext):
    return e.children[0].eval(ctx)


@evaluator(Abs)
def _eval_abs(e: Abs, ctx: EvalContext):
    v = e.children[0].eval(ctx)
    d, dt = data_of(v), e.data_type()
    if isinstance(dt, t.DecimalType):
        pair = decimal_operand(ctx, v, dt, dt.scale)
        return make_decimal_column(ctx, dt, i128.abs_(pair), validity_of(v))
    if dt in (t.DOUBLE, t.FLOAT):
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
    if t.is_dec128(out):
        return _extreme128(e, ctx, is_max)
    best = best_word = best_valid = None
    for c in e.children:
        v = c.eval(ctx)
        d = cast_data(data_of(v), c.data_type(), out)
        if not isinstance(d, torch.Tensor):
            d = torch.full((ctx.capacity,), d, dtype=out.torch_dtype,
                           device=ctx.device)
        val = _full_validity(ctx, v)
        word = ordered_word(d.to(torch.float64) if d.dtype == torch.float32
                            else d)
        if best is None:
            best, best_word, best_valid = d, word, val
            continue
        better = (word > best_word) if is_max else (word < best_word)
        take = val & (~best_valid | better)
        best = torch.where(take, d, best)
        best_word = torch.where(take, word, best_word)
        best_valid = best_valid | val
    return make_column(ctx, out, best, best_valid)


def _extreme128(e, ctx: EvalContext, is_max: bool):
    """greatest/least over DECIMAL128: each child's words at the result's
    scale, ordered by (high word signed, low word unsigned), the order of
    K3's min and max."""
    out = e.data_type()
    best = best_valid = None
    for c in e.children:
        v = c.eval(ctx)
        d = decimal_operand(ctx, v, c.data_type(), out.scale)
        val = _full_validity(ctx, v)
        if best is None:
            best, best_valid = d, val
            continue
        better = i128.lt(best, d) if is_max else i128.lt(d, best)
        best = i128.where(val & (~best_valid | better), d, best)
        best_valid = best_valid | val
    return make_decimal_column(ctx, out, best, best_valid)


def _full_validity(ctx: EvalContext, v) -> torch.Tensor:
    val = and_validity(ctx, validity_of(v))
    return torch.ones(ctx.capacity, dtype=torch.bool, device=ctx.device) \
        if val is None else val


@evaluator(Greatest)
def _eval_greatest(e, ctx):
    return _eval_extreme(e, ctx, True)


@evaluator(Least)
def _eval_least(e, ctx):
    return _eval_extreme(e, ctx, False)


# ---------------------------------------------------------------------------
# Spark's decimal markers (the reference's expr/misc_tail.py)
# ---------------------------------------------------------------------------

class PromotePrecision(Expression):
    """The analyzer's precision-promotion marker: the cast below it
    already gives the type."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self):
        return self.children[0].data_type()


@evaluator(PromotePrecision)
def _eval_promote(e: PromotePrecision, ctx: EvalContext):
    return e.children[0].eval(ctx)


class MakeDecimal(Expression):
    """An unscaled LONG as DECIMAL(precision, scale), null past the
    precision."""

    def __init__(self, child: Expression, precision: int, scale: int):
        self.children = (child,)
        self.precision = int(precision)
        self.scale = int(scale)

    def data_type(self):
        return t.DecimalType(self.precision, self.scale)


class CheckOverflow(Expression):
    """Null where a decimal passes DECIMAL(precision, scale)'s digits
    (Spark's nullOnOverflow)."""

    def __init__(self, child: Expression, precision: int, scale: int):
        self.children = (child,)
        self.precision = int(precision)
        self.scale = int(scale)

    def data_type(self):
        return t.DecimalType(self.precision, self.scale)


@evaluator(MakeDecimal)
@evaluator(CheckOverflow)
def _eval_bounded(e, ctx: EvalContext):
    v = e.children[0].eval(ctx)
    src = e.children[0].data_type()
    pair = decimal_operand(ctx, v, src, src.scale
                           if isinstance(src, t.DecimalType) else 0)
    ok = i128.fits_digits(pair, e.precision)
    return make_decimal_column(ctx, e.data_type(), pair,
                               and_validity(ctx, validity_of(v), ok))

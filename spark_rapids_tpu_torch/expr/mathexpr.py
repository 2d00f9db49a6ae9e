"""Math expressions over the port's flat types.

Counterpart of spark_rapids_tpu/expr/mathexpr.py: the unary double
family (sqrt, exp, expm1, the trigonometric and hyperbolic functions and
their inverses, cbrt, rint, degrees, radians), cot, log(base, x), ln,
log2, log10, log1p, pow, atan2, floor, ceil, signum, round and bround.
Spark's corners, as the reference keeps them: the log of a value <= 0
(log1p: <= -1) is null, not NaN; floor and ceil of a double give LONG,
NaN -> 0 and out of range saturated; signum(NaN) is NaN; round is
HALF_UP at a scale (``floor(x * 10^s + 0.5) / 10^s`` for a double,
exact for an integral), bround HALF_EVEN (``torch.round``).  Over a
decimal, floor and ceil give DECIMAL(p - s + 1, 0) and round and bround
DECIMAL at the target scale (the reference's types: a negative scale
rounds at 0), computed on the unscaled int128 pair (``ops/int128.py``),
never through a double.  NormalizeNaNAndZero gives -0.0 as 0.0 and every
NaN as the canonical NaN, as the reference's does.
"""

from __future__ import annotations

import torch

from .. import types as t
from ..ops import int128 as i128
from .arithmetic import cast_data
from .core import (EvalContext, Expression, ScalarValue, and_validity,
                   column_of, data_of, decimal_pair, evaluator, make_column,
                   make_decimal_column, validity_of)

_INT64_EDGE = 9.223372036854776e18          # 2^63 as a double


class UnaryMath(Expression):
    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self):
        return t.DOUBLE


def _as_double(ctx: EvalContext, e: Expression):
    """(float64[cap], validity) of an expression's value."""
    v = e.eval(ctx)
    d = cast_data(data_of(v), e.data_type(), t.DOUBLE)
    if not isinstance(d, torch.Tensor):
        d = torch.full((ctx.capacity,), float(d), dtype=torch.float64,
                       device=ctx.device)
    return d, validity_of(v)


def _cbrt(d):
    r = torch.abs(d).pow(1.0 / 3.0)
    return torch.where(d < 0, -r, r)


_SIMPLE = {
    "Sqrt": torch.sqrt, "Exp": torch.exp, "Expm1": torch.expm1,
    "Sin": torch.sin, "Cos": torch.cos, "Tan": torch.tan,
    "Asin": torch.asin, "Acos": torch.acos, "Atan": torch.atan,
    "Sinh": torch.sinh, "Cosh": torch.cosh, "Tanh": torch.tanh,
    "Cbrt": _cbrt, "Rint": torch.round, "ToDegrees": torch.rad2deg,
    "ToRadians": torch.deg2rad, "Asinh": torch.asinh, "Acosh": torch.acosh,
    "Atanh": torch.atanh,
    "Cot": lambda d: 1.0 / torch.tan(d),
    "Signum": lambda d: torch.where(torch.isnan(d), d, torch.sign(d)),
}


def _simple(cls_name: str):
    cls = type(cls_name, (UnaryMath,), {})

    @evaluator(cls)
    def _e(e, ctx: EvalContext, _fn=_SIMPLE[cls_name]):
        d, val = _as_double(ctx, e.children[0])
        return make_column(ctx, t.DOUBLE, _fn(d), val)
    return cls


Sqrt = _simple("Sqrt")
Exp = _simple("Exp")
Expm1 = _simple("Expm1")
Sin = _simple("Sin")
Cos = _simple("Cos")
Tan = _simple("Tan")
Asin = _simple("Asin")
Acos = _simple("Acos")
Atan = _simple("Atan")
Sinh = _simple("Sinh")
Cosh = _simple("Cosh")
Tanh = _simple("Tanh")
Cbrt = _simple("Cbrt")
Rint = _simple("Rint")
ToDegrees = _simple("ToDegrees")
ToRadians = _simple("ToRadians")
Asinh = _simple("Asinh")
Acosh = _simple("Acosh")
Atanh = _simple("Atanh")
Cot = _simple("Cot")
Signum = _simple("Signum")


class Log(UnaryMath):
    """Natural log; null for an input <= 0."""
    fn = staticmethod(torch.log)
    floor = 0.0


class Log2(Log):
    fn = staticmethod(torch.log2)


class Log10(Log):
    fn = staticmethod(torch.log10)


class Log1p(Log):
    """log(1 + x); null for an input <= -1."""
    fn = staticmethod(torch.log1p)
    floor = -1.0


def _eval_log(e: Log, ctx: EvalContext):
    d, val = _as_double(ctx, e.children[0])
    ok = d > e.floor
    safe = torch.where(ok, d, torch.full_like(d, e.floor + 1.0))
    return make_column(ctx, t.DOUBLE, e.fn(safe), and_validity(ctx, val, ok))


for _cls in (Log, Log2, Log10, Log1p):
    evaluator(_cls)(_eval_log)


class Logarithm(Expression):
    """log(base, x); null for x <= 0 or base <= 0."""

    def __init__(self, base: Expression, child: Expression):
        self.children = (base, child)

    def data_type(self):
        return t.DOUBLE

    def sql(self):
        return (f"log({self.children[0].sql()}, "
                f"{self.children[1].sql()})")


@evaluator(Logarithm)
def _eval_logarithm(e: Logarithm, ctx: EvalContext):
    b, bval = _as_double(ctx, e.children[0])
    x, xval = _as_double(ctx, e.children[1])
    ok = (x > 0) & (b > 0)
    sb = torch.where(ok, b, torch.full_like(b, 2.0))
    sx = torch.where(ok, x, torch.ones_like(x))
    return make_column(ctx, t.DOUBLE, torch.log(sx) / torch.log(sb),
                       and_validity(ctx, bval, xval, ok))


class Pow(Expression):
    def __init__(self, left, right):
        self.children = (left, right)

    def data_type(self):
        return t.DOUBLE


class Atan2(Pow):
    pass


@evaluator(Pow)
def _eval_pow(e: Pow, ctx: EvalContext):
    a, av = _as_double(ctx, e.children[0])
    b, bv = _as_double(ctx, e.children[1])
    return make_column(ctx, t.DOUBLE, torch.pow(a, b),
                       and_validity(ctx, av, bv))


@evaluator(Atan2)
def _eval_atan2(e: Atan2, ctx: EvalContext):
    a, av = _as_double(ctx, e.children[0])
    b, bv = _as_double(ctx, e.children[1])
    return make_column(ctx, t.DOUBLE, torch.atan2(a, b),
                       and_validity(ctx, av, bv))


class Floor(Expression):
    def __init__(self, child):
        self.children = (child,)

    def data_type(self):
        dt = self.children[0].data_type()
        if isinstance(dt, t.DecimalType):
            return t.DecimalType(dt.precision - dt.scale + 1, 0)
        return dt if t.is_integral(dt) else t.LONG


class Ceil(Floor):
    pass


def _decimal_input(ctx: EvalContext, e: Expression):
    """(int128 pair, validity) of a decimal expression's value."""
    v = e.eval(ctx)
    if isinstance(v, ScalarValue):
        v = make_decimal_column(ctx, v.dtype, int(v.value or 0),
                                validity_of(v))
    return decimal_pair(v.col), v.col.validity


def _magnitude_divmod(pair, k: int):
    """(sign, |a| // 10^k, |a| % 10^k) of an int128 pair."""
    neg = i128.is_neg(pair)
    m = i128.abs_(pair)
    q = i128.div_pow10(m, k)
    return neg, q, i128.sub(m, i128.mul(q, 10 ** k))


def _signed(neg, q):
    return i128.where(neg, i128.neg(q), q)


def _eval_floor(e: Floor, ctx: EvalContext):
    src = e.children[0].data_type()
    if isinstance(src, t.DecimalType):
        pair, val = _decimal_input(ctx, e.children[0])
        neg, q, r = _magnitude_divmod(pair, src.scale)
        # toward -inf (floor) or +inf (ceil): the magnitude grows by one
        # where a remainder is left on the side that rounds away
        away = ~i128.eq(r, 0) & (neg if type(e) is Floor else ~neg)
        q = i128.add(q, (away.to(torch.int64), torch.zeros_like(q[1])))
        return make_decimal_column(ctx, e.data_type(), _signed(neg, q), val)
    if t.is_integral(src):
        return e.children[0].eval(ctx)
    d, val = _as_double(ctx, e.children[0])
    r = torch.ceil(d) if type(e) is Ceil else torch.floor(d)
    # Java's d.toLong: NaN -> 0, out of range saturates
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    too_hi, too_lo = r >= _INT64_EDGE, r <= -_INT64_EDGE
    safe = torch.clamp(r, -9.2e18, 9.2e18).to(torch.int64)
    data = torch.where(too_hi, torch.full_like(safe, 2**63 - 1),
                       torch.where(too_lo, torch.full_like(safe, -2**63),
                                   safe))
    return make_column(ctx, t.LONG, data, val)


evaluator(Floor)(_eval_floor)
evaluator(Ceil)(_eval_floor)


class Round(Expression):
    """HALF_UP rounding to ``scale`` digits (Spark's Round)."""

    half_even = False

    def __init__(self, child, scale: int = 0):
        self.children = (child,)
        self.scale = scale

    def data_type(self):
        dt = self.children[0].data_type()
        if isinstance(dt, t.DecimalType):
            scale = min(max(self.scale, 0), dt.scale)
            p = dt.precision - dt.scale + scale + (scale < dt.scale)
            return t.DecimalType(min(p, 38), scale)
        return dt


class BRound(Round):
    """HALF_EVEN rounding to ``scale`` digits (Spark's BRound)."""
    half_even = True


def _div_round_half_up(num: torch.Tensor, den: int) -> torch.Tensor:
    """Integer divide rounding half away from zero."""
    trunc = torch.div(num, den, rounding_mode="trunc")
    r2 = torch.abs(num) - torch.abs(trunc) * den
    mag = torch.abs(trunc) + (2 * r2 >= den).to(num.dtype)
    return torch.where(num < 0, -mag, mag)


def _round_decimal(e: Round, ctx: EvalContext):
    src, out = e.children[0].data_type(), e.data_type()
    pair, val = _decimal_input(ctx, e.children[0])
    k = src.scale - out.scale
    if k == 0:
        return make_decimal_column(ctx, out, pair, val)
    if not e.half_even:
        return make_decimal_column(ctx, out,
                                   i128.round_half_up_pow10(pair, k), val)
    neg, q, r = _magnitude_divmod(pair, k)
    half = 10 ** k // 2
    up = ~i128.lt(r, half + 1) | (i128.eq(r, half) & ((q[0] & 1) == 1))
    q = i128.add(q, (up.to(torch.int64), torch.zeros_like(q[1])))
    return make_decimal_column(ctx, out, _signed(neg, q), val)


def _eval_round(e: Round, ctx: EvalContext):
    if isinstance(e.children[0].data_type(), t.DecimalType):
        return _round_decimal(e, ctx)
    src = e.data_type()
    s = e.scale
    if t.is_integral(src):
        v = e.children[0].eval(ctx)
        if s >= 0:
            return v
        d = data_of(v)
        if not isinstance(d, torch.Tensor):
            d = torch.full((ctx.capacity,), d, dtype=src.torch_dtype,
                           device=ctx.device)
        f = 10 ** (-s)
        return make_column(ctx, src, _div_round_half_up(d, f) * f,
                           validity_of(v))
    d, val = _as_double(ctx, e.children[0])
    f = 10.0 ** s
    if e.half_even:
        data = torch.round(d * f) / f
    else:
        data = torch.where(d >= 0, torch.floor(d * f + 0.5),
                           torch.ceil(d * f - 0.5)) / f
    return make_column(ctx, src, data, val)


evaluator(Round)(_eval_round)
evaluator(BRound)(_eval_round)


class NormalizeNaNAndZero(Expression):
    """Canonical floats for grouping and join keys: every NaN becomes the
    one NaN and -0.0 becomes 0.0 (Spark's NormalizeFloatingNumbers).  The
    key words of grouping and sorting already normalise; this is the form
    a plan carries."""

    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self):
        return self.children[0].data_type()

    def sql(self):
        return f"normalize_nan_and_zero({self.children[0].sql()})"


@evaluator(NormalizeNaNAndZero)
def _eval_normalize_nan_zero(e: NormalizeNaNAndZero, ctx: EvalContext):
    c = column_of(ctx, e.children[0])
    d = torch.where(torch.isnan(c.data), torch.full_like(c.data,
                                                         float("nan")), c.data)
    d = torch.where(d == 0, torch.zeros_like(d), d)
    return make_column(ctx, e.data_type(), d, c.validity)

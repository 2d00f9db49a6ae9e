"""Cast among the port's flat types: BOOLEAN, BYTE, SHORT, INT, LONG,
FLOAT, DOUBLE, DATE, TIMESTAMP and DECIMAL.

Counterpart of spark_rapids_tpu/expr/cast.py (``Cast``,
``cast_supported_on_tpu``, ``_eval_cast``, ``_int_to_int``).  Semantics
(Spark's non-ANSI cast):
  * floating -> integral saturates as Java's ``d.toInt`` / ``d.toLong``:
    NaN -> 0, at or above 2^(bits-1) -> the type's maximum, below its
    minimum -> the minimum, in range truncated toward zero.  The
    reference clamps to ``float(2**63 - 1)``, which is 2^63, and then
    converts, which gives INT64_MIN for 1e19 on the CPU; the port
    saturates before it converts (ROADMAP.md Queue 3);
  * integral -> narrower integral wraps bits (Java's ``l.toInt``);
  * numeric -> BOOLEAN is ``x != 0`` (NaN is true);
  * DATE <-> TIMESTAMP by UTC days and microseconds (a timestamp floors
    to its day); TIMESTAMP -> integral is whole seconds (floored),
    -> floating seconds, -> BOOLEAN microseconds != 0; integral ->
    TIMESTAMP is seconds;
  * -> DECIMAL: a decimal rescales (up exactly, down HALF_UP), an integer
    scales up, a float rounds HALF_UP at the scale (at most 18 digits,
    as the reference's); a value past the target precision is null;
  * DECIMAL -> integral truncates toward zero, -> floating divides;
  * a NULL source gives an all-null column.
Decimals are computed over int128 pairs (``ops/int128.py``).  Casts to
and from strings wait for the string functions (Queue 1 item 4).
"""

from __future__ import annotations

import torch

from .. import types as t
from ..ops import int128 as i128
from .core import (EvalContext, Expression, ScalarValue, all_null_column,
                   and_validity, data_of, decimal_pair, evaluator,
                   make_column, make_decimal_column, validity_of)

_INT_LIMITS = {t.BYTE: (-(2**7), 2**7 - 1), t.SHORT: (-(2**15), 2**15 - 1),
               t.INT: (-(2**31), 2**31 - 1), t.LONG: (-(2**63), 2**63 - 1)}
_NUMERIC = (t.BooleanType, t.ByteType, t.ShortType, t.IntegerType,
            t.LongType, t.FloatType, t.DoubleType, t.DecimalType)
_TEMPORAL = (t.DateType, t.TimestampType)
_MICROS_PER_DAY = 86_400_000_000
# the decimal digits an integral type's values need
_INT_DIGITS = {t.BYTE: 3, t.SHORT: 5, t.INT: 10, t.LONG: 19}


def cast_supported_on_gpu(src: t.DataType, dst: t.DataType) -> bool:
    """Whether a cast runs on the GPU (the reference's
    ``cast_supported_on_tpu`` over the port's types): the numeric types
    among themselves, dates and timestamps among themselves, timestamps
    to and from the numeric types, and any cast of a NULL.  Expression
    kernels compute a decimal in one int64 lane, so a source of more
    than 18 digits, or such a destination other than a same- or
    down-scale decimal, stays on the CPU."""
    if src == dst or isinstance(src, t.NullType):
        return True
    if t.is_dec128(src):
        return False
    if t.is_dec128(dst) and not (isinstance(src, t.DecimalType)
                                 and dst.scale <= src.scale):
        return False
    if isinstance(src, _NUMERIC) and isinstance(dst, _NUMERIC):
        return True
    if isinstance(src, _TEMPORAL) and isinstance(dst, _TEMPORAL):
        return True
    return (isinstance(src, t.TimestampType) and isinstance(dst, _NUMERIC)
            ) or (isinstance(src, _NUMERIC) and isinstance(dst,
                                                          t.TimestampType))


def _castable(src: t.DataType, dst: t.DataType) -> bool:
    """Whether the port evaluates the cast at all (on either engine)."""
    flat = _NUMERIC + _TEMPORAL
    return isinstance(src, flat) and isinstance(dst, flat)


class Cast(Expression):
    def __init__(self, child: Expression, to: t.DataType):
        self.children = (child,)
        self.to = to

    @property
    def child(self):
        return self.children[0]

    def data_type(self):
        return self.to

    def sql(self):
        return f"CAST({self.child.sql()} AS {self.to.name})"


def double_to_integral(d: torch.Tensor, dst: t.DataType) -> torch.Tensor:
    """Java's saturating floating -> integral conversion."""
    lo, hi = _INT_LIMITS[dst]
    d = d.to(torch.float64)
    too_high = d >= float(hi + 1)           # 2^(bits-1), an exact double
    too_low = d < float(lo)
    zero = torch.isnan(d) | too_high | too_low
    out = torch.where(zero, torch.zeros_like(d), d).to(dst.torch_dtype)
    out = torch.where(too_high, torch.full_like(out, hi), out)
    return torch.where(too_low, torch.full_like(out, lo), out)


def _round_half_up_float(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d >= 0, torch.floor(d + 0.5), torch.ceil(d - 0.5))


def _to_decimal(ctx: EvalContext, col, src: t.DataType,
                dst: t.DecimalType, val):
    """A numeric column cast to ``dst``: null where the value does not fit
    its precision."""
    if src in (t.FLOAT, t.DOUBLE):
        scaled = col.data.to(torch.float64) * (10.0 ** dst.scale)
        lim = 10 ** min(dst.precision, 18)
        ok = ~torch.isnan(scaled) & (scaled.abs() < float(lim))
        data = torch.where(ok, _round_half_up_float(scaled),
                           torch.zeros_like(scaled)).to(torch.int64)
        ok = ok & (data.abs() < lim)
        return make_decimal_column(ctx, dst, i128.from_int64(data),
                                   and_validity(ctx, val, ok))
    if src == t.BOOLEAN:
        pair = i128.from_int64(col.data.to(torch.int64) * 10 ** dst.scale)
        return make_decimal_column(ctx, dst, pair, val)
    own = src.scale if isinstance(src, t.DecimalType) else 0
    pair = decimal_pair(col) if isinstance(src, t.DecimalType) \
        else i128.from_int64(col.data)
    k = dst.scale - own
    if k > 0:
        pair = i128.mul(pair, 10 ** k)
    elif k < 0:
        pair = i128.round_half_up_pow10(pair, -k)
    # a value can pass the target's digits only where the target has
    # fewer integer digits than the source (a sum's widening cannot)
    whole = src.precision - src.scale if isinstance(src, t.DecimalType) \
        else _INT_DIGITS[src]
    if dst.precision - dst.scale < whole + (1 if k < 0 else 0):
        val = and_validity(ctx, val, i128.fits_digits(pair, dst.precision))
    return make_decimal_column(ctx, dst, pair, val)


def _from_decimal(ctx: EvalContext, col, src: t.DecimalType,
                  dst: t.DataType, val):
    pair = decimal_pair(col)
    if dst == t.BOOLEAN:
        return make_column(ctx, dst, (pair[0] != 0) | (pair[1] != 0), val)
    if dst in (t.FLOAT, t.DOUBLE):
        # the magnitude as a double: its high word times 2^64 plus its
        # low word unsigned (exact below 2^53), then the sign and the
        # scale
        m = i128.abs_(pair)
        lo = m[0].to(torch.float64)
        x = m[1].to(torch.float64) * 2.0 ** 64 + torch.where(
            m[0] < 0, lo + 2.0 ** 64, lo)
        x = torch.where(i128.is_neg(pair), -x, x)
        return make_column(ctx, dst, (x / 10.0 ** src.scale).to(
            dst.torch_dtype), val)
    # integral: truncated toward zero, then wrapped into the type
    q = i128.div_pow10(i128.abs_(pair), src.scale)
    q = i128.where(i128.is_neg(pair), i128.neg(q), q)
    return make_column(ctx, dst, q[0].to(dst.torch_dtype), val)


@evaluator(Cast)
def _eval_cast(e: Cast, ctx: EvalContext):
    src, dst = e.child.data_type(), e.to
    v = e.child.eval(ctx)
    if src == dst:
        return v
    if isinstance(src, t.NullType):
        return all_null_column(ctx, dst)
    if not _castable(src, dst):
        raise NotImplementedError(
            f"cast from {src.name} to {dst.name} is not ported yet (casts "
            f"to and from string, binary and nested types come with the "
            f"string and collection functions, Queue 1 item 4)")
    if isinstance(v, ScalarValue):
        v = make_column(ctx, src, data_of(v), validity_of(v))
    col, val = v.col, v.col.validity
    d = col.data
    if src == t.DATE and dst == t.TIMESTAMP:
        return make_column(ctx, dst, d.to(torch.int64) * _MICROS_PER_DAY,
                           val)
    if src == t.TIMESTAMP and dst == t.DATE:
        return make_column(ctx, dst, torch.div(
            d, _MICROS_PER_DAY, rounding_mode="floor").to(torch.int32), val)
    if src == t.TIMESTAMP and dst == t.BOOLEAN:
        return make_column(ctx, dst, d != 0, val)       # microseconds
    if src == t.TIMESTAMP:
        if dst in (t.FLOAT, t.DOUBLE):
            return make_column(ctx, dst, (d.to(torch.float64) / 1e6).to(
                dst.torch_dtype), val)
        secs = torch.div(d, 1_000_000, rounding_mode="floor")
        if isinstance(dst, t.DecimalType):
            return _to_decimal(ctx, make_column(ctx, t.LONG, secs, val).col,
                               t.LONG, dst, val)
        return make_column(ctx, dst, secs, val)
    if dst == t.TIMESTAMP:
        if src in (t.FLOAT, t.DOUBLE):
            return make_column(ctx, dst, double_to_integral(
                d.to(torch.float64) * 1e6, t.LONG), val)
        if isinstance(src, t.DecimalType):
            d = _from_decimal(ctx, col, src, t.LONG, val).col.data
        return make_column(ctx, dst, d.to(torch.int64) * 1_000_000, val)
    if isinstance(dst, t.DecimalType):
        return _to_decimal(ctx, col, src, dst, val)
    if isinstance(src, t.DecimalType):
        return _from_decimal(ctx, col, src, dst, val)
    if dst == t.BOOLEAN:
        return make_column(ctx, dst, d != 0, val)
    if src in (t.FLOAT, t.DOUBLE) and t.is_integral(dst):
        return make_column(ctx, dst, double_to_integral(d, dst), val)
    # int <-> int wraps like Java; int / bool -> floating is exact or rounds
    return make_column(ctx, dst, d.to(dst.torch_dtype), val)

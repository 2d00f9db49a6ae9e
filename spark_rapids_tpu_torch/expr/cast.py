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
  * a NULL source gives an all-null column;
  * -> STRING (``_cast_to_string``): BOOLEAN "true"/"false", integral
    digits, DATE "yyyy-mm-dd", DECIMAL its digits with the scale's
    point, TIMESTAMP its microseconds' digits (the reference's), each
    row a byte matrix packed by ``ops/strings.py:pack_rows``; FLOAT and
    DOUBLE are not ported (the reference raises too: shortest-repr
    formatting);
  * STRING -> (``_cast_from_string``): the first 24 bytes of a row,
    trimmed of ASCII whitespace, parsed (``window_bytes``): BOOLEAN
    t/true/y/yes/1 and f/false/n/no/0 (any case), integral [+-] up to 19
    digits (wrapped into the type as the reference does), floating
    [+-]digits[.digits][e[+-]digits], DATE yyyy-mm-dd, TIMESTAMP as
    whole seconds; anything else is null; STRING -> DECIMAL is not
    ported (the reference raises).
Decimals are computed over int128 pairs (``ops/int128.py``).
"""

from __future__ import annotations

import torch

from .. import types as t
from ..columnar.device import DEFAULT_CHAR_BUCKETS, DeviceColumn, bucket_for
from ..ops import int128 as i128
from ..ops.dates import _civil_from_days, _days_from_civil
from ..ops.strings import pack_rows, window_bytes
from .core import (ColumnValue, EvalContext, Expression, ScalarValue,
                   all_null_column,
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
    to and from the numeric types, the numeric types but FLOAT and
    DOUBLE and DATE to STRING, STRING to the numeric types but DECIMAL
    and to DATE, and any cast of a NULL.  Expression kernels compute a
    decimal in one int64 lane, so a source of more than 18 digits, or
    such a destination other than a same- or down-scale decimal, stays
    on the CPU."""
    if src == dst or isinstance(src, t.NullType):
        return True
    if t.is_dec128(src):
        return False
    if t.is_dec128(dst) and not (isinstance(src, t.DecimalType)
                                 and dst.scale <= src.scale):
        return False
    if isinstance(src, _NUMERIC) and isinstance(dst, _NUMERIC):
        return True
    if isinstance(dst, t.StringType):
        return (isinstance(src, _NUMERIC) and src not in (t.FLOAT, t.DOUBLE)
                ) or isinstance(src, t.DateType)
    if isinstance(src, t.StringType):
        return (isinstance(dst, _NUMERIC) and not isinstance(
            dst, t.DecimalType)) or isinstance(dst, t.DateType)
    if isinstance(src, _TEMPORAL) and isinstance(dst, _TEMPORAL):
        return True
    return (isinstance(src, t.TimestampType) and isinstance(dst, _NUMERIC)
            ) or (isinstance(src, _NUMERIC) and isinstance(dst,
                                                          t.TimestampType))


def _castable(src: t.DataType, dst: t.DataType) -> bool:
    """Whether the port evaluates the cast at all (on either engine)."""
    flat = _NUMERIC + _TEMPORAL + (t.StringType,)
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
            f"to and from binary and nested types come with the "
            f"collection functions, Queue 1 item 4)")
    if isinstance(v, ScalarValue):
        v = make_column(ctx, src, data_of(v), validity_of(v))
    if src == t.STRING:
        return _cast_from_string(ctx, v.col, dst)
    if dst == t.STRING:
        return _cast_to_string(ctx, v.col, src)
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


# ---------------------------------------------------------------------------
# to STRING: a byte matrix a row, then pack_rows
# ---------------------------------------------------------------------------

_ZERO = ord("0")


def _packed(ctx: EvalContext, mat: torch.Tensor, lens: torch.Tensor,
            val: torch.Tensor) -> ColumnValue:
    offs, chars = pack_rows(mat, lens, val, bucket_for(
        max(ctx.capacity * mat.shape[1], 1), DEFAULT_CHAR_BUCKETS))
    return ColumnValue(DeviceColumn(t.STRING, chars, val, offs))


def _int_digits(d: torch.Tensor):
    """(uint8[cap, 20] the decimal text of int64 values, left-aligned;
    int64[cap] its length), INT64_MIN included: the digits come from the
    value made non-positive, so no magnitude overflows."""
    d = d.to(torch.int64)
    neg = d < 0
    n = torch.where(neg, d, -d)
    digs = []
    for _ in range(19):
        digs.append(-torch.fmod(n, 10))
        n = torch.div(n, 10, rounding_mode="trunc")
    digs.append(torch.zeros_like(n))
    ms = torch.stack(digs[::-1], 1)                 # most significant first
    nz = ms != 0
    first = torch.where(nz.any(1), nz.to(torch.int8).argmax(1),
                        torch.full_like(d, 19))
    lens = 20 - first + neg.to(torch.int64)
    j = torch.arange(20, device=d.device)[None, :]
    src = (j - neg.to(torch.int64)[:, None] + first[:, None]).clamp(0, 19)
    out = torch.gather(ms, 1, src) + _ZERO
    out = torch.where((j == 0) & neg[:, None], torch.full_like(out, 45), out)
    return out.to(torch.uint8), lens


def _decimal_text(ctx: EvalContext, col: DeviceColumn, src: t.DecimalType,
                  val: torch.Tensor) -> ColumnValue:
    """sign, the integer digits, then '.' and ``scale`` digits."""
    scale = src.scale
    if not src.is64:
        # past 18 digits: formatted on the host engine from exact ints
        from .host_strings import build_string_column, host_only
        host_only(ctx, "a cast of a decimal of more than 18 digits to "
                       "string")
        ints = i128.to_ints(decimal_pair(col))
        rows = []
        for x, ok in zip(ints, val.tolist()):
            if not ok:
                rows.append(None)
                continue
            digits = str(abs(x)).rjust(scale + 1, "0")
            body = digits[:len(digits) - scale] + \
                ("." + digits[len(digits) - scale:] if scale else "")
            rows.append(("-" if x < 0 else "") + body)
        return build_string_column(ctx, rows)
    d = col.data.to(torch.int64)
    if scale == 0:
        mat, lens = _int_digits(d)
        return _packed(ctx, mat, lens, val)
    neg = d < 0
    mag = torch.where(neg, -d, d)
    ipart = torch.div(mag, 10 ** scale, rounding_mode="floor")
    fpart = mag - ipart * 10 ** scale
    imat, ilens = _int_digits(ipart)
    width = 21 + scale
    j = torch.arange(width, device=d.device)[None, :]
    sign = neg.to(torch.int64)[:, None]
    il = ilens[:, None]
    total = sign[:, 0] + ilens + 1 + scale
    pw = torch.tensor([10 ** (scale - 1 - k) for k in range(scale)],
                      dtype=torch.int64, device=d.device)
    fdig = (torch.remainder(torch.div(fpart[:, None], pw[None, :],
                                      rounding_mode="floor"), 10)
            + _ZERO).to(torch.uint8)
    int_src = (j - sign).clamp(0, 19)
    frac_src = (j - sign - il - 1).clamp(0, scale - 1)
    out = torch.zeros((d.shape[0], width), dtype=torch.uint8, device=d.device)
    out = torch.where((j == 0) & neg[:, None], torch.full_like(out, 45), out)
    out = torch.where((j >= sign) & (j < sign + il),
                      torch.gather(imat, 1, int_src.expand(-1, width)), out)
    out = torch.where(j == sign + il, torch.full_like(out, 46), out)
    out = torch.where((j > sign + il) & (j < total[:, None]),
                      torch.gather(fdig, 1, frac_src), out)
    return _packed(ctx, out, total, val)


def _cast_to_string(ctx: EvalContext, col: DeviceColumn,
                    src: t.DataType) -> ColumnValue:
    val = col.validity
    d = col.data
    cap = ctx.capacity
    if src == t.BOOLEAN:
        words = torch.tensor([list(b"false"), list(b"true\0")],
                             dtype=torch.uint8, device=ctx.device)
        b = d.to(torch.int64)
        return _packed(ctx, words[b], 5 - b, val)
    if src == t.DATE:
        y, m, day = _civil_from_days(d)

        def dig(x, p):
            return torch.remainder(torch.div(x, p, rounding_mode="floor"), 10)
        dash = torch.full_like(y, -3)                  # '-' = '0' - 3
        mat = torch.stack([dig(y, 1000), dig(y, 100), dig(y, 10), dig(y, 1),
                           dash, dig(m, 10), dig(m, 1), dash, dig(day, 10),
                           dig(day, 1)], 1) + _ZERO
        return _packed(ctx, mat.to(torch.uint8),
                       torch.full((cap,), 10, dtype=torch.int64,
                                  device=ctx.device), val)
    if isinstance(src, t.DecimalType):
        return _decimal_text(ctx, col, src, val)
    if t.is_integral(src) or src == t.TIMESTAMP:
        mat, lens = _int_digits(d)
        return _packed(ctx, mat, lens, val)
    raise NotImplementedError(f"cast {src.name} -> string is not ported "
                              f"(the reference raises too)")


# ---------------------------------------------------------------------------
# from STRING: the first 24 bytes of a row, trimmed, then parsed
# ---------------------------------------------------------------------------

_WINDOW = 24


def _trimmed_window(col: DeviceColumn):
    """(uint8[cap, 24] each row's first 24 bytes with the ASCII whitespace
    at both ends cut and the rest left-aligned, int64[cap] its length)."""
    b, lens = window_bytes(col.offsets, col.data, _WINDOW)
    ws = (b == 32) | ((b >= 9) & (b <= 13))
    pos = torch.arange(_WINDOW, device=b.device)
    nonws = ~ws & (pos[None, :] < lens[:, None].to(torch.int64))
    any_c = nonws.any(1)
    start = nonws.to(torch.int8).argmax(1)
    end = _WINDOW - nonws.flip(1).to(torch.int8).argmax(1)
    start = torch.where(any_c, start, torch.zeros_like(start))
    end = torch.where(any_c, end, torch.zeros_like(end))
    tl = end - start
    tb = torch.gather(b, 1, (start[:, None] + pos[None, :]).clamp(
        0, _WINDOW - 1))
    tb = torch.where(pos[None, :] < tl[:, None], tb, torch.zeros_like(tb))
    return tb, tl


def _parse_bool(tb, tl):
    lower = torch.where((tb >= 65) & (tb <= 90), tb + 32, tb)

    def word(w: bytes):
        wb = torch.tensor(list(w.ljust(_WINDOW, b"\0")), dtype=torch.uint8,
                          device=tb.device)
        return (tl == len(w)) & (lower == wb[None, :]).all(1)
    yes = word(b"true") | word(b"t") | word(b"yes") | word(b"y") | word(b"1")
    no = word(b"false") | word(b"f") | word(b"no") | word(b"n") | word(b"0")
    return yes, yes | no


def _parse_long(tb, tl):
    """([+-] 1-19 digits as int64, wrapping as the reference's numpy
    sum does; ok)."""
    dev = tb.device
    pos = torch.arange(_WINDOW, device=dev)
    neg = tb[:, 0] == 45
    shift = (neg | (tb[:, 0] == 43)).to(torch.int64)
    ndig = tl - shift
    db = torch.gather(tb, 1, (pos[None, :] + shift[:, None]).clamp(
        0, _WINDOW - 1))
    in_d = pos[None, :] < ndig[:, None]
    is_digit = (db >= 48) & (db <= 57)
    ok = (ndig >= 1) & (ndig <= 19) & (is_digit | ~in_d).all(1)
    dv = torch.where(in_d, db.to(torch.int64) - 48,
                     torch.zeros((), dtype=torch.int64, device=dev))
    p10 = torch.tensor([10 ** k for k in range(19)], dtype=torch.int64,
                       device=dev)
    expo = (ndig[:, None] - 1 - pos[None, :]).clamp(0, 18)
    value = torch.where(in_d, dv * p10[expo], torch.zeros_like(dv)).sum(1)
    return torch.where(neg, -value, value), ok


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of each row of float64[cap, 24] in the reference's device
    order (eight running sums, one a lane of eight, then halved: lanes
    j + 4, j + 2, j + 1), so a parse rounds as the reference's does."""
    r = x[:, 0:8] + x[:, 8:16] + x[:, 16:24]
    r = r[:, :4] + r[:, 4:]
    r = r[:, :2] + r[:, 2:]
    return r[:, 0] + r[:, 1]


def _parse_float(tb, tl):
    """[+-]digits[.digits][e[+-]digits] as the reference sums it in
    float64 (no inf/nan words)."""
    dev = tb.device
    f64 = torch.float64
    pos = torch.arange(_WINDOW, device=dev)[None, :]
    neg = tb[:, 0] == 45
    shift = (neg | (tb[:, 0] == 43)).to(torch.int64)
    in_s = pos < tl[:, None]
    is_digit = (tb >= 48) & (tb <= 57)
    is_dot = tb == 46
    is_e = (tb == 101) | (tb == 69)
    tl64 = tl.to(torch.int64)

    def first_or(mask, default):
        hit = (mask & in_s).any(1)
        return hit, torch.where(hit, (mask & in_s).to(torch.int8).argmax(1),
                                default)
    _, dot = first_or(is_dot, tl64)
    e_any, epos = first_or(is_e, tl64)
    mant_end = torch.minimum(epos, tl64)
    int_end = torch.minimum(dot, mant_end)
    in_int = (pos >= shift[:, None]) & (pos < int_end[:, None])
    in_frac = (pos > dot[:, None]) & (pos < mant_end[:, None])
    dval = torch.where(is_digit, (tb.to(torch.int64) - 48).to(f64),
                       torch.zeros((), dtype=f64, device=dev))
    ten = torch.tensor(10.0, dtype=f64, device=dev)
    ie = (int_end[:, None] - 1 - pos).clamp(-1, _WINDOW).to(f64)
    int_val = _row_sum(torch.where(in_int, dval * torch.pow(ten, ie),
                                   torch.zeros((), dtype=f64, device=dev)))
    fe = (pos - dot[:, None]).clamp(1, _WINDOW).to(f64)
    frac_val = _row_sum(torch.where(in_frac, dval * torch.pow(ten, -fe),
                                    torch.zeros((), dtype=f64, device=dev)))
    mant = int_val + frac_val
    e_start = epos + 1
    at = torch.gather(tb, 1, e_start.clamp(0, _WINDOW - 1)[:, None])[:, 0]
    eneg, epl = at == 45, at == 43
    es = e_start + (eneg | epl).to(torch.int64)
    in_exp = (pos >= es[:, None]) & (pos < tl64[:, None])
    ee = (tl64[:, None] - 1 - pos).clamp(0, 8).to(f64)
    exp_val = _row_sum(torch.where(in_exp, dval * torch.pow(ten, ee),
                                   torch.zeros((), dtype=f64, device=dev)))
    exp_val = torch.where(e_any, torch.where(eneg, -exp_val, exp_val),
                          torch.zeros((), dtype=f64, device=dev))
    value = torch.where(neg, -mant, mant) * torch.pow(ten, exp_val)
    legal = is_digit | is_dot | is_e | (tb == 45) | (tb == 43)
    last = torch.gather(is_digit, 1, (tl64 - 1).clamp(0, _WINDOW - 1)[:, None]
                        )[:, 0]
    ok = (is_digit & in_s).any(1) & torch.where(in_s, legal, True).all(1) & \
        ((is_dot & in_s).sum(1) <= 1) & ((is_e & in_s).sum(1) <= 1) & \
        (tl >= 1) & (~e_any | last)
    return value, ok


def _parse_date(tb, tl):
    """yyyy-mm-dd, strictly (the 3.1+ parser; the reference's 3.0 dialect
    also takes unpadded forms)."""
    dig = (tb >= 48) & (tb <= 57)
    dash = tb == 45
    dv = tb.to(torch.int64) - 48
    ok = (tl == 10) & dig[:, 0] & dig[:, 1] & dig[:, 2] & dig[:, 3] & \
        dash[:, 4] & dig[:, 5] & dig[:, 6] & dash[:, 7] & dig[:, 8] & \
        dig[:, 9]
    y = dv[:, 0] * 1000 + dv[:, 1] * 100 + dv[:, 2] * 10 + dv[:, 3]
    m = dv[:, 5] * 10 + dv[:, 6]
    d = dv[:, 8] * 10 + dv[:, 9]
    ok = ok & (m >= 1) & (m <= 12) & (d >= 1) & (d <= 31)
    return _days_from_civil(y, m, d), ok


def _cast_from_string(ctx: EvalContext, col: DeviceColumn,
                      dst: t.DataType) -> ColumnValue:
    val = col.validity
    if isinstance(dst, t.DecimalType):
        raise NotImplementedError(f"cast string -> {dst.name} is not ported "
                                  f"(the reference raises too)")
    tb, tl = _trimmed_window(col)
    if dst == t.BOOLEAN:
        data, ok = _parse_bool(tb, tl)
        return make_column(ctx, dst, data, and_validity(ctx, val, ok))
    if dst == t.DATE:
        days, ok = _parse_date(tb, tl)
        return make_column(ctx, dst, days.to(torch.int32),
                           and_validity(ctx, val, ok))
    if dst in (t.FLOAT, t.DOUBLE):
        data, ok = _parse_float(tb, tl)
        return make_column(ctx, dst, data.to(dst.torch_dtype),
                           and_validity(ctx, val, ok))
    longs, ok = _parse_long(tb, tl)
    if dst == t.TIMESTAMP:
        longs = longs * 1_000_000
    return make_column(ctx, dst, longs.to(dst.torch_dtype),
                       and_validity(ctx, val, ok))

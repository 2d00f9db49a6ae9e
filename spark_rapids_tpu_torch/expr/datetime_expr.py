"""Date and time expressions (UTC only).

Counterpart of spark_rapids_tpu/expr/datetime_expr.py.  DATE is int32
days since 1970-01-01, TIMESTAMP int64 microseconds since the epoch.
Year, Month, DayOfMonth, Quarter, DayOfWeek, WeekDay, DayOfYear,
LastDay, Hour, Minute, Second, AddMonths and TruncDate compute one
field of the child's lane with K22 (``ops/dates.py:date_fields``; a
literal child on the host with its plain version, no launch).  DateAdd,
DateSub, DateDiff, ToUnixTimestamp, UnixTimestamp, FromUnixTime and
TimeAdd are one or two torch ops.  Each result wraps to int32 (int64
for the LONG and TIMESTAMP ones) where the reference's does.  TimeWindow
evaluates a tumbling window (a struct of start and end); a sliding
window lowers through ExpandExec, which the port does not have yet
(ROADMAP Queue 1 item 4d), and raises.  DateFormatClass and
DateAddInterval are registered to stay on the CPU engine, which has no
evaluator for them, as in the reference.

Where the reference reads another type's lane as its own, the port
casts as Spark's analyzer does (ROADMAP Queue 3): hour, minute and
second of a DATE read its midnight (the reference reads the days as
microseconds), and add_months of a TIMESTAMP its day (the reference
reads the microseconds as days).
"""

from __future__ import annotations

import torch

from .. import types as t
from ..columnar.device import DeviceColumn
from ..ops import dates
from ..ops.dates import MICROS_PER_DAY, TRUNC_FIELDS
from .arithmetic import wrap_int
from .core import (ColumnValue, EvalContext, Expression, ScalarValue,
                   and_validity, column_of, data_of, evaluator, make_column,
                   validity_of)

_KIND = {t.DATE: "date", t.TIMESTAMP: "timestamp"}


def _kind(e: Expression) -> str:
    dt = e.data_type()
    if dt not in _KIND:
        raise TypeError(f"a date or time field of {dt.name}: the child is a "
                        f"DATE or a TIMESTAMP")
    return _KIND[dt]


def _lane(v, kind: str):
    """A column's lane, or a literal as a one-row host lane."""
    if isinstance(v, ColumnValue):
        return v.col.data
    return torch.tensor([data_of(v)], dtype=torch.int32 if kind == "date"
                        else torch.int64)


def _field(ctx: EvalContext, v, kind: str, field: str, arg=None):
    """``field`` of a value's lane: a tensor for a column (K22), a Python
    int for a literal."""
    lane = _lane(v, kind)
    if isinstance(v, ColumnValue):
        return dates.date_fields(lane, kind, field, arg)
    return int(dates.date_fields_plain(lane, kind, field, arg)[0])


class DateTimeUnary(Expression):
    out_type = t.INT
    field = ""

    def __init__(self, child: Expression):
        self.children = (child,)

    def data_type(self):
        return self.out_type


class Year(DateTimeUnary):
    field = "year"


class Month(DateTimeUnary):
    field = "month"


class DayOfMonth(DateTimeUnary):
    field = "day"


class Quarter(DateTimeUnary):
    field = "quarter"


class DayOfWeek(DateTimeUnary):
    """1 = Sunday ... 7 = Saturday (Spark)."""
    field = "dayofweek"


class WeekDay(DateTimeUnary):
    """0 = Monday ... 6 = Sunday (Spark)."""
    field = "weekday"


class DayOfYear(DateTimeUnary):
    field = "dayofyear"


class LastDay(DateTimeUnary):
    out_type = t.DATE
    field = "last_day"


class TimePartUnary(DateTimeUnary):
    pass


class Hour(TimePartUnary):
    field = "hour"


class Minute(TimePartUnary):
    field = "minute"


class Second(TimePartUnary):
    field = "second"


def _eval_unary(e: DateTimeUnary, ctx: EvalContext):
    v = e.children[0].eval(ctx)
    kind = _kind(e.children[0])
    if isinstance(e, TimePartUnary) and kind == "date":
        # Spark reads a date's time of day at its midnight
        v = make_column(ctx, t.TIMESTAMP,
                        _lane(v, kind).to(torch.int64) * MICROS_PER_DAY,
                        validity_of(v)) if isinstance(v, ColumnValue) \
            else ScalarValue(None if v.value is None
                             else v.value * MICROS_PER_DAY, t.TIMESTAMP)
        kind = "timestamp"
    return make_column(ctx, e.data_type(), _field(ctx, v, kind, e.field),
                       validity_of(v))


for _cls in (Year, Month, DayOfMonth, Quarter, DayOfWeek, WeekDay,
             DayOfYear, LastDay, Hour, Minute, Second):
    evaluator(_cls)(_eval_unary)


class DateBinary(Expression):
    def __init__(self, left, right):
        self.children = (left, right)


class DateAdd(DateBinary):
    def data_type(self):
        return t.DATE


class DateSub(DateBinary):
    def data_type(self):
        return t.DATE


class DateDiff(DateBinary):
    def data_type(self):
        return t.INT


def _int64(x):
    return x.to(torch.int64) if isinstance(x, torch.Tensor) else int(x)


def _wrapped(ctx: EvalContext, dtype: t.DataType, x, validity):
    """An int64 result as ``dtype`` (INT wraps, as ``astype(np.int32)``
    does); a Python int is wrapped the same way."""
    if not isinstance(x, torch.Tensor):
        x = wrap_int(x, t.INT if dtype in (t.INT, t.DATE) else t.LONG)
    return make_column(ctx, dtype, x, validity)


@evaluator(DateAdd)
@evaluator(DateSub)
def _eval_dateadd(e: DateBinary, ctx: EvalContext):
    lv, rv = e.children[0].eval(ctx), e.children[1].eval(ctx)
    sign = -1 if isinstance(e, DateSub) else 1
    out = _int64(data_of(lv)) + sign * _int64(data_of(rv))
    return _wrapped(ctx, t.DATE, out, and_validity(ctx, validity_of(lv),
                                                   validity_of(rv)))


@evaluator(DateDiff)
def _eval_datediff(e: DateDiff, ctx: EvalContext):
    lv, rv = e.children[0].eval(ctx), e.children[1].eval(ctx)
    out = _int64(data_of(lv)) - _int64(data_of(rv))
    return _wrapped(ctx, t.INT, out, and_validity(ctx, validity_of(lv),
                                                  validity_of(rv)))


class AddMonths(DateBinary):
    def data_type(self):
        return t.DATE


@evaluator(AddMonths)
def _eval_addmonths(e: AddMonths, ctx: EvalContext):
    lv, rv = e.children[0].eval(ctx), e.children[1].eval(ctx)
    val = and_validity(ctx, validity_of(lv), validity_of(rv))
    if _kind(e.children[0]) == "timestamp":
        # Spark's analyzer casts a timestamp to its day
        days = torch.div(_lane(lv, "timestamp"), MICROS_PER_DAY,
                         rounding_mode="floor").to(torch.int32)
        lv = make_column(ctx, t.DATE, days, validity_of(lv)) \
            if isinstance(lv, ColumnValue) else \
            ScalarValue(None if lv.value is None else int(days[0]), t.DATE)
    if isinstance(rv, ColumnValue):
        if rv.dtype not in (t.BYTE, t.SHORT, t.INT):
            raise TypeError(f"add_months takes INT months, not "
                            f"{rv.dtype.name} (Spark's AddMonths)")
        months = rv.col.data.to(torch.int32)
        if not isinstance(lv, ColumnValue):
            lv = make_column(ctx, t.DATE, data_of(lv), validity_of(lv))
    else:
        months = int(data_of(rv))
    return make_column(ctx, t.DATE, _field(ctx, lv, "date", "add_months",
                                           months), val)


class TruncDate(Expression):
    """trunc(date, fmt): fmt year/yyyy/yy, month/mon/mm, quarter or
    week."""

    def __init__(self, child, fmt: str):
        self.children = (child,)
        self.fmt = fmt.lower()

    def data_type(self):
        return t.DATE


@evaluator(TruncDate)
def _eval_trunc(e: TruncDate, ctx: EvalContext):
    if e.fmt not in TRUNC_FIELDS:
        raise NotImplementedError(f"trunc format {e.fmt}")
    v = e.children[0].eval(ctx)
    return make_column(ctx, t.DATE, _field(ctx, v, _kind(e.children[0]),
                                           TRUNC_FIELDS[e.fmt]),
                       validity_of(v))


class UnixTimestampBase(Expression):
    def __init__(self, child):
        self.children = (child,)

    def data_type(self):
        return t.LONG


class ToUnixTimestamp(UnixTimestampBase):
    pass


class UnixTimestamp(ToUnixTimestamp):
    """unix_timestamp(ts): the same function as to_unix_timestamp (the
    two Spark classes share GpuToTimestamp)."""


@evaluator(ToUnixTimestamp)
@evaluator(UnixTimestamp)
def _eval_tounix(e: UnixTimestampBase, ctx: EvalContext):
    v = e.children[0].eval(ctx)
    d = _int64(data_of(v))
    if e.children[0].data_type() == t.DATE:
        secs = d * 86400
    elif isinstance(d, torch.Tensor):
        secs = torch.div(d, 1_000_000, rounding_mode="floor")
    else:
        secs = d // 1_000_000
    return _wrapped(ctx, t.LONG, secs, validity_of(v))


class FromUnixTime(Expression):
    """from_unixtime(sec) -> timestamp."""

    def __init__(self, child):
        self.children = (child,)

    def data_type(self):
        return t.TIMESTAMP


@evaluator(FromUnixTime)
def _eval_fromunix(e: FromUnixTime, ctx: EvalContext):
    v = e.children[0].eval(ctx)
    return _wrapped(ctx, t.TIMESTAMP, _int64(data_of(v)) * 1_000_000,
                    validity_of(v))


class TimeAdd(Expression):
    """timestamp + an interval of literal microseconds."""

    def __init__(self, child, interval_micros: int):
        self.children = (child,)
        self.interval = int(interval_micros)

    def data_type(self):
        return t.TIMESTAMP


@evaluator(TimeAdd)
def _eval_timeadd(e: TimeAdd, ctx: EvalContext):
    v = e.children[0].eval(ctx)
    return _wrapped(ctx, t.TIMESTAMP, _int64(data_of(v)) + e.interval,
                    validity_of(v))


def parse_duration_micros(s: str, allow_nonpositive: bool = False) -> int:
    """'10 minutes' / '1 hour' / '30 seconds' -> microseconds (the fixed
    units of a time window; months and years are refused, as Spark's
    TimeWindow analysis refuses them).  A start offset may be zero or
    negative (``allow_nonpositive``)."""
    units = {
        "microsecond": 1, "millisecond": 1000, "second": 1_000_000,
        "minute": 60_000_000, "hour": 3_600_000_000,
        "day": 86_400_000_000, "week": 7 * 86_400_000_000,
    }
    total = 0
    toks = s.strip().lower().replace("interval", "").split()
    if len(toks) % 2 != 0 or not toks:
        raise ValueError(f"cannot parse window duration {s!r}")
    for i in range(0, len(toks), 2):
        n, unit = toks[i], toks[i + 1].rstrip("s")
        if unit not in units:
            raise ValueError(
                f"window duration unit {unit!r} not supported "
                f"(month/year windows are not fixed-length)")
        total += int(n) * units[unit]
    if total <= 0 and not allow_nonpositive:
        raise ValueError(f"window duration must be positive: {s!r}")
    return total


class TimeWindow(Expression):
    """window(ts, windowDuration[, slideDuration[, startTime]]): a struct
    of the start and end timestamps of the row's window.  Only a tumbling
    window (slide = window) evaluates here."""

    def __init__(self, child: Expression, window_micros: int,
                 slide_micros=None, start_micros: int = 0):
        self.children = (child,)
        self.window = int(window_micros)
        self.slide = int(slide_micros if slide_micros is not None
                         else window_micros)
        self.start = int(start_micros)

    def data_type(self):
        return t.StructType([t.StructField("start", t.TIMESTAMP),
                             t.StructField("end", t.TIMESTAMP)])

    def sql(self):
        return f"window({self.children[0].sql()}, {self.window}us)"

    @property
    def is_tumbling(self):
        return self.slide == self.window


@evaluator(TimeWindow)
def _eval_time_window(e: TimeWindow, ctx: EvalContext):
    if not e.is_tumbling:
        raise NotImplementedError(
            "sliding time windows lower through ExpandExec, which is not "
            "ported yet (ROADMAP Queue 1 item 4d)")
    c = column_of(ctx, e.children[0])
    ts, valid = c.data, c.validity
    # a floor modulo, so a timestamp before the start (or 1970) falls in
    # the window that holds it
    ws = ts - torch.remainder(ts - e.start, e.slide)
    start = make_column(ctx, t.TIMESTAMP, ws, valid).col
    end = make_column(ctx, t.TIMESTAMP, ws + e.window, valid).col
    return ColumnValue(DeviceColumn(e.data_type(), None, valid, None, None,
                                    (start, end)))


class DateFormatClass(Expression):
    """date_format(ts, fmt): registered to stay on the CPU engine
    (strftime-style rendering), as in the reference."""

    def __init__(self, child, fmt):
        self.children = (child,)
        self.fmt = fmt

    def data_type(self):
        return t.STRING

    def sql(self):
        return f"date_format({self.children[0].sql()}, '{self.fmt}')"


class DateAddInterval(Expression):
    """date + a calendar interval: registered to stay on the CPU engine
    (no interval type on the device), as in the reference."""

    def __init__(self, child, months: int = 0, days: int = 0):
        self.children = (child,)
        self.months = months
        self.days = days

    def data_type(self):
        return t.DATE

    def sql(self):
        return (f"date_add_interval({self.children[0].sql()}, "
                f"{self.months} months {self.days} days)")

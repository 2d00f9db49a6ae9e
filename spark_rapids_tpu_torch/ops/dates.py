"""The civil calendar over DATE (int32 days since 1970-01-01) and
TIMESTAMP (int64 microseconds since the epoch, UTC) lanes.

Counterpart of spark_rapids_tpu/expr/cast.py ``_civil_from_days`` and
``_days_from_civil`` (Howard Hinnant's algorithms, floor divisions, in
int64) and of the field arithmetic of
spark_rapids_tpu/expr/datetime_expr.py (``_ymd``, ``_time_part`` and the
evaluators of DayOfWeek, WeekDay, DayOfYear, LastDay, AddMonths and
TruncDate), bit for bit with the reference's numpy branch.

K22 ``date_fields`` (``csrc/date_fields.cu``) computes one field of one
lane a launch; ``date_fields_plain`` is its plain version, over the two
helpers below.  A day field reads a TIMESTAMP lane floor-divided to its
day; HOUR, MINUTE and SECOND read only a TIMESTAMP lane, ADD_MONTHS only
a DATE lane (the evaluators in expr/datetime_expr.py cast the other
type first, as Spark's analyzer does).  Every result is computed in
int64 and wrapped to int32, where the reference's ``astype(np.int32)``
wraps it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .. import kernels

MICROS_PER_DAY = 86_400_000_000

# field codes: the order of the C switch in csrc/date_fields.cu
FIELDS = ("year", "month", "day", "quarter", "dayofweek", "weekday",
          "dayofyear", "last_day", "hour", "minute", "second", "add_months",
          "trunc_year", "trunc_month", "trunc_quarter", "trunc_week")
_TIME_PARTS = {"hour": (3_600_000_000, 24), "minute": (60_000_000, 60),
               "second": (1_000_000, 60)}
TRUNC_FIELDS = {"year": "trunc_year", "yyyy": "trunc_year",
                "yy": "trunc_year", "month": "trunc_month",
                "mon": "trunc_month", "mm": "trunc_month",
                "quarter": "trunc_quarter", "week": "trunc_week"}
_KINDS = {"date": torch.int32, "timestamp": torch.int64}


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(z: torch.Tensor):
    """(year, month, day) of days since 1970-01-01 (Hinnant's algorithm,
    floor divisions)."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    return y + (m <= 2).to(torch.int64), m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor, d):
    y = y - (m <= 2).to(torch.int64)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.remainder(m + 9, 12)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _check(values: torch.Tensor, kind: str, field: str, arg):
    if kind not in _KINDS or values.dtype != _KINDS[kind] or \
            values.dim() != 1:
        raise TypeError(f"date_fields: a date lane is int32[n], a timestamp "
                        f"lane int64[n]; got {kind} {values.dtype}")
    if field not in FIELDS:
        raise ValueError(f"date_fields: field {field!r} is not one of "
                         f"{FIELDS}")
    if (field in _TIME_PARTS and kind != "timestamp") or \
            (field == "add_months" and kind != "date"):
        raise TypeError(f"date_fields: {field} of a {kind} lane")
    if (field == "add_months") != (arg is not None):
        raise TypeError("date_fields: add_months takes the months (an int "
                        "or an int32[n]), no other field an argument")
    if isinstance(arg, torch.Tensor) and (arg.dtype != torch.int32 or
                                          arg.shape != values.shape):
        raise TypeError(f"date_fields: the months column is "
                        f"int32[{values.shape[0]}]")
    if isinstance(arg, int) and not -2**31 <= arg < 2**31:
        raise ValueError("date_fields: add_months' months are an INT")


def date_fields_plain(values: torch.Tensor, kind: str, field: str,
                      arg: Union[None, int, torch.Tensor] = None
                      ) -> torch.Tensor:
    """Plain version of K22: ``field`` of each row of a ``kind`` ("date"
    or "timestamp") lane, as int32 (a DATE for last_day, add_months and
    the truncations).  ``arg`` is add_months' months: an int, or an
    int32 column."""
    _check(values, kind, field, arg)
    x = values.to(torch.int64)
    if field in _TIME_PARTS:
        div, mod = _TIME_PARTS[field]
        tod = torch.remainder(x, MICROS_PER_DAY)
        return torch.remainder(_fdiv(tod, div), mod).to(torch.int32)
    if field == "add_months":
        y, m, d = _civil_from_days(x)
        months = arg.to(torch.int64) if isinstance(arg, torch.Tensor) \
            else int(arg)
        tot = y * 12 + (m - 1) + months
        ny = _fdiv(tot, 12)
        nm = torch.remainder(tot, 12) + 1
        ny2 = torch.where(nm == 12, ny + 1, ny)
        nm2 = torch.where(nm == 12, torch.ones_like(nm), nm + 1)
        last = _days_from_civil(ny2, nm2, 1) - 1
        last_d = _civil_from_days(last)[2]
        return _days_from_civil(ny, nm, torch.minimum(d, last_d)).to(
            torch.int32)
    days = _fdiv(x, MICROS_PER_DAY) if kind == "timestamp" else x
    if field == "dayofweek":      # 1 = Sunday; 1970-01-01 was a Thursday
        return (torch.remainder(days + 4, 7) + 1).to(torch.int32)
    if field == "weekday":                   # 0 = Monday
        return torch.remainder(days + 3, 7).to(torch.int32)
    if field == "trunc_week":
        return (days - torch.remainder(days + 3, 7)).to(torch.int32)
    y, m, d = _civil_from_days(days)
    if field == "year":
        out = y
    elif field == "month":
        out = m
    elif field == "day":
        out = d
    elif field == "quarter":
        out = _fdiv(m - 1, 3) + 1
    elif field == "dayofyear":
        out = days - _days_from_civil(y, torch.ones_like(m), 1) + 1
    elif field == "last_day":
        ny = torch.where(m == 12, y + 1, y)
        nm = torch.where(m == 12, torch.ones_like(m), m + 1)
        out = _days_from_civil(ny, nm, 1) - 1
    elif field == "trunc_year":
        out = _days_from_civil(y, torch.ones_like(m), 1)
    elif field == "trunc_month":
        out = _days_from_civil(y, m, 1)
    else:                                    # trunc_quarter
        out = _days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, 1)
    return out.to(torch.int32)


def date_fields(values: torch.Tensor, kind: str, field: str,
                arg: Union[None, int, torch.Tensor] = None) -> torch.Tensor:
    """``field`` of each row of a date or timestamp lane as int32 (K22);
    see ``date_fields_plain``.  The rows' validity is the caller's: the
    kernel reads every row and writes every row."""
    _check(values, kind, field, arg)
    if values.device.type == "cpu":
        return date_fields_plain(values, kind, field, arg)
    months: Optional[torch.Tensor] = arg if isinstance(arg, torch.Tensor) \
        else None
    kernels.require_cuda("date_fields", values,
                         *([] if months is None else [months]))
    n = int(values.shape[0])
    out = torch.empty(n, dtype=torch.int32, device=values.device)
    if n:
        months_lit = 0 if arg is None or months is not None else int(arg)
        lib = kernels.library("date_fields")
        kernels.check(lib, lib.srt_date_fields(
            values.data_ptr(), int(kind == "timestamp"), n,
            FIELDS.index(field), None if months is None else
            months.data_ptr(), months_lit, out.data_ptr(),
            kernels.stream(values)), "date_fields")
        date_fields.launches += 1
    return out


date_fields.launches = 0

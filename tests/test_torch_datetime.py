"""Dates and times in the port against the reference, on the CPU.

* Every test of the reference's tests/test_datetime.py that is about
  dates (the fields, the date arithmetic, the timestamp fields, the fuzz
  differential), its tumbling-window tests of tests/test_expr_tail.py
  and test_unix_timestamp_alias of tests/test_expr_tail4.py: each query
  through ``GpuSession(device="cpu")`` (the GPU-placed plan on CPU
  tensors, so K22's plain version) and ``TpuSession``, compared exactly
  with the reference's ``assert_tables_equal``; each port plan is
  GPU-placed but for its DeviceToHostExec.
* The trouble spots of the civil calendar through both sessions: leap
  rules (1900, 2000, 2100), 0001-01-01 and 9999-12-31, month ends under
  add_months, months of +-(2^31 - 1), days before 1970 and timestamps of
  -1 microsecond, every truncation format.
* ``date_fields_plain`` (K22's plain version) against the reference's
  evaluators under numpy (``_ymd`` over ``_civil_from_days`` and
  ``_days_from_civil``, ``_time_part``, the floor-mod fields) on seeded
  days over the whole int32 range and on the trouble spots, and the two
  helpers against the reference's at days past int32 (add_months' month
  ends).
* DateFormatClass and DateAddInterval stay on the CPU with the
  reference's reasons; a sliding window raises naming ROADMAP Queue 1
  item 4d (the reference lowers it through ExpandExec).
* Pinned (the port gives Spark's answer, ROADMAP Queue 3): hour of a
  DATE reads its midnight, add_months of a TIMESTAMP its day.
"""

import datetime
import types as pytypes

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as rt
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import Column as RColumn
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.column import lit as rlit
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.device import batch_to_device as r_upload
from spark_rapids_tpu.expr import cast as rcast
from spark_rapids_tpu.expr import datetime_expr as rdte
from spark_rapids_tpu.expr.core import BoundReference as RBound
from spark_rapids_tpu.expr.core import EvalContext as REvalContext
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu.testing.data_gen import (DateGen, TimestampGen,
                                               gen_table)
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import Column as PColumn
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.column import lit as plit
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.expr import datetime_expr as pdte
from spark_rapids_tpu_torch.ops import dates

REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}
UTC = datetime.timezone.utc


def _side(F, col, lit, dte, Col):
    def ex(cls_name, *args):
        """Column(cls(*args)): a Column argument as its expression, a
        string (a format) and TimeAdd's microseconds as they are, any
        other value as a literal."""
        return Col(getattr(dte, cls_name)(*[
            a.expr if isinstance(a, Col) else
            a if isinstance(a, str) or (cls_name == "TimeAdd" and i == 1)
            else lit(a).expr for i, a in enumerate(args)]))
    return pytypes.SimpleNamespace(F=F, col=col, lit=lit, ex=ex)


REF = _side(RF, rcol, rlit, rdte, RColumn)
PORT = _side(PF, pcol, plit, pdte, PColumn)


def sessions(enabled=True):
    b = TpuSession.builder().config("spark.rapids.sql.enabled", enabled)
    for k, v in REF_FUSE.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(
        device="cpu", conf={"spark.rapids.sql.enabled": enabled})


def placements(session):
    nodes = []
    session.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__, e.placement)))
    return nodes


def _days(table):
    """DATE and TIMESTAMP columns as their int days and microseconds (a
    day past 9999-12-31 has no Python date)."""
    return pa.table([c.cast(pa.int32()) if pa.types.is_date32(c.type) else
                     c.cast(pa.int64()) if pa.types.is_timestamp(c.type)
                     else c for c in table.columns],
                    names=table.column_names)


def run_both(table, query, partitions=1, ignore_order=False):
    """``query(df, X)`` through both sessions, compared exactly; the port's
    plan GPU-placed but for its download.  Returns the port's result."""
    ref, port = sessions()
    want = query(ref.create_dataframe(table, num_partitions=partitions),
                 REF).collect()
    got = query(port.create_dataframe(table, num_partitions=partitions),
                PORT).collect()
    assert got.schema == want.schema
    assert_tables_equal(_days(want), _days(got), ignore_order=ignore_order)
    assert all(p == "gpu" for n, p in placements(port)
               if n != "DeviceToHostExec"), placements(port)
    return got


_DATES = [datetime.date(2024, 2, 29), datetime.date(1970, 1, 1),
          datetime.date(1969, 12, 31), datetime.date(2000, 12, 31),
          None, datetime.date(1582, 10, 15), datetime.date(2038, 1, 19)]


def _dates_table():
    return pa.table({
        "d": pa.array(_DATES, type=pa.date32()),
        "n": pa.array(list(range(len(_DATES))), type=pa.int32())})


# ---------------------------------------------------------------------------
# tests/test_datetime.py
# ---------------------------------------------------------------------------

def test_extract_fields():
    def q(df, X):
        d = X.col("d")
        return df.select(
            X.F.year(d).alias("y"), X.F.month(d).alias("m"),
            X.F.dayofmonth(d).alias("dm"),
            X.ex("DayOfWeek", d).alias("dw"), X.ex("WeekDay", d).alias("wd"),
            X.ex("DayOfYear", d).alias("dy"), X.ex("Quarter", d).alias("q"))
    got = run_both(_dates_table(), q)
    assert got.column("y").to_pylist() == \
        [None if d is None else d.year for d in _DATES]
    assert got.column("m").to_pylist() == \
        [None if d is None else d.month for d in _DATES]
    assert got.column("dm").to_pylist() == \
        [None if d is None else d.day for d in _DATES]
    # Spark: Sunday = 1 .. Saturday = 7; WeekDay Monday = 0
    assert got.column("dw").to_pylist() == \
        [None if d is None else (d.weekday() + 1) % 7 + 1 for d in _DATES]
    assert got.column("wd").to_pylist() == \
        [None if d is None else d.weekday() for d in _DATES]
    assert got.column("dy").to_pylist() == \
        [None if d is None else d.timetuple().tm_yday for d in _DATES]
    assert got.column("q").to_pylist() == \
        [None if d is None else (d.month - 1) // 3 + 1 for d in _DATES]


def test_date_arithmetic():
    def q(df, X):
        d = X.col("d")
        return df.select(
            X.ex("DateAdd", d, 10).alias("pa"),
            X.ex("DateSub", d, 10).alias("mi"),
            X.ex("AddMonths", d, 1).alias("am"),
            X.ex("LastDay", d).alias("ld"),
            X.ex("DateDiff", d, datetime.date(2000, 1, 1)).alias("dd"),
            *[X.ex("TruncDate", d, f).alias(f"tr_{f}") for f in
              ("year", "yyyy", "yy", "month", "mon", "mm", "quarter",
               "week")])
    got = run_both(_dates_table(), q)
    assert got.column("pa").to_pylist() == \
        [None if d is None else d + datetime.timedelta(days=10)
         for d in _DATES]
    # add_months clamps to the month's end (Jan 31 + 1 = Feb 29)
    assert got.column("am").to_pylist()[0] == datetime.date(2024, 3, 29)
    assert got.column("ld").to_pylist()[0] == datetime.date(2024, 2, 29)
    assert got.column("tr_quarter").to_pylist()[0] == \
        datetime.date(2024, 1, 1)
    assert got.column("tr_week").to_pylist()[0] == datetime.date(2024, 2, 26)


def test_timestamp_fields():
    ts = [datetime.datetime(2024, 6, 15, 13, 45, 59, 123456, tzinfo=UTC),
          datetime.datetime(1970, 1, 1, tzinfo=UTC), None,
          datetime.datetime(1969, 12, 31, 23, 59, 59, 999999, tzinfo=UTC),
          datetime.datetime(1900, 3, 1, 6, 7, 8, tzinfo=UTC)]
    tb = pa.table({"t": pa.array(ts, type=pa.timestamp("us", tz="UTC"))})

    def q(df, X):
        t = X.col("t")
        return df.select(
            X.ex("Hour", t).alias("h"), X.ex("Minute", t).alias("mi"),
            X.ex("Second", t).alias("s"), X.F.year(t).alias("y"),
            X.F.month(t).alias("m"), X.F.dayofmonth(t).alias("d"),
            X.ex("DayOfWeek", t).alias("dw"), X.ex("LastDay", t).alias("ld"),
            X.ex("TruncDate", t, "month").alias("tm"))
    got = run_both(tb, q)
    assert got.column("h").to_pylist() == [13, 0, None, 23, 6]
    assert got.column("mi").to_pylist() == [45, 0, None, 59, 7]
    assert got.column("s").to_pylist() == [59, 0, None, 59, 8]
    assert got.column("y").to_pylist() == [2024, 1970, None, 1969, 1900]
    assert got.column("d").to_pylist() == [15, 1, None, 31, 1]


@pytest.mark.parametrize("partitions", [1, 4])
def test_datetime_fuzz_differential(partitions):
    tb = gen_table([("d", DateGen()), ("t", TimestampGen())], length=512)

    def q(df, X):
        d, t = X.col("d"), X.col("t")
        return df.select(
            X.F.year(d).alias("yd"), X.F.month(d).alias("md"),
            X.F.dayofmonth(d).alias("dd"), X.F.year(t).alias("yt"),
            X.ex("DateDiff", d, datetime.date(2000, 1, 1)).alias("dd2"),
            *[X.ex(c, d).alias(f"{c}_d") for c in
              ("Quarter", "DayOfWeek", "WeekDay", "DayOfYear", "LastDay")],
            *[X.ex(c, t).alias(f"{c}_t") for c in
              ("Hour", "Minute", "Second", "DayOfYear", "LastDay")],
            X.ex("AddMonths", d, -13).alias("am"),
            X.ex("TruncDate", t, "quarter").alias("tq"))
    run_both(tb, q, partitions, ignore_order=True)


# ---------------------------------------------------------------------------
# the trouble spots
# ---------------------------------------------------------------------------

_SPOTS = [datetime.date(1900, 2, 28), datetime.date(1900, 3, 1),
          datetime.date(2000, 2, 29), datetime.date(2100, 2, 28),
          datetime.date(2100, 3, 1), datetime.date(1, 1, 1),
          datetime.date(9999, 12, 31), datetime.date(2023, 1, 31),
          datetime.date(2024, 1, 31), datetime.date(1969, 1, 1),
          datetime.date(1600, 12, 31), datetime.date(2024, 12, 31), None]


def test_add_months_and_fields_at_the_calendar_edges():
    n = len(_SPOTS)
    months = [1, 1, 12, -12, 1, -1, 1, 1, 1, 2**31 - 1, -(2**31 - 1),
              None, 5]
    tb = pa.table({"d": pa.array(_SPOTS, pa.date32()),
                   "k": pa.array(months[:n], pa.int32())})

    def q(df, X):
        d = X.col("d")
        return df.select(
            X.ex("AddMonths", d, X.col("k")).alias("amk"),
            X.ex("AddMonths", d, 1).alias("am1"),
            *[X.ex(c, d).alias(c) for c in
              ("Quarter", "DayOfWeek", "WeekDay", "DayOfYear", "LastDay")],
            X.F.year(d).alias("y"), X.F.month(d).alias("m"),
            X.F.dayofmonth(d).alias("dm"),
            *[X.ex("TruncDate", d, f).alias(f"t_{f}") for f in
              ("year", "month", "quarter", "week")])
    got = _days(run_both(tb, q))

    def day(y, m, d):
        return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days
    am1 = got.column("am1").to_pylist()
    assert am1[:3] == [day(1900, 3, 28), day(1900, 4, 1), day(2000, 3, 29)]
    assert am1[6] == day(9999, 12, 31) + 31         # 10000-01-31
    assert am1[7:9] == [day(2023, 2, 28), day(2024, 2, 29)]
    assert got.column("LastDay").to_pylist()[:5] == [
        day(1900, 2, 28), day(1900, 3, 31), day(2000, 2, 29),
        day(2100, 2, 28), day(2100, 3, 31)]
    assert got.column("y").to_pylist()[5:7] == [1, 9999]
    # months of +-(2^31 - 1): far past Python's dates
    amk = got.column("amk").to_pylist()
    want = dates.date_fields_plain(
        torch.tensor([day(d.year, d.month, d.day) for d in _SPOTS[9:11]],
                     dtype=torch.int32),
        "date", "add_months", torch.tensor(months[9:11], dtype=torch.int32))
    assert amk[9:11] == want.tolist()
    assert amk[11:] == [None, None]


def test_unix_timestamp_alias():
    tb = pa.table({"ts": pa.array(
        np.array([0, 86_400_000_000, 1_600_000_000_123_456, -1,
                  -86_400_000_001], dtype="int64").view("M8[us]")),
        "d": pa.array([0, 1, 18_000, -1, -719162], pa.date32()),
        "sec": pa.array([0, -1, 1_600_000_000, None, 2**40], pa.int64())})

    def q(df, X):
        return df.select(
            X.ex("UnixTimestamp", X.col("ts")).alias("u"),
            X.ex("ToUnixTimestamp", X.col("ts")).alias("tu"),
            X.ex("ToUnixTimestamp", X.col("d")).alias("du"),
            X.ex("FromUnixTime", X.col("sec")).alias("fu"),
            X.ex("TimeAdd", X.col("ts"), 90_061_000_001).alias("ta"))
    got = run_both(tb, q)
    assert got.column("u").to_pylist() == [0, 86_400, 1_600_000_000, -1,
                                           -86_401]


# ---------------------------------------------------------------------------
# tumbling windows (tests/test_expr_tail.py)
# ---------------------------------------------------------------------------

def _window_table(minutes, vals):
    base = datetime.datetime(2024, 3, 1, 10, 0, 0, tzinfo=UTC)
    return base, pa.table({
        "ts": pa.array([base + datetime.timedelta(minutes=m)
                        for m in minutes], type=pa.timestamp("us", tz="UTC")),
        "v": pa.array(vals, type=pa.int64())})


@pytest.mark.parametrize("partitions", [1, 3])
def test_tumbling_time_window_groups(partitions):
    base, tb = _window_table((0, 3, 7, 12, 14, 21, -61, -1),
                             [1, 2, 3, 4, 5, 6, 7, 8])

    def q(df, X):
        return (df.group_by(X.F.window(X.col("ts"), "10 minutes").alias("w"))
                .agg(X.F.sum(X.col("v")).alias("s")))
    got = run_both(tb, q, partitions, ignore_order=True)
    rows = sorted((w["start"], s) for w, s in
                  zip(got.column("w").to_pylist(),
                      got.column("s").to_pylist()))
    # minutes 0-9 -> 1 + 2 + 3; 10-19 -> 4 + 5; 20-29 -> 6; before the
    # base, the windows that hold -61 and -1
    assert [r[1] for r in rows] == [7, 8, 6, 9, 6]
    starts = [r[0].replace(tzinfo=UTC) for r in rows]
    assert starts[2] == base
    assert starts[3] == base + datetime.timedelta(minutes=10)


def test_window_start_time_offsets():
    _, tb = _window_table((0, 4, 6), [1, 2, 4])
    for st in ("0 minutes", "-5 minutes", "3 minutes"):
        def q(df, X, st=st):
            return (df.group_by(X.F.window(X.col("ts"), "10 minutes",
                                           start_time=st).alias("w"))
                    .agg(X.F.sum(X.col("v")).alias("s")))
        got = run_both(tb, q, ignore_order=True)
        assert sum(got.column("s").to_pylist()) == 7


def test_sliding_window_is_not_ported():
    """A slide other than the window lowers through ExpandExec in the
    reference; the port has no ExpandExec yet, tags the window off the
    GPU and raises on the CPU engine, naming the item."""
    _, tb = _window_table((0, 4), [1, 2])
    port = GpuSession(device="cpu")
    df = port.create_dataframe(tb).select(
        PF.window(pcol("ts"), "10 minutes", "5 minutes").alias("w"))
    assert "item 4d" in df.explain()
    with pytest.raises(NotImplementedError, match="item 4d"):
        df.collect()


# ---------------------------------------------------------------------------
# host-only rules and the pinned departures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule,reason", [
    ("DateFormatClass", "strftime-style formatting runs on the host"),
    ("DateAddInterval", "calendar-interval type is not modeled on device"),
])
def test_host_only_date_rules_stay_on_cpu(rule, reason):
    tb = _dates_table()
    outs = []
    for X, s in zip((REF, PORT), sessions()):
        col = X.col("d").expr
        e = getattr(rdte if X is REF else pdte, rule)(
            col, "yyyy" if rule == "DateFormatClass" else 1)
        df = s.create_dataframe(tb).select(
            (RColumn if X is REF else PColumn)(e).alias("x"))
        outs.append(df.explain())
    assert all(reason in o for o in outs), outs


def test_time_parts_of_a_date_and_add_months_of_a_timestamp():
    """Spark casts a DATE to its midnight for hour/minute/second and a
    TIMESTAMP to its day for add_months; the reference reads the other
    lane as its own (days as microseconds, microseconds as days)."""
    tb = pa.table({"d": pa.array([-1, 0, 19_000], pa.date32()),
                   "t": pa.array(np.array([-1, 0, 86_400_000_000 * 31 + 5],
                                          dtype="int64").view("M8[us]"))})
    ref, port = sessions()

    def q(df, X):
        return df.select(X.ex("Hour", X.col("d")).alias("h"),
                         X.ex("AddMonths", X.col("t"), 1).alias("am"))
    want = q(ref.create_dataframe(tb), REF).collect()
    got = q(port.create_dataframe(tb), PORT).collect()
    assert got.column("h").to_pylist() == [0, 0, 0]
    assert want.column("h").to_pylist() == [23, 0, 0]
    assert got.column("am").to_pylist() == [
        datetime.date(1970, 1, 31), datetime.date(1970, 2, 1),
        datetime.date(1970, 3, 1)]
    assert want.column("am").cast(pa.int32()).to_pylist() != \
        got.column("am").cast(pa.int32()).to_pylist()


# ---------------------------------------------------------------------------
# K22's plain version against the reference's numpy code
# ---------------------------------------------------------------------------

_TROUBLE_DAYS = [
    -2**31, -2**31 + 1, 2**31 - 1, 2**31 - 2, -2_000_000_001, 2_000_000_001,
    -1, 0, 1, -719_162, 2_932_896, -25_508, -25_509, 10_956, 47_540, 47_541,
    # z = days + 719468 at multiples of -146097: the floor of the era
    -719_468 - 146_097, -719_468 - 2 * 146_097, -719_468,
    -719_468 - 146_096, -719_469]
_TROUBLE_MICROS = [
    -1, 0, 1, -86_400_000_000, -86_400_000_001, 86_400_000_000 - 1,
    -2**63, 2**63 - 1, -3_600_000_000, 3_599_999_999, -60_000_001]


def _day_inputs(seed, n=4000):
    rng = np.random.default_rng(seed)
    days = np.concatenate([
        rng.integers(-2**31, 2**31, n, dtype=np.int64),
        rng.integers(-719_162, 2_932_897, n),      # 0001-01-01..9999-12-31
        np.array(_TROUBLE_DAYS)]).astype(np.int32)
    micros = np.concatenate([
        rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64),
        rng.integers(-(2**50), 2**50, n, dtype=np.int64),
        np.array(_TROUBLE_MICROS, dtype=np.int64)])
    months = rng.integers(-2**31 + 1, 2**31, days.shape[0]).astype(np.int32)
    months[: n // 2] = rng.integers(-30, 31, n // 2)
    months[-4:] = [2**31 - 1, -(2**31 - 1), 0, -2**31 + 1]
    return days, micros, months


def _reference_field(field, days, micros, months):
    """The reference's evaluator of ``field`` under numpy, over a batch
    of (d DATE, t TIMESTAMP, k INT)."""
    n = days.shape[0]
    rb = pa.RecordBatch.from_arrays([
        pa.array(days, pa.date32()),
        pa.array(micros[:n] if micros.shape[0] >= n else
                 np.resize(micros, n), pa.timestamp("us")),
        pa.array(months, pa.int32())], names=["d", "t", "k"])
    batch = r_upload(rb, xp=np)
    d, t, k = (RBound(0, rt.DATE), RBound(1, rt.TIMESTAMP),
               RBound(2, rt.INT))
    kind, cls = {
        "year": ("date", rdte.Year), "month": ("date", rdte.Month),
        "day": ("date", rdte.DayOfMonth), "quarter": ("date", rdte.Quarter),
        "dayofweek": ("date", rdte.DayOfWeek),
        "weekday": ("date", rdte.WeekDay),
        "dayofyear": ("date", rdte.DayOfYear),
        "last_day": ("date", rdte.LastDay), "hour": ("timestamp", rdte.Hour),
        "minute": ("timestamp", rdte.Minute),
        "second": ("timestamp", rdte.Second)}.get(field, ("date", None))
    if field == "add_months":
        e = rdte.AddMonths(d, k)
    elif field.startswith("trunc_"):
        e = rdte.TruncDate(d, field[len("trunc_"):])
    else:
        e = cls(t if kind == "timestamp" else d)
    out = e.eval(REvalContext(np, batch)).col.data[:n]
    return np.asarray(out).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("field", dates.FIELDS)
def test_date_fields_plain_matches_reference(field, seed):
    days, micros, months = _day_inputs(seed)
    n = days.shape[0]
    micros = np.resize(micros, n)
    want = _reference_field(field, days, micros, months)
    if field in ("hour", "minute", "second"):
        got = dates.date_fields_plain(torch.from_numpy(micros), "timestamp",
                                      field)
    else:
        got = dates.date_fields_plain(
            torch.from_numpy(days), "date", field,
            torch.from_numpy(months) if field == "add_months" else None)
    np.testing.assert_array_equal(got.numpy(), want)
    if field not in ("hour", "minute", "second", "add_months"):
        # the same field of a timestamp reads its (floored) day
        ts = dates.date_fields_plain(torch.from_numpy(micros), "timestamp",
                                     field)
        day_of = torch.div(torch.from_numpy(micros), dates.MICROS_PER_DAY,
                           rounding_mode="floor").to(torch.int32)
        assert torch.equal(ts, dates.date_fields_plain(day_of, "date",
                                                       field))


def test_civil_helpers_match_reference_past_int32():
    rng = np.random.default_rng(7)
    z = np.concatenate([rng.integers(-7 * 10**10, 7 * 10**10, 5000),
                        np.array(_TROUBLE_DAYS, dtype=np.int64)])
    y, m, d = rcast._civil_from_days(np, z)
    py, pm, pd_ = dates._civil_from_days(torch.from_numpy(z))
    for a, b in ((y, py), (m, pm), (d, pd_)):
        np.testing.assert_array_equal(b.numpy(), a)
    back = rcast._days_from_civil(np, y, m, d)
    np.testing.assert_array_equal(
        dates._days_from_civil(py, pm, pd_).numpy(), back)


def test_date_fields_refuses_what_the_kernel_does_not_take():
    days = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        dates.date_fields(days, "date", "hour")
    with pytest.raises(TypeError):
        dates.date_fields(days.to(torch.int64), "timestamp", "add_months", 1)
    with pytest.raises(TypeError):
        dates.date_fields(days, "timestamp", "year")
    with pytest.raises(TypeError):
        dates.date_fields(days, "date", "add_months")
    with pytest.raises(TypeError):
        dates.date_fields(days, "date", "add_months",
                          torch.zeros(4, dtype=torch.int64))

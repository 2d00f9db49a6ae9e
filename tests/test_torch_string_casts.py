"""Casts to and from STRING in the port against the reference, on the
CPU.

Every direction the reference's ``cast_supported_on_tpu`` admits runs
through ``GpuSession(device="cpu")`` (GPU-placed but for the download)
and ``TpuSession`` and is compared exactly: BOOLEAN, BYTE, SHORT, INT,
LONG, DATE and DECIMAL to STRING; STRING to BOOLEAN, BYTE, SHORT, INT,
LONG, FLOAT, DOUBLE and DATE, over malformed input (null), whitespace,
signs, overflow past 19 digits, dates before 1970 and 29 February.
TIMESTAMP to and from STRING stay on the CPU engine in both; FLOAT and
DOUBLE to STRING and STRING to DECIMAL stay there with the reference's
reasons, and both packages raise on them.
"""

import datetime
import decimal

import pyarrow as pa
import pytest

from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.column import lit as rlit
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.column import lit as plit
from spark_rapids_tpu_torch.api.session import GpuSession

D = decimal.Decimal
REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}


def sessions():
    b = TpuSession.builder()
    for k, v in REF_FUSE.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(device="cpu")


def placements(port):
    nodes = []
    port.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__, e.placement)))
    return nodes


def run_both(table, query, gpu=True, partitions=1):
    ref, port = sessions()
    want = query(ref.create_dataframe(table, num_partitions=partitions),
                 rcol, rlit).collect()
    got = query(port.create_dataframe(table, num_partitions=partitions),
                pcol, plit).collect()
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=False)
    nodes = placements(port)
    if gpu:
        assert all(p == "gpu" for n, p in nodes
                   if n != "DeviceToHostExec"), nodes
    return want, got, port


_TO_STRING = {
    "boolean": pa.array([True, False, None]),
    "tinyint": pa.array([0, -128, 127, None, 5], pa.int8()),
    "smallint": pa.array([-32768, 32767, 0, None, -7], pa.int16()),
    "int": pa.array([0, 1, -1, 2**31 - 1, -2**31, None, 1000000],
                    pa.int32()),
    "bigint": pa.array([0, 2**63 - 1, -2**63, None, 10**18, -5],
                       pa.int64()),
    "date": pa.array([datetime.date(1970, 1, 1), datetime.date(1969, 12, 31),
                      datetime.date(2000, 2, 29), datetime.date(1900, 3, 1),
                      datetime.date(1, 1, 1), datetime.date(9999, 12, 31),
                      None, datetime.date(2024, 2, 29)]),
    "decimal(7,2)": pa.array([D("12.34"), D("-0.05"), D("0.00"), None,
                              D("99999.99"), D("-99999.99"), D("5.10")],
                             pa.decimal128(7, 2)),
    "decimal(18,0)": pa.array([D(10**17), D(-(10**18 - 1)), D(0), None],
                              pa.decimal128(18, 0)),
    "decimal(10,4)": pa.array([D("-0.0001"), D("123456.7890"), None],
                              pa.decimal128(10, 4)),
}


@pytest.mark.parametrize("name", sorted(_TO_STRING))
@pytest.mark.parametrize("partitions", [1, 2])
def test_cast_to_string(name, partitions):
    t = pa.table({"x": _TO_STRING[name]})
    _, got, _ = run_both(t, lambda d, col, lit: d.select(
        col("x").cast("string").alias("s")), partitions=partitions)
    if name in ("int", "bigint"):
        assert got.column("s").to_pylist() == [
            None if v is None else str(v) for v in _TO_STRING[name].to_pylist()]


_STRINGS = ["0", "1", "-1", "+7", " 42 ", "\t13\n", "007", "", " ", "abc",
            "1a", "12.5", "-", "+", "127", "128", "-129", "32768",
            "2147483647", "2147483648", "-2147483649",
            "9223372036854775807", "-9223372036854775808",
            "99999999999999999999", "1e3", "1.5E-3", "-0.25", ".5", "5.",
            "1e", "e5", "1.2.3", "true", "FALSE", "t", "No", "y", "yes",
            "2000-02-29", "2001-02-29", "1969-12-31", "1900-03-01",
            "2024-13-01", "2024-1-5", " 1999-12-31 ", "0001-01-01",
            "abcdefghijklmnopqrstuvwxyz0123", "  123456789012345678901  ",
            None, "é", "1 2"]


@pytest.mark.parametrize("to", ["boolean", "tinyint", "smallint", "int",
                                "bigint", "float", "double", "date"])
@pytest.mark.parametrize("partitions", [1, 2])
def test_cast_from_string(to, partitions):
    t = pa.table({"s": pa.array(_STRINGS, pa.string())})
    _, got, _ = run_both(t, lambda d, col, lit: d.select(
        col("s").cast(to).alias("v")), partitions=partitions)
    if to == "int":
        assert got.column("v").to_pylist()[:5] == [0, 1, -1, 7, 42]


def test_cast_round_trips_and_literals():
    t = pa.table({"i": pa.array([5, -12, None, 2**31 - 1], pa.int32()),
                  "s": pa.array(["3", None, "x", "-8"])})
    run_both(t, lambda d, col, lit: d.select(
        col("i").cast("string").cast("int").alias("rt"),
        (col("s").cast("int") + col("i")).alias("sum"),
        col("s").cast("bigint").cast("string").alias("rt2")))


@pytest.mark.parametrize("query", ["ts_to_string", "string_to_ts"])
def test_timestamp_string_casts_on_cpu_engine(query):
    """Not admitted on the device by either package: both CPU engines give
    the reference's answer (a timestamp's microseconds as digits; a
    string read as whole seconds)."""
    t = pa.table({"ts": pa.array([datetime.datetime(2020, 1, 1, 1, 2, 3),
                                  None], pa.timestamp("us", tz="UTC")),
                  "s": pa.array(["7", " 12 "])})
    col_name, to = ("ts", "string") if query == "ts_to_string" else \
        ("s", "timestamp")
    _, _, port = run_both(t, lambda d, col, lit: d.select(
        col(col_name).cast(to).alias("r")), gpu=False)
    assert ("ProjectExec", "cpu") in placements(port)


@pytest.mark.parametrize("src,to,reason", [
    ("f", "string", "cast from double to string is not supported on GPU"),
    ("g", "string", "cast from float to string is not supported on GPU"),
    ("s", "decimal(10,2)",
     "cast from string to decimal(10,2) is not supported on GPU")])
def test_unsupported_string_casts_stay_on_cpu(src, to, reason):
    """The reference keeps these off its device and its CPU engine raises
    on them; so does the port's."""
    t = pa.table({"f": pa.array([1.5, None], pa.float64()),
                  "g": pa.array([2.5, None], pa.float32()),
                  "s": pa.array(["1.25", None])})
    ref, port = sessions()
    for s, col in ((ref, rcol), (port, pcol)):
        with pytest.raises(NotImplementedError):
            s.create_dataframe(t).select(col(src).cast(to)).collect()
    assert reason in port.last_explain
    assert reason.replace("GPU", "TPU") in ref.last_explain


def test_decimal128_to_string_on_cpu_engine():
    """A DECIMAL(30,2) to string stays on the CPU engine in both (the
    reference's reason); the port formats the exact value, Spark's
    answer, where the reference's engine raises OverflowError."""
    t = pa.table({"d": pa.array([D("1111111111111111111111111.55"),
                                 D("-0.05"), None, D(0)],
                                pa.decimal128(30, 2))})
    ref, port = sessions()
    got = port.create_dataframe(t).select(
        pcol("d").cast("string").alias("s")).collect()
    assert got.column("s").to_pylist() == [
        "1111111111111111111111111.55", "-0.05", None, "0.00"]
    assert "cast from decimal(30,2) to string is not supported on GPU" in \
        port.last_explain
    with pytest.raises(OverflowError):
        ref.create_dataframe(t).select(rcol("d").cast("string")).collect()

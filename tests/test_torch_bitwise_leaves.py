"""Bitwise expressions and the registry's small leaves in the port
against the reference, on the CPU.

* tests/test_bitwise_math.py's bitwise and shift tests, over BYTE,
  SHORT, INT and LONG with negative values and shift distances of 0-200
  (Java's masking by the width - 1; the unsigned shift is logical).
* tests/test_misc_expressions.py's rand, spark_partition_id and
  input_file_name tests: rand's bits equal the reference's for several
  seeds over 1, 2 and 4 partitions; input_file_name stays on the CPU
  with the reference's reason and is "" past an exchange.
* tests/test_expr_tail4.py::test_nanvl_inset_atleastn and
  ::test_decimal_plumbing, tests/test_expr_tail.py::
  test_normalize_nan_and_zero (the NaN bits and -0.0), and
  InputFileBlockStart/Length, KnownNotNull,
  KnownFloatingPointNormalized, PreciseTimestampConversion, ParamLiteral
  and ScalarSubquery.
Each query runs through ``GpuSession(device="cpu")`` and ``TpuSession``
and is compared exactly with the reference's ``assert_tables_equal``
(rand's doubles by their bits); each port plan is GPU-placed but for its
DeviceToHostExec, except where a rule keeps it on the CPU, which is
checked with the reference's reason.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import types as rt
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import Column as RColumn
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.column import lit as rlit
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.expr import mathexpr as rmx
from spark_rapids_tpu.expr import misc_tail as rmt
from spark_rapids_tpu.expr.params import ParamLiteral as RParam
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch import types as pt
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import Column as PColumn
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.column import lit as plit
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.expr import arithmetic as par
from spark_rapids_tpu_torch.expr import mathexpr as pmx
from spark_rapids_tpu_torch.expr import misc_tail as pmt
from spark_rapids_tpu_torch.expr.params import ParamLiteral as PParam

REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}


class _Side:
    def __init__(self, F, col, lit, Col, mt, mx, types, Param):
        self.F, self.col, self.lit, self.Col = F, col, lit, Col
        self.mt, self.mx, self.t, self.Param = mt, mx, types, Param


REF = _Side(RF, rcol, rlit, RColumn, rmt, rmx, rt, RParam)
PORT = _Side(PF, pcol, plit, PColumn, pmt, pmx, pt, PParam)


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


def run_both(table, query, partitions=1, gpu=True, ignore_order=False):
    """``query(df, X)`` through both sessions, compared exactly; the
    port's plan GPU-placed but for its download where ``gpu``.  Returns
    (reference's, port's, port session)."""
    ref, port = sessions()
    want = query(ref.create_dataframe(table, num_partitions=partitions),
                 REF).collect()
    got = query(port.create_dataframe(table, num_partitions=partitions),
                PORT).collect()
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=ignore_order)
    if gpu:
        assert all(p == "gpu" for n, p in placements(port)
                   if n != "DeviceToHostExec"), placements(port)
    return want, got, port


# ---------------------------------------------------------------------------
# bitwise (tests/test_bitwise_math.py)
# ---------------------------------------------------------------------------

_INTS = {"byte": (pa.int8(), 8), "short": (pa.int16(), 16),
         "int": (pa.int32(), 32), "long": (pa.int64(), 64)}


def _int_table(kind, n=500, seed=11):
    typ, bits = _INTS[kind]
    rng = np.random.default_rng(seed)
    lo, hi = -2**(bits - 1), 2**(bits - 1)
    a = rng.integers(lo, hi, n, dtype=np.int64)
    b = rng.integers(lo, hi, n, dtype=np.int64)
    a[:4] = [lo, hi - 1, -1, 0]
    s = rng.integers(0, 201, n)
    s[:8] = [0, 1, bits - 1, bits, bits + 1, 63, 64, 200]
    mask = rng.random(n) < 0.05
    return pa.table({"a": pa.array(a, typ, mask=mask),
                     "b": pa.array(b, typ),
                     "s": pa.array(s.astype(np.int32), mask=rng.random(n)
                                   < 0.05),
                     "l": pa.array(b, pa.int64())})


@pytest.mark.parametrize("kind", sorted(_INTS))
def test_bitwise_and_or_xor_not_differential(kind):
    tb = _int_table(kind)

    def q(df, X):
        a, b, l = X.col("a"), X.col("b"), X.col("l")
        return df.select(
            X.F.bitwise_and(a, b).alias("and_"),
            X.F.bitwise_or(a, b).alias("or_"),
            X.F.bitwise_xor(a, b).alias("xor_"),
            X.F.bitwise_not(a).alias("not_"),
            X.F.bitwise_and(a, l).alias("and_l"))
    _, got, _ = run_both(tb, q)
    a = tb.column("a").to_pylist()
    b = tb.column("b").to_pylist()
    assert got.column("and_").to_pylist()[:50] == \
        [None if x is None else x & y for x, y in zip(a[:50], b[:50])]


@pytest.mark.parametrize("kind", sorted(_INTS))
def test_shifts_follow_java_masking(kind):
    tb = _int_table(kind, seed=12)

    def q(df, X):
        a, s = X.col("a"), X.col("s")
        return df.select(
            X.F.shiftleft(a, s).alias("shl"),
            X.F.shiftright(a, s).alias("shr"),
            X.F.shiftrightunsigned(a, s).alias("shru"))
    _, got, _ = run_both(tb, q)
    bits = 64 if kind == "long" else 32
    a = tb.column("a").to_pylist()
    s = tb.column("s").to_pylist()
    for x, k, l, r, u in zip(a, s, got.column("shl").to_pylist(),
                             got.column("shr").to_pylist(),
                             got.column("shru").to_pylist()):
        if x is None or k is None:
            assert l is None and r is None and u is None
            continue
        k &= bits - 1
        m = (1 << bits) - 1
        as_signed = (lambda v: v - (1 << bits) if v >> (bits - 1) else v)
        assert l == as_signed((x << k) & m)
        assert r == x >> k
        assert u == as_signed((x & m) >> k)


def test_shifts_of_a_long_by_java_masking():
    tb = pa.table({"v": pa.array([1, -8, 2**40, -1], type=pa.int64()),
                   "s": pa.array([1, 2, 65, 63], type=pa.int32())})

    def q(df, X):
        v, s = X.col("v"), X.col("s")
        return df.select(X.F.shiftleft(v, s).alias("shl"),
                         X.F.shiftright(v, s).alias("shr"),
                         X.F.shiftrightunsigned(v, s).alias("shru"))
    _, got, _ = run_both(tb, q)
    # Java masks long shifts by 63: a shift of 65 is a shift of 1
    assert got.column("shl").to_pylist()[2] == (2**40) << 1
    assert got.column("shr").to_pylist()[3] == -1      # sign-extends
    assert got.column("shru").to_pylist()[3] == 1      # zero-fills


def test_literal_operands():
    """A literal operand of a bitwise op or a shift: the port's answer is
    Java's; the reference's evaluators call ``astype`` on a Python int
    and raise (ROADMAP Queue 3)."""
    tb = pa.table({"a": pa.array([-8, 7, None, 2**40], pa.int64()),
                   "s": pa.array([1, 63, 2, 64], pa.int32())})
    ref, port = sessions()

    def q(df, X):
        a, s = X.col("a"), X.col("s")
        return df.select(
            X.F.bitwise_xor(a, X.lit(5)).alias("x5"),
            X.F.shiftleft(a, 3).alias("shl3"),
            X.F.shiftrightunsigned(a, 70).alias("shru70"),
            X.F.shiftrightunsigned(X.lit(-8), s).alias("lit_shru"),
            X.F.shiftright(X.lit(-8), X.lit(1)).alias("both"))
    with pytest.raises(AttributeError, match="astype"):
        q(ref.create_dataframe(tb), REF).collect()
    got = q(port.create_dataframe(tb), PORT).collect()
    m = (1 << 64) - 1
    assert got.column("x5").to_pylist() == [-8 ^ 5, 7 ^ 5, None,
                                            2**40 ^ 5]
    assert got.column("shl3").to_pylist() == [-64, 56, None, 2**43]
    assert got.column("shru70").to_pylist() == [(-8 & m) >> 6, 0, None,
                                                2**34]
    # an INT literal shifts as an INT: -8 >>> 1 is 2^31 - 4
    assert got.column("lit_shru").to_pylist() == [
        (-8 & 0xFFFFFFFF) >> 1, (-8 & 0xFFFFFFFF) >> 31,
        (-8 & 0xFFFFFFFF) >> 2, -8]
    assert got.column("both").to_pylist() == [-4] * 4


# ---------------------------------------------------------------------------
# rand, spark_partition_id, input_file_name (tests/test_misc_expressions.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partitions", [1, 2, 4])
def test_rand_bits_equal_the_reference(partitions):
    tb = pa.table({"v": pa.array(np.arange(500, dtype=np.int64))})

    def q(df, X):
        return df.select(X.col("v"), X.F.rand(42).alias("r"),
                         X.F.rand(-7).alias("rn"), X.F.rand().alias("r0"),
                         X.F.rand(2**63 + 5).alias("rb"),
                         X.F.spark_partition_id().alias("pid"),
                         X.F.monotonically_increasing_id().alias("mid"))
    want, got, _ = run_both(tb, q, partitions)
    for name in ("r", "rn", "r0", "rb"):
        np.testing.assert_array_equal(
            got.column(name).to_numpy().view(np.int64),
            want.column(name).to_numpy().view(np.int64))
    rs = got.column("r").to_pylist()
    assert all(0.0 <= r < 1.0 for r in rs)
    assert len(set(rs)) > 450
    assert got.column("r").to_pylist() != got.column("rn").to_pylist()
    for m, p in zip(got.column("mid").to_pylist(),
                    got.column("pid").to_pylist()):
        assert m >> 33 == p


def test_rand_in_a_filter_over_partitions():
    tb = pa.table({"v": pa.array(np.arange(2000, dtype=np.int64))})
    run_both(tb, lambda df, X: df.filter(X.F.rand(3) < X.lit(0.25)), 3,
             ignore_order=True)


def _parquet_files(tmp_path, n=2):
    paths = []
    for i in range(n):
        p = str(tmp_path / f"part-{i}.parquet")
        pq.write_table(pa.table({
            "v": pa.array(np.arange(5, dtype=np.int64) + 10 * i)}), p)
        paths.append(p)
    return paths


def test_input_file_name(tmp_path):
    paths = _parquet_files(tmp_path)
    outs = []
    for X, s in zip((REF, PORT), sessions()):
        df = s.read.parquet(*paths).select(
            X.col("v"), X.F.input_file_name().alias("f"),
            X.Col(X.mt.InputFileBlockStart()).alias("bs"),
            X.Col(X.mt.InputFileBlockLength()).alias("bl"))
        outs.append(df.collect())
    ref_out, port_out = outs
    assert_tables_equal(ref_out, port_out)
    got = dict(zip(port_out.column("v").to_pylist(),
                   port_out.column("f").to_pylist()))
    for i, p in enumerate(paths):
        for v in range(10 * i, 10 * i + 5):
            assert got[v] == p, (v, got[v])
    assert ("ProjectExec", "cpu") in placements(s)
    assert "file-path strings materialize on the host engine" in \
        s.last_explain


def test_input_file_name_empty_after_exchange(tmp_path):
    # a file read first leaves its path as the thread's current file
    GpuSession(device="cpu").read.parquet(
        *_parquet_files(tmp_path, 1)).collect()
    tb = pa.table({"k": pa.array([1, 2, 1, 2]), "v": pa.array([1, 2, 3, 4])})
    out = GpuSession(device="cpu").create_dataframe(tb, num_partitions=2) \
        .group_by(pcol("k")).agg(PF.sum(pcol("v")).alias("sv")) \
        .select(PF.input_file_name().alias("f")).collect()
    assert set(out.column("f").to_pylist()) == {""}


# ---------------------------------------------------------------------------
# the small leaves (tests/test_expr_tail4.py, tests/test_expr_tail.py)
# ---------------------------------------------------------------------------

def test_nanvl_inset_atleastn():
    tb = pa.table({
        "a": pa.array([1.0, float("nan"), None, 4.0, float("nan")]),
        "b": pa.array([10.0, 20.0, 30.0, None, None]),
        "f": pa.array([1.5, float("nan"), None, 2.0, 3.0], pa.float32()),
        "k": pa.array([1, 2, 3, 4, None], type=pa.int64())})

    def q(df, X):
        a, b, f, k = (X.col(c).expr for c in "abfk")
        return df.select(
            X.Col(X.mt.NaNvl(a, b)).alias("nv"),
            X.Col(X.mt.NaNvl(f, f)).alias("nvf"),
            X.Col(X.mt.NaNvl(f, b)).alias("nvfd"),
            X.Col(X.mt.InSet(k, (2, 4, None))).alias("ins"),
            X.Col(X.mt.InSet(k, (1, 3))).alias("ins2"),
            X.Col(X.mt.AtLeastNNonNulls(2, [a, b])).alias("aln"),
            X.Col(X.mt.AtLeastNNonNulls(1, [a, f, k])).alias("aln1"))
    _, got, _ = run_both(tb, q)
    assert got.column("nv").to_pylist() == [1.0, 20.0, None, 4.0, None]
    # IN with a null in the list: null unless matched
    assert got.column("ins").to_pylist() == [None, True, None, True, None]
    # NaN does not count as non-null for dropna
    assert got.column("aln").to_pylist() == [True, False, False, False,
                                             False]


def test_decimal_plumbing():
    tb = pa.table({
        "d": pa.array([None, 1, 12345, -99999], type=pa.decimal128(9, 2)),
        "u": pa.array([5, 123, 10**7, -(10**7)], type=pa.int64())})

    def q(df, X):
        d, u = X.col("d").expr, X.col("u").expr
        mk = X.mt if X is REF else par
        return df.select(
            X.Col(X.mt.UnscaledValue(d)).alias("uv"),
            X.Col(mk.MakeDecimal(u, 5, 2)).alias("md"),
            X.Col(mk.CheckOverflow(d, 4, 2)).alias("co"))
    _, got, _ = run_both(tb, q)
    # pyarrow reads the ints as decimal values: 1.00, 123.45, -999.99
    assert got.column("uv").to_pylist() == [None, 100, 1234500, -9999900]
    assert [None if x is None else str(x) for x in
            got.column("md").to_pylist()] == ["0.05", "1.23", None, None]
    assert [None if x is None else str(x) for x in
            got.column("co").to_pylist()] == [None, "1.00", None, None]


def test_unscaled_value_of_a_decimal128_stays_on_the_cpu():
    tb = pa.table({"d": pa.array([1, -2], type=pa.decimal128(30, 2))})
    reason = "unscaledvalue of decimal128 needs both lanes"
    for X, s in zip((REF, PORT), sessions()):
        s.create_dataframe(tb).select(
            X.Col(X.mt.UnscaledValue(X.col("d").expr)).alias("u")).collect()
    assert reason in s.last_explain
    assert ("ProjectExec", "cpu") in placements(s)


def test_normalize_nan_and_zero():
    nan_bits = np.array([0x7FF0000000000001, -0x0008000000000001],
                        dtype=np.int64).view(np.float64)
    tb = pa.table({"x": pa.array([0.0, -0.0, float("nan"), 1.5, None,
                                  nan_bits[0], nan_bits[1]]),
                   "f": pa.array([-0.0, 0.0, float("nan"), 1.5, None, 2.0,
                                  -1.0], pa.float32())})

    def q(df, X):
        x, f = X.col("x").expr, X.col("f").expr
        return df.select(
            X.Col(X.mx.NormalizeNaNAndZero(x)).alias("n"),
            X.Col(X.mx.NormalizeNaNAndZero(f)).alias("nf"),
            X.Col(X.mt.KnownFloatingPointNormalized(
                X.mx.NormalizeNaNAndZero(x))).alias("kn"),
            X.Col(X.mt.KnownNotNull(f)).alias("knn"))
    want, got, _ = run_both(tb, q)
    for name in ("n", "nf"):
        g, w = got.column(name), want.column(name)
        np.testing.assert_array_equal(
            g.fill_null(1.0).to_numpy().view(np.uint64 if name == "n"
                                             else np.uint32),
            w.fill_null(1.0).to_numpy().view(np.uint64 if name == "n"
                                             else np.uint32))
    vals = got.column("n").to_pylist()
    assert str(vals[1]) == "0.0"
    assert np.isnan(vals[2]) and vals[3] == 1.5 and vals[4] is None
    assert set(got.column("n").to_numpy()[[2, 5, 6]].view(np.uint64)) == \
        {0x7FF8000000000000}
    # grouping floats already normalises: -0.0 and 0.0 share a group
    _, g, _ = run_both(tb, lambda df, X: df.group_by(X.col("x")).agg(
        X.F.count("*").alias("c")), ignore_order=True)
    assert [c for x, c in zip(g.column("x").to_pylist(),
                              g.column("c").to_pylist()) if x == 0.0] == [2]


def test_precise_timestamp_conversion():
    tb = pa.table({"ts": pa.array(np.array([0, -1, 1_600_000_000_123_456],
                                           dtype="int64").view("M8[us]")),
                   "l": pa.array([5, None, -7], pa.int64())})

    def q(df, X):
        return df.select(
            X.Col(X.mt.PreciseTimestampConversion(
                X.col("ts").expr, X.t.TIMESTAMP, X.t.LONG)).alias("tl"),
            X.Col(X.mt.PreciseTimestampConversion(
                X.col("l").expr, X.t.LONG, X.t.TIMESTAMP)).alias("lt"))
    _, got, _ = run_both(tb, q)
    assert got.column("tl").to_pylist() == [0, -1, 1_600_000_000_123_456]


def test_param_literal_evaluates_as_its_value():
    tb = pa.table({"v": pa.array([1, 5, 9, None], pa.int64())})

    def q(df, X):
        p = X.Param(0, X.t.LONG, 5)
        return df.select(
            X.Col(p).alias("p"),
            (X.col("v") > X.Col(X.Param(1, X.t.LONG, 4))).alias("gt"))
    _, got, _ = run_both(tb, q)
    assert got.column("gt").to_pylist() == [False, True, True, None]


# ---------------------------------------------------------------------------
# scalar subqueries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partitions", [1, 3])
def test_scalar_subquery_in_a_filter(partitions):
    rng = np.random.default_rng(5)
    tb = pa.table({"k": pa.array(rng.integers(0, 10, 300)),
                   "v": pa.array(rng.normal(0, 10, 300))})

    def q(df, X):
        avg = df.agg(X.F.avg(X.col("v")).alias("m"))
        return df.filter(X.col("v") > X.F.scalar_subquery(avg)) \
            .group_by(X.col("k")).agg(X.F.count("*").alias("c"))
    _, got, port = run_both(tb, q, partitions, ignore_order=True)
    mean = float(np.mean(tb.column("v").to_numpy()))
    assert sum(got.column("c").to_pylist()) == \
        int((tb.column("v").to_numpy() > mean).sum())
    # explain runs no subquery: a typed null stands in
    lp = q(port.create_dataframe(tb, num_partitions=partitions), PORT)._lp
    assert "NULL" in port.explain(lp)


def test_scalar_subquery_of_more_than_one_row_raises():
    tb = pa.table({"v": pa.array([1, 2, 3])})
    for X, s in zip((REF, PORT), sessions()):
        df = s.create_dataframe(tb)
        with pytest.raises(ValueError, match="one row"):
            df.filter(X.col("v") > X.F.scalar_subquery(df)).collect()

"""The narrow flat types in the port against the reference, on the CPU.

BYTE, SHORT, FLOAT, DATE, TIMESTAMP (microseconds, UTC) and DECIMAL(9,2)
columns, about 10 % null, with each type's edge values (its minimum and
maximum; NaN, +-0.0 and +-inf for FLOAT; dates before 1970 and at
1582-10-15; timestamps with microseconds), go through the same checks:
the upload and ``column_to_arrow`` round trip, filter, project,
group-by, sort, TopN, union, distinct and sample through the reference's
TpuSession and the port's GpuSession(device="cpu") (results equal,
FLOAT to the reference's tolerance, placements equal), casts among all
flat types, comparisons at mixed decimal scales, the key words against
the reference's ``key_words_for_column``, murmur3 against the
reference's ``hash_column``, joins on keys of each type, window
partition and order keys of each type with bounded RANGE frames over
DATE, DECIMAL, TIMESTAMP and SHORT, Parquet, ORC and CSV round trips,
and the parquet cached batch.
"""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as papq
import pytest
import torch

from spark_rapids_tpu import types as rt
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.column import lit as rlit
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar import device as rdev
from spark_rapids_tpu.expr import hashfns as rhash
from spark_rapids_tpu.expr.window import Window as RWindow
from spark_rapids_tpu.expr.window import WindowBuilder as RWB
from spark_rapids_tpu.ops import segmented as rseg
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch import types as pt
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.column import lit as plit
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar import device as pdev
from spark_rapids_tpu_torch.columnar.fetch import fetch_batch
from spark_rapids_tpu_torch.expr import hashfns as phash
from spark_rapids_tpu_torch.expr.window import Window as PWindow
from spark_rapids_tpu_torch.expr.window import WindowBuilder as PWB
from spark_rapids_tpu_torch.ops import segmented as pseg

FLOAT_RTOL = 1e-6          # float32 through one operation
REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}
REF = (RF, rcol, rlit)
PORT = (PF, pcol, plit)
NARROW = ["b", "s", "f", "dt", "ts", "dec"]
EPOCH = datetime.date(1970, 1, 1)


def narrow_table(n=600, seed=0, nulls=0.1):
    """One column of each narrow type, edge values first, then random
    rows; about ``nulls`` of each column null."""
    rng = np.random.default_rng(seed)
    edge_b = [-128, 127, 0, -1, 1]
    edge_s = [-32768, 32767, 0, -1, 1]
    edge_f = [float("nan"), 0.0, -0.0, float("inf"), float("-inf"),
              3.4028235e38, -3.4028235e38, 1.5]
    edge_dt = [(datetime.date(1582, 10, 15) - EPOCH).days, -1, 0,
               (datetime.date(1900, 3, 1) - EPOCH).days,
               (datetime.date(2262, 4, 11) - EPOCH).days]
    edge_ts = [-1, 0, 1, 123456789, -62135596800000000, 253402300799999999]
    edge_dec = [-9999999.99, 9999999.99, 0.0, -0.01, 0.01]

    def col(edge, gen):
        vals = list(edge) + list(gen(n - len(edge)))
        mask = rng.random(n) < nulls
        mask[:len(edge)] = False
        return vals[:n], mask
    b, mb = col(edge_b, lambda m: rng.integers(-128, 128, m))
    s, ms = col(edge_s, lambda m: rng.integers(-32768, 32768, m))
    f, mf = col(edge_f, lambda m: rng.normal(0, 100, m).astype(np.float32))
    dt, mdt = col(edge_dt, lambda m: rng.integers(-30000, 30000, m))
    ts, mts = col(edge_ts, lambda m: rng.integers(-2**52, 2**52, m))
    dec, mdec = col(edge_dec, lambda m: rng.integers(-10**8, 10**8, m)
                    / 100.0)
    dec_arr = pa.array(
        [None if m else decimal.Decimal(int(round(x * 100))).scaleb(-2)
         for x, m in zip(dec, mdec)], pa.decimal128(9, 2))
    return pa.table({
        "k": pa.array(rng.integers(0, 8, n).astype(np.int64)),
        "b": pa.array(np.array(b, np.int8), mask=mb),
        "s": pa.array(np.array(s, np.int16), mask=ms),
        "f": pa.array(np.array(f, np.float32), mask=mf),
        "dt": pa.array(np.array(dt, np.int32), pa.date32(), mask=mdt),
        "ts": pa.array(np.array(ts, np.int64),
                       pa.timestamp("us", tz="UTC"), mask=mts),
        "dec": dec_arr,
    })


@pytest.fixture(scope="module")
def sessions():
    b = TpuSession.builder()
    for k, v in REF_FUSE.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(device="cpu")


def shape(session):
    nodes = []
    session.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__.replace("Tpu", "Gpu"),
         e.placement.replace("tpu", "gpu"))))
    return [n for n in nodes
            if n[0] not in ("AQEShuffleReadExec", "_SkewAwareRead")]


def run_both(sessions, table, query, partitions=1, order=False):
    ref, port = sessions
    want = query(ref.create_dataframe(table, num_partitions=partitions),
                 *REF).collect()
    got = query(port.create_dataframe(table, num_partitions=partitions),
                *PORT).collect()
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=not order,
                        approximate_float=FLOAT_RTOL)
    assert shape(port) == shape(ref)
    return got, port


# ---------------------------------------------------------------------------
# the columns themselves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NARROW)
def test_upload_and_arrow_round_trip(name):
    tb = narrow_table().select([name])
    b = pdev.batch_to_device(tb.to_batches()[0], "cpu")
    back = pdev.batch_to_arrow(b)
    assert back.schema == tb.schema
    want = tb.column(0).combine_chunks()
    same_bits(back.column(0), want)
    same_bits(pdev.batch_to_arrow(fetch_batch(b)).column(0), want)
    same_bits(rdev.batch_to_arrow(rdev.batch_to_device(
        tb.to_batches()[0], xp=np)).column(0), back.column(0))


def same_bits(a: pa.Array, b: pa.Array):
    """Equal validity and, under it, the same values (a float's bits, so
    NaN equals NaN and -0.0 differs from 0.0)."""
    assert a.type == b.type and a.is_valid().equals(b.is_valid())
    if pa.types.is_floating(a.type):
        x = a.fill_null(0).to_numpy().view(np.int32)
        y = b.fill_null(0).to_numpy().view(np.int32)
        assert x.tolist() == y.tolist()
    else:
        assert a.to_pylist() == b.to_pylist()


@pytest.mark.parametrize("name", NARROW)
def test_key_words_match_reference(name):
    """The port's words order and group rows as the reference's: the same
    stable order and the same equal neighbours."""
    tb = narrow_table(400, seed=2).select([name])
    rb = tb.to_batches()[0]
    rc = rdev.batch_to_device(rb, xp=np).columns[0]
    pc = pdev.batch_to_device(rb, "cpu").columns[0]
    n = rb.num_rows
    for asc in (True, False):
        rwords = rseg.key_words_for_column(np, rc, np.ones(rc.capacity,
                                                           bool),
                                           for_grouping=False,
                                           ascending=asc)
        pwords = pseg.sort_key_words(pc, asc, True)
        rorder = np.lexsort([w[:n] for w in reversed(rwords)])
        porder = pseg.lexsort([w[:n] for w in pwords]).numpy()
        assert rorder.tolist() == porder.tolist()

        def ties(words, order):
            return [all(w[order[i]] == w[order[i + 1]] for w in words)
                    for i in range(n - 1)]
        assert ties([w[:n] for w in rwords], rorder) == \
            ties([w[:n].numpy() for w in pwords], porder)


@pytest.mark.parametrize("name", NARROW)
def test_murmur3_matches_reference(name):
    tb = narrow_table(300, seed=3).select([name])
    rb = tb.to_batches()[0]
    rc = rdev.batch_to_device(rb, xp=np).columns[0]
    pc = pdev.batch_to_device(rb, "cpu").columns[0]
    seed_r = np.full(rc.capacity, np.uint32(42), np.uint32)
    want = rhash.hash_column(np, rc, seed_r, rc.capacity)
    got = phash.hash_column(pc, torch.full((pc.capacity,), 42,
                                           dtype=torch.int64))
    assert got.numpy().astype(np.uint32).tolist() == \
        want.astype(np.uint32).tolist()


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------

FILTERS = {
    "s_gt": lambda c, l: c("s") > l(-100),
    "f_le": lambda c, l: c("f") <= l(10.0),
    "dt_lt": lambda c, l: c("dt") < l(datetime.date(1975, 6, 1)),
    "ts_ge": lambda c, l: c("ts") >= l(datetime.datetime(1970, 1, 1, 0, 0,
                                                         0, 1)),
    "dec_eq_scale": lambda c, l: c("dec") >= l(__import__(
        "decimal").Decimal("0.500")),
    "b_in": lambda c, l: c("b").isin(1, -1, 127, None),
    "s_and_f": lambda c, l: (c("s") > l(0)) & (c("f") > l(0.0)),
}


@pytest.mark.parametrize("case", sorted(FILTERS))
def test_filter(sessions, case):
    run_both(sessions, narrow_table(), lambda df, F, col, lit:
             df.filter(FILTERS[case](col, lit)), order=True)


def test_project(sessions):
    run_both(sessions, narrow_table(), lambda df, F, col, lit: df.select(
        (col("b") + col("b")).alias("bb"), (col("s") * lit(3)).alias("s3"),
        (col("f") + lit(1.0)).alias("f1"), (-col("b")).alias("nb"),
        (col("dec") + col("dec")).alias("d2"),
        (col("dec") * col("b")).alias("db"),
        (col("dt") == col("dt")).alias("de"), col("ts").is_null()
        .alias("tn"), F.abs(col("s")).alias("as")), order=True)


@pytest.mark.parametrize("partitions", [1, 3])
def test_group_by_byte_date(sessions, partitions):
    tb = narrow_table()
    run_both(sessions, tb, lambda df, F, col, lit: df.group_by(
        col("b"), col("dt")).agg(
        F.sum(col("s")).alias("ss"), F.min(col("s")).alias("mns"),
        F.max(col("s")).alias("mxs"), F.sum(col("f")).alias("sf"),
        F.min(col("f")).alias("mnf"), F.max(col("f")).alias("mxf"),
        F.min(col("ts")).alias("mnt"), F.max(col("ts")).alias("mxt"),
        F.sum(col("dec")).alias("sd"), F.min(col("dec")).alias("mnd"),
        F.max(col("dec")).alias("mxd"), F.count("*").alias("c")),
        partitions=partitions)


@pytest.mark.parametrize("name", NARROW)
def test_group_by_each_type(sessions, name):
    run_both(sessions, narrow_table(), lambda df, F, col, lit: df.group_by(
        col(name)).agg(F.count("*").alias("c"), F.max(col("k"))
                       .alias("m")), partitions=2)


@pytest.mark.parametrize("name", NARROW)
def test_sort_each_type(sessions, name):
    run_both(sessions, narrow_table(), lambda df, F, col, lit: df.sort(
        col(name).desc(), col("k"), col("b"), col("s")), order=True)


def test_sort_ts_desc_float_and_topn(sessions):
    tb = narrow_table()
    for partitions in (1, 4):
        run_both(sessions, tb, lambda df, F, col, lit: df.sort(
            col("ts").desc(), col("f")), partitions=partitions, order=True)
        run_both(sessions, tb, lambda df, F, col, lit: df.sort(
            col("ts").desc(), col("f")).limit(25), partitions=partitions,
            order=True)


def test_union_distinct_sample(sessions):
    tb = narrow_table(300)
    run_both(sessions, tb, lambda df, F, col, lit: df.union(df))
    run_both(sessions, tb.drop_columns(["f"]), lambda df, F, col, lit:
             df.select(col("b"), col("dt"), col("dec")).distinct())
    run_both(sessions, tb, lambda df, F, col, lit: df.sample(0.3, seed=7),
             order=True)


CAST_TYPES = ["tinyint", "smallint", "int", "bigint", "float", "double",
              "boolean", "date", "timestamp", "decimal(9,2)",
              "decimal(20,4)"]
# pairs where the reference's answer departs from Spark's or its cast
# is not defined; the port gives Spark's (double -> integral saturates)
_CAST_SKIP = {("f", "tinyint"), ("f", "smallint"), ("f", "int"),
              ("f", "bigint"), ("f", "timestamp"), ("dt", "tinyint"),
              ("dt", "smallint"), ("dt", "int"), ("dt", "bigint"),
              ("dt", "float"), ("dt", "double"), ("dt", "boolean"),
              ("dt", "decimal(9,2)"), ("dt", "decimal(20,4)"),
              ("b", "date"), ("s", "date"), ("f", "date"), ("dec", "date"),
              ("ts", "decimal(9,2)"), ("ts", "decimal(20,4)"),
              ("dec", "timestamp"), ("f", "decimal(9,2)"),
              ("f", "decimal(20,4)")}


@pytest.mark.parametrize("src", NARROW)
def test_casts_among_flat_types(sessions, src):
    tb = narrow_table(200, seed=5).select([src])
    targets = [d for d in CAST_TYPES if (src, d) not in _CAST_SKIP]
    run_both(sessions, tb, lambda df, F, col, lit: df.select(*[
        col(src).cast(d).alias(f"c{i}") for i, d in enumerate(targets)]),
        order=True)


def test_float_casts_saturate():
    """FLOAT -> integral saturates (Java's toInt), NaN -> 0."""
    tb = pa.table({"f": pa.array([float("nan"), 1e10, -1e10, 300.7, -1.9],
                                 pa.float32())})
    got = GpuSession(device="cpu").create_dataframe(tb).select(
        pcol("f").cast("tinyint").alias("b"),
        pcol("f").cast("int").alias("i")).collect()
    assert got.column("b").to_pylist() == [0, 127, -128, 127, -1]
    assert got.column("i").to_pylist() == [0, 2**31 - 1, -2**31, 300, -1]


def test_mixed_decimal_scale_comparisons(sessions):
    import decimal
    D = decimal.Decimal
    tb = pa.table({
        "a": pa.array([D("1.50"), D("-2.25"), None, D("3.00"), D("0.01")],
                      pa.decimal128(5, 2)),
        "b": pa.array([D("1.500"), D("-2.249"), D("1.000"), None,
                       D("0.010")], pa.decimal128(10, 3)),
        "i": pa.array([1, -2, 3, 3, 0], pa.int16())})
    run_both(sessions, tb, lambda df, F, col, lit: df.select(
        (col("a") == col("b")).alias("eq"), (col("a") < col("b"))
        .alias("lt"), (col("a") >= col("i")).alias("ge"),
        (col("b") > lit(D("0.0105"))).alias("gl"),
        col("a").isin(D("1.5"), 3).alias("inn")), order=True)


@pytest.mark.parametrize("name", ["b", "s", "dt", "ts", "dec", "f"])
def test_join_on_each_type(sessions, name):
    tb = narrow_table(300, seed=9)
    other = tb.select([name, "k"]).rename_columns([name + "2", "k2"])
    run_both(sessions, tb, lambda df, F, col, lit: df.join(
        _frame(df, other),
        col(name) == col(name + "2"), "inner").select(
            col("k"), col("k2"), col(name)))


def _frame(df, table):
    """A DataFrame of ``table`` in the session of ``df``."""
    session = getattr(df, "session", None) or getattr(df, "_session")
    return session.create_dataframe(table)


def test_parquet_round_trip(tmp_path, sessions):
    tb = narrow_table(500, seed=4)
    p = str(tmp_path / "n.parquet")
    papq.write_table(tb, p)
    ref, port = sessions
    want = ref.read.parquet(p).collect()
    got = port.read.parquet(p).collect()
    assert got.schema == want.schema == tb.schema
    assert_tables_equal(want, got, ignore_order=False,
                        approximate_float=FLOAT_RTOL)
    out = str(tmp_path / "w")
    port.read.parquet(p).filter(pcol("dt") > plit(datetime.date(1969, 1, 1))
                                ).write.mode("overwrite").parquet(out)
    back = papq.read_table(out)
    keep = [d is not None and d > datetime.date(1969, 1, 1)
            for d in tb.column("dt").to_pylist()]
    assert back.num_rows == sum(keep)
    assert back.schema.field("dec").type == pa.decimal128(9, 2)


# ---------------------------------------------------------------------------
# windows, the other file formats and the cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NARROW)
def test_window_keys_of_each_type(sessions, name):
    """Partition and order keys of each type: row_number, a running sum
    and a min over the type's own column."""
    def q(df, F, col, lit, W):
        return df.select(
            col("k"), col(name),
            F.row_number().over(W.partition_by(col(name)).order_by(
                col("k"), col("s"), col("b"), col("ts"))).alias("rn"),
            F.sum(col("k")).over(W.partition_by(col("k")).order_by(
                col(name))).alias("rs"),
            F.min(col(name)).over(W.partition_by(col("k")).order_by(
                col("s"), col("b"), col("ts"))).alias("mn"))
    ref, port = sessions
    tb = narrow_table(300, seed=4)
    want = q(ref.create_dataframe(tb, num_partitions=2), RF, rcol, rlit,
             RWindow).collect()
    got = q(port.create_dataframe(tb, num_partitions=2), PF, pcol, plit,
            PWindow).collect()
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)
    assert shape(port) == shape(ref)


@pytest.mark.parametrize("name", ["dt", "dec", "ts", "s"])
def test_bounded_range_frame_over_each_type(sessions, name):
    """RANGE BETWEEN 3 PRECEDING AND 3 FOLLOWING over a DATE, DECIMAL,
    TIMESTAMP and SHORT order key (a decimal's frame runs on the CPU
    engine, as the reference places it)."""
    def q(df, F, col, lit, WB):
        return df.select(col("k"), col(name), F.sum(col("k")).over(
            WB().partition_by(col("k")).order_by(col(name))
            .range_between(-3, 3)).alias("rr"))
    ref, port = sessions
    tb = narrow_table(300, seed=4)
    want = q(ref.create_dataframe(tb), RF, rcol, rlit, RWB).collect()
    got = q(port.create_dataframe(tb), PF, pcol, plit, PWB).collect()
    assert_tables_equal(want, got)
    assert shape(port) == shape(ref)


def test_orc_and_csv_round_trips(tmp_path, sessions):
    import pyarrow.orc as paorc
    ref, port = sessions
    # ORC keeps timestamps in nanoseconds: the edge timestamps stay out
    tb = narrow_table(400, seed=6).drop_columns(["ts"])
    p = str(tmp_path / "n.orc")
    paorc.write_table(tb, p)
    want, got = ref.read.orc(p).collect(), port.read.orc(p).collect()
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=False,
                        approximate_float=FLOAT_RTOL)
    c = str(tmp_path / "n.csv")
    with open(c, "w") as f:
        f.write("k,d,ts,x\n1,2020-01-01,2020-01-01 10:00:00,1.5\n"
                "2,,2021-02-03 00:00:01,2.25\n3,1969-12-31,,\n")
    want, got = ref.read.csv(c).collect(), port.read.csv(c).collect()
    assert got.schema == want.schema
    assert got.to_pydict() == want.to_pydict()
    assert got.schema.field("d").type == pa.date32()


def test_cache_of_the_narrow_types():
    from spark_rapids_tpu_torch.io.cached_batch import CacheManager
    CacheManager.clear()
    tb = narrow_table(500, seed=8)
    port = GpuSession(device="cpu")
    cached = port.create_dataframe(tb, num_partitions=2).cache()
    try:
        for _ in range(2):
            got = cached.collect()
            for name in tb.column_names:
                same_bits(got[name].combine_chunks(),
                          tb[name].combine_chunks())
    finally:
        cached.unpersist()
        CacheManager.clear()

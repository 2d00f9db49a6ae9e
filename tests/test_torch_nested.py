"""BINARY, ARRAY, MAP and STRUCT columns through the port, held against
the reference on the CPU.

Every query runs through the reference's TpuSession (its single-device
exchange fusion forced on, as the port's is whenever it drives one
device) and the port's GpuSession(device="cpu") on the same tables,
made from a numpy seed; results are compared with the reference's
``assert_tables_equal`` (exact but for float sums, to a relative 1e-9),
and every plan's operators, placements and explain lines with their
fallback reasons ("TPU" read as "GPU"; a shuffle exchange whose
consumer stays on the CPU runs on the port's host, ``host_exchanges``).

* The upload and packed-fetch round trip (mirrors
  tests/test_fetch_plan.py::test_fetch_nested_round_trip), slices, a map
  with entries under a null row, a struct child holding a value under a
  null struct row.
* The nested queries of chip_smoke.py at a few hundred orders (TPC-H's
  orders with their lineitems nested inside): qa1 a filter carrying
  every column, qa2 the accessors, qa3 a group-by on a struct, qa4 a
  join carrying an array of structs and a binary, qa5 union and limit,
  a parquet write read back with a pushed filter, the cache; over 1 and
  4 partitions.
* The accessors of tests/test_higher_order.py
  (test_element_at_and_get_item, test_create_array_and_struct_roundtrip,
  test_get_struct_field), murmur3 of binary and struct columns.
* The fallbacks, with the reference's reasons: a sort carrying an
  array, a group-by on a binary key, a join carrying a map with string
  keys, a join on a struct key.
* Pinned differences (ROADMAP Queue 3): the reference's CPU join fails
  in pyarrow on a nested payload where the port's takes the payload by
  row id; a null struct whose children hold values groups apart in the
  reference's device group-by and as one group in the port (and in both
  CPU engines).
* K18's plain version (``span_rows_plain``) against the reference's
  ``gather_spans`` (numpy branch), and TypeSig parity over a grid of
  nested types for every signature the port registers.
"""

import datetime

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from spark_rapids_tpu import types as rt
from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.column import lit as rlit
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar import device as rdev
from spark_rapids_tpu.ops.gather import gather_spans
from spark_rapids_tpu.plan import overrides as roverrides
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch import types as pt
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.column import lit as plit
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar import device as pdev
from spark_rapids_tpu_torch.columnar.fetch import fetch_batch
from spark_rapids_tpu_torch.io.cached_batch import CacheManager
from spark_rapids_tpu_torch.ops import strings as psops
from spark_rapids_tpu_torch.ops.gather import span_rows_plain
from spark_rapids_tpu_torch.plan import overrides as poverrides

REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}
REF = (RF, rcol, rlit)
PORT = (PF, pcol, plit)
FLOAT_RTOL = 1e-9
CUTOFF = datetime.date(1995, 3, 15)
SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                     "MACHINERY"])
TAG_KEYS = np.array(["o_orderpriority", "o_shippriority", "o_clerk"])


def orders(n=240, seed=0, null_rate=0.05):
    """TPC-H's orders with each order's lineitems nested inside it, as
    chip_smoke.py makes them at 7,500,000 orders: 1-7 lines an order;
    the customer's nation and segment as a struct whose children hold
    values under a null struct row; the order's attributes as a map; a
    16-byte binary digest."""
    rng = np.random.default_rng(seed)
    nl = rng.integers(1, 8, n)
    off = np.zeros(n + 1, np.int32)
    np.cumsum(nl, out=off[1:])
    m = int(off[-1])
    line = pa.StructArray.from_arrays([
        pa.array(rng.integers(1, 200_000, m)),
        pa.array(rng.integers(1, 51, m)),
        pa.array(rng.random(m) * 1e5),
        pa.array(rng.integers(0, 11, m) / 100.0,
                 mask=rng.random(m) < null_rate),
        pa.array(rng.integers(8035, 10440, m).astype(np.int32)).cast(
            pa.date32())],
        names=["l_partkey", "l_quantity", "l_extendedprice", "l_discount",
               "l_shipdate"])
    lines = pa.ListArray.from_arrays(
        pa.array(off), line, mask=pa.array(rng.random(n) < null_rate))
    cust = pa.StructArray.from_arrays(
        [pa.array(rng.integers(0, 25, n).astype(np.int32)),
         pa.array(SEGMENTS[rng.integers(0, 5, n)])],
        names=["c_nationkey", "c_mktsegment"],
        mask=pa.array(rng.random(n) < null_rate))
    nt = rng.integers(1, 4, n)
    toff = np.zeros(n + 1, np.int32)
    np.cumsum(nt, out=toff[1:])
    which = np.concatenate([np.arange(k) for k in nt])
    vals = np.where(which == 0, rng.integers(1, 6, len(which)),
                    np.where(which == 1, 0,
                             rng.integers(1, 5001, len(which))))
    tags = pa.MapArray.from_arrays(pa.array(toff), pa.array(TAG_KEYS[which]),
                                   pa.array(vals))
    dig = rng.integers(0, 256, n * 16).astype(np.uint8)
    doff = np.arange(n + 1, dtype=np.int32) * 16
    valid = rng.random(n) >= null_rate
    digest = pa.Array.from_buffers(
        pa.binary(), n, [pa.array(valid).buffers()[1],
                         pa.py_buffer(doff.tobytes()),
                         pa.py_buffer(dig.tobytes())])
    return pa.table({
        "o_orderkey": pa.array(np.arange(1, n + 1, dtype=np.int64) * 4),
        "o_custkey": pa.array(rng.integers(1, 60, n)),
        "o_orderdate": pa.array(rng.integers(8035, 10440, n).astype(
            np.int32)).cast(pa.date32()),
        "o_totalprice": pa.array(rng.random(n) * 1e5),
        "o_cust": cust, "o_lines": lines, "o_tags": tags, "o_digest": digest})


def customers(n=59, seed=1):
    rng = np.random.default_rng(seed)
    return pa.table({"c_custkey": pa.array(np.arange(1, n + 1,
                                                     dtype=np.int64)),
                     "c_acctbal": pa.array(rng.random(n) * 1e4)})


def sessions(conf=None):
    conf = dict(conf or {})
    b = TpuSession.builder()
    for k, v in {**REF_FUSE, **conf}.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(device="cpu", conf=conf)


def shape(session):
    nodes = []
    session.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__.replace("Tpu", "Gpu"),
         e.placement.replace("tpu", "gpu"))))
    return [n for n in nodes
            if n[0] not in ("AQEShuffleReadExec", "_SkewAwareRead")]


def host_exchanges(ref_shape, ref_explain):
    """The reference's plan and explain as the port gives them: a shuffle
    exchange under a CPU consumer runs on the host, below the download,
    and its explain line says why."""
    nodes = list(ref_shape)
    for i in range(len(nodes) - 1):
        if nodes[i:i + 2] == [("DeviceToHostExec", "cpu"),
                              ("ShuffleExchangeExec", "gpu")]:
            nodes[i:i + 2] = [("ShuffleExchangeExec", "cpu"),
                              ("DeviceToHostExec", "cpu")]
    lines = ref_explain.replace("TPU", "GPU").splitlines()
    for i, line in enumerate(lines):
        body = line.lstrip()
        if body != "*Exec <ShuffleExchangeExec> will run on GPU":
            continue
        pad = line[:len(line) - len(body)]
        parent = next(p for p in reversed(lines[:i])
                      if len(p) - len(p.lstrip()) < len(pad))
        if parent.lstrip().startswith("!"):
            consumer = parent.split("<")[1].split(">")[0]
            lines[i] = (f"{pad}!Exec <ShuffleExchangeExec> cannot run on GPU "
                        f"because the shuffle exchange runs on the host only "
                        f"(its consumer {consumer} stays on the CPU)")
    return nodes, "\n".join(lines)


def same_plans(ref, port):
    want_shape, want_explain = host_exchanges(shape(ref), ref.last_explain)
    assert shape(port) == want_shape
    assert port.last_explain == want_explain


def run_both(query, tables, partitions=1, conf=None, check_plans=True,
             ignore_order=True):
    """``query(dfs, F, col, lit)`` through both sessions; results and
    plans must agree.  Returns (reference result, port result, port
    session)."""
    ref, port = sessions(conf)
    out = []
    for s, lib in ((ref, REF), (port, PORT)):
        dfs = [s.create_dataframe(t, num_partitions=partitions if i == 0
                                  else 1) for i, t in enumerate(tables)]
        out.append(query(dfs, *lib).collect())
    want, got = out
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=ignore_order,
                        approximate_float=FLOAT_RTOL)
    if check_plans:
        same_plans(ref, port)
    return want, got, port


def gpu_placed(port, but=("DeviceToHostExec",)):
    nodes = shape(port)
    assert all(p == "gpu" for n, p in nodes if n not in but), nodes
    return nodes


# ---------------------------------------------------------------------------
# upload and fetch
# ---------------------------------------------------------------------------

def round_trip_table(n=500):
    rng = np.random.default_rng(99)
    return pa.table({
        "arr": pa.array([None if i % 7 == 0 else list(range(i % 5))
                         for i in range(n)], type=pa.list_(pa.int64())),
        "m": pa.array([None if i % 11 == 0 else
                       [(f"k{j}", i * j) for j in range(i % 3)]
                       for i in range(n)],
                      type=pa.map_(pa.string(), pa.int64())),
        "st": pa.array([{"a": int(i), "b": None if i % 3 else float(i)}
                        for i in range(n)],
                       type=pa.struct([("a", pa.int64()),
                                       ("b", pa.float64())])),
        "v": pa.array(rng.integers(0, 9, n).astype(np.int64)),
        "bin": pa.array([None if i % 5 == 0 else bytes([i % 256] * (i % 4))
                         for i in range(n)]),
        "ls": pa.array([None if i % 6 == 0 else
                        [{"x": i, "s": "ab"[:j]} for j in range(i % 3)]
                        for i in range(n)]),
        "aa": pa.array([[[j] * j for j in range(i % 3)] for i in range(n)],
                       type=pa.list_(pa.list_(pa.int32()))),
    })


@pytest.mark.parametrize("cut", [(0, 500), (3, 200), (499, 1), (17, 0)])
def test_fetch_nested_round_trip(cut):
    """The port's upload and packed fetch give the reference's download
    of its upload, on slices of the table."""
    rb = round_trip_table().slice(*cut).combine_chunks()
    rb = rb.to_batches()[0] if rb.num_rows else \
        pa.RecordBatch.from_pylist([], schema=rb.schema)
    want = rdev.batch_to_arrow(rdev.batch_to_device(rb, xp=np))
    got = pdev.batch_to_arrow(fetch_batch(pdev.batch_to_device(rb, "cpu")))
    for name in rb.schema.names:
        assert got.column(name).to_pylist() == \
            want.column(name).to_pylist(), name
    assert got.schema == want.schema


def test_fetched_columns_gather_on_the_cpu_engine():
    """A fetched batch (HostColumns, what a CPU operator above a device
    one reads) gathers as the device batch does: its offsets are int32,
    its struct children row-aligned."""
    from spark_rapids_tpu_torch.ops.gather import gather_columns
    rb = round_trip_table(300).combine_chunks().to_batches()[0]
    batch = pdev.batch_to_device(rb, "cpu")
    fetched = fetch_batch(batch)
    idx = torch.from_numpy(np.random.default_rng(4).integers(
        0, 300, 200).astype(np.int32))
    want = pdev.batch_to_arrow(pdev.DeviceBatch(
        gather_columns(batch.columns, idx), 200, batch.names))
    got = pdev.batch_to_arrow(pdev.DeviceBatch(
        gather_columns(fetched.columns, idx), 200, batch.names))
    assert got.equals(want)


def test_upload_layout_matches_reference():
    """Offsets rebased to 0 and padded with the last offset, children at
    their own capacity bucket, as the reference lays them out."""
    rb = round_trip_table(40).slice(5, 30).combine_chunks().to_batches()[0]
    ref = rdev.batch_to_device(rb, xp=np)
    mine = pdev.batch_to_device(rb, "cpu")
    for rc, pc_ in zip(ref.columns, mine.columns):
        if rc.offsets is not None:
            assert pc_.offsets.tolist() == np.asarray(rc.offsets).tolist()
        assert len(pc_.children) == len(rc.children)
        for rk, pk in zip(rc.children, pc_.children):
            assert pk.capacity == rk.capacity


def test_map_entries_under_a_null_row():
    """A null map row that still spans entries (Arrow only recommends
    empty spans) spans none after the upload: the reference's repair."""
    m = pa.MapArray.from_arrays(
        pa.array([0, 2, 3, 5, 5], pa.int32()),
        pa.array(["a", "b", "c", "d", "e"]), pa.array([1, 2, 3, 4, 5]),
        mask=pa.array([False, True, False, False]))
    t = pa.table({"k": pa.array([1, 2, 3, 4]), "m": m})
    col = pdev.batch_to_device(t.to_batches()[0], "cpu").columns[1]
    assert col.offsets[:5].tolist() == [0, 2, 2, 4, 4]
    assert col.children[0].capacity >= 4
    want, got, port = run_both(
        lambda d, F, col, lit: d[0].filter(col("k") > lit(1)), [t])
    assert got.column("m").to_pylist() == [None, [("d", 4), ("e", 5)], []]
    gpu_placed(port)


def test_struct_child_value_under_null_parent():
    """Children hold a value under a null struct row (as Arrow keeps
    them); every download masks them, and a field of a null row is
    null."""
    st = pa.StructArray.from_arrays(
        [pa.array([1, 2, 3]), pa.array(["x", "y", "z"])], names=["a", "b"],
        mask=pa.array([False, True, False]))
    t = pa.table({"k": pa.array([1, 2, 3]), "st": st})
    want, got, port = run_both(lambda d, F, col, lit: d[0].select(
        col("k"), col("st"), col("st").getField("a").alias("a"),
        col("st")["b"].alias("b")), [t])
    assert got.column("st").to_pylist() == [{"a": 1, "b": "x"}, None,
                                            {"a": 3, "b": "z"}]
    assert got.column("a").to_pylist() == [1, None, 3]
    assert got.column("b").to_pylist() == ["x", None, "z"]
    gpu_placed(port)


# ---------------------------------------------------------------------------
# the nested queries (chip_smoke.py's qa1-qa5 at a few hundred orders)
# ---------------------------------------------------------------------------

def qa1(d, F, col, lit):
    return d[0].filter(col("o_orderdate") < lit(CUTOFF))


def qa2(d, F, col, lit):
    return d[0].select(
        col("o_orderkey"),
        F.element_at(col("o_lines"), 1).getField("l_quantity").alias("q1"),
        col("o_lines")[0].alias("l0"),
        col("o_cust").getField("c_mktsegment").alias("seg"),
        F.struct(col("o_orderkey"), col("o_totalprice")).alias("st"),
        F.array(col("o_orderkey"), col("o_custkey")).alias("ar"))


def qa4(d, F, col, lit):
    return d[0].select("o_orderkey", "o_custkey", "o_lines", "o_digest") \
        .join(d[1], on=(col("o_custkey") == col("c_custkey")))


def qa5_union(d, F, col, lit):
    return d[0].filter(col("o_orderdate") < lit(CUTOFF)).union(
        d[0].filter(col("o_orderdate") >= lit(CUTOFF))).limit(150)


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("query", [qa1, qa2, qa4, qa5_union],
                         ids=["qa1", "qa2", "qa4", "qa5_union"])
def test_nested_queries(query, parts):
    want, got, port = run_both(query, [orders(), customers()], parts)
    gpu_placed(port)
    assert got.num_rows > 0


def _struct_oracle(t):
    """pyarrow's group-by on the flattened fields, the null rows apart."""
    flat = pa.table({"n": pc.struct_field(t["o_cust"], 0),
                     "s": pc.struct_field(t["o_cust"], 1),
                     "null": pc.is_null(t["o_cust"]),
                     "p": t["o_totalprice"]})
    res = flat.group_by(["n", "s", "null"]).aggregate([("p", "count"),
                                                       ("p", "sum")])
    return {None if r["null"] else (r["n"], r["s"]): (r["p_count"],
                                                      r["p_sum"])
            for r in res.to_pylist()}


@pytest.mark.parametrize("parts", [1, 4])
def test_qa3_group_by_struct(parts):
    """The null structs of orders() hold values under them: the port's
    device path and both CPU engines make one null group; the
    reference's device path splits it by the hidden values (a pinned
    difference).  On a table whose null structs hold the defaults that
    Arrow gives a None, the two packages agree row for row."""
    t = orders()
    want = _struct_oracle(t)
    for conf in ({}, {"spark.rapids.sql.enabled": False}):
        port = GpuSession(device="cpu", conf=conf)
        got = port.create_dataframe(t, num_partitions=parts).group_by(
            pcol("o_cust")).agg(PF.count("*").alias("c"),
                                PF.sum(pcol("o_totalprice")).alias("s")
                                ).collect()
        rows = {None if r["o_cust"] is None else
                (r["o_cust"]["c_nationkey"], r["o_cust"]["c_mktsegment"]):
                (r["c"], r["s"]) for r in got.to_pylist()}
        assert rows.keys() == want.keys()
        for k, (c, s) in rows.items():
            assert c == want[k][0]
            assert abs(s - want[k][1]) <= FLOAT_RTOL * abs(want[k][1])
        if conf:
            continue
        gpu_placed(port)
    ref, _ = sessions()
    ref_rows = ref.create_dataframe(t, num_partitions=parts).group_by(
        rcol("o_cust")).agg(RF.count("*").alias("c")).collect().num_rows
    assert ref_rows > len(want)
    clean = t.set_column(4, "o_cust", pa.array(t["o_cust"].to_pylist(),
                                               t.schema.field(4).type))
    run_both(lambda d, F, col, lit: d[0].group_by(col("o_cust")).agg(
        F.count("*").alias("c"), F.sum(col("o_totalprice")).alias("s")),
        [clean], parts)


def test_distinct_struct_and_struct_with_flat_key():
    t = orders(200, seed=3)
    clean = t.set_column(4, "o_cust", pa.array(t["o_cust"].to_pylist(),
                                               t.schema.field(4).type))
    _, _, port = run_both(lambda d, F, col, lit: d[0].select(
        "o_cust").distinct(), [clean], 3)
    gpu_placed(port)
    _, _, port = run_both(lambda d, F, col, lit: d[0].group_by(
        col("o_custkey"), col("o_cust")).agg(F.max(col("o_orderkey")).alias(
            "mx"), F.count(col("o_digest")).alias("nd")), [clean], 2)
    gpu_placed(port)
    # a count of an array of structs stays on the CPU, as in the
    # reference (Count's signature takes no nested child)
    _, _, port = run_both(lambda d, F, col, lit: d[0].group_by(
        col("o_custkey")).agg(F.count(col("o_lines")).alias("nl")),
        [clean], 2)
    assert "Count over unsupported input: array child" in port.last_explain


@pytest.mark.parametrize("parts", [1, 4])
def test_qa5_parquet_round_trip(tmp_path, parts):
    """A parquet write of a filtered orders table, read back with a
    filter pushed to the reader (on a flat column; a nested or binary
    column is never pushed), equal to pyarrow's filter of the table.
    The reference reads the same files back equally and with the same
    plan, but without the map column: with it, its read through the
    pushed filter aborts the process inside pyarrow ("Map array keys
    array should have no nulls", a pinned difference)."""
    t = orders(200, seed=5)
    want = t.filter(pc.and_(pc.and_(pc.greater(t["o_orderkey"], 100),
                                     pc.less(t["o_orderkey"], 600)),
                            pc.is_valid(t["o_digest"])))
    paths = []

    def q(d, F, col, lit):
        p = str(tmp_path / f"w{len(paths)}")
        paths.append(p)
        d[0].filter(col("o_orderkey") > lit(100)).write.mode(
            "overwrite").parquet(p)
        return d[0].session.read.parquet(p).filter(
            (col("o_orderkey") < lit(600)) & col("o_digest").is_not_null())
    port = GpuSession(device="cpu")
    got = q([port.create_dataframe(t, num_partitions=parts)], *PORT
            ).collect()
    assert_tables_equal(want, got.cast(want.schema))
    gpu_placed(port)
    _, _, port = run_both(q, [t.drop_columns(["o_tags"])], parts)
    gpu_placed(port)


def test_pushdown_skips_nested_and_binary_columns():
    from spark_rapids_tpu_torch.expr import predicates as P
    from spark_rapids_tpu_torch.expr.core import AttributeReference, Literal
    from spark_rapids_tpu_torch.io.scan import _pushdown_to_arrow
    names = ["k", "b", "l"]
    types = [pt.LONG, pt.BINARY, pt.ArrayType(pt.LONG)]
    filters = [P.IsNotNull(AttributeReference("b")),
               P.IsNotNull(AttributeReference("l")),
               P.GreaterThan(AttributeReference("k"), Literal(3))]
    got = _pushdown_to_arrow(filters, names, types)
    assert str(got) == str(pc.field("k") > 3)


def test_qa5_cache():
    CacheManager.clear()
    t = orders(200, seed=6)

    def q(d, F, col, lit):
        c = d[0].filter(col("o_orderdate") < lit(CUTOFF)).cache()
        c.collect()
        return c
    try:
        _, got, port = run_both(q, [t], 2)
        gpu_placed(port)
        assert any(n == "CachedScanExec" for n, _ in shape(port))
    finally:
        CacheManager.clear()


# ---------------------------------------------------------------------------
# the accessors (tests/test_higher_order.py's)
# ---------------------------------------------------------------------------

def test_element_at_and_get_item():
    t = pa.table({"a": pa.array([[1, 2, 3], [4], [], None, [7, 8]],
                                type=pa.list_(pa.int64()))})
    _, got, port = run_both(lambda d, F, col, lit: d[0].select(
        F.element_at(col("a"), 1).alias("e1"),
        F.element_at(col("a"), -1).alias("em1"),
        F.element_at(col("a"), 5).alias("e5"),
        col("a")[1].alias("g1"), col("a")[-1].alias("gneg")), [t],
        check_plans=True)
    assert got.column("e1").to_pylist() == [1, 4, None, None, 7]
    assert got.column("em1").to_pylist() == [3, 4, None, None, 8]
    assert got.column("g1").to_pylist() == [2, None, None, None, 8]
    gpu_placed(port)


def test_create_array_and_struct_roundtrip():
    t = pa.table({"x": pa.array([1, 2, None, 4]),
                  "y": pa.array([5, None, 7, 8]),
                  "s": pa.array(["a", "bb", None, ""])})
    _, got, port = run_both(lambda d, F, col, lit: d[0].select(
        F.array(col("x"), col("y")).alias("arr"),
        F.struct(col("x"), col("y").alias("why")).alias("st"),
        F.array(col("x"), lit(9)).alias("al"),
        F.struct(col("s"), col("x")).alias("ss")), [t])
    assert got.column("arr").to_pylist() == [[1, 5], [2, None], [None, 7],
                                             [4, 8]]
    gpu_placed(port)
    # array() of strings stays on the CPU engine, with the reference's
    # reason; there the reference's engine fails (its lane blend cannot
    # take spans, a pinned difference) and the port's gives the arrays
    ref, port = sessions()
    outs = []
    for sess, (F, col, lit) in ((ref, REF), (port, PORT)):
        df = sess.create_dataframe(t).select(
            F.array(col("s"), col("s")).alias("sa"))
        try:
            outs.append(df.collect())
        except ValueError as ex:
            outs.append(ex)
    assert isinstance(outs[0], ValueError)
    assert outs[1].column("sa").to_pylist() == [
        ["a", "a"], ["bb", "bb"], [None, None], ["", ""]]
    same_plans(ref, port)
    assert "array() over string/nested elements is not supported on GPU" \
        in port.last_explain


def test_get_struct_field():
    t = pa.table({"s": pa.array(
        [{"a": 1, "b": "x"}, {"a": None, "b": "y"}, None],
        type=pa.struct([("a", pa.int64()), ("b", pa.string())]))})
    _, got, port = run_both(lambda d, F, col, lit: d[0].select(
        col("s").getField("a").alias("a"), col("s")["b"].alias("b"),
        (col("s").getField("a") + lit(1)).alias("a1")), [t])
    assert got.column("a").to_pylist() == [1, None, None]
    assert got.column("b").to_pylist() == ["x", "y", None]
    gpu_placed(port)


def test_nested_accessor_chain():
    """element_at of an array of structs, then a field; an array of
    arrays indexed twice."""
    t = round_trip_table(60)
    _, _, port = run_both(lambda d, F, col, lit: d[0].select(
        F.element_at(col("ls"), 1).getField("x").alias("x1"),
        F.element_at(col("ls"), -1).getField("s").alias("s1"),
        col("aa")[1][0].alias("a10"), col("arr")[2].alias("a2")), [t], 2)
    gpu_placed(port)


def test_murmur3_binary_and_struct():
    t = orders(150, seed=7)
    _, got, port = run_both(lambda d, F, col, lit: d[0].select(
        F.hash(col("o_digest")).alias("h1"),
        F.hash(col("o_cust")).alias("h2"),
        F.hash(col("o_orderkey"), col("o_cust"),
               col("o_digest")).alias("h3")), [t])
    gpu_placed(port)


# ---------------------------------------------------------------------------
# fallbacks and pinned differences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 4])
def test_sort_carrying_array_falls_back(parts):
    _, got, port = run_both(lambda d, F, col, lit: d[0].select(
        "o_orderkey", "o_orderdate", "o_lines").sort(
            col("o_orderdate"), col("o_orderkey")), [orders()], parts,
        ignore_order=False)
    assert ("!Exec <SortExec> cannot run on GPU because output column "
            "o_lines: array<struct<l_partkey:bigint,l_quantity:bigint,"
            "l_extendedprice:double,l_discount:double,l_shipdate:date>> is "
            "not supported") in port.last_explain


@pytest.mark.parametrize("parts", [1, 4])
def test_group_by_binary_falls_back(parts):
    _, got, port = run_both(lambda d, F, col, lit: d[0].group_by(
        col("o_digest")).agg(F.count("*").alias("c")), [orders()], parts)
    assert ("!Exec <CpuHashAggregateExec> cannot run on GPU because output "
            "column o_digest: binary is not supported") in port.last_explain


@pytest.mark.parametrize("parts", [1, 4])
def test_join_carrying_map_falls_back_pinned(parts):
    """A join carrying map<string, bigint> stays on the CPU with the
    reference's reason.  The reference's CPU join then fails in pyarrow
    (a nested non-key field); the port's takes the payload by row id and
    gives Spark's answer (ROADMAP Queue 3)."""
    t, c = orders(), customers()
    ref, port = sessions()

    def q(s, F, col, lit):
        return s.create_dataframe(t, num_partitions=parts).select(
            "o_orderkey", "o_custkey", "o_tags").join(
            s.create_dataframe(c), on=(col("o_custkey") == col("c_custkey")))
    with pytest.raises(pa.ArrowInvalid, match="is not supported in join "
                       "non-key field"):
        q(ref, *REF).collect()
    got = q(port, *PORT).collect()
    assert ("cannot run on GPU because join payload type map<string,bigint> "
            "(varlen nested in varlen) not sized for duplicating gathers") \
        in port.last_explain
    # oracle: the primary key's row for each order, by searchsorted
    keys = c["c_custkey"].to_numpy()
    pos = np.searchsorted(keys, t["o_custkey"].to_numpy())
    hit = (pos < len(keys)) & (keys[np.minimum(pos, len(keys) - 1)] ==
                               t["o_custkey"].to_numpy())
    rows = np.flatnonzero(hit)
    want = pa.table({
        "o_orderkey": t["o_orderkey"].take(rows),
        "o_custkey": t["o_custkey"].take(rows),
        "o_tags": t["o_tags"].take(rows),
        "c_custkey": c["c_custkey"].take(pos[rows]),
        "c_acctbal": c["c_acctbal"].take(pos[rows])})
    assert_tables_equal(want, got.cast(want.schema))


def test_join_on_struct_key_stays_on_cpu():
    """A struct join key stays on the CPU with the reference's reason;
    neither CPU engine matches on it: pyarrow raises in the reference,
    the port raises NotImplementedError naming Queue 1 item 4."""
    t = orders(100)
    ref, port = sessions()
    outcomes = []
    for s, (F, col, lit), err in ((ref, REF, pa.ArrowInvalid),
                                  (port, PORT, NotImplementedError)):
        df = s.create_dataframe(t).select("o_orderkey", "o_cust").join(
            s.create_dataframe(t).select(col("o_cust").alias("c2"),
                                         col("o_custkey")),
            on=(col("o_cust") == col("c2")))
        with pytest.raises(err) as ex:
            df.collect()
        outcomes.append(str(ex.value))
    assert "is not supported in join key field" in outcomes[0]
    assert "Queue 1 item 4" in outcomes[1]
    assert port.last_explain == ref.last_explain.replace("TPU", "GPU")
    assert "join key type struct<c_nationkey:int,c_mktsegment:string> not " \
        "supported" in port.last_explain


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
def test_join_nested_payloads_every_type(how):
    """The hash join carries list<bigint>, struct<bigint,double>, binary
    and list<struct<...>> payloads on the device, both sides.  A full
    join fails in the reference (its null extension asks a flat numpy
    dtype of the array, a pinned difference): there the port is held to
    its own CPU engine, the plan to the reference's."""
    rng = np.random.default_rng(11)
    n = 160
    a = pa.table({
        "k": pa.array(rng.integers(0, 40, n), mask=rng.random(n) < 0.05),
        "arr": pa.array([None if i % 9 == 0 else list(range(i % 4))
                         for i in range(n)], type=pa.list_(pa.int64())),
        "st": pa.array([{"x": i, "y": float(i) / 3} for i in range(n)],
                       type=pa.struct([("x", pa.int64()),
                                       ("y", pa.float64())])),
        "bin": pa.array([bytes([i % 256]) * (i % 5) for i in range(n)])})
    b = pa.table({
        "k2": pa.array(rng.integers(0, 40, 50)),
        "ls": pa.array([[{"p": j, "q": 0.5 * j} for j in range(i % 3)]
                        for i in range(50)])})

    def q(d, F, col, lit):
        return d[0].join(d[1], on=(col("k") == col("k2")), how=how)
    if how != "full":
        _, _, port = run_both(q, [a, b], 2)
        gpu_placed(port)
        return
    ref, port = sessions()
    with pytest.raises(TypeError, match="no flat numpy dtype"):
        q([ref.create_dataframe(a, num_partitions=2),
           ref.create_dataframe(b)], *REF).collect()
    got = q([port.create_dataframe(a, num_partitions=2),
             port.create_dataframe(b)], *PORT).collect()
    same_plans(ref, port)
    gpu_placed(port)
    cpu = GpuSession(device="cpu", conf={"spark.rapids.sql.enabled": False})
    want = q([cpu.create_dataframe(a, num_partitions=2),
              cpu.create_dataframe(b)], *PORT).collect()
    assert_tables_equal(want, got)
    assert got.num_rows > n


@pytest.mark.parametrize("parts", [1, 2])
def test_conditional_left_join_nested_payloads_cpu_engine(parts):
    """A conditional LEFT join carrying list<bigint>, struct, binary and
    list<struct<...>> payloads on the CPU engine (spark.rapids.sql.enabled
    false): the port's re-join takes the payloads by row id, as its plain
    join does, and equals the reference's device answer; the reference's
    CPU engine fails in pyarrow (a pinned difference)."""
    rng = np.random.default_rng(11)
    n = 160
    a = pa.table({
        "k": pa.array(rng.integers(0, 40, n), mask=rng.random(n) < 0.05),
        "arr": pa.array([None if i % 9 == 0 else list(range(i % 4))
                         for i in range(n)], type=pa.list_(pa.int64())),
        "st": pa.array([{"x": i, "y": float(i) / 3} for i in range(n)],
                       type=pa.struct([("x", pa.int64()),
                                       ("y", pa.float64())])),
        "bin": pa.array([bytes([i % 256]) * (i % 5) for i in range(n)])})
    b = pa.table({
        "k2": pa.array(rng.integers(0, 40, 50)),
        "w": pa.array(rng.integers(0, 9, 50)),
        "ls": pa.array([[{"p": j, "q": 0.5 * j} for j in range(i % 3)]
                        for i in range(50)])})

    def q(s, F, col, lit):
        return s.create_dataframe(a, num_partitions=parts).join(
            s.create_dataframe(b),
            on=(col("k") == col("k2")) & (col("w") > lit(3)), how="left")
    ref, _ = sessions()
    want = q(ref, *REF).collect()
    ref_cpu, port_cpu = sessions({"spark.rapids.sql.enabled": False})
    with pytest.raises(pa.ArrowInvalid, match="is not supported in join "
                       "non-key field"):
        q(ref_cpu, *REF).collect()
    got = q(port_cpu, *PORT).collect()
    assert ("CpuJoinExec", "cpu") in shape(port_cpu)
    assert got.schema == want.schema
    assert_tables_equal(want, got, approximate_float=FLOAT_RTOL)
    assert got.num_rows >= n


# ---------------------------------------------------------------------------
# K18's plain version, TypeSig parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_span_rows_plain_matches_gather_spans(seed):
    """``gather_offsets`` and ``span_rows_plain`` give the reference's
    ``gather_spans`` (numpy branch): the new offsets, and each in-range
    child slot's source row; the port's slots past the total are 0."""
    rng = np.random.default_rng(seed)
    rows = [0, 1, 5, 300][seed % 4]
    lens = rng.integers(0, 6, rows) * (rng.random(rows) < 0.7)
    offs = np.zeros(rows + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    n = [0, 3, 40, 500][seed // 2 % 4]
    idx = rng.integers(0, max(rows, 1), n).astype(np.int32)
    valid = rng.random(n) < 0.8 if rows else np.zeros(n, bool)
    offsets = torch.from_numpy(offs)
    new_offs, total, starts = psops.gather_offsets(
        offsets, torch.from_numpy(idx), torch.from_numpy(valid))
    total = int(total)
    cap = total + 7
    got = span_rows_plain(starts, new_offs, total, cap)
    assert got.shape == (cap,) and got[total:].eq(0).all()
    if n == 0 or rows == 0:
        assert total == 0
        return
    want_offs, want_src, in_range = gather_spans(np, offs, idx, valid, cap)
    assert new_offs.tolist() == np.asarray(want_offs).tolist()
    assert int(np.asarray(in_range).sum()) == total
    assert got[:total].tolist() == np.asarray(want_src)[:total].tolist()


SKEWED_SPANS = {
    # one row over several of K18's merge tiles (2,048 items), beside
    # rows of one
    "one row over many tiles": (np.r_[[9000], np.ones(3000, np.int64)],
                                None, 0),
    "10^6 empty rows": (np.r_[[1], np.zeros(1_000_000, np.int64), [1]],
                        None, 0),
    "all rows empty": (np.zeros(5000, np.int64), None, 0),
    "total 0": (np.full(300, 4), np.zeros(300, bool), 0),
    # 2,048 rows of 2: 6,144 merge items, three whole tiles
    "total a multiple of the tile": (np.full(2048, 2), None, 0),
    "a zero tail past the total": (np.full(1000, 3), None, 1 << 14),
}


@pytest.mark.parametrize("shape", sorted(SKEWED_SPANS))
def test_span_rows_plain_skewed_shapes_match_gather_spans(shape):
    """K18's plain version on the shapes that load-balance its merge-path
    tiles (a span over many tiles, runs of empty rows, no slot at all, a
    total filling whole tiles, a zero tail) against the reference's
    ``gather_spans`` (numpy branch): each in-range child slot's source
    row, and 0 on every slot past the total."""
    lens, valid, tail = SKEWED_SPANS[shape]
    lens = np.asarray(lens, np.int64)
    rows = len(lens)
    offs = np.zeros(rows + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    idx = np.arange(rows, dtype=np.int32)
    valid = np.ones(rows, bool) if valid is None else valid
    new_offs, total, starts = psops.gather_offsets(
        torch.from_numpy(offs), torch.from_numpy(idx),
        torch.from_numpy(valid))
    total = int(total)
    cap = max(total, 1) + tail
    got = span_rows_plain(starts, new_offs, total, cap)
    assert got.shape == (cap,) and got[total:].eq(0).all()
    want_offs, want_src, in_range = gather_spans(np, offs, idx, valid, cap)
    assert new_offs.tolist() == np.asarray(want_offs).tolist()
    assert int(np.asarray(in_range).sum()) == total
    assert got[:total].tolist() == np.asarray(want_src)[:total].tolist()


def _type_grid(lib):
    return [
        lib.BINARY, lib.ArrayType(lib.INT), lib.ArrayType(lib.STRING),
        lib.ArrayType(lib.ArrayType(lib.LONG)),
        lib.MapType(lib.STRING, lib.LONG),
        lib.MapType(lib.INT, lib.StructType([
            lib.StructField("a", lib.INT), lib.StructField("b", lib.DOUBLE)])),
        lib.StructType([lib.StructField("a", lib.INT),
                        lib.StructField("b", lib.STRING)]),
        lib.StructType([lib.StructField("a", lib.ArrayType(lib.INT))]),
        lib.ArrayType(lib.DecimalType(30, 2)),
        lib.StructType([lib.StructField("d", lib.DecimalType(9, 2)),
                        lib.StructField("b", lib.BINARY)])]


def _signatures(mod):
    sigs = {("expr", c.__name__): r.sig for c, r in mod.EXPR_RULES.items()}
    sigs.update({("exec", c.__name__): s for c, s in mod.EXEC_SIGS.items()})
    return sigs


def test_typesig_parity_for_nested_types():
    """For every exec and expression signature the port registers,
    ``is_supported`` and ``reasons_not_supported`` over the grid of
    nested and binary types equal the reference's."""
    mine, theirs = _signatures(poverrides), _signatures(roverrides)
    assert set(mine) <= set(theirs)
    for key, sig in sorted(mine.items()):
        for pdt, rdt in zip(_type_grid(pt), _type_grid(rt)):
            assert pdt.name == rdt.name
            assert sig.is_supported(pdt) == theirs[key].is_supported(rdt), \
                (key, pdt)
            assert sig.reasons_not_supported(pdt) == \
                theirs[key].reasons_not_supported(rdt), (key, pdt)


@pytest.mark.parametrize("name", [
    "binary", "array<int>", "map<string,bigint>",
    "struct<a:int,b:array<string>>", "array<map<int,struct<x:double>>>"])
def test_parse_nested_type_names(name):
    dt = pt.from_name(name)
    assert dt.name == name
    from spark_rapids_tpu_torch.columnar.interop import (from_arrow_type,
                                                         to_arrow_type)
    assert from_arrow_type(to_arrow_type(dt)) == dt


@pytest.mark.parametrize("asc", [True, False])
def test_sort_by_struct_key_on_cpu_engine(asc):
    """A sort by a struct key stays on the CPU (the sort's signature takes
    no struct), where the port orders by the children in turn, as the
    reference's engine does."""
    t = pa.table({"s": pa.array(
        [{"a": 2, "b": "x"}, {"a": 1, "b": "z"}, None, {"a": 1, "b": "y"},
         {"a": None, "b": "w"}],
        type=pa.struct([("a", pa.int64()), ("b", pa.string())])),
        "v": pa.array([1, 2, 3, 4, 5])})
    _, got, port = run_both(lambda d, F, col, lit: d[0].sort(
        col("s") if asc else col("s").desc(), col("v")), [t],
        ignore_order=False)
    assert "!Exec <SortExec> cannot run on GPU" in port.last_explain


def test_orc_round_trip_nested(tmp_path):
    """An ORC write and read of every nested and binary column, with a
    filter pushed to the reader, through both packages."""
    t = orders(120, seed=8)
    written = []

    def q(d, F, col, lit):
        p = str(tmp_path / f"o{len(written)}")
        written.append(p)
        d[0].write.mode("overwrite").orc(p)
        return d[0].session.read.orc(p).filter(col("o_orderkey") > lit(40))
    _, got, port = run_both(q, [t])
    assert got.num_rows == 110
    gpu_placed(port)

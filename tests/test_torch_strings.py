"""STRING columns through the port's sessions, held against the
reference's, on the CPU.

* The reference's own string tests, each query run through
  ``GpuSession(device="cpu")`` (the GPU-placed plan on CPU tensors, so
  every kernel's plain version) and ``TpuSession``:
  test_group_by_string_keys, test_group_by_min_max_strings,
  test_global_min_max_strings (tests/test_hash_aggregate.py),
  test_equi_join_string_keys for every join type the port has
  (tests/test_join.py), test_sort_strings row for row
  (tests/test_sort.py), test_filter_string_predicates
  (tests/test_basic_ops.py) and test_multi_partition_string_group
  (tests/test_shuffle.py); each port plan must be GPU-placed but for its
  DeviceToHostExec.
* Upload and fetch round trips: sliced arrays, all-null columns, 0 rows.
* Paths: parquet, ORC and CSV scans and writes, a window partitioned and
  ordered by strings with lead/lag of a string, F.hash, the CPU engine.
* Pinned behaviour: the approximate order past 32 bytes of shared
  prefix, and a CASE WHEN and a COALESCE yielding a string, on the GPU.
"""

import numpy as np
import pyarrow as pa
import pyarrow.orc as paorc
import pyarrow.parquet as papq
import pytest

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol
from spark_rapids_tpu.api.column import lit as rlit
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu.testing.data_gen import (IntegerGen, LongGen,
                                               StringGen, gen_table)
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol
from spark_rapids_tpu_torch.api.column import lit as plit
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar import device as pdev
from spark_rapids_tpu_torch.columnar.fetch import fetch_batch
from spark_rapids_tpu_torch.expr.window import Window

REF_FUSE = {"spark.rapids.tpu.singleChipFuse": "on"}


def sessions(enabled=True):
    b = TpuSession.builder()
    for k, v in {**REF_FUSE, "spark.rapids.sql.enabled": enabled}.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(
        device="cpu", conf={"spark.rapids.sql.enabled": enabled})


def run_both(tables, query, partitions=1, ignore_order=True,
             enabled=True):
    """``query(dfs, F, col, lit)`` through both sessions over the same
    Arrow tables; the results must agree.  Returns the port's session."""
    ref, port = sessions(enabled)
    parts = partitions if isinstance(partitions, (list, tuple)) else \
        [partitions] * len(tables)
    want = query([ref.create_dataframe(t, num_partitions=p)
                  for t, p in zip(tables, parts)], RF, rcol, rlit).collect()
    got = query([port.create_dataframe(t, num_partitions=p)
                 for t, p in zip(tables, parts)], PF, pcol, plit).collect()
    assert got.schema == want.schema
    assert_tables_equal(want, got, ignore_order=ignore_order)
    return port


def gpu_placed(port):
    """Every operator of the port's last plan but the download is on the
    GPU."""
    nodes = []
    port.last_plan.foreach(lambda e: nodes.append(
        (type(e).__name__, e.placement)))
    assert all(p == "gpu" for n, p in nodes if n != "DeviceToHostExec"), \
        nodes
    return nodes


# ---------------------------------------------------------------------------
# the reference's own string tests
# ---------------------------------------------------------------------------

def test_group_by_string_keys():
    t = gen_table([("k", StringGen(max_len=8)), ("v", LongGen())], 1024)
    port = run_both([t], lambda d, F, col, lit: d[0].group_by(col("k")).agg(
        F.sum(col("v")).alias("s"), F.count("*").alias("c")))
    gpu_placed(port)


def test_group_by_min_max_strings():
    t = gen_table([("k", IntegerGen(nullable=False)), ("s", StringGen())],
                  512)
    port = run_both([t], lambda d, F, col, lit: d[0].group_by(col("k")).agg(
        F.min(col("s")).alias("mn"), F.max(col("s")).alias("mx"),
        F.count(col("s")).alias("c")))
    gpu_placed(port)


def test_global_min_max_strings():
    t = gen_table([("s", StringGen())], 256)
    port = run_both([t], lambda d, F, col, lit: d[0].agg(
        F.min(col("s")).alias("mn"), F.max(col("s")).alias("mx")))
    gpu_placed(port)


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
def test_equi_join_string_keys(how):
    a = gen_table([("k", StringGen(max_len=4)), ("va", LongGen())], 256, 1)
    b = gen_table([("k2", StringGen(max_len=4)), ("vb", LongGen())], 128, 2)
    port = run_both([a, b], lambda d, F, col, lit: d[0].join(
        d[1], on=(col("k") == col("k2")), how=how))
    gpu_placed(port)


@pytest.mark.parametrize("how", ["inner", "left", "full"])
def test_string_join_payloads(how):
    """String payloads on both sides, with nulls, a multi-byte value and
    a string key with duplicates on the build side, over two probe
    partitions."""
    a = gen_table([("k", StringGen(max_len=3)), ("pa", StringGen()),
                   ("va", LongGen())], 300, 3)
    b = gen_table([("k2", StringGen(max_len=3)), ("pb", StringGen())],
                  150, 4)
    run_both([a, b], lambda d, F, col, lit: d[0].join(
        d[1], on=(col("k") == col("k2")), how=how), partitions=[2, 1])


def test_sort_strings():
    t = gen_table([("s", StringGen(max_len=10)), ("x", IntegerGen())], 512)
    port = run_both([t], lambda d, F, col, lit: d[0].order_by(
        col("s"), col("x")), ignore_order=False)
    gpu_placed(port)


def test_sort_strings_desc_multi_partition_with_payload():
    t = gen_table([("s", StringGen(max_len=6)), ("x", IntegerGen()),
                   ("p", StringGen())], 700, 5)
    run_both([t], lambda d, F, col, lit: d[0].order_by(
        col("s").desc(), col("x")), partitions=4, ignore_order=False)
    run_both([t], lambda d, F, col, lit: d[0].order_by(
        col("s"), col("x")).limit(37), ignore_order=False)


def test_filter_string_predicates():
    t = gen_table([("s", StringGen(max_len=6)), ("v", LongGen())], 1024)
    port = run_both([t], lambda d, F, col, lit: d[0].filter(
        col("s") > lit("m")).select("s", "v"))
    gpu_placed(port)


@pytest.mark.parametrize("pred", ["eq", "ne", "lt", "le", "ge", "eqns",
                                  "in", "isnull", "colcol"])
def test_string_comparisons(pred):
    t = gen_table([("s", StringGen(max_len=3, alphabet="abm")),
                   ("u", StringGen(max_len=3, alphabet="abm")),
                   ("v", LongGen())], 600, 6)
    preds = {
        "eq": lambda col, lit: col("s") == lit("ab"),
        "ne": lambda col, lit: col("s") != lit("ab"),
        "lt": lambda col, lit: col("s") < lit("b"),
        "le": lambda col, lit: lit("b") <= col("s"),
        "ge": lambda col, lit: col("s") >= col("u"),
        "eqns": lambda col, lit: col("s").eq_null_safe(col("u")),
        "in": lambda col, lit: col("s").isin("a", "mb", ""),
        "isnull": lambda col, lit: col("s").is_null(),
        "colcol": lambda col, lit: col("s") == col("u"),
    }
    port = run_both([t], lambda d, F, col, lit: d[0].filter(
        preds[pred](col, lit)))
    gpu_placed(port)


def test_multi_partition_string_group():
    t = gen_table([("k", StringGen(max_len=5)), ("v", LongGen())], 1024)
    port = run_both([t], lambda d, F, col, lit: d[0].group_by(col("k")).agg(
        F.count("*").alias("c")), partitions=3)
    gpu_placed(port)


def test_many_batches_string_group_merge():
    """String keys and string min/max through the cross-batch merge (the
    canonical keyed merge over concatenated partials)."""
    t = gen_table([("k", StringGen(max_len=2, alphabet="ab")),
                   ("s", StringGen(max_len=5)), ("v", LongGen())], 900, 7)
    run_both([t], lambda d, F, col, lit: d[0].group_by(col("k")).agg(
        F.min(col("s")).alias("mn"), F.max(col("s")).alias("mx"),
        F.sum(col("v")).alias("sv")), partitions=5)


@pytest.mark.parametrize("mode", ["complete", "partial_final"])
def test_string_aggregate_across_batches(mode):
    """String keys and string MIN/MAX through the cross-batch merge: the
    partial buffers of 9 input batches concatenated, put in the
    canonical order and reduced again (exec level, so every batch
    reaches the aggregate), against pyarrow's group_by."""
    from spark_rapids_tpu_torch.exec.aggregate import GpuHashAggregateExec
    from spark_rapids_tpu_torch.exec.base import ExecContext
    from spark_rapids_tpu_torch.exec.basic import LocalScanExec
    from spark_rapids_tpu_torch.expr import aggregates as ag
    from spark_rapids_tpu_torch.expr.core import AttributeReference as A
    t = gen_table([("k", StringGen(max_len=2, alphabet="abc")),
                   ("s", StringGen(max_len=12)), ("v", LongGen())], 900, 18)
    aggs = [ag.AggregateExpression(ag.Min(A("s")), "mn"),
            ag.AggregateExpression(ag.Max(A("s")), "mx"),
            ag.AggregateExpression(ag.Count(A("s")), "n")]
    scan = LocalScanExec(t, batch_rows=100)
    if mode == "complete":
        plan = GpuHashAggregateExec([A("k")], aggs, ag.COMPLETE, scan)
    else:
        part = GpuHashAggregateExec([A("k")], aggs, ag.PARTIAL, scan)
        plan = GpuHashAggregateExec(
            [A("k")], [ag.bind_aggregate(a, scan.output_names,
                                         scan.output_types)
                       for a in aggs], ag.FINAL, part)
    got = plan.execute_collect(ExecContext("cpu")).sort_by("k")
    want = t.group_by("k").aggregate([("s", "min"), ("s", "max"),
                                      ("s", "count")]).sort_by("k")
    assert got["k"].to_pylist() == want["k"].to_pylist()
    assert got["mn"].to_pylist() == want["s_min"].to_pylist()
    assert got["mx"].to_pylist() == want["s_max"].to_pylist()
    assert got["n"].to_pylist() == want["s_count"].to_pylist()


def test_cpu_engine_strings():
    """Both engines with acceleration off: pyarrow's group_by, join and
    sort over strings."""
    a = gen_table([("k", StringGen(max_len=3)), ("v", LongGen())], 200, 8)
    b = gen_table([("k2", StringGen(max_len=3)), ("w", LongGen())], 90, 9)
    run_both([a, b], lambda d, F, col, lit: d[0].join(
        d[1], on=col("k") == col("k2")).group_by(col("k")).agg(
        F.sum(col("w")).alias("s"), F.max(col("k2")).alias("m")),
        enabled=False)


# ---------------------------------------------------------------------------
# upload and fetch round trips
# ---------------------------------------------------------------------------

ROUND_TRIPS = {
    "plain": pa.array(["a", None, "", "é中\U0001F600", "x" * 100]),
    "sliced": pa.array(["q", "rr", None, "ssss", "t", "u" * 40]).slice(1, 4),
    "large_sliced": pa.array(["q", "rr", None, "ssss"],
                             pa.large_string()).slice(2),
    "all_null": pa.array([None] * 20, pa.string()),
    "zero_rows": pa.array([], pa.string()),
    "long": pa.array(["z" * 300_000, "y", None]),
}


@pytest.mark.parametrize("case", sorted(ROUND_TRIPS))
def test_upload_fetch_round_trip(case):
    arr = ROUND_TRIPS[case]
    rb = pa.RecordBatch.from_arrays(
        [arr, pa.array(np.arange(len(arr)), pa.int64())], ["s", "i"])
    batch = pdev.batch_to_device(rb, "cpu")
    want = pa.RecordBatch.from_arrays(
        [arr.cast(pa.large_string()), rb.column(1)], ["s", "i"])
    assert pdev.batch_to_arrow(batch).equals(want)
    fetched = pdev.batch_to_arrow(fetch_batch(batch))
    assert fetched.equals(want)
    got = GpuSession(device="cpu").create_dataframe(pa.table(rb)).collect()
    assert got.combine_chunks().to_batches()[0].equals(want) \
        if len(arr) else got.num_rows == 0


# ---------------------------------------------------------------------------
# paths: file IO, window, hash
# ---------------------------------------------------------------------------

def string_table(seed=10, n=400):
    return gen_table([("s", StringGen(max_len=6)), ("c", StringGen()),
                      ("v", LongGen())], n, seed)


@pytest.mark.parametrize("fmt", ["parquet", "orc", "csv"])
def test_file_scan_and_write_strings(fmt, tmp_path):
    t = string_table()
    path = str(tmp_path / f"t.{fmt}")
    if fmt == "parquet":
        papq.write_table(t, path)
    elif fmt == "orc":
        paorc.write_table(t, path)
    else:
        import pyarrow.csv as pacsv
        # CSV cannot tell a null from an empty string: write no nulls
        t = t.drop_null()
        pacsv.write_csv(t, path)
    s = GpuSession(device="cpu")
    reader = getattr(s.read, fmt)
    df = reader(path, header=True) if fmt == "csv" else reader(path)
    got = df.filter(pcol("s") != plit("a")).collect()
    want = t.filter(pa.compute.not_equal(t["s"], "a"))
    assert_tables_equal(want.cast(got.schema), got)
    out = str(tmp_path / "out")
    df.write.mode("overwrite").parquet(out)
    back = s.read.parquet(out).collect()
    assert_tables_equal(t.cast(back.schema), back)


def test_window_over_strings():
    t = gen_table([("p", StringGen(max_len=2, alphabet="ab")),
                   ("o", StringGen(max_len=4)), ("v", LongGen()),
                   ("c", StringGen(max_len=7))], 500, 11)

    def q(d, F, col, lit):
        if F is RF:
            from spark_rapids_tpu.expr.window import Window as W
        else:
            W = Window
        # the reference's RANGE frame reads a string order key's chars as
        # its values, so the running sum orders by a number
        w = W.partition_by(col("p")).order_by(col("o"), col("v"))
        wv = W.partition_by(col("p")).order_by(col("v"))
        return d[0].select(
            col("p"), col("o"), col("v"), col("c"),
            F.row_number().over(w).alias("rn"),
            F.rank().over(w).alias("rk"),
            F.dense_rank().over(w).alias("dr"),
            F.sum(col("v")).over(wv).alias("rs"),
            F.lead(col("c"), 1).over(w).alias("ld"),
            F.lag(col("o"), 2).over(w).alias("lg"))
    port = run_both([t], q, partitions=3)
    gpu_placed(port)


def test_hash_of_strings():
    t = gen_table([("s", StringGen()), ("k", IntegerGen())], 300, 12)
    port = run_both([t], lambda d, F, col, lit: d[0].select(
        F.hash(col("s"), col("k")).alias("h"), F.hash(col("s")).alias("h1")),
        ignore_order=False)
    gpu_placed(port)


def test_hash_partitioning_over_string_keys():
    """The host exchange routes every row by murmur3 of its string key as
    the reference does (the plain K15)."""
    from spark_rapids_tpu.shuffle import partitioning as rpart
    from spark_rapids_tpu.columnar import device as rdev
    from spark_rapids_tpu.expr.core import EvalContext as REval
    from spark_rapids_tpu.expr.core import AttributeReference as RAttr
    from spark_rapids_tpu_torch.shuffle import partitioning as ppart
    from spark_rapids_tpu_torch.expr.core import EvalContext as PEval
    from spark_rapids_tpu_torch.expr.core import AttributeReference as PAttr
    t = gen_table([("s", StringGen()), ("v", LongGen())], 333, 13)
    rb = t.combine_chunks().to_batches()[0]
    names, cap = ["s", "v"], 1024
    from spark_rapids_tpu import types as rt
    rbatch = rdev.batch_to_device(rb, capacity=cap, xp=np)
    rp = rpart.HashPartitioning([RAttr("s")], 7).bind(
        names, [rt.STRING, rt.LONG])
    want = np.asarray(rp.partition_ids(np, REval(np, rbatch), rbatch))
    pbatch = pdev.batch_to_device(rb, "cpu", capacity=cap)
    pp = ppart.HashPartitioning([PAttr("s")], 7).bind(
        names, [pdev.t.STRING, pdev.t.LONG])
    got = pp.partition_ids(PEval(pbatch), pbatch).numpy()
    assert np.array_equal(want[:rb.num_rows], got[:rb.num_rows])


@pytest.mark.parametrize("parts", [1, 4])
def test_host_assisted_collect_with_strings(parts):
    """The host-assisted collect fetches only the row id and takes the
    string columns on the host: equal to the direct collect and to the
    reference's assisted collect, row for row."""
    t = gen_table([("s", StringGen(max_len=5)), ("v", LongGen()),
                   ("c", StringGen())], 1 << 16, 16)
    key = "spark.rapids.sql.collect.hostAssisted"
    got = GpuSession(device="cpu", conf={key: True}).create_dataframe(
        t, num_partitions=parts).sort(pcol("s"), pcol("v")).collect()
    want = GpuSession(device="cpu", conf={key: False}).create_dataframe(
        t, num_partitions=parts).sort(pcol("s"), pcol("v")).collect()
    assert got.equals(want)
    r = TpuSession.builder().config(key, True).get_or_create()
    assert_tables_equal(r.create_dataframe(t, num_partitions=parts).sort(
        rcol("s"), rcol("v")).collect(), got, ignore_order=False)


def test_host_assisted_write_with_strings(tmp_path):
    t = gen_table([("s", StringGen(max_len=5)), ("v", LongGen()),
                   ("c", StringGen())], 5000, 17)
    key = "spark.rapids.sql.write.hostAssisted"
    outs = []
    for assisted in (True, False):
        out = str(tmp_path / f"w{assisted}")
        GpuSession(device="cpu", conf={key: assisted}).create_dataframe(
            t).filter(pcol("v") > 0).select(pcol("s"), pcol("c")).write \
            .mode("overwrite").parquet(out)
        outs.append(papq.read_table(out))
    assert outs[0].equals(outs[1])
    want = t.filter(pa.compute.greater(t["v"], 0)).select(["s", "c"])
    assert_tables_equal(want.cast(outs[0].schema), outs[0],
                        ignore_order=False)


# ---------------------------------------------------------------------------
# pinned behaviour
# ---------------------------------------------------------------------------

def test_order_past_32_bytes_is_approximate():
    """Strings sharing more than 32 bytes of prefix order by length only,
    as in the reference: 'p'*40+'b' ties with 'p'*40+'a' (a stable sort
    keeps input order, so 'b' stays first), and both packages agree."""
    pre = "p" * 40
    t = pa.table({"s": [pre + "b", pre + "a", pre[:35], "a"],
                  "x": pa.array([1, 2, 3, 4], pa.int32())})
    port = run_both([t], lambda d, F, col, lit: d[0].order_by(col("s")),
                    ignore_order=False)
    got = port.create_dataframe(t).order_by(pcol("s")).collect()
    assert got["s"].to_pylist() == ["a", pre[:35], pre + "b", pre + "a"]


def test_case_when_string_runs_on_cpu_with_reason():
    t = gen_table([("s", StringGen(max_len=4)), ("v", IntegerGen())], 200,
                  14)

    def q(d, F, col, lit):
        return d[0].select(
            F.when(col("v") > 0, col("s")).when(col("v") < -5, lit("neg"))
            .otherwise(lit("z")).alias("cw"),
            F.coalesce(col("s"), lit("d")).alias("co"))
    # string branches run on the GPU since the string functions' slice
    # (the name is kept from when the plan kept them on the CPU engine)
    port = run_both([t], q, ignore_order=False)
    gpu_placed(port)
    assert "produces unsupported type" not in port.last_explain


def test_string_literal_operands_and_null_literal():
    t = gen_table([("s", StringGen(max_len=3, alphabet="kq")),
                   ("v", LongGen())], 64, 15)
    run_both([t], lambda d, F, col, lit: d[0].filter(
        (lit("k") == col("s")) | (lit("q") < col("s"))).select(
        col("s"), (col("s") == lit(None)).alias("n")), ignore_order=False)
    # a string literal as a column (the reference's engine refuses to
    # select one): the port broadcasts it, and collects it
    got = GpuSession(device="cpu").create_dataframe(t).select(
        plit("k").alias("k"), pcol("v")).collect()
    assert got["k"].to_pylist() == ["k"] * t.num_rows


def test_strings_through_the_kernel_wrappers_on_cpu_only():
    """No launch is counted on the CPU: every wrapper took its plain
    version."""
    from spark_rapids_tpu_torch.expr import hashfns as ph
    from spark_rapids_tpu_torch.ops import strings as so
    before = (so.string_hashes.launches, so.order_keys.launches,
              so.gather_strings.launches, ph.hash_bytes.launches)
    test_group_by_min_max_strings()
    test_hash_of_strings()
    assert (so.string_hashes.launches, so.order_keys.launches,
            so.gather_strings.launches, ph.hash_bytes.launches) == before

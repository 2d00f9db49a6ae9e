"""The DataFrame surface of the port against the reference's, on the CPU:
range, union, distinct, drop, with_column_renamed, repartition, sample,
count, dtypes, to_pandas and GroupedData's count / sum / avg / min / max.

Each query runs through the reference's TpuSession (its single-device
exchange fusion forced on, as in tests/test_torch_overrides.py) and the
port's GpuSession(device="cpu") on the same tables, made from a numpy
seed, and the results are compared with the reference's
``assert_tables_equal`` (floats to a relative 1e-9).  The reference's
round-robin repartition fails on its device path (its jitted map side
converts the traced row offset with ``np.int32``), so round robin is
held against the reference's CPU engine.  Also here: the sample's keep
mask against the reference's numpy branch bit for bit, RangeExec's
edges, K3's plain version with an empty op set against the reference's
``_group_reduce``, and the new operators' placements.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.api import functions as RF
from spark_rapids_tpu.api.column import col as rcol, lit as rlit
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar import device as rdev
from spark_rapids_tpu.exec import aggregate as ragg
from spark_rapids_tpu.exec import basic as rbasic
from spark_rapids_tpu.expr.core import EvalContext as REval
from spark_rapids_tpu.shuffle import partitioning as rpart
from spark_rapids_tpu.testing.asserts import assert_tables_equal
from spark_rapids_tpu_torch.api import functions as PF
from spark_rapids_tpu_torch.api.column import col as pcol, lit as plit
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar import device as pdev
from spark_rapids_tpu_torch.exec import aggregate as pagg
from spark_rapids_tpu_torch.exec import basic as pbasic
from spark_rapids_tpu_torch.exec.base import CPU, GPU, ExecContext
from spark_rapids_tpu_torch.expr import aggregates as paggs
from spark_rapids_tpu_torch.expr.core import AttributeReference as PA
from spark_rapids_tpu_torch.expr.core import EvalContext as PEval
from spark_rapids_tpu_torch.ops import carry as pcarry
from spark_rapids_tpu_torch.shuffle import partitioning as ppart

FLOAT_RTOL = 1e-9
REF = (RF, rcol, rlit)
PORT = (PF, pcol, plit)


def sessions(conf=None, ref_conf=None):
    b = TpuSession.builder().config("spark.rapids.tpu.singleChipFuse", "on")
    for k, v in {**(conf or {}), **(ref_conf or {})}.items():
        b = b.config(k, v)
    return b.get_or_create(), GpuSession(device="cpu", conf=conf)


def both(query, conf=None, ref_conf=None, ignore_order=True):
    """The reference's and the port's results of ``query(session, F, col,
    lit)``; they must be equal."""
    ref, port = sessions(conf, ref_conf)
    want = query(ref, *REF).collect()
    got = query(port, *PORT).collect()
    assert got.schema.names == want.schema.names
    assert_tables_equal(want, got, ignore_order=ignore_order,
                        approximate_float=FLOAT_RTOL)
    return want, got, port


def int_long_table(n, seed, k_type=np.int32):
    """An int column k and a long column v, both with nulls."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(-1000, 1000, n).astype(k_type),
                      mask=rng.random(n) < 0.05),
        "v": pa.array(rng.integers(-2**40, 2**40, n),
                      mask=rng.random(n) < 0.05)})


def specials_table(n, seed):
    """Keys with nulls, NaN, -0.0 beside 0.0, +-inf, and strings."""
    rng = np.random.default_rng(seed)
    f = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, 2.5]),
                   n)
    names = np.array(["", "a", "ab", "é中", "zz"])
    return pa.table({
        "k": pa.array(rng.integers(0, 4, n), mask=rng.random(n) < 0.1),
        "f": pa.array(f, mask=rng.random(n) < 0.1),
        "s": pa.array(list(rng.choice(names, n)), type=pa.string(),
                      mask=rng.random(n) < 0.1)})


# ---------------------------------------------------------------------------
# the reference's own tests, mirrored
# ---------------------------------------------------------------------------

def test_limit_and_union():
    """tests/test_basic_ops.py:test_limit_and_union."""
    a, b = int_long_table(100, 1), int_long_table(100, 2)
    want, got, _ = both(lambda s, F, col, lit: s.create_dataframe(
        a.select(["k"])).union(s.create_dataframe(b.select(["k"])))
        .limit(150), ignore_order=False)
    assert got.num_rows == 150


def test_range():
    """tests/test_basic_ops.py:test_range."""
    both(lambda s, F, col, lit: s.range(0, 1000, 3).select(
        (col("id") * 2).alias("x")), ignore_order=False)


@pytest.mark.parametrize("enabled", [True, False])
def test_distinct_multi_partition_dedupes_globally(enabled):
    """tests/test_basic_ops.py:
    test_distinct_multi_partition_dedupes_globally."""
    rng = np.random.default_rng(6)
    tb = pa.table({
        "k": pa.array(rng.integers(0, 9, 500).astype(np.int64)),
        "s": pa.array([f"g{int(i) % 5}" for i in rng.integers(0, 50, 500)]),
    })
    want_rows = tb.group_by(["k", "s"]).aggregate([]).num_rows
    conf = {"spark.rapids.sql.enabled": enabled}
    _, got, _ = both(lambda s, F, col, lit: s.create_dataframe(
        tb, num_partitions=4).distinct(), conf)
    assert got.num_rows == want_rows


def test_sample_deterministic():
    """tests/test_expand_generate.py:test_sample_deterministic."""
    t = pa.table({"x": pa.array(np.random.default_rng(42).integers(
        -2**62, 2**62, 1024))})
    _, got, _ = both(lambda s, F, col, lit: s.create_dataframe(t).sample(
        0.3, seed=7), ignore_order=False)
    assert 0 < got.num_rows < 1024


def test_sample_fraction_bounds():
    """tests/test_expand_generate.py:test_sample_fraction_bounds."""
    t = pa.table({"x": pa.array(np.random.default_rng(43).integers(
        -2**62, 2**62, 512))})
    _, got, _ = both(lambda s, F, col, lit: s.create_dataframe(
        t, num_partitions=2).sample(1.0, seed=1), ignore_order=False)
    assert got.num_rows == 512
    _, got, _ = both(lambda s, F, col, lit: s.create_dataframe(
        t, num_partitions=2).sample(0.0, seed=1))
    assert got.num_rows == 0


def test_repartition_roundtrip():
    """tests/test_shuffle.py:test_repartition_roundtrip."""
    t = int_long_table(512, 3)
    _, got, _ = both(lambda s, F, col, lit: s.create_dataframe(
        t, num_partitions=2).repartition(5, col("k")).group_by(col("k"))
        .agg(F.count("*").alias("c")))
    assert sum(got["c"].to_pylist()) == 512


# ---------------------------------------------------------------------------
# the sample's keep mask, bit for bit
# ---------------------------------------------------------------------------

OFFSETS = (0, 1000, 2**31 - 7, 2**32 - 8192, 2**32 - 5000, 2**32 - 1)


@pytest.mark.parametrize("pid", range(4))
@pytest.mark.parametrize("seed", [0, 7, 2**31, 2**32 - 1])
def test_keep_mask_matches_reference(seed, pid):
    """The int64-carried mixer keeps exactly the rows the reference's
    uint32 numpy mixer keeps, at row offsets that wrap past 2^32."""
    child = rbasic.LocalScanExec(pa.table({"x": pa.array([1])}))
    for fraction in (0.0, 0.1, 0.3, 0.999, 1.0):
        ref = rbasic.SampleExec(fraction, seed, child)
        for offset in OFFSETS:
            want = ref._keep_mask(np, 8192, offset, pid)
            got = pbasic.sample_keep_mask(8192, offset, pid, ref.seed,
                                          fraction, torch.device("cpu"))
            np.testing.assert_array_equal(got.numpy(), want)


def test_sample_carries_the_row_offset_across_batches():
    """A sample over several batches per partition keys each row by its
    index in the partition, as one batch would."""
    t = int_long_table(3000, 9, np.int64)
    whole = pbasic.SampleExec(0.4, 11, pbasic.LocalScanExec(t))
    split = pbasic.SampleExec(0.4, 11, pbasic.LocalScanExec(
        t, batch_rows=700))
    ctx = ExecContext("cpu")
    assert whole.execute_collect(ctx).equals(split.execute_collect(ctx))


# ---------------------------------------------------------------------------
# range edges
# ---------------------------------------------------------------------------

RANGES = {
    "negative_step": (10, -7, -3, 4),
    "negative_step_mid_batch": (1000, -2001, -7, 3),
    "empty": (5, 5, 1, 2),
    "empty_wrong_direction": (5, 0, 1, 1),
    "step_not_dividing": (0, 1000, 7, 1),
    "more_partitions_than_rows": (0, 3, 1, 8),
    "one_row": (-4, -3, 5, 2),
}


@pytest.mark.parametrize("case", sorted(RANGES))
def test_range_edges_match_reference(case):
    start, end, step, parts = RANGES[case]
    _, got, _ = both(lambda s, F, col, lit: s.range(
        start, end, step, num_partitions=parts), ignore_order=False)
    assert got["id"].to_pylist() == list(range(start, end, step))


def test_range_of_several_batches():
    """More than 2^20 rows in a partition: batches of at most 2^20 rows,
    each at its capacity bucket with invalid, zero padding."""
    n = (1 << 20) + 5000
    ex = pbasic.RangeExec(-3, -3 + 2 * n, 2)
    batches = list(ex.execute_partition(0, ExecContext("cpu")))
    assert [b.num_rows for b in batches] == [1 << 20, 5000]
    assert [b.capacity for b in batches] == [1 << 20, 8192]
    tail = batches[1].columns[0]
    assert not tail.validity[5000:].any() and not tail.data[5000:].any()
    got = GpuSession(device="cpu").range(-3, -3 + 2 * n, 2).collect()
    np.testing.assert_array_equal(got["id"].to_numpy(),
                                  np.arange(-3, -3 + 2 * n, 2))


def test_range_wraps_in_int64():
    got = GpuSession(device="cpu").range(
        2**63 - 3, 2**63 + 2, 1).collect()["id"].to_pylist()
    assert got == [2**63 - 3, 2**63 - 2, 2**63 - 1, -2**63, -2**63 + 1]


def test_range_step_zero_raises():
    with pytest.raises(ValueError):
        GpuSession(device="cpu").range(0, 10, 0).collect()


# ---------------------------------------------------------------------------
# distinct
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("cols", [("k",), ("f",), ("s",), ("k", "f", "s")])
def test_distinct_specials_match_reference(cols, parts):
    t = specials_table(400, 21)
    _, got, _ = both(lambda s, F, col, lit: s.create_dataframe(
        t, num_partitions=parts).select(*cols).distinct())
    rows = [tuple(r.values()) for r in got.to_pylist()]
    key = [tuple("nan" if isinstance(x, float) and x != x else x
                 for x in r) for r in rows]
    assert len(set(key)) == len(key)      # no duplicate left


@pytest.mark.parametrize("parts", [1, 4])
def test_distinct_of_no_rows(parts):
    t = specials_table(0, 22)
    _, got, _ = both(lambda s, F, col, lit: s.create_dataframe(
        t, num_partitions=parts).distinct())
    assert got.num_rows == 0


@pytest.mark.parametrize("n", [0, 1, 900, 5000])
def test_group_reduce_with_no_ops_matches_reference(n):
    """K3's plain version with an empty op set: the group count and each
    group's key, against the reference's _group_reduce."""
    t = specials_table(n, 23).select(["k", "f"])
    ref = rdev.batch_to_device(pa.RecordBatch.from_arrays(
        [c.combine_chunks() for c in t.columns], names=t.column_names))
    mine = pdev.batch_to_device(pa.RecordBatch.from_arrays(
        [c.combine_chunks() for c in t.columns], names=t.column_names),
        "cpu")
    live = jnp.arange(ref.capacity) < ref.num_rows
    rk, rv, rn = ragg._group_reduce(jnp, list(ref.columns), [], [],
                                    ref.capacity, live, False)
    pk, pv, pn = pagg._group_reduce(list(mine.columns), [], [], n, False)
    assert pn == int(rn) and rv == [] and pv == []
    want = pa.table({"k": rdev.column_to_arrow(rk[0], pn),
                     "f": rdev.column_to_arrow(rk[1], pn)})
    got = pa.table({"k": pdev.column_to_arrow(pk[0], pn),
                    "f": pdev.column_to_arrow(pk[1], pn)})
    assert_tables_equal(want, got)
    assert pagg.segment_reduce_sorted.launches == 0     # plain version


def test_segment_reduce_plain_with_no_ops():
    """The plain K3 with no op: the group count and each group's first
    row, in key order."""
    k = torch.tensor([5, 3, 5, 9, 3, 3], dtype=torch.int64)
    order = pcarry.sort_order([k])
    first, sums, counts, g = pagg.segment_reduce_sorted(
        [k], None, [], [], False, order, [])
    assert g == 3 and sums == [] and counts == []
    assert k[first.long()].tolist() == [3, 5, 9]


@pytest.mark.parametrize("batch_rows", [None, 37])
def test_partial_final_aggregate_with_no_buffers(batch_rows):
    """The PARTIAL, merge and FINAL paths with zero aggregate buffers:
    one row per distinct key."""
    t = specials_table(300, 24).select(["k", "s"])
    scan = pbasic.LocalScanExec(t, batch_rows=batch_rows)
    keys = [PA("k"), PA("s")]
    part = pagg.GpuHashAggregateExec(keys, [], paggs.PARTIAL, scan)
    final = pagg.GpuHashAggregateExec(keys, [], paggs.FINAL, part)
    got = final.execute_collect(ExecContext("cpu"))
    want = t.group_by(["k", "s"]).aggregate([])
    assert_tables_equal(want.select(["k", "s"]), got)


# ---------------------------------------------------------------------------
# union, repartition, actions
# ---------------------------------------------------------------------------

def test_union_of_one_and_four_partitions():
    a, b = int_long_table(300, 4), int_long_table(200, 5)
    _, got, port = both(lambda s, F, col, lit: s.create_dataframe(a).union(
        s.create_dataframe(b, num_partitions=4)))
    assert got.num_rows == 500
    _, got, _ = both(lambda s, F, col, lit: s.create_dataframe(a).unionAll(
        s.create_dataframe(b, num_partitions=4)).group_by(col("k")).agg(
        F.sum(col("v")).alias("sv"), F.count("*").alias("c")))


def test_union_partitions_end_to_end():
    a, b = int_long_table(30, 6), int_long_table(20, 7)
    u = pbasic.UnionExec([pbasic.LocalScanExec(a, 2),
                          pbasic.LocalScanExec(b, 3)])
    assert u.num_partitions == 5
    ctx = ExecContext("cpu")
    rows = [sum(x.num_rows for x in u.execute_partition(p, ctx))
            for p in range(5)]
    assert rows == [15, 15, 7, 7, 6]


@pytest.mark.parametrize("parts", [1, 3])
def test_round_robin_matches_reference_cpu_engine(parts):
    t = int_long_table(700, 8)
    ref = TpuSession.builder().config("spark.rapids.sql.enabled",
                                      False).get_or_create()
    for port in (GpuSession(device="cpu"),
                 GpuSession(device="cpu",
                            conf={"spark.rapids.sql.enabled": False})):
        for q in (lambda s, col: s.create_dataframe(t, parts)
                  .repartition(4).sample(0.5, seed=3),
                  lambda s, col: s.create_dataframe(t, parts)
                  .repartition(4).group_by(col("k")).count()):
            assert_tables_equal(q(ref, rcol).collect(),
                                q(port, pcol).collect())
    assert GpuSession(device="cpu").create_dataframe(t, parts) \
        .repartition(8).count() == 700


@pytest.mark.parametrize("offset", [0, 5, 2**31 - 1000, 2**31 - 1])
def test_round_robin_partition_ids_match_reference(offset):
    t = int_long_table(1000, 10)
    rb = t.to_batches()[0]
    rbatch = rdev.batch_to_device(rb, xp=np)
    pbatch = pdev.batch_to_device(rb, "cpu")
    with np.errstate(over="ignore"):
        want = rpart.RoundRobinPartitioning(7).partition_ids(
            np, REval(np, rbatch), rbatch, offset)
    got = ppart.RoundRobinPartitioning(7).partition_ids(
        PEval(pbatch), pbatch, offset)
    np.testing.assert_array_equal(got.numpy(), want)


def test_repartition_under_device_operators_is_stripped():
    """A repartition under GPU operators that only pass its partitions on
    leaves no exchange in the plan; one under a sample keeps the
    exchange, on the host, with its reason, and the sample on the GPU."""
    t = int_long_table(400, 11)
    s = GpuSession(device="cpu")
    s.create_dataframe(t, 2).repartition(3).filter(
        pcol("v") > 0).collect()
    names = []
    s.last_plan.foreach(lambda e: names.append(type(e).__name__))
    assert "ShuffleExchangeExec" not in names
    assert s.create_dataframe(t).repartition(3, pcol("k")).count() == 400
    s.create_dataframe(t, 2).repartition(3).sample(0.5).collect()
    assert "!Exec <ShuffleExchangeExec> cannot run on GPU because " \
        "SampleExec above reads its partitions" in s.last_explain
    assert "*Exec <SampleExec> will run on GPU" in s.last_explain


# queries with an operator that reads partitions (a sample, a row id, a
# sort within partitions, a limit, a cache write) above a repartition,
# with operators between that pass the partitions on
READERS = {
    "filter_sample": lambda s, F, col, t: s.create_dataframe(t, 2)
    .repartition(4, col("k")).filter(col("v") > 0).sample(0.5, seed=3),
    "project_sample": lambda s, F, col, t: s.create_dataframe(t, 2)
    .repartition(4).select(col("k"), (col("v") * 2).alias("w"))
    .sample(0.5, seed=3),
    "union_sample": lambda s, F, col, t: s.create_dataframe(t, 2)
    .repartition(4).union(s.create_dataframe(t.slice(0, 90), 3))
    .sample(0.5, seed=3),
    "row_id": lambda s, F, col, t: s.create_dataframe(t, 2)
    .repartition(3, col("k")).filter(col("v") > 0)
    .select(col("k"), col("v"),
            F.monotonically_increasing_id().alias("id")),
    "row_id_filter": lambda s, F, col, t: s.create_dataframe(t, 2)
    .repartition(3).filter(F.monotonically_increasing_id() % 3 == 0),
    "sort_within": lambda s, F, col, t: s.create_dataframe(t, 2)
    .repartition(3, col("k")).filter(col("v") > 0)
    .sort_within_partitions(col("v")),
    "limit": lambda s, F, col, t: s.create_dataframe(t, 2)
    .repartition(4, col("k")).select(col("k"), col("v")).limit(50),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_partition_readers_above_a_repartition_match_reference(name):
    """Every engine keeps the repartition's partitions under a reader,
    whatever passes them on between: the reference's CPU engine against
    the port with and without the GPU."""
    t = int_long_table(600, 15)
    ref = TpuSession.builder().config("spark.rapids.sql.enabled",
                                      False).get_or_create()
    want = READERS[name](ref, RF, rcol, t).collect()
    for conf in (None, {"spark.rapids.sql.enabled": False}):
        port = GpuSession(device="cpu", conf=conf)
        got = READERS[name](port, PF, pcol, t).collect()
        assert_tables_equal(want, got, ignore_order=name != "sort_within",
                            approximate_float=FLOAT_RTOL)
        if conf is None:
            assert "ShuffleExchangeExec" in port.last_explain


def test_drop_and_rename_match_reference():
    t = int_long_table(50, 12)
    both(lambda s, F, col, lit: s.create_dataframe(t).with_column(
        "w", col("v") + 1).drop("v").with_column_renamed("k", "key"))
    both(lambda s, F, col, lit: s.create_dataframe(t).withColumnRenamed(
        "v", "value"))


def test_count_dtypes_and_to_pandas():
    t = specials_table(120, 13)
    ref, port = sessions()
    for s in (ref, port):
        df = s.create_dataframe(t, num_partitions=3)
        assert df.count() == 120
        assert df.filter((rcol if s is ref else pcol)("k") > 100).count() \
            == 0
        assert s.create_dataframe(t.slice(0, 0)).count() == 0
    assert port.create_dataframe(t).dtypes == \
        ref.create_dataframe(t).dtypes == \
        [("k", "bigint"), ("f", "double"), ("s", "string")]
    got = port.create_dataframe(t).to_pandas()
    assert got.equals(ref.create_dataframe(t).toPandas())


def test_show_prints_the_first_rows(capsys):
    t = int_long_table(30, 14)
    GpuSession(device="cpu").create_dataframe(t).show(5)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 6 and out[0].split() == ["k", "v"]


GROUPED = {
    "count": lambda g: g.count(),
    "sum_all": lambda g: g.sum(),
    "avg_all": lambda g: g.avg(),
    "min_all": lambda g: g.min(),
    "max_all": lambda g: g.max(),
    "sum_v": lambda g: g.sum("v"),
    "avg_f_v": lambda g: g.avg("f", "v"),
    "min_f": lambda g: g.min("f"),
    "max_v": lambda g: g.max("v"),
}


@pytest.mark.parametrize("case", sorted(GROUPED))
def test_grouped_shorthands_match_reference(case):
    rng = np.random.default_rng(15)
    t = pa.table({"k": pa.array(rng.integers(0, 6, 300)),
                  "v": pa.array(rng.integers(-99, 99, 300),
                                mask=rng.random(300) < 0.1),
                  "f": pa.array(rng.random(300)),
                  "s": pa.array([f"x{i % 4}" for i in range(300)]),
                  "i": pa.array(rng.integers(0, 9, 300).astype(np.int32))})
    _, got, port = both(lambda s, F, col, lit: GROUPED[case](
        s.create_dataframe(t, num_partitions=2).group_by(col("k"))))
    assert "!" not in port.last_explain


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

SURFACE = {
    "range": lambda s, col: s.range(0, 100, 3, num_partitions=2),
    "union": lambda s, col: s.range(0, 10).union(s.range(5, 20)),
    "sample": lambda s, col: s.range(0, 100).sample(0.5),
    "distinct": lambda s, col: s.range(0, 100, num_partitions=3).select(
        (col("id") % 7).alias("m")).distinct(),
}


@pytest.mark.parametrize("case", sorted(SURFACE))
@pytest.mark.parametrize("enabled", [True, False])
def test_surface_placements(case, enabled):
    """GPU-placed on the port's default rewrite (only the final download
    is on the CPU); every operator on the CPU under
    spark.rapids.sql.enabled=false."""
    s = GpuSession(device="cpu", conf={"spark.rapids.sql.enabled": enabled})
    df = SURFACE[case](s, pcol)
    df.explain()
    df.collect()
    places = []
    s.last_plan.foreach(lambda e: places.append(
        (type(e).__name__, e.placement)))
    if enabled:
        assert places[0] == ("DeviceToHostExec", CPU)
        assert all(p == GPU for _, p in places[1:]), places
    else:
        assert all(p == CPU for _, p in places), places
